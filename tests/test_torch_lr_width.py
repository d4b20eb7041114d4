"""The training launcher's schedule on a wide config, in both packages.

The launcher's default lr (1e-3) is tuned at the smoke config's d_model
288. Adam's first update is lr * sign(g) on every entry, whatever the
weight's scale, so at wider layers (and, for the output projections
drawn at 1/sqrt(fan_in * L), deeper stacks) it moves a matrix's output by
a multiple of its own size, and over the launcher's 5 warmup steps the
loss climbs past ln(vocab) before it falls. This is the reference's
recipe, not the port's: on MiniCPM-2B's layer at half its width (d_model
1152, 4 layers, a 2048-token vocab, float32), the launcher's ten steps
(warmup 5, WSD) give the same losses in both packages, to rtol 1e-4
(gradient norms to 1e-3: the two float32 trajectories part in the last
bits, and the climb amplifies that), and the loss climbs past ln(vocab)
in both.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_config as jget
from repro.data.pipeline import TokenPipeline as JPipe
from repro.models import model as JM
from repro.train import optimizer as JO
from repro.train.train_loop import train as jtrain
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import model as M
from repro_torch.train import optimizer as O
from repro_torch.train.train_loop import train
from torch_engine_pair import torch_one_thread  # noqa: F401  (fixture)

STEPS, BATCH, SEQ = 10, 2, 64
WIDE = dict(num_layers=4, d_model=1152, num_heads=18, num_kv_heads=18,
            d_ff=2880, vocab_size=2048, dtype="float32")


@pytest.fixture(autouse=True)
def _one_thread(torch_one_thread):
    yield


def _both(lr):
    """The ten steps at ``lr`` from the same weights and data: (port, JAX)
    histories."""
    jcfg = dataclasses.replace(jget("minicpm_2b"), **WIDE)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    # the launcher's schedule for --steps 10
    kw = dict(lr=lr, schedule="wsd", warmup_steps=max(STEPS // 20, 5),
              total_steps=STEPS)
    _, _, jh = jtrain(jcfg, JO.AdamWConfig(**kw),
                      iter(JPipe(jcfg, BATCH, SEQ)), num_steps=STEPS,
                      params=jax.tree.map(jnp.asarray, tree), log_every=1,
                      log_fn=lambda *_: None)
    _, _, th = train(cfg, O.AdamWConfig(**kw),
                     iter(TokenPipeline(cfg, BATCH, SEQ)), num_steps=STEPS,
                     params=M.load_jax_params(tree, "cpu"),
                     device="cpu", log_every=1, log_fn=lambda *_: None)
    return th, jh


def test_launcher_schedule_at_width_matches_jax():
    th, jh = _both(1e-3)
    assert [h["step"] for h in th] == [h["step"] for h in jh] \
        == list(range(1, STEPS + 1))
    for t, j in zip(th, jh):
        assert t["loss"] == pytest.approx(j["loss"], rel=1e-4), t["step"]
        assert t["lr"] == pytest.approx(j["lr"], rel=1e-6), t["step"]
        assert t["grad_norm"] == pytest.approx(j["grad_norm"], rel=1e-3), \
            t["step"]
    ln_v = math.log(WIDE["vocab_size"])
    assert max(h["loss"] for h in jh) > ln_v + 1.0, jh
    assert max(h["loss"] for h in th) > ln_v + 1.0, th
