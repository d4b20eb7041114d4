"""The port's training side (``repro_torch.train``, ``data.pipeline
.TokenPipeline``, ``launch.train``) on the CPU: the ports of
``test_train.py``'s tests, and parity with ``repro.train`` on the same
weights and data.

Schedules equal JAX's float32 values to 1e-6 relative; one AdamW update
(params, moments, lr, gradient norm) to 1e-6 with float32 state, and with
bf16 state the moments bit for bit wherever the float32 update agrees
bit for bit (XLA's and torch's float32 arithmetic differ in the last bit
on about a quarter of them) and within one bf16 step elsewhere; the
first 5 losses of ``train`` to rtol 1e-4; the pipeline's batches element
for element.
"""
import dataclasses
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_smoke_config as jget_smoke
from repro.data.pipeline import TokenPipeline as JPipe
from repro.models import model as JM
from repro.train import optimizer as JO
from repro.train.train_loop import train as jtrain
from repro_torch.configs.base import ModelConfig, get_smoke_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import model as M
from repro_torch.train import checkpoint as C
from repro_torch.train import optimizer as O
from repro_torch.train.train_loop import train
from torch_engine_pair import torch_one_thread  # noqa: F401  (fixture)

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


@pytest.fixture(autouse=True)
def _one_thread(torch_one_thread):
    yield


def _configs(arch, dtype="float32"):
    jcfg = dataclasses.replace(jget_smoke(arch), dtype=dtype)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


# ---------------------------------------------------------------------------
# test_train.py on the port
# ---------------------------------------------------------------------------

def test_wsd_schedule_shape():
    cfg = O.AdamWConfig(lr=1e-3, schedule="wsd", warmup_steps=10,
                        total_steps=100, decay_frac=0.2)
    lr = lambda s: float(O.wsd_schedule(cfg, s))
    assert lr(0) == 0.0
    assert lr(10) == pytest.approx(1e-3)
    assert lr(50) == pytest.approx(1e-3)          # stable plateau
    assert lr(99) < 0.6e-3                        # decay tail
    assert lr(80) == pytest.approx(1e-3)


def test_adamw_decreases_loss():
    cfg = get_smoke_config("minicpm_2b")
    pipe = TokenPipeline(cfg, batch_size=4, seq_len=64, seed=0)
    opt = O.AdamWConfig(lr=3e-3, schedule="wsd", warmup_steps=5,
                        total_steps=40, weight_decay=0.0)
    _, _, hist = train(cfg, opt, iter(pipe), num_steps=40, device="cpu",
                       log_every=10, log_fn=lambda *_: None)
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.3, hist


def test_grad_clip_caps_update():
    g = {"w": torch.full((4, 4), 100.0)}
    p = {"w": torch.zeros((4, 4))}
    cfg = O.AdamWConfig(grad_clip=1.0)
    st = O.init_opt_state(cfg, p)
    mets = O.apply_adamw(cfg, p, g, st)
    assert float(mets["grad_norm"]) == pytest.approx(400.0)


def test_checkpoint_roundtrip():
    """bf16, int, float32 and scalar leaves, nested; the write leaves no
    temporary file behind."""
    tree = {"a": torch.arange(6).reshape(2, 3),
            "b": {"c": 3.5, "d": torch.ones(4, dtype=torch.int32),
                  "e": torch.randn(3, 2).to(torch.bfloat16)},
            "step": 7, "f": torch.tensor(2.25)}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "sub", "ckpt.pt")
        C.save(path, tree)
        C.save(path, tree)               # replaces the first one
        back = C.load(path)
        assert os.listdir(os.path.dirname(path)) == ["ckpt.pt"]
    assert back["step"] == 7 and back["b"]["c"] == 3.5
    for get in (lambda t: t["a"], lambda t: t["b"]["d"],
                lambda t: t["b"]["e"], lambda t: t["f"]):
        assert get(back).dtype == get(tree).dtype
        assert torch.equal(get(back), get(tree))


def test_pipeline_determinism_and_structure():
    cfg = get_smoke_config("stablelm_3b")
    a = TokenPipeline(cfg, 2, 32, seed=5).next_batch()
    b = TokenPipeline(cfg, 2, 32, seed=5).next_batch()
    assert torch.equal(a["tokens"], b["tokens"])
    assert tuple(a["tokens"].shape) == (2, 32)
    assert a["tokens"].dtype == torch.int32
    assert int(a["tokens"].max()) < cfg.vocab_size


# ---------------------------------------------------------------------------
# parity with repro.train
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["cosine", "wsd", "const"])
def test_schedules_match_jax(schedule):
    kw = dict(lr=2e-3, schedule=schedule, warmup_steps=7, total_steps=50,
              decay_frac=0.3)
    jcfg, cfg = JO.AdamWConfig(**kw), O.AdamWConfig(**kw)
    for step in range(kw["total_steps"] + 1):
        want = float(JO.schedule_fn(jcfg)(jcfg, jnp.int32(step)))
        got = float(O.schedule_fn(cfg)(cfg, torch.tensor(step)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step


def _adamw_inputs(rng):
    shapes = {"w": (6, 5), "stack": (2, 3, 4), "norm": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = {k: 0.3 * rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
    # moments that bf16 holds exactly, so both state dtypes start equal
    mu = {k: np.asarray(jnp.asarray(0.1 * rng.standard_normal(s),
                                    jnp.bfloat16).astype(jnp.float32))
          for k, s in shapes.items()}
    nu = {k: np.asarray(jnp.asarray(0.01 * rng.random(s),
                                    jnp.bfloat16).astype(jnp.float32))
          for k, s in shapes.items()}
    return params, grads, mu, nu


def _adamw_both(state_dtype, params, grads, mu, nu):
    kw = dict(lr=1e-2, schedule="cosine", warmup_steps=2, total_steps=10,
              state_dtype=state_dtype, grad_clip=0.5)
    jcfg, cfg = JO.AdamWConfig(**kw), O.AdamWConfig(**kw)
    jdt = jnp.bfloat16 if state_dtype == "bfloat16" else jnp.float32
    jstate = {"mu": {k: jnp.asarray(v, jdt) for k, v in mu.items()},
              "nu": {k: jnp.asarray(v, jdt) for k, v in nu.items()},
              "step": jnp.int32(3)}
    jp, js, jm = JO.apply_adamw(jcfg, jax.tree.map(jnp.asarray, params),
                                jax.tree.map(jnp.asarray, grads), jstate)
    tdt = torch.bfloat16 if state_dtype == "bfloat16" else torch.float32
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = {"mu": {k: torch.tensor(v, dtype=tdt) for k, v in mu.items()},
              "nu": {k: torch.tensor(v, dtype=tdt) for k, v in nu.items()},
              "step": torch.tensor(3, dtype=torch.int32)}
    tm = O.apply_adamw(cfg, tp, {k: torch.from_numpy(v) for k, v in
                                 grads.items()}, tstate)
    assert int(tstate["step"]) == int(js["step"]) == 4
    for k in ("lr", "grad_norm"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6)
    return (jp, js), (tp, tstate)


def test_apply_adamw_matches_jax():
    """One update from step 3, clipped, with weight decay on the 2-D and
    3-D leaves only; then with bf16 moments from the same (bf16-exact)
    starting moments."""
    params, grads, mu, nu = _adamw_inputs(np.random.default_rng(0))
    (jp, js), (tp, ts) = _adamw_both("float32", params, grads, mu, nu)
    for k in params:
        for got, want in ((tp[k], jp[k]), (ts["mu"][k], js["mu"][k]),
                          (ts["nu"][k], js["nu"][k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    # weight decay only where ndim >= 2: without it the 1-D leaf is the
    # same, the matrices are not
    nowd = dataclasses.replace(O.AdamWConfig(
        lr=1e-2, schedule="cosine", warmup_steps=2, total_steps=10,
        grad_clip=0.5), weight_decay=0.0)
    p0 = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    st = {"mu": {k: torch.tensor(v) for k, v in mu.items()},
          "nu": {k: torch.tensor(v) for k, v in nu.items()},
          "step": torch.tensor(3, dtype=torch.int32)}
    O.apply_adamw(nowd, p0, {k: torch.from_numpy(v) for k, v in
                             grads.items()}, st)
    assert torch.equal(p0["norm"], tp["norm"])
    assert not torch.equal(p0["w"], tp["w"])

    (jpb, jsb), (tpb, tsb) = _adamw_both("bfloat16", params, grads, mu, nu)
    agree = 0
    for k in params:
        np.testing.assert_allclose(tpb[k].numpy(), np.asarray(jpb[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        for m in ("mu", "nu"):
            assert tsb[m][k].dtype == torch.bfloat16
            same = ts[m][k].numpy() == np.asarray(js[m][k])
            got = tsb[m][k].float().numpy()
            want = np.asarray(jsb[m][k].astype(jnp.float32))
            np.testing.assert_array_equal(got[same], want[same], err_msg=k)
            # elsewhere the float32 values differ in their last bits, so
            # the cast may round them one bf16 step apart
            assert (np.abs(got - want) <= np.abs(want) * 2.0 ** -7).all(), k
            agree += same.sum()
    assert agree >= 0.5 * 2 * sum(v.size for v in params.values())


def test_first_train_losses_match_jax():
    jcfg, cfg = _configs("minicpm_2b")
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                   jax.random.PRNGKey(2)))
    kw = dict(lr=3e-3, schedule="wsd", warmup_steps=2, total_steps=5)
    _, _, jh = jtrain(jcfg, JO.AdamWConfig(**kw), iter(JPipe(jcfg, 2, 32)),
                      num_steps=5, params=jax.tree.map(jnp.asarray, tree),
                      log_every=1, log_fn=lambda *_: None)
    lines = []
    _, _, th = train(cfg, O.AdamWConfig(**kw), iter(TokenPipeline(cfg, 2, 32)),
                     num_steps=5, params=M.load_jax_params(tree, "cpu"),
                     device="cpu", log_every=1, log_fn=lines.append)
    assert [h["step"] for h in th] == [h["step"] for h in jh] == [1, 2, 3, 4,
                                                                   5]
    assert set(th[0]) == set(jh[0])
    for t, j in zip(th, jh):
        for k in ("loss", "xent", "grad_norm", "lr"):
            assert t[k] == pytest.approx(j[k], rel=1e-4), (t["step"], k)
    assert lines[0].startswith("step     1 loss ")


@pytest.mark.parametrize("arch", ["stablelm_3b", "llava_next_mistral_7b",
                                  "whisper_large_v3"])
def test_token_pipeline_matches_jax(arch):
    cfg = get_smoke_config(arch)
    jp, tp = JPipe(jget_smoke(arch), 3, 24, seed=4), TokenPipeline(cfg, 3, 24,
                                                                    seed=4)
    for _ in range(2):
        jb, tb = jp.next_batch(), next(tp)
        assert set(jb) == set(tb)
        for k, want in jb.items():
            want = np.asarray(want)
            assert tb[k].device.type == "cpu"
            assert str(tb[k].dtype).split(".")[-1] == want.dtype.name, k
            np.testing.assert_array_equal(tb[k].numpy(), want, err_msg=k)


def test_launcher_trains_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "3", "--batch", "2", "--seq", "32"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout.splitlines()
    assert sum(line.startswith("step ") for line in out) == 3, out
    assert out[-1].startswith("final loss "), out
