"""The port's VLM (LLaVA-NeXT: patch embeddings ahead of the text, a
sliding window) against ``repro.models.model`` on the same weights and
inputs (numpy, from a seed), in float32 on the CPU: prefill and decode
with the window taking effect, the window's masking, and the loss over
the text positions only.

Prefill attention runs through ``ops.swa_attention``'s plain version in
the port and through ``chunked_attention`` in JAX; logits and caches are
held to 2e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_smoke_config as jget_smoke
from repro.models import model as JM
from repro_torch.configs.base import ModelConfig
from repro_torch.models import decoder as D
from repro_torch.models import layers as L
from repro_torch.models import model as M

TOL = dict(atol=2e-5, rtol=2e-5)


def _configs(**changes):
    jcfg = dataclasses.replace(jget_smoke("llava_next_mistral_7b"),
                               dtype="float32", **changes)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _weights(jcfg, rng):
    """The JAX init's weights with the norms (zeros there) randomised."""
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                   jax.random.PRNGKey(1)))
    for group, name in ((tree, "final_norm"), (tree["layers"], "attn_norm"),
                        (tree["layers"], "mlp_norm")):
        group[name] = (0.1 * rng.standard_normal(group[name].shape)).astype(
            np.float32)
    return tree


def _batch(cfg, rng, b, s):
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return {"tokens": toks,
            "targets": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32),
            "patches": (0.02 * rng.standard_normal(
                (b, cfg.num_patch_tokens, cfg.d_model))).astype(np.float32)}


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), err_msg=what,
                               **TOL)


def test_prefill_and_decode_match_jax():
    """16 patches and 200 text tokens: 216 positions, past the smoke
    config's 64-token window, so the window masks keys at every layer; the
    cache holds P + S positions and decode starts at cache_len P + S."""
    jcfg, cfg = _configs()
    rng = np.random.default_rng(0)
    tree = _weights(jcfg, rng)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = M.load_jax_params(tree, "cpu")
    b, s, steps = 2, 200, 3
    n = cfg.num_patch_tokens + s
    assert n > cfg.sliding_window
    batch = _batch(cfg, rng, b, s)
    size = n + steps
    jl, jc = JM.prefill(jcfg, jp, {k: jnp.asarray(v) for k, v in
                                   batch.items()}, size)
    tl, tc = M.prefill(cfg, tp, {k: torch.from_numpy(v) for k, v in
                                 batch.items()}, size)
    _close(tl, jl, "prefill logits")
    assert set(tc) == set(jc) == {"k", "v"}
    for k in jc:
        _close(tc[k], jc[k], f"prefill cache {k}")
    assert {k: (tuple(t.shape), t.dtype) for k, t in tc.items()} == \
        M.cache_specs(cfg, b, size)

    nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    for step in range(steps):
        jl, jc = JM.decode_step(jcfg, jp, jc, jnp.asarray(nxt),
                                jnp.int32(n + step))
        tl, _ = M.decode_step(cfg, tp, tc, torch.from_numpy(nxt), n + step)
        _close(tl, jl, f"decode {step} logits")
        for k in jc:
            _close(tc[k], jc[k], f"decode {step} cache {k}")
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


def test_sliding_window_masks_old_tokens():
    """``test_models.py``'s window property on the port: with window 8 and
    two layers the last position sees back 16 positions, so changing text
    token 2 of 32 (behind 16 zero patches) leaves the last logits as they
    were; changing token 30 does not."""
    _, cfg = _configs(sliding_window=8)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    s = 32
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, s)), dtype=torch.int32)
    patches = torch.zeros((1, cfg.num_patch_tokens, cfg.d_model))

    def last_logits(t):
        batch = {"tokens": t, "targets": t, "patches": patches}
        return M.prefill(cfg, params, batch, cache_size=s + 40)[0]

    base = last_logits(toks)
    for pos, same in ((2, True), (30, False)):
        mod = toks.clone()
        mod[0, pos] = (mod[0, pos] + 1) % cfg.vocab_size
        assert torch.allclose(last_logits(mod), base, atol=1e-5) == same, pos


def test_loss_scores_text_positions_only():
    """``loss_fn`` equals JAX's (rtol 1e-5), and equals the mean next-token
    cross entropy over the S - 1 text positions of the teacher-forced
    logits: the patches feed the text but carry no loss."""
    jcfg, cfg = _configs()
    rng = np.random.default_rng(3)
    tree = _weights(jcfg, rng)
    tp = M.load_jax_params(tree, "cpu")
    batch = _batch(cfg, rng, 2, 40)
    jloss, jm = JM.loss_fn(jcfg, jax.tree.map(jnp.asarray, tree),
                           {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, m = M.loss_fn(cfg, tp, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(m["xent"]), float(jm["xent"]),
                               rtol=1e-5)
    assert float(m["aux"]) == 0.0

    x = torch.cat([tb["patches"], tp["embed"][tb["tokens"].long()]], dim=1)
    h, _ = D.forward(cfg, tp["layers"], x,
                     torch.arange(x.shape[1])[None, :])
    logits = (L.rms_norm(h, tp["final_norm"]) @ tp["unembed"])[:, -40:]
    want = torch.nn.functional.cross_entropy(
        logits[:, :-1].reshape(-1, cfg.vocab_size),
        tb["targets"][:, 1:].reshape(-1).long())
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)
    other = dict(tb, patches=tb["patches"] * 2)
    assert float(M.loss_fn(cfg, tp, other)[0]) != float(loss)
