"""The port's training forward and loss (``models.model.loss_fn``,
``decoder.forward``, ``encdec.decode_forward``) against
``repro.models.model`` for every architecture, and the ports of
``test_models.py``'s tests.

Every arch's smoke config in float32 on the same weights (the JAX init's,
norms randomised) and batch (numpy, from a seed): the loss and the MoE
aux loss within rtol 1e-5, and the gradient of every parameter leaf
(autograd against ``jax.grad``) within 1e-4 of the leaf's largest
|gradient|, plus 1e-7. The forward computes sliding-window attention and
the SSD scan in plain PyTorch, as the JAX forward does, so SSM and hybrid
archs hold the same tolerances.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ARCH_IDS
from repro.configs.base import get_smoke_config as jget_smoke
from repro.models import decoder as JD
from repro.models import model as JM
from repro_torch.configs.base import ModelConfig, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.models import decoder as D
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.train import optimizer as O
from repro_torch.train.train_loop import make_train_step
from torch_engine_pair import torch_one_thread  # noqa: F401  (fixture)

# leaves the JAX init makes constant: randomised so the gradients differ
NORMS = ("final_norm", "attn_norm", "mlp_norm", "norm", "ssm_norm",
         "attn_out_norm", "ssm_out_norm", "w", "b", "b1", "b2", "bq", "bk",
         "bv", "conv_b")


@pytest.fixture(autouse=True)
def _one_thread(torch_one_thread):
    yield


def _configs(arch, dtype="float32", **changes):
    jcfg = dataclasses.replace(jget_smoke(arch), dtype=dtype, **changes)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _weights(jcfg, rng):
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                   jax.random.PRNGKey(1)))

    def walk(t):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v)
            elif k in NORMS:
                t[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(
                    v.dtype)
    walk(tree)
    return tree


def _batch(cfg, rng, b=2, s=32):
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)),
             "targets": rng.integers(0, cfg.vocab_size, (b, s))}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    if cfg.arch_type == "vlm":
        batch["patches"] = (0.02 * rng.standard_normal(
            (b, cfg.num_patch_tokens, cfg.d_model))).astype(np.float32)
    if cfg.arch_type == "audio":
        batch["frames"] = (0.02 * rng.standard_normal(
            (b, cfg.encoder_frames, cfg.d_model))).astype(np.float32)
    return batch


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _grads(cfg, params, batch):
    """(loss, metrics, {leaf path: gradient}) through autograd."""
    flat = dict(M.named_leaves(params))
    for p in flat.values():
        p.requires_grad_(True)
    loss, metrics = M.loss_fn(cfg, params, batch)
    grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True,
                                materialize_grads=True)
    for p in flat.values():
        p.requires_grad_(False)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, dict(zip(flat, grads))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_gradients_match_jax(arch):
    jcfg, cfg = _configs(arch)
    rng = np.random.default_rng(0)
    tree = _weights(jcfg, rng)
    batch = _batch(cfg, rng)
    jp = jax.tree.map(jnp.asarray, tree)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, _j(batch)), has_aux=True))(jp)
    loss, m, grads = _grads(cfg, M.load_jax_params(tree, "cpu"), _t(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]), rtol=1e-5,
                               atol=1e-9)
    if cfg.arch_type == "moe":
        assert float(m["aux"]) > 0
    jflat = {"/".join(p.key for p in path): np.asarray(g) for path, g in
             jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert set(grads) == set(jflat)
    for k, want in jflat.items():
        got = grads[k].numpy()
        scale = np.abs(want).max()
        # every leaf the loss reads gets a gradient (the audio model's LM
        # head has no final norm)
        unread = arch == "whisper_large_v3" and k == "final_norm"
        assert (scale > 0) != unread, k
        err = np.abs(got - want).max()
        assert err <= 1e-4 * scale + 1e-7, (k, err, scale)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_forward_and_train_step(arch):
    """``test_models.py::test_smoke_forward_and_train_step`` on the port:
    the bf16 smoke config's loss is finite, and one train step gives a
    finite loss and gradient norm and moves the parameters."""
    cfg = get_smoke_config(arch)
    assert cfg.num_layers <= 2 and cfg.d_model <= 512
    assert cfg.num_experts <= 4
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = _t(_batch(cfg, np.random.default_rng(0), 2, 64))
    with torch.no_grad():
        loss, _ = M.loss_fn(cfg, params, batch)
    assert torch.isfinite(loss), (arch, loss)

    opt_cfg = O.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    before = [p.clone() for p in O.leaves(params)]
    opt_state = O.init_opt_state(opt_cfg, params)
    params, opt_state, mets = make_train_step(cfg, opt_cfg)(
        params, opt_state, batch)
    assert torch.isfinite(mets["loss"]) and torch.isfinite(mets["grad_norm"])
    delta = sum(float((a.float() - b.float()).abs().sum())
                for a, b in zip(before, O.leaves(params)))
    assert delta > 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_prefill_decode_shapes(arch):
    """``test_models.py::test_smoke_prefill_decode_shapes`` on the port."""
    cfg = get_smoke_config(arch)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b, s = 2, 32
    batch = _t(_batch(cfg, np.random.default_rng(0), b, s))
    n = s + (cfg.num_patch_tokens if cfg.arch_type == "vlm" else 0)
    logits, cache = M.prefill(cfg, params, batch, n + 16)
    assert tuple(logits.shape) == (b, 1, cfg.vocab_size)
    tok = logits[:, -1].argmax(-1).to(torch.int32)
    lg, cache = M.decode_step(cfg, params, cache, tok, n)
    assert tuple(lg.shape) == (b, cfg.vocab_size)
    assert bool(torch.isfinite(lg.float()).all())


def _forward_logits(cfg, params, toks):
    h, _ = D.forward(cfg, params["layers"], params["embed"][toks.long()],
                     torch.arange(toks.shape[1])[None, :])
    return L.rms_norm(h, params["final_norm"]) @ params["unembed"]


@pytest.mark.parametrize("arch,leaves", [
    ("llava_next_mistral_7b", ("wq", "wk", "wv")),
    ("mamba2_130m", ("in_proj",)),
    ("hymba_1_5b", ("wq", "wk", "wv", "in_proj"))])
def test_forward_reaches_no_kernel_and_every_projection(arch, leaves,
                                                        monkeypatch):
    """The training forward runs neither ``ops.swa_attention`` (B15) nor
    ``ops.ssd_scan`` (B14), whose CUDA kernels have no backward: with both
    replaced by a function that raises, the loss of a windowed (the window
    bites) and of an SSM config still reaches every layer's attention
    projections and SSM in-projection with a non-zero gradient."""
    def refuse(*args, **kwargs):
        raise AssertionError("the training forward called a kernel entry")
    monkeypatch.setattr(ops, "swa_attention", refuse)
    monkeypatch.setattr(ops, "ssd_scan", refuse)
    _, cfg = _configs(arch)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    s = 2 * (cfg.sliding_window or 8) + 8
    _, _, grads = _grads(cfg, params, _t(_batch(cfg, np.random.default_rng(0),
                                                2, s)))
    for name in leaves:
        g = grads[f"layers/{name}"]
        for layer in range(cfg.num_layers):
            assert bool(g[layer].abs().max() > 0), (name, layer)


def test_ssm_mixer_takes_the_plain_scan_only_when_asked(monkeypatch):
    """``plain`` alone picks the differentiable scan: with parameters that
    require grad and grad mode on, ``ssm_mixer`` still calls
    ``ops.ssd_scan`` (B14, which raises for such inputs on the card)."""
    from repro_torch.models import ssm as S
    calls = []
    real = ops.ssd_scan

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    monkeypatch.setattr(ops, "ssd_scan", spy)
    _, cfg = _configs("mamba2_130m")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    lp = {k: v[0].clone().requires_grad_(True)
          for k, v in params["layers"].items()}
    x = torch.randn((1, 12, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    out_k, _ = S.ssm_mixer(cfg, lp, x)
    assert calls == [1]
    out_p, _ = S.ssm_mixer(cfg, lp, x, plain=True)
    assert calls == [1]
    torch.testing.assert_close(out_k, out_p, atol=1e-5, rtol=1e-5)


def test_decode_matches_teacher_forcing_dense():
    _, cfg = _configs("glm4_9b")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    s = 16
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, s)), dtype=torch.int32)
    lp, cache = M.prefill(cfg, params, {"tokens": toks}, cache_size=s + 4)
    full = _forward_logits(cfg, params, toks)
    torch.testing.assert_close(lp[:, 0], full[:, -1], atol=2e-4, rtol=2e-4)
    nxt = lp[:, -1].argmax(-1).to(torch.int32)
    ld, _ = M.decode_step(cfg, params, cache, nxt, s)
    full2 = _forward_logits(cfg, params, torch.cat([toks, nxt[:, None]], 1))
    torch.testing.assert_close(ld, full2[:, -1], atol=2e-4, rtol=2e-4)


def test_decode_matches_teacher_forcing_ssm():
    """Prefill and decode run the SSD scan through ``ops.ssd_scan`` (its
    token-sequential plain version here), the forward the chunked plain
    scan: 5e-3, as in ``test_models.py``."""
    _, cfg = _configs("mamba2_130m", ssm_chunk=8)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    s = 16
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, s)), dtype=torch.int32)
    lp, cache = M.prefill(cfg, params, {"tokens": toks}, cache_size=s)
    nxt = lp[:, -1].argmax(-1).to(torch.int32)
    ld, _ = M.decode_step(cfg, params, cache, nxt, s)
    full2 = _forward_logits(cfg, params, torch.cat([toks, nxt[:, None]], 1))
    torch.testing.assert_close(ld, full2[:, -1], atol=5e-3, rtol=5e-3)


def test_loop_matches_jax_scan_and_unrolled_loss():
    """``test_models.py::test_unroll_matches_scan``: the port's layer loop
    against the JAX loss through ``lax.scan`` and unrolled."""
    jcfg, cfg = _configs("stablelm_3b")
    rng = np.random.default_rng(1)
    tree = _weights(jcfg, rng)
    batch = _batch(cfg, rng)
    jp = jax.tree.map(jnp.asarray, tree)
    want = []
    for unroll in (False, True):
        JD.set_unroll(unroll)
        try:
            want.append(float(JM.loss_fn(jcfg, jp, _j(batch))[0]))
        finally:
            JD.set_unroll(False)
    with torch.no_grad():
        loss = float(M.loss_fn(cfg, M.load_jax_params(tree, "cpu"),
                               _t(batch))[0])
    for w in want:
        np.testing.assert_allclose(loss, w, rtol=1e-5)


def test_int8_kv_cache_decode_close():
    """``test_models.py::test_int8_kv_cache_decode_close`` on the port."""
    _, cfg = _configs("glm4_9b")
    cfgq = dataclasses.replace(cfg, kv_quant_int8=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 24)), dtype=torch.int32)
    lg1, c1 = M.prefill(cfg, params, {"tokens": toks}, 32)
    lg2, c2 = M.prefill(cfgq, params, {"tokens": toks}, 32)
    assert c2["k"].dtype == torch.int8
    torch.testing.assert_close(lg1, lg2, atol=1e-4, rtol=0)
    nxt = lg1[:, -1].argmax(-1).to(torch.int32)
    d1, _ = M.decode_step(cfg, params, c1, nxt, 24)
    d2, _ = M.decode_step(cfgq, params, c2, nxt, 24)
    err = float((d1 - d2).abs().max()) / float(d1.abs().max())
    assert err < 0.05, err


def test_causal_skip_prefill_matches(monkeypatch):
    """``test_models.py::test_causal_skip_prefill_matches``: with 32-query
    chunks over 128 tokens, the port's prefill (which has no block-skipping
    variant: ``prefill_causal_skip`` leaves it unchanged) equals the JAX
    prefill with and without the skip, to 2e-5."""
    import repro.models.layers as JL
    jcfg, cfg = _configs("glm4_9b")
    jcfgs = dataclasses.replace(jcfg, prefill_causal_skip=True)
    cfgs = dataclasses.replace(cfg, prefill_causal_skip=True)
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    params = M.load_jax_params(tree, "cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (1, 128)).astype(np.int32)
    monkeypatch.setattr(JL, "chunked_attention", functools.partial(
        JL.chunked_attention, q_chunk=32))
    monkeypatch.setattr(L, "chunked_attention", functools.partial(
        L.chunked_attention, q_chunk=32))
    jp = jax.tree.map(jnp.asarray, tree)
    j1, _ = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, 128)
    j2, _ = JM.prefill(jcfgs, jp, {"tokens": jnp.asarray(toks)}, 128)
    t1, _ = M.prefill(cfg, params, {"tokens": torch.from_numpy(toks)}, 128)
    t2, _ = M.prefill(cfgs, params, {"tokens": torch.from_numpy(toks)}, 128)
    assert torch.equal(t1, t2)
    for want in (j1, j2):
        np.testing.assert_allclose(t1.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=2e-5)


def test_remat_policies_same_loss_and_gradients():
    """``test_models.py::test_remat_policies_same_loss`` on the port, with
    the gradients too: no remat, "full" (``torch.utils.checkpoint`` per
    layer) and "dots" (matmul outputs kept) give the same loss and the same
    gradient on every leaf, bit for bit (the recomputation reruns the same
    CPU ops on the same inputs)."""
    _, cfg = _configs("mixtral_8x22b")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = _t(_batch(cfg, np.random.default_rng(0)))
    runs = {}
    for pol in ("off", "full", "dots"):
        c = dataclasses.replace(cfg, remat_policy="full" if pol == "off"
                                else pol)
        D.set_remat(pol != "off")
        try:
            runs[pol] = _grads(c, params, batch)
        finally:
            D.set_remat(False)
    loss, _, grads = runs["off"]
    for pol in ("full", "dots"):
        assert torch.equal(runs[pol][0], loss), pol
        for k, g in grads.items():
            assert torch.equal(runs[pol][2][k], g), (pol, k)
