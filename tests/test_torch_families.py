"""The port's dense-cache ``prefill`` / ``decode_step`` of the SSM
(Mamba2), hybrid (Hymba), dense (with and without a sliding window,
float or int8 KV) and MoE (Mixtral with its window, Kimi-K2 without)
stacks against ``repro.models.model`` on the same weights
(``load_jax_params``), in float32 on the CPU.

On the CPU the port's SSD scan is the token-sequential recurrence and
the JAX model's the chunked scan, so the sums run in different orders:
logits of the SSM and hybrid stacks are held to 1e-3, their SSM states to
1e-3; dense logits and every K/V cache to 1e-4; conv caches to 1e-4. The
int8 KV payloads may differ by one step where a value sits on a rounding
boundary, and their scales by float32 rounding (rtol 1e-5).
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
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.models import ssm as S

# name -> (arch, config changes, prompt length, logits tolerance)
CASES = {
    # chunk 8 over 20 tokens: the scan pads the last chunk
    "mamba2": ("mamba2_130m", dict(ssm_chunk=8), 20, 1e-3),
    # window 64 < 150 tokens, and 150 is padded to 256 for the SWA kernel
    "hymba": ("hymba_1_5b", {}, 150, 1e-3),
    "hymba-int8": ("hymba_1_5b", dict(kv_quant_int8=True), 150, 1e-3),
    "dense-window": ("glm4_9b", dict(sliding_window=10), 40, 1e-4),
    "dense": ("glm4_9b", {}, 24, 1e-4),
    "dense-int8": ("glm4_9b", dict(kv_quant_int8=True), 24, 1e-4),
    # MoE with a 64-token window < 150 tokens, through the SWA kernel
    "mixtral": ("mixtral_8x22b", {}, 150, 1e-4),
    "kimi": ("kimi_k2_1t_a32b", {}, 24, 1e-4),
}
# leaves the JAX init makes constant (zeros, ones): randomised so that the
# comparison exercises them
CONSTANT = ("attn_norm", "mlp_norm", "norm", "ssm_norm", "conv_b",
            "attn_out_norm", "ssm_out_norm", "final_norm")
GAINS = ("fuse_attn", "fuse_ssm", "D")
# leaves that stay float32 in a bf16 model
F32_LEAVES = ("A_log", "D", "dt_bias", "wr")


def _configs(arch, dtype="float32", **changes):
    jcfg = dataclasses.replace(jget_smoke(arch), dtype=dtype, **changes)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _np_tree(jcfg, seed=1):
    return jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                   jax.random.PRNGKey(seed)))


def _randomise(tree, rng):
    for group in (tree, tree["layers"]):
        for name in CONSTANT + GAINS:
            if name in group:
                a = (0.1 * rng.standard_normal(group[name].shape)).astype(
                    np.float32)
                group[name] = a + 1.0 if name in GAINS else a
    return tree


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


def _check_cache(cfg, tc, jc, what):
    assert set(tc) == set(jc), (sorted(tc), sorted(jc))
    for k, want in jc.items():
        got = tc[k]
        assert tuple(got.shape) == want.shape, (what, k)
        if got.dtype == torch.int8:
            diff = np.abs(got.numpy().astype(int) - np.asarray(want, int))
            assert diff.max() <= 1, (what, k)
        elif k.endswith("_scale"):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, err_msg=f"{what} {k}")
        else:
            _close(got, want, 1e-3 if k == "state" else 1e-4, f"{what} {k}")


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_jax(case):
    arch, changes, s, ltol = CASES[case]
    jcfg, cfg = _configs(arch, **changes)
    rng = np.random.default_rng(0)
    tree = _randomise(_np_tree(jcfg), rng)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = M.load_jax_params(tree, "cpu")
    b, size, steps = 2, s + 4, 3
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)

    jl, jc = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)}, size)
    tl, tc = M.prefill(cfg, params, {"tokens": torch.from_numpy(toks)}, size)
    assert tuple(tl.shape) == (b, 1, cfg.vocab_size)
    _close(tl, jl, ltol, f"{case} prefill logits")
    _check_cache(cfg, tc, jc, f"{case} prefill")
    specs = M.cache_specs(cfg, b, size)
    assert {k: (tuple(t.shape), t.dtype) for k, t in tc.items()} == specs

    nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    for step in range(steps):
        jl, jc = JM.decode_step(jcfg, jparams, jc, jnp.asarray(nxt),
                                jnp.int32(s + step))
        tl, tc2 = M.decode_step(cfg, params, tc, torch.from_numpy(nxt),
                                s + step)
        assert tc2 is tc                  # the cache is updated in place
        _close(tl, jl, ltol, f"{case} decode {step} logits")
        _check_cache(cfg, tc, jc, f"{case} decode {step}")
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


def test_sliding_window_masks_old_tokens():
    """Text-only counterpart of ``test_models.py``'s window property: with
    window 8 and two layers, the last position sees back 16 tokens, so a
    token changed at position 2 of 32 leaves its logits as they were, and
    a token changed at position 30 does not."""
    _, cfg = _configs("glm4_9b", sliding_window=8)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 32)), dtype=torch.int32)

    def last_logits(t):
        return M.prefill(cfg, params, {"tokens": t}, 72)[0]

    base = last_logits(toks)
    for pos, same in ((2, True), (30, False)):
        mod = toks.clone()
        mod[0, pos] = (mod[0, pos] + 1) % cfg.vocab_size
        got = last_logits(mod)
        assert torch.allclose(got, base, atol=1e-5) == same, pos


@pytest.mark.parametrize("arch", ["mamba2_130m", "hymba_1_5b",
                                  "kimi_k2_1t_a32b", "mixtral_8x22b"])
def test_init_and_load_params_match_jax_tree(arch):
    """bf16 SSM, hybrid and MoE trees: ``init_params`` draws every leaf of
    the JAX pytree with its shape, dtype (``A_log``, ``D``, ``dt_bias`` and
    the MoE router ``wr`` float32 among bf16) and scale, equal where the
    JAX init is deterministic; ``load_jax_params`` keeps dtypes and values
    bit for bit."""
    jcfg, cfg = _configs(arch, dtype="bfloat16")
    tree = _np_tree(jcfg, seed=0)
    flat_j = {tuple(p.key for p in path): a for path, a in
              jax.tree_util.tree_flatten_with_path(tree)[0]}

    def flat(params):
        out = {}
        for k, v in params.items():
            for k2, v2 in (v.items() if isinstance(v, dict) else [(None, v)]):
                out[(k, k2) if k2 else (k,)] = v2
        return out

    drawn = flat(M.init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    loaded = flat(M.load_jax_params(tree, "cpu"))
    assert set(drawn) == set(flat_j) == set(loaded)
    for key, a in flat_j.items():
        want = torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32
        assert want == (torch.float32 if key[-1] in F32_LEAVES
                        else torch.bfloat16), key
        for t in (drawn[key], loaded[key]):
            assert tuple(t.shape) == a.shape and t.dtype == want, key
        af = a.astype(np.float32)
        np.testing.assert_array_equal(loaded[key].float().numpy(), af)
        if key[-1] in ("A_log", "D", "dt_bias") or af.std() == 0:
            np.testing.assert_allclose(drawn[key].float().numpy(), af,
                                       rtol=1e-6, err_msg=str(key))
        else:
            np.testing.assert_allclose(drawn[key].float().std().item(),
                                       af.std(), rtol=0.2, err_msg=str(key))


def test_cache_specs_match_jax():
    for arch, changes in (("mamba2_130m", {}), ("hymba_1_5b", {}),
                          ("hymba_1_5b", dict(kv_quant_int8=True)),
                          ("mixtral_8x22b", {}), ("kimi_k2_1t_a32b", {})):
        jcfg, cfg = _configs(arch, dtype="bfloat16", **changes)
        jspecs = JM.cache_specs(jcfg, 3, 40)
        specs = M.cache_specs(cfg, 3, 40)
        assert set(specs) == set(jspecs)
        for k, (shape, dtype) in specs.items():
            assert shape == jspecs[k].shape, k
            assert str(dtype).split(".")[-1] == jspecs[k].dtype.name, k


def test_cpu_prefill_launches_no_kernel_and_other_archs_raise():
    _, cfg = _configs("mamba2_130m")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros((1, 8), dtype=torch.int32)
    ops.reset_launches()
    M.prefill(cfg, params, {"tokens": toks})
    assert ops.launches["ssd_scan"] == 0      # CPU calls are not launches
    with pytest.raises(NotImplementedError, match="zero state"):
        S.ssm_mixer(cfg, {}, torch.zeros((1, 4, cfg.d_model)),
                    state=torch.zeros(1))
