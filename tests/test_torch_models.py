"""The port's paged decode/prefill steps and LM head against the JAX ones
on the same weights (``load_jax_params``), in float32 on the CPU, to
1e-4 on the logits and hidden states, and bit for bit on the pools they
write (up to the scratch block)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ModelConfig as JModelConfig
from repro.models import model as JM
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M

TINY = dict(name="tiny-f32", arch_type="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
            dtype="float32")
TOL = dict(atol=1e-4, rtol=1e-4)
NB, BS = 12, 16                     # pool blocks (+1 scratch), block size


def _setup(qkv_bias):
    kw = dict(TINY, qkv_bias=qkv_bias)
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    rng = np.random.default_rng(0)
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                   jax.random.PRNGKey(1)))
    # the JAX init zeroes biases and norm gains: randomise them so the
    # comparison exercises them
    for name in ("bq", "bk", "bv", "attn_norm", "mlp_norm"):
        if name in tree["layers"]:
            a = tree["layers"][name]
            tree["layers"][name] = (0.1 * rng.standard_normal(a.shape)
                                    ).astype(np.float32)
    tree["final_norm"] = (0.1 * rng.standard_normal(tree["final_norm"].shape)
                          ).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = M.load_jax_params(tree, "cpu")
    shape = (cfg.num_layers, NB + 1, BS, cfg.num_kv_heads, cfg.head_dim)
    pools = [rng.standard_normal(shape).astype(np.float32) for _ in "kv"]
    return jcfg, cfg, jparams, params, pools, rng


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _i32(*arrays):
    return ([jnp.asarray(a, jnp.int32) for a in arrays],
            [torch.from_numpy(np.asarray(a, np.int32)) for a in arrays])


@pytest.mark.parametrize("qkv_bias", [False, True], ids=["tiny", "qkv-bias"])
def test_paged_decode_step_matches_jax(qkv_bias):
    jcfg, cfg, jparams, params, pools, _ = _setup(qkv_bias)
    tables = np.array([[3, 4, 0, 0], [7, 8, 9, 1], [0, 0, 0, 0],
                       [0, 0, 0, 0]])
    positions = np.array([20, 50, 0, 0])
    attn_lens = np.array([21, 51, 0, 0])          # two padded rows
    scratch = NB * BS
    slots = np.array([4 * BS + 4, 1 * BS + 2, scratch, scratch])
    toks = np.array([5, 77, 0, 0])
    jargs, targs = _i32(toks, tables, positions, attn_lens, slots)
    jl, jk, jv = JM.paged_decode_step(jcfg, jparams, jnp.asarray(pools[0]),
                                      jnp.asarray(pools[1]), *jargs)
    tk, tv = (torch.from_numpy(p.copy()) for p in pools)
    tl = M.paged_decode_step(cfg, params, tk, tv, *targs)
    np.testing.assert_allclose(_np(tl)[:2], _np(jl)[:2], **TOL)
    np.testing.assert_allclose(_np(tk)[:, :NB], _np(jk)[:, :NB], **TOL)
    np.testing.assert_allclose(_np(tv)[:, :NB], _np(jv)[:, :NB], **TOL)


@pytest.mark.parametrize("qkv_bias", [False, True], ids=["tiny", "qkv-bias"])
def test_paged_prefill_step_and_head_match_jax(qkv_bias):
    jcfg, cfg, jparams, params, pools, rng = _setup(qkv_bias)
    c = 8
    tables = np.array([[2, 5, 6, 0], [9, 10, 11, 3]])
    # row 0: cached prefix of 13 tokens, suffix of 8 starts mid-block and
    # spills into block 5; row 1: 5 tokens from position 0
    qpos = np.full((2, c), -1)
    qpos[0] = 13 + np.arange(c)
    qpos[1, :5] = np.arange(5)
    wpages = np.full((2, (c - 1) // BS + 2), NB)
    wpages[0] = [2, 5]
    wpages[1, 0] = 9
    wstart, wcount = np.array([13, 0]), np.array([c, 5])
    toks = rng.integers(0, cfg.vocab_size, (2, c))
    jargs, targs = _i32(toks, tables, qpos, wpages, wstart, wcount)
    jh, jk, jv = JM.paged_prefill_step(jcfg, jparams, jnp.asarray(pools[0]),
                                       jnp.asarray(pools[1]), *jargs)
    tk, tv = (torch.from_numpy(p.copy()) for p in pools)
    th = M.paged_prefill_step(cfg, params, tk, tv, *targs)
    valid = qpos >= 0
    np.testing.assert_allclose(_np(th)[valid], _np(jh)[valid], **TOL)
    np.testing.assert_allclose(_np(tk)[:, :NB], _np(jk)[:, :NB], **TOL)
    np.testing.assert_allclose(_np(tv)[:, :NB], _np(jv)[:, :NB], **TOL)

    rows = np.stack([_np(jh)[0, c - 1], _np(jh)[1, 4]])
    jlog = JM.head_logits(jcfg, jparams, jnp.asarray(rows))
    tlog = M.head_logits(cfg, params, torch.from_numpy(rows))
    np.testing.assert_allclose(_np(tlog), _np(jlog), **TOL)


def test_init_params_shapes_and_scales_match_jax():
    """Random init draws every leaf of the JAX pytree, with its shape,
    dtype and scale (weights differ: the two generators differ)."""
    cfg = ModelConfig(**dict(TINY, qkv_bias=True, num_layers=3))
    jcfg = JModelConfig(**dataclasses.asdict(cfg))
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    flat_j = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    flat_t = {}
    for k, v in params.items():
        for k2, v2 in (v.items() if isinstance(v, dict) else [(None, v)]):
            flat_t[(k, k2) if k2 else (k,)] = v2
    assert len(flat_j) == len(flat_t)
    for path, a in flat_j.items():
        key = tuple(p.key for p in path)
        t = flat_t[key]
        assert tuple(t.shape) == a.shape and t.dtype == torch.float32, key
        if a.std() > 0:
            np.testing.assert_allclose(t.std().item(), a.std(), rtol=0.2,
                                       err_msg=str(key))
        else:
            assert not t.any(), key
