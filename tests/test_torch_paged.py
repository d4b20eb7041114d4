"""The port's PagedKVCache against the JAX one, bit for bit, on the CPU:
offload -> upload round trips into new blocks, COW ``copy_blocks``, the
layer-folded ``write_tokens``, ``write_prefill`` and ``write_window``."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ModelConfig as JModelConfig
from repro.kvcache.paged import PagedKVCache as JCache
from repro_torch.configs.base import ModelConfig
from repro_torch.kvcache.paged import PagedKVCache

TINY = dict(name="tiny-f32", arch_type="dense", num_layers=3, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
            dtype="float32")
NB, BS, HOST = 10, 4, 6


def _pair(host_blocks=HOST):
    rng = np.random.default_rng(0)
    j = JCache(JModelConfig(**TINY), NB, BS, host_blocks=host_blocks,
               dtype=jnp.float32)
    t = PagedKVCache(ModelConfig(**TINY), NB, BS, host_blocks=host_blocks,
                     dtype=torch.float32, device="cpu")
    k = rng.standard_normal(t.k.shape).astype(np.float32)
    v = rng.standard_normal(t.v.shape).astype(np.float32)
    j.k, j.v = jnp.asarray(k), jnp.asarray(v)
    t.k.copy_(torch.from_numpy(k))
    t.v.copy_(torch.from_numpy(v))
    return j, t, rng


def _same(j, t, upto=None):
    for a, b in ((j.k, t.k), (j.v, t.v)):
        np.testing.assert_array_equal(np.asarray(a)[:, :upto],
                                      b.numpy()[:, :upto])


def test_offload_upload_roundtrip_matches_jax_bit_for_bit():
    j, t, _ = _pair()
    for c in (j, t):
        c.offload([3, 7, 1], [4, 0, 2])
    np.testing.assert_array_equal(j.host_k, t.host_k.numpy())
    np.testing.assert_array_equal(j.host_v, t.host_v.numpy())
    snap = t.k[:, [3, 7, 1]].clone()
    t.k[:, [3, 7, 1]] = 0
    j.k = j.k.at[:, jnp.asarray([3, 7, 1])].set(0)
    for c in (j, t):
        c.upload([4, 0, 2], [8, 9, 3])
    _same(j, t)
    assert torch.equal(t.k[:, [8, 9, 3]], snap)


def test_copy_blocks_matches_jax():
    j, t, _ = _pair()
    for c in (j, t):
        c.copy_blocks([2, 5], [6, 0])
    _same(j, t)


def test_write_tokens_and_prefill_match_jax():
    j, t, rng = _pair()
    slots = np.array([2 * BS + 1, 5 * BS + 3, t.scratch_slot], np.int32)
    kt = rng.standard_normal((3, 3, 2, 16)).astype(np.float32)
    vt = rng.standard_normal((3, 3, 2, 16)).astype(np.float32)
    j.write_tokens(jnp.asarray(slots), jnp.asarray(kt), jnp.asarray(vt))
    t.write_tokens(slots, torch.from_numpy(kt), torch.from_numpy(vt))
    _same(j, t, upto=NB)
    ks = rng.standard_normal((3, 6, 2, 16)).astype(np.float32)
    vs = rng.standard_normal((3, 6, 2, 16)).astype(np.float32)
    j.write_prefill([4, 1], jnp.asarray(ks), jnp.asarray(vs))
    t.write_prefill([4, 1], torch.from_numpy(ks), torch.from_numpy(vs))
    _same(j, t)


@pytest.mark.parametrize("start,count", [(0, 4), (3, 6), (5, 1), (7, 9)])
def test_write_window_matches_jax(start, count):
    j, t, _ = _pair()
    blocks = [9, 2, 6, 4, 8]
    jp, js = j.write_window(blocks, start, count, 4)
    tp, ts = t.write_window(blocks, start, count, 4)
    np.testing.assert_array_equal(jp, tp)
    assert js == ts


def test_disabled_host_tier_and_int8_host_fail_loudly():
    _, t, _ = _pair(host_blocks=0)
    with pytest.raises(RuntimeError, match="host_blocks=0"):
        t.offload([1], [0])
    with pytest.raises(RuntimeError, match="host_blocks=0"):
        t.upload([0], [1])
    with pytest.raises(NotImplementedError, match="later slice"):
        PagedKVCache(ModelConfig(**TINY), NB, BS, host_blocks=2,
                     host_precision="int8_host", device="cpu")
