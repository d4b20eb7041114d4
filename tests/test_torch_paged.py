"""The port's PagedKVCache against the JAX one, bit for bit, on the CPU:
offload -> upload round trips into new blocks, COW ``copy_blocks``, the
layer-folded ``write_tokens``, ``write_prefill`` and ``write_window``, and
the one-request ``write_token`` and ``gather_seq``; ``decode_attention``
against the JAX cache's Pallas kernel at ``test_kernels.py``'s float32
tolerance (3e-5), a row of length 0 giving zeros in both.

With the int8 host tier the port's host payload and scales equal the JAX
oracle ``quantize_block_ref`` bit for bit; against the JAX cache, whose
jitted Pallas gather computes the scale as ``amax * (1/127)``, a payload
element may be one step off and a scale one ulp (``rtol=1e-6``)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ModelConfig as JModelConfig
from repro.kernels import ref as JR
from repro.kvcache.paged import PagedKVCache as JCache
from repro_torch.configs.base import ModelConfig
from repro_torch.kvcache.paged import PagedKVCache

TINY = dict(name="tiny-f32", arch_type="dense", num_layers=3, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
            dtype="float32")
NB, BS, HOST = 10, 4, 6


def _pair(host_blocks=HOST, precision="fp16"):
    rng = np.random.default_rng(0)
    j = JCache(JModelConfig(**TINY), NB, BS, host_blocks=host_blocks,
               dtype=jnp.float32, host_precision=precision)
    t = PagedKVCache(ModelConfig(**TINY), NB, BS, host_blocks=host_blocks,
                     dtype=torch.float32, host_precision=precision,
                     device="cpu")
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


def test_int8_offload_upload_roundtrip_matches_jax():
    j, t, _ = _pair(precision="int8_host")
    orig = [p[:, [1, 3, 5]].clone() for p in (t.k, t.v)]
    for c in (j, t):
        c.offload([1, 3, 5], [0, 1, 2])
    hosts = ((j.host_k, t.host_k), (j.host_v, t.host_v))
    scales = ((j.host_scales_k, t.host_scales_k),
              (j.host_scales_v, t.host_scales_v))
    for (jq, tq), (js, ts), o in zip(hosts, scales, orig):
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        assert tq.shape == jq.shape and ts.shape == js.shape
        want_q, want_s = JR.quantize_block_ref(jnp.asarray(o.numpy()))
        np.testing.assert_array_equal(tq.numpy()[:, :3], np.asarray(want_q))
        np.testing.assert_array_equal(ts.numpy()[:, :3], np.asarray(want_s))
        np.testing.assert_allclose(ts.numpy(), js, rtol=1e-6, atol=0)
        assert np.abs(tq.numpy().astype(np.int16)
                      - jq.astype(np.int16)).max() <= 1
        jq[...], js[...] = tq.numpy(), ts.numpy()   # upload the same bytes
    for p in (t.k, t.v):
        p[:, [1, 3, 5]] = 0
    j.k = j.k.at[:, jnp.asarray([1, 3, 5])].set(0)
    j.v = j.v.at[:, jnp.asarray([1, 3, 5])].set(0)
    for c in (j, t):
        c.upload([0, 1, 2], [6, 7, 0])
    _same(j, t)
    for p, ts, o in zip((t.k, t.v), (t.host_scales_k, t.host_scales_v),
                        orig):
        bound = ts[:, :3, None, :, None] / 2 + 1e-6
        assert torch.all((p[:, [6, 7, 0]] - o).abs() <= bound)


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


@pytest.mark.parametrize("pos", [0, 5, 2 * BS + 3, 3 * BS])
def test_write_token_matches_jax_bit_for_bit(pos):
    """One token's K/V of every layer at position ``pos`` of a request;
    3 * BS lies past its three blocks, so both write the scratch slot."""
    j, t, rng = _pair()
    blocks = [7, 2, 5]
    kt = rng.standard_normal((3, 2, 16)).astype(np.float32)
    vt = rng.standard_normal((3, 2, 16)).astype(np.float32)
    j.write_token(blocks, pos, jnp.asarray(kt), jnp.asarray(vt))
    t.write_token(blocks, pos, torch.from_numpy(kt), torch.from_numpy(vt))
    _same(j, t)


@pytest.mark.parametrize("length", [1, 7, 12])
def test_gather_seq_matches_jax(length):
    j, t, _ = _pair()
    blocks = [6, 0, 9]
    for want, got in zip(j.gather_seq(blocks, length),
                         t.gather_seq(blocks, length)):
        assert got.shape == (3, length, 2, 16)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_decode_attention_matches_jax_with_a_zero_length_row():
    """Every layer against the JAX cache's Pallas kernel (interpret mode)
    at ``test_kernels.py``'s float32 tolerance; a row with
    ``context_lens`` 0 comes out as zeros in both."""
    j, t, rng = _pair()
    q = rng.standard_normal((3, 4, 16)).astype(np.float32)
    tables = np.array([[3, 7, 1], [0, 9, 2], [5, 5, 5]], np.int32)
    lens = np.array([9, 12, 0], np.int32)
    for layer in range(3):
        want = np.asarray(j.decode_attention(
            layer, jnp.asarray(q), jnp.asarray(tables), jnp.asarray(lens)))
        got = t.decode_attention(layer, torch.from_numpy(q),
                                 torch.from_numpy(tables),
                                 torch.from_numpy(lens)).numpy()
        np.testing.assert_allclose(got, want, atol=3e-5, rtol=3e-5)
        assert not got[2].any() and not want[2].any()


def test_disabled_host_tier_and_int8_host_fail_loudly():
    """A disabled host tier fails loudly; an int8 host tier allocates its
    int8 payload and float32 scales, and an fp16 one has no scales."""
    _, t, _ = _pair(host_blocks=0)
    assert t.host_scales_k is None and t.host_scales_v is None
    with pytest.raises(RuntimeError, match="host_blocks=0"):
        t.offload([1], [0])
    with pytest.raises(RuntimeError, match="host_blocks=0"):
        t.upload([0], [1])
    c = PagedKVCache(ModelConfig(**TINY), NB, BS, host_blocks=2,
                     host_precision="int8_host", device="cpu")
    for h in (c.host_k, c.host_v):
        assert h.dtype == torch.int8 and h.shape == (3, 2, BS, 2, 16)
    for s in (c.host_scales_k, c.host_scales_v):
        assert s.dtype == torch.float32 and s.shape == (3, 2, 2)
    assert c.k.dtype == torch.bfloat16
    assert _pair()[1].host_scales_k is None
