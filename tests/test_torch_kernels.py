"""The port's kernel wrappers on the CPU (their plain PyTorch versions)
against the Pallas kernels in interpret mode, on the same numpy inputs.

Tolerances are those of ``test_kernels.py``: 3e-5 in float32, 2e-2 in
bfloat16 for the attention kernels; the write and copy kernels are exact.
Write kernels are compared on every block but the scratch block, where
padded rows may land in any order.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops
from repro_torch.kernels import ops

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bf16" \
        else dict(atol=3e-5, rtol=3e-5)


def pair(x, dt):
    """The same values as a JAX and a torch array of dtype pair ``dt``."""
    jd, td = DTYPES[dt]
    x = np.asarray(x)
    if x.dtype.kind in "iu":
        return jnp.asarray(x, jnp.int32), torch.from_numpy(
            x.astype(np.int32))
    return jnp.asarray(x, jd), torch.from_numpy(
        x.astype(np.float32)).to(td)


def ints(x):
    return pair(np.asarray(x, np.int32), "f32")


def npf(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,h,hkv,d,bs,p", [
    (3, 8, 2, 64, 16, 5),     # GQA 4:1
    (2, 10, 2, 32, 16, 4),    # G = 5, as Qwen2.5-14B
    (2, 4, 4, 16, 8, 3),      # MHA
])
def test_paged_attention(dt, b, h, hkv, d, bs, p):
    rng = np.random.default_rng(0)
    n = p * b + 2
    q, tq = pair(rng.standard_normal((b, h, d)), dt)
    kp, tkp = pair(rng.standard_normal((n, bs, hkv, d)), dt)
    vp, tvp = pair(rng.standard_normal((n, bs, hkv, d)), dt)
    bt, tbt = ints(rng.integers(0, n, (b, p)))
    lens = rng.integers(1, p * bs + 1, b)
    lens[-1] = 0                          # padded decode row -> zeros
    cl, tcl = ints(lens)
    want = jops.paged_attention(q, kp, vp, bt, cl)
    got = ops.paged_attention(tq, tkp, tvp, tbt, tcl)
    np.testing.assert_allclose(npf(got), npf(want), **tol(dt))
    assert not npf(got)[-1].any()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,c,h,hkv,d,bs,p", [
    (3, 8, 8, 2, 64, 16, 5),
    (2, 12, 10, 2, 32, 8, 6),    # G = 5, chunk not a multiple of the tile
    (2, 5, 4, 4, 16, 8, 4),
])
def test_paged_prefill_attention(dt, b, c, h, hkv, d, bs, p):
    rng = np.random.default_rng(1)
    n = p * b + 2
    q, tq = pair(rng.standard_normal((b, c, h, d)), dt)
    kp, tkp = pair(rng.standard_normal((n, bs, hkv, d)), dt)
    vp, tvp = pair(rng.standard_normal((n, bs, hkv, d)), dt)
    bt, tbt = ints(rng.integers(0, n, (b, p)))
    qpos = np.full((b, c), -1, np.int32)
    for i in range(b - 1):                # last row fully padded
        start = int(rng.integers(0, p * bs - c))
        valid = int(rng.integers(1, c + 1))
        qpos[i, :valid] = start + np.arange(valid)
    qp, tqp = ints(qpos)
    want = jops.paged_prefill_attention(q, kp, vp, bt, qp)
    got = ops.paged_prefill_attention(tq, tkp, tvp, tbt, tqp)
    np.testing.assert_allclose(npf(got), npf(want), **tol(dt))
    assert not npf(got)[qpos < 0].any()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_kv_token_write(dt):
    rng = np.random.default_rng(2)
    n, bs, hkv, d, b = 9, 8, 2, 16, 6
    scratch = (n - 1) * bs
    kp, tkp = pair(rng.standard_normal((n, bs, hkv, d)), dt)
    vp, tvp = pair(rng.standard_normal((n, bs, hkv, d)), dt)
    kn, tkn = pair(rng.standard_normal((b, hkv, d)), dt)
    vn, tvn = pair(rng.standard_normal((b, hkv, d)), dt)
    live = rng.choice(scratch, b - 2, replace=False)
    sl, tsl = ints(np.concatenate([live, [scratch, scratch]]))
    wk, wv = jops.kv_token_write(kp, vp, kn, vn, sl)
    gk, gv = ops.kv_token_write(tkp, tvp, tkn, tvn, tsl)
    assert gk is tkp and gv is tvp        # in place
    np.testing.assert_array_equal(npf(gk)[:-1], npf(wk)[:-1])
    np.testing.assert_array_equal(npf(gv)[:-1], npf(wv)[:-1])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_kv_token_write_layer_folded(dt):
    """PagedKVCache.write_tokens folds the layer axis into the page axis
    (layer l's block b is folded block l*(N+1)+b) so one launch writes
    every (layer, sequence) pair."""
    rng = np.random.default_rng(3)
    nl, nb, bs, hkv, d, b = 3, 5, 4, 2, 8, 3
    slots = np.array([1 * bs + 2, 3 * bs, (nb - 1) * bs], np.int32)
    folded = (np.arange(nl)[:, None] * nb * bs + slots[None]).reshape(-1)
    pools = rng.standard_normal((nl * nb, bs, hkv, d))
    kp, tkp = pair(pools, dt)
    vp, tvp = pair(pools + 1, dt)
    kn, tkn = pair(rng.standard_normal((nl * b, hkv, d)), dt)
    vn, tvn = pair(rng.standard_normal((nl * b, hkv, d)), dt)
    fs, tfs = ints(folded)
    wk, wv = jops.kv_token_write(kp, vp, kn, vn, fs)
    ops.kv_token_write(tkp, tvp, tkn, tvn, tfs)
    np.testing.assert_array_equal(npf(tkp), npf(wk))
    np.testing.assert_array_equal(npf(tvp), npf(wv))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_kv_chunk_write(dt):
    """Row 0 starts mid-page and spills over two page boundaries, row 1
    starts page-aligned with a short count, row 2 is padding."""
    rng = np.random.default_rng(4)
    n, bs, hkv, d, c = 12, 4, 2, 8, 10
    scratch = n - 1
    pp = (c - 1) // bs + 2
    kp, tkp = pair(rng.standard_normal((n, bs, hkv, d)), dt)
    vp, tvp = pair(rng.standard_normal((n, bs, hkv, d)), dt)
    kn, tkn = pair(rng.standard_normal((3, c, hkv, d)), dt)
    vn, tvn = pair(rng.standard_normal((3, c, hkv, d)), dt)
    wpages = np.full((3, pp), scratch, np.int32)
    wpages[0, :3] = [7, 2, 5]
    wpages[1, :1] = [9]
    wp, twp = ints(wpages)
    ws, tws = ints([3, 0, 0])
    wc, twc = ints([c, 3, 0])
    wk, wv = jops.kv_chunk_write(kp, vp, kn, vn, wp, ws, wc)
    gk, gv = ops.kv_chunk_write(tkp, tvp, tkn, tvn, twp, tws, twc)
    np.testing.assert_array_equal(npf(gk)[:-1], npf(wk)[:-1])
    np.testing.assert_array_equal(npf(gv)[:-1], npf(wv)[:-1])
    # the spill really crossed pages: page 2 holds chunk tokens 1..4
    np.testing.assert_array_equal(npf(gk)[2], npf(tkn)[0, 1:5])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_block_gather_scatter_layers(dt):
    rng = np.random.default_rng(5)
    nl, n, bs, hkv, d = 3, 10, 4, 2, 8
    pools, tpools = pair(rng.standard_normal((nl, n, bs, hkv, d)), dt)
    idx, tidx = ints([7, 1, 4])
    want = jops.block_gather_layers(pools, idx)
    got = ops.block_gather_layers(tpools, tidx)
    np.testing.assert_array_equal(npf(got), npf(want))

    st, tst = pair(rng.standard_normal((nl, 3, bs, hkv, d)), dt)
    dst, tdst = ints([0, 9, 5])
    want = jops.block_scatter_layers(pools, dst, st)
    got = ops.block_scatter_layers(tpools, tdst, tst)
    assert got is tpools                  # in place
    np.testing.assert_array_equal(npf(got), npf(want))


def test_cpu_calls_are_not_counted_as_launches():
    ops.reset_launches()
    x = torch.zeros((2, 3, 4, 1, 2))
    ops.block_gather_layers(x, torch.tensor([0, 2], dtype=torch.int32))
    assert set(ops.launches) == set(ops.KERNELS)
    assert not any(ops.launches.values())


def test_mixed_devices_raise():
    x = torch.zeros((2, 3, 4, 1, 2))
    idx = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.block_gather_layers(x, idx)
