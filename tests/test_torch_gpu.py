"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: without a CUDA device every test skips. On a machine with
one, run ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``
(the first call builds the kernels with nvcc into build/kernels/).
Tolerances: exact for the write and copy kernels; for the attention
kernels 3e-5 in float32 and, in bfloat16, atol 2e-3 with rtol 8e-3: kernel
and plain version both accumulate in float32 and round once, so they may
differ by one bfloat16 step of the output (2**-7 of its size at most).
Two cases run at Qwen2.5-14B's serve-pool size, where byte offsets pass
2**31 and only 64-bit offset arithmetic gives the right blocks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops
from repro_torch.kernels import ref as R

pytestmark = pytest.mark.gpu

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def tol(dt):
    return dict(atol=2e-3, rtol=8e-3) if dt == "bf16" \
        else dict(atol=3e-5, rtol=3e-5)


def _rand(gen, shape, dt, dev):
    return torch.randn(shape, generator=gen, device=dev).to(DTYPES[dt])


def _ints(x, dev):
    return torch.as_tensor(np.asarray(x, np.int32)).to(dev)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,h,hkv,d,bs,p", [
    (8, 40, 8, 128, 16, 64),     # Qwen2.5-14B decode
    (3, 8, 2, 64, 16, 5),
    (2, 4, 4, 16, 8, 3),
])
def test_paged_attention(dev, dt, b, h, hkv, d, bs, p):
    gen = torch.Generator(device=dev).manual_seed(0)
    n = p * b + 2
    q = _rand(gen, (b, h, d), dt, dev)
    kp, vp = (_rand(gen, (n, bs, hkv, d), dt, dev) for _ in "kv")
    bt = torch.randint(0, n, (b, p), generator=gen, device=dev,
                       dtype=torch.int32)
    lens = np.random.default_rng(0).integers(1, p * bs + 1, b)
    lens[-1] = 0
    cl = _ints(lens, dev)
    got = ops.paged_attention(q, kp, vp, bt, cl)
    want = R.paged_attention_ref(q, kp, vp, bt, cl)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **tol(dt))
    assert not got[-1].any()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,c,h,hkv,d,bs,p", [
    (8, 32, 40, 8, 128, 16, 64),  # Qwen2.5-14B prefill chunk
    (2, 12, 10, 2, 32, 8, 6),
])
def test_paged_prefill_attention(dev, dt, b, c, h, hkv, d, bs, p):
    gen = torch.Generator(device=dev).manual_seed(1)
    n = p * b + 2
    q = _rand(gen, (b, c, h, d), dt, dev)
    kp, vp = (_rand(gen, (n, bs, hkv, d), dt, dev) for _ in "kv")
    bt = torch.randint(0, n, (b, p), generator=gen, device=dev,
                       dtype=torch.int32)
    rng = np.random.default_rng(1)
    qpos = np.full((b, c), -1)
    for i in range(b - 1):
        start = int(rng.integers(0, p * bs - c))
        valid = int(rng.integers(1, c + 1))
        qpos[i, :valid] = start + np.arange(valid)
    qp = _ints(qpos, dev)
    got = ops.paged_prefill_attention(q, kp, vp, bt, qp)
    want = R.paged_prefill_attention_ref(q, kp, vp, bt, qp)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **tol(dt))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_kv_writes(dev, dt):
    gen = torch.Generator(device=dev).manual_seed(2)
    n, bs, hkv, d, b, c = 40, 16, 8, 128, 8, 32
    pools = [_rand(gen, (n, bs, hkv, d), dt, dev) for _ in range(2)]
    kn, vn = (_rand(gen, (b, hkv, d), dt, dev) for _ in "kv")
    scratch = (n - 1) * bs
    slots = np.random.default_rng(2).choice(scratch, b, replace=False)
    slots[-2:] = scratch
    sl = _ints(slots, dev)
    want = [p.clone() for p in pools]
    R.kv_token_write_ref(*want, kn, vn, sl)
    ops.kv_token_write(*pools, kn, vn, sl)
    torch.cuda.synchronize()
    for g, w in zip(pools, want):
        assert torch.equal(g[:-1], w[:-1])

    kc, vc = (_rand(gen, (b, c, hkv, d), dt, dev) for _ in "kv")
    pp = (c - 1) // bs + 2
    wpages = np.full((b, pp), n - 1)
    for i in range(b - 1):
        wpages[i, :pp] = [3 * i, 3 * i + 1, 3 * i + 2]
    wstart = _ints([i % bs for i in range(b)], dev)
    wcount = _ints([c - i for i in range(b - 1)] + [0], dev)
    wp = _ints(wpages, dev)
    want = [p.clone() for p in pools]
    R.kv_chunk_write_ref(*want, kc, vc, wp, wstart, wcount)
    ops.kv_chunk_write(*pools, kc, vc, wp, wstart, wcount)
    torch.cuda.synchronize()
    for g, w in zip(pools, want):
        assert torch.equal(g, w)


def test_kv_token_write_folded_serve_pool(dev):
    """The layer-folded decode write of ``PagedKVCache.write_tokens`` on
    Qwen2.5-14B's serve pools, 48 layers x 2049 blocks folded into N: the
    slots on the last layers sit past 2**31 bytes."""
    gen = torch.Generator(device=dev).manual_seed(4)
    n, bs, hkv, d = 48 * 2049, 16, 8, 128
    pools = [torch.zeros((n, bs, hkv, d), dtype=torch.bfloat16, device=dev)
             for _ in "kv"]
    kn, vn = (_rand(gen, (4, hkv, d), "bf16", dev) for _ in "kv")
    sl = _ints([n * bs - 1, (n - 2) * bs + 3, 47 * 2049 * bs, 5], dev)
    want = [p.clone() for p in pools]
    R.kv_token_write_ref(*want, kn, vn, sl)
    ops.kv_token_write(*pools, kn, vn, sl)
    torch.cuda.synchronize()
    for g, w in zip(pools, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("layers,n", [
    (6, 50),
    (48, 2049),                  # Qwen2.5-14B serve pool: offsets > 2**31
])
def test_block_gather_scatter_layers(dev, dt, layers, n):
    gen = torch.Generator(device=dev).manual_seed(3)
    pools = _rand(gen, (layers, n, 16, 8, 128), dt, dev)
    idx = _ints([7, 1, n - 6, 20], dev)
    got = ops.block_gather_layers(pools, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, R.block_gather_layers_ref(pools, idx))
    st = _rand(gen, (layers, 4, 16, 8, 128), dt, dev)
    dst = _ints([0, n - 1, 5, 11], dev)
    want = R.block_scatter_layers_ref(pools.clone(), dst, st)
    ops.block_scatter_layers(pools, dst, st)
    torch.cuda.synchronize()
    assert torch.equal(pools, want)


def test_launches_are_counted_and_bad_inputs_raise(dev):
    ops.reset_launches()
    pools = torch.zeros((2, 4, 16, 8, 128), device=dev)
    ops.block_gather_layers(pools, _ints([1], dev))
    assert ops.launches["block_gather_layers"] == 1
    with pytest.raises(TypeError):
        ops.block_gather_layers(pools, torch.tensor([1], device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        ops.block_gather_layers(pools.transpose(0, 1), _ints([1], dev))
