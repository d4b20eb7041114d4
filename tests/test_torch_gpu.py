"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: without a CUDA device every test skips. On a machine with
one, run ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``
(the first call builds the kernels with nvcc into build/kernels/).
Tolerances: exact for the write and copy kernels; for the attention
kernels 3e-5 in float32 and, in bfloat16, atol 2e-3 with rtol 8e-3: kernel
and plain version both accumulate in float32 and round once, so they may
differ by one bfloat16 step of the output (2**-7 of its size at most).
The bf16 tensor-core kernels (P split into two bf16 parts) are held at
the same tolerance at the edges of their 64-row and 64-key tiles: paged
prefill over bf16 pools (B4) and over int8 pages (B10), sliding-window
attention (B15), whose window edges cut tiles too, and split-context
decode over bf16 pools (B2) and int8 pages (B9), whose runs of tiles
may be empty; bf16 head dims outside those kernels take the scalar
kernels of B2, B9, B10 and B15.
The decode and prefill writes fused with the RoPE of q and k are held
to their plain versions bit for bit, or one step of the dtype (the count
is printed), at the main path's shapes and at a head dim that takes the
kernels' scalar path; pool rows they do not write stay bit for bit.
Two cases run at Qwen2.5-14B's serve-pool size, where byte offsets pass
2**31 and only 64-bit offset arithmetic gives the right blocks. The int8
quantize and dequantize kernels are exact against their plain versions,
and so are the single-layer block copies (at 1, 5 and 1536 blocks, 28 KiB
runs, ids outside the pool, and a 2.3 GB single-layer pool whose offsets
pass 2**31; a split that misses the run is refused); attention over int8
pools takes the attention kernels' tolerances. The SSD scan (B14) is held to
its token-sequential plain version at 2e-3, the tolerance of the JAX
package's ``test_ssd_scan`` (the chunked sums run in another order over
up to 256 steps), on both of its routes (tensor cores at Mamba2's and
Hymba's widths, scalar kernels at ragged shapes, told apart by
``ops.route_launches``), and at the two models' full prefill shapes to
within 1e-3 (Mamba2) and 1.5e-4 (Hymba) of a float64 run; sliding-window
attention (B15) takes the attention tolerances. The Hymba smoke model runs
prefill and decode on the card in float32 (full float32 products) and
matches the CPU to 1e-4. Mamba2-130M's one-element pool rows go through
an offload -> upload round trip on both host tiers bit for bit against
the plain versions, and one decode step of the Hymba smoke model on the
engine path (after its per-request prefill) through the kernels stays
within four bf16 steps of the largest logit of the plain versions' step.
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


# the bf16 split-context decode kernel's edges (B2 over bf16 pools, B9 over
# int8 pages): contexts on and beside 64-key tile edges, a whole 1024-token
# table and a padded row (context 0); G 1 / 5 / 8 / 16, D 64 / 128, bs 8 /
# 16 / 32; and a table whose last run of tiles is empty for every row
DECODE_CTX = (0, 1, 63, 64, 65, 255, 1024)
DECODE_TILE_CASES = [
    (4, 4, 64, 16, 64, DECODE_CTX, False),          # G 1
    (40, 8, 128, 16, 64, DECODE_CTX, False),        # G 5, Qwen2.5-14B
    (16, 2, 128, 8, 128, DECODE_CTX, False),        # G 8
    (32, 2, 64, 32, 32, DECODE_CTX, False),         # G 16
    (10, 2, 128, 16, 64, (1, 63, 65, 255, 900, 0), True),
]


def _decode_tiles(dev, seed, h, hkv, d, bs, p, lens, last_run_empty,
                  quant):
    """One bf16 decode call per row context in ``lens`` through the
    wrapper and its plain version; checks the launch count, the padded
    rows' exact zeros and, with ``last_run_empty``, that the wrapper's
    last run of tiles starts past every context."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    b = len(lens)
    n = p * b + 2
    q = _rand(gen, (b, h, d), "bf16", dev)
    bt = torch.randint(0, n, (b, p), generator=gen, device=dev,
                       dtype=torch.int32)
    cl = _ints(lens, dev)
    ops.reset_launches()
    if quant:
        kq, ks = _int8_pool(gen, (n, bs, hkv, d), dev)
        vq, vs = _int8_pool(gen, (n, bs, hkv, d), dev)
        got = ops.paged_attention_quant(q, kq, vq, ks, vs, bt, cl)
        want = R.paged_attention_quant_ref(q, kq, vq, ks, vs, bt, cl)
        name = "paged_attention_quant"
    else:
        kp, vp = (_rand(gen, (n, bs, hkv, d), "bf16", dev) for _ in "kv")
        got = ops.paged_attention(q, kp, vp, bt, cl)
        want = R.paged_attention_ref(q, kp, vp, bt, cl)
        name = "paged_attention"
    torch.cuda.synchronize()
    assert ops.launches[name] == 1
    torch.testing.assert_close(got.float(), want.float(), **tol("bf16"))
    assert not got[torch.as_tensor(np.asarray(lens) == 0, device=dev)].any()
    if last_run_empty:
        splits = ops.decode_splits(torch.cuda.current_device(), b, p, bs,
                                   hkv, d, quant)
        run = -(-(-(-p * bs // 64)) // splits) * 64
        assert splits > 1 and (splits - 1) * run >= max(lens)


@pytest.mark.parametrize("h,hkv,d,bs,p,lens,last_run_empty",
                         DECODE_TILE_CASES)
def test_paged_attention_bf16_tiles(dev, h, hkv, d, bs, p, lens,
                                    last_run_empty):
    _decode_tiles(dev, 11, h, hkv, d, bs, p, lens, last_run_empty, False)


@pytest.mark.parametrize("h,hkv,d,bs,p,lens,last_run_empty",
                         DECODE_TILE_CASES)
def test_paged_attention_quant_bf16_tiles(dev, h, hkv, d, bs, p, lens,
                                          last_run_empty):
    """B9 over int8 pools whose scales spread 0.3x to 3x per (page, kv
    head)."""
    _decode_tiles(dev, 12, h, hkv, d, bs, p, lens, last_run_empty, True)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,c,h,hkv,d,bs,p", [
    (8, 32, 40, 8, 128, 16, 64),  # Qwen2.5-14B prefill chunk
    (2, 12, 10, 2, 32, 8, 6),
    (2, 512, 40, 8, 128, 16, 256),  # its longest replay, 4k-token tables
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


# the bf16 tensor-core kernel's edges: 64-row tiles of r = j * G + g (C * G
# ragged), G 1 / 5 / 8, bs 8 / 16 / 32, D 64 / 80 / 128, a one-page table,
# last positions on 64-key tile edges (63, 64, 127), a padded row inside
# the batch; ends[i] is row i's last q_pos (-1: padded row)
@pytest.mark.parametrize("b,c,h,hkv,d,bs,p,ends", [
    (3, 7, 10, 2, 64, 16, 8, (63, -1, 100)),
    (2, 16, 4, 4, 64, 16, 9, (64, 127)),
    (2, 20, 16, 2, 128, 16, 10, (159, 64)),
    (2, 12, 10, 2, 80, 8, 20, (127, 159)),
    (2, 12, 10, 2, 128, 32, 5, (63, 159)),
    (3, 8, 10, 2, 64, 16, 1, (15, 7, -1)),
    (2, 32, 40, 8, 128, 16, 16, (255, 255)),
    (1, 512, 40, 8, 128, 16, 256, (4095,)),
])
def test_paged_prefill_attention_bf16_tiles(dev, b, c, h, hkv, d, bs, p,
                                            ends):
    gen = torch.Generator(device=dev).manual_seed(5)
    n = p * b + 2
    q = _rand(gen, (b, c, h, d), "bf16", dev)
    kp, vp = (_rand(gen, (n, bs, hkv, d), "bf16", dev) for _ in "kv")
    bt = torch.randint(0, n, (b, p), generator=gen, device=dev,
                       dtype=torch.int32)
    qpos = np.full((b, c), -1)
    for i, e in enumerate(ends):
        valid = min(c - i % 3, e + 1)     # some rows end in padding
        qpos[i, :valid] = e - valid + 1 + np.arange(valid)
    qp = _ints(qpos, dev)
    got = ops.paged_prefill_attention(q, kp, vp, bt, qp)
    want = R.paged_prefill_attention_ref(q, kp, vp, bt, qp)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **tol("bf16"))
    assert not got[torch.from_numpy(qpos < 0).to(dev)].any()


def test_paged_prefill_attention_bf16_head_dim_outside_tiles_raises(dev):
    """D = 72 is no multiple of 16: the bf16 tensor-core kernel has no
    instantiation for it, and the wrapper raises instead of launching."""
    q = torch.zeros((1, 4, 2, 72), dtype=torch.bfloat16, device=dev)
    kp = torch.zeros((2, 16, 2, 72), dtype=torch.bfloat16, device=dev)
    bt = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    qp = torch.arange(4, dtype=torch.int32, device=dev)[None]
    with pytest.raises(ValueError, match="multiple of 16"):
        ops.paged_prefill_attention(q, kp, kp, bt, qp)


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
def test_kv_writes_scalar_path(dev, dt):
    """B1 and B3 where 16-byte vectors do not fit: D 6 (not a multiple of
    16 bytes in either dtype), then D 128 with new K/V that start one
    element past a 16-byte boundary; a chunk of 10 tokens (runs of 8 and
    2) over 4-token pages."""
    gen = torch.Generator(device=dev).manual_seed(5)

    def rand(*shape):           # D 128: one element past a 16-byte boundary
        if shape[-1] == 6:
            return _rand(gen, shape, dt, dev)
        return _rand(gen, (int(np.prod(shape)) + 1,), dt, dev)[1:] \
            .view(shape)

    for d in (6, 128):
        n, bs, hkv, b, c = 12, 4, 2, 3, 10
        pools = [_rand(gen, (n, bs, hkv, d), dt, dev) for _ in "kv"]
        tok = [rand(b, hkv, d) for _ in "kv"]
        new = [rand(b, c, hkv, d) for _ in "kv"]
        sl = _ints([5, 13, (n - 1) * bs], dev)
        want = [p.clone() for p in pools]
        R.kv_token_write_ref(*want, *tok, sl)
        ops.kv_token_write(*pools, *tok, sl)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(pools, want))
        wp = _ints([[3, 4, 5, 11], [6, 7, 11, 11], [11, 11, 11, 11]], dev)
        ws, wc = _ints([2, 0, 0], dev), _ints([c, 7, 0], dev)
        R.kv_chunk_write_ref(*want, *new, wp, ws, wc)
        ops.kv_chunk_write(*pools, *new, wp, ws, wc)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(pools, want))


def _step(x, dtype):
    """One step of ``dtype`` at each |x| (x float32): the gap to the next
    representable value away from 0; the smallest subnormal step at 0."""
    bits = {torch.float32: 23, torch.bfloat16: 7}[dtype]
    _, e = torch.frexp(x.abs())
    step = torch.ldexp(torch.ones_like(x), e - 1 - bits)
    tiny = torch.finfo(dtype).tiny * 2.0 ** -bits
    return torch.where(x == 0, torch.full_like(x, tiny), step)


def _one_step(got, want):
    """Asserts every element of ``got`` is ``want`` or one step of their
    dtype away from it; returns the count of differing elements."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    step = torch.maximum(_step(g, got.dtype), _step(w, got.dtype))
    assert bool((diff <= step).all()), float(diff.max())
    return int((diff > 0).sum())


def _rope_write_check(fn, plain, pools, written):
    """Runs the fused kernel ``fn`` and its plain version ``plain`` (both
    return the roped q) from the same pool snapshot. The roped q and the
    pools may differ by one step (the count is returned); pool rows that
    ``written`` (a bool mask over the (N * bs) slots) leaves out stay bit
    for bit as they were."""
    snap = [p.clone() for p in pools]
    want_q = plain()
    want = [p.clone() for p in pools]
    for p, s in zip(pools, snap):
        p.copy_(s)
    got_q = fn()
    torch.cuda.synchronize()
    n_diff = _one_step(got_q, want_q)
    for got, w, s in zip(pools, want, snap):
        n_diff += _one_step(got, w)
        flat, sflat = got.view(-1, *got.shape[2:]), s.view(-1, *s.shape[2:])
        assert torch.equal(flat[~written], sflat[~written])
        assert not torch.equal(flat[written], sflat[written])
    return n_diff


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,h,hkv,d,theta", [
    (8, 40, 8, 128, 1e6),        # Qwen2.5-14B decode
    (3, 8, 2, 20, 1e4),          # D/2 = 10: the scalar path
    (2, 4, 4, 8, 1e4),           # bf16 scalar, f32 16-byte vectors
])
def test_rope_kv_token_write(dev, dt, b, h, hkv, d, theta):
    """The decode layer's fused RoPE and write against its plain version:
    bit for bit, or one step of the dtype (the count is printed); the last
    row padded into the scratch slot, which is left out of the check."""
    gen = torch.Generator(device=dev).manual_seed(6)
    n, bs = 4 * b + 1, 16
    pools = [_rand(gen, (n, bs, hkv, d), dt, dev) for _ in "kv"]
    q = _rand(gen, (b, h, d), dt, dev)
    k, v = (_rand(gen, (b, hkv, d), dt, dev) for _ in "kv")
    scratch = (n - 1) * bs
    slots = np.random.default_rng(6).choice(scratch, b, replace=False)
    slots[-1] = scratch
    sl = _ints(slots, dev)
    pos = _ints(np.random.default_rng(7).integers(0, 4097, b), dev)
    written = torch.zeros(n * bs, dtype=torch.bool, device=dev)
    written[sl[:-1].long()] = True
    live = [p[:-1] for p in pools]        # the scratch page is left out
    n_diff = _rope_write_check(
        lambda: ops.rope_kv_token_write(q, k, v, *pools, sl, pos, theta),
        lambda: R.rope_kv_token_write_ref(q, k, v, *pools, sl, pos, theta),
        live, written[:scratch])
    print(f"rope_kv_token_write {dt} D {d}: {n_diff} elements one step off")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,c,h,hkv,d,bs,theta", [
    (8, 32, 40, 8, 128, 16, 1e6),    # Qwen2.5-14B prefill chunk
    (3, 10, 8, 2, 20, 4, 1e4),       # D/2 = 10: the scalar path
    (2, 512, 40, 8, 128, 16, 1e6),   # its longest replay
])
def test_rope_kv_chunk_write(dev, dt, b, c, h, hkv, d, bs, theta):
    """The prefill layer's fused RoPE and write against its plain version:
    windows that start mid-page and cross pages, short counts, the last row
    padded (wcount = 0, q_pos = -1 clamped to 0); every query is roped."""
    gen = torch.Generator(device=dev).manual_seed(8)
    rng = np.random.default_rng(8)
    pp = (c - 1) // bs + 2
    n = b * pp + 1
    pools = [_rand(gen, (n, bs, hkv, d), dt, dev) for _ in "kv"]
    q = _rand(gen, (b, c, h, d), dt, dev)
    k, v = (_rand(gen, (b, c, hkv, d), dt, dev) for _ in "kv")
    wpages = np.full((b, pp), n - 1)
    wpages[:b - 1] = rng.permutation(b * pp)[:(b - 1) * pp].reshape(b - 1, pp)
    starts = np.arange(b) % bs
    counts = np.array([c - i for i in range(b - 1)] + [0])
    qpos = np.zeros((b, c), np.int64)
    for i in range(b - 1):
        qpos[i] = rng.integers(0, 4097 - c) + np.arange(c)
    written = torch.zeros(n * bs, dtype=torch.bool, device=dev)
    for i in range(b - 1):
        p = starts[i] + np.arange(counts[i])
        written[torch.as_tensor(wpages[i, p // bs] * bs + p % bs)] = True
    wp, ws, wc = (_ints(a, dev) for a in (wpages, starts, counts))
    pos = _ints(qpos, dev)
    n_diff = _rope_write_check(
        lambda: ops.rope_kv_chunk_write(q, k, v, *pools, wp, ws, wc, pos,
                                        theta),
        lambda: R.rope_kv_chunk_write_ref(q, k, v, *pools, wp, ws, wc, pos,
                                          theta),
        [p[:-1] for p in pools], written[:(n - 1) * bs])
    print(f"rope_kv_chunk_write {dt} D {d}: {n_diff} elements one step off")


def test_rope_writes_launches_and_bad_inputs(dev):
    gen = torch.Generator(device=dev).manual_seed(9)
    pools = [_rand(gen, (6, 16, 2, 64), "bf16", dev) for _ in "kv"]
    q, k, v = (_rand(gen, s, "bf16", dev)
               for s in ((2, 8, 64), (2, 2, 64), (2, 2, 64)))
    qc, kc, vc = (_rand(gen, s, "bf16", dev)
                  for s in ((2, 4, 8, 64), (2, 4, 2, 64), (2, 4, 2, 64)))
    sl, pos = _ints([3, 40], dev), _ints([5, 9], dev)
    wp, ws, wc = _ints([[1], [2]], dev), _ints([0, 3], dev), _ints([4, 2],
                                                                    dev)
    cpos = _ints([[0, 1, 2, 3], [7, 8, 0, 0]], dev)
    ops.reset_launches()
    out = ops.rope_kv_token_write(q, k, v, *pools, sl, pos, 1e4)
    outc = ops.rope_kv_chunk_write(qc, kc, vc, *pools, wp, ws, wc, cpos, 1e4)
    torch.cuda.synchronize()
    assert out.shape == q.shape and outc.shape == qc.shape
    assert ops.launches["rope_kv_token_write"] == 1
    assert ops.launches["rope_kv_chunk_write"] == 1
    assert not ops.launches["kv_token_write"]
    assert not ops.launches["kv_chunk_write"]
    with pytest.raises(TypeError):                  # q not the pool dtype
        ops.rope_kv_token_write(q.float(), k, v, *pools, sl, pos, 1e4)
    with pytest.raises(TypeError):                  # positions not int32
        ops.rope_kv_token_write(q, k, v, *pools, sl, pos.long(), 1e4)
    with pytest.raises(ValueError, match="contiguous"):
        ops.rope_kv_chunk_write(qc.transpose(1, 2), kc, vc, *pools, wp, ws,
                                wc, cpos, 1e4)
    with pytest.raises(ValueError, match="shape mismatch"):
        ops.rope_kv_chunk_write(qc, kc, vc, *pools, wp, ws, wc,
                                cpos[:, :2].contiguous(), 1e4)
    odd = [_rand(gen, (6, 16, 2, 63), "bf16", dev) for _ in "kv"]
    with pytest.raises(ValueError, match="even D"):
        ops.rope_kv_token_write(_rand(gen, (2, 8, 63), "bf16", dev),
                                *(_rand(gen, (2, 2, 63), "bf16", dev)
                                  for _ in "kv"), *odd, sl, pos, 1e4)
    assert ops.launches["rope_kv_token_write"] == 1
    assert ops.launches["rope_kv_chunk_write"] == 1


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
    # B2: one launch per call on either route (bf16 D 128: the split kernel
    # and its combine, in one C entry; f32: the scalar kernel), none for a
    # call that raises
    kp = torch.zeros((4, 16, 2, 128), dtype=torch.bfloat16, device=dev)
    q = torch.zeros((2, 10, 128), dtype=torch.bfloat16, device=dev)
    bt, cl = _ints([[0, 1], [2, 3]], dev), _ints([20, 0], dev)
    ops.paged_attention(q, kp, kp, bt, cl)
    ops.paged_attention(q.float(), kp.float(), kp.float(), bt, cl)
    assert ops.launches["paged_attention"] == 2
    with pytest.raises(TypeError):                  # q not the pool dtype
        ops.paged_attention(q.float(), kp, kp, bt, cl)
    with pytest.raises(TypeError):                  # tables not int32
        ops.paged_attention(q, kp, kp, bt.long(), cl)
    with pytest.raises(ValueError, match="contiguous"):
        ops.paged_attention(q.transpose(0, 1), kp, kp, bt, cl)
    with pytest.raises(ValueError, match="H/Hkv <= 16"):   # G = 20
        ops.paged_attention(torch.zeros((2, 40, 128), dtype=torch.bfloat16,
                                        device=dev), kp, kp, bt, cl)
    assert ops.launches["paged_attention"] == 2


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("layers,n", [
    (6, 50),
    (48, 2049),                  # Qwen2.5-14B serve pool: offsets > 2**31
])
def test_block_gather_quant_scatter_dequant_layers(dev, dt, layers, n):
    gen = torch.Generator(device=dev).manual_seed(5)
    pools = _rand(gen, (layers, n, 16, 8, 128), dt, dev)
    pools[:, 20] = 0                                    # an all-zero block
    idx = _ints([7, n - 2, n - 1, 20], dev)             # last live, scratch
    q, s = ops.block_gather_quant_layers(pools, idx)
    want_q, want_s = R.block_gather_quant_layers_ref(pools, idx)
    torch.cuda.synchronize()
    assert torch.equal(q, want_q) and torch.equal(s, want_s)
    assert not q[:, 3].any() and bool((s[:, 3] == 1e-8).all())
    dst = _ints([0, n - 1, 5, 11], dev)
    want = R.block_scatter_dequant_layers_ref(pools.clone(), dst, q, s)
    ops.block_scatter_dequant_layers(pools, dst, q, s)
    torch.cuda.synchronize()
    assert torch.equal(pools, want)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("m,bs,hkv,d", [
    (1536, 16, 8, 128),          # 32 blocks x 48 layers of Qwen2.5-14B
    (5, 8, 5, 16),
    (2, 4, 12, 32),              # more kv heads than warps per block
    (3, 4, 2, 6),                # D not a multiple of a 16-byte vector
])
def test_kv_block_quant_dequant(dev, dt, m, bs, hkv, d):
    gen = torch.Generator(device=dev).manual_seed(6)
    x = _rand(gen, (m, bs, hkv, d), dt, dev) * 7.0
    x[0] = 0
    q, s = ops.kv_block_quant(x)
    want_q, want_s = R.quantize_block_ref(x)
    torch.cuda.synchronize()
    assert torch.equal(q, want_q) and torch.equal(s, want_s)
    for out in (torch.float32, torch.bfloat16):
        y = ops.kv_block_dequant(q, s, out)
        torch.cuda.synchronize()
        assert y.dtype == out
        assert torch.equal(y, R.dequantize_block_ref(q, s, out))


def test_int8_launches_are_counted_and_bad_inputs_raise(dev):
    ops.reset_launches()
    pools = torch.zeros((2, 4, 16, 8, 128), device=dev)
    idx = _ints([1, 3], dev)
    q, s = ops.block_gather_quant_layers(pools, idx)
    ops.block_scatter_dequant_layers(pools, idx, q, s)
    q2, s2 = ops.kv_block_quant(pools[0])
    ops.kv_block_dequant(q2, s2)
    torch.cuda.synchronize()
    for name in ("block_gather_quant_layers", "block_scatter_dequant_layers",
                 "kv_block_quant", "kv_block_dequant"):
        assert ops.launches[name] == 1, name
    with pytest.raises(TypeError):                    # staging not int8
        ops.block_scatter_dequant_layers(pools, idx, q.float(), s)
    with pytest.raises(ValueError, match="scales shape"):
        ops.block_scatter_dequant_layers(pools, idx, q,
                                         s[:, :1].contiguous())
    with pytest.raises(TypeError):                    # ids not int32
        ops.block_gather_quant_layers(pools, idx.long())
    with pytest.raises(TypeError):                    # pools not float
        ops.block_gather_quant_layers(q, idx)
    with pytest.raises(TypeError):
        ops.kv_block_dequant(q2, s2, torch.float16)
    with pytest.raises(ValueError, match="scales shape"):
        ops.kv_block_dequant(q2, s2[:1])


# ---------------------------------------------------------------------------
# attention over int8 pools (B9, B10); single-layer block copies (B13a/b)
# ---------------------------------------------------------------------------

def _int8_pool(gen, shape, dev):
    """int8 pages and (N, Hkv) float32 scales, quantized by the plain
    version from normal pages whose magnitude differs by page and kv head
    (0.3x to 3x), so each (page, kv head) has its own scale."""
    n, _, hkv, _ = shape
    mag = 10.0 ** (torch.rand((n, 1, hkv, 1), generator=gen, device=dev)
                   - 0.5)
    return R.quantize_block_ref(
        torch.randn(shape, generator=gen, device=dev) * mag)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,h,hkv,d,bs,p", [
    (8, 40, 8, 128, 16, 64),     # Qwen2.5-14B decode
    (3, 32, 2, 64, 16, 5),       # G = 16
    (2, 4, 4, 16, 8, 3),
    (3, 6, 2, 24, 8, 4),         # D % 16 != 0: scalar int8 staging
])
def test_paged_attention_quant(dev, dt, b, h, hkv, d, bs, p):
    gen = torch.Generator(device=dev).manual_seed(7)
    n = p * b + 2
    q = _rand(gen, (b, h, d), dt, dev)
    kq, ks = _int8_pool(gen, (n, bs, hkv, d), dev)
    vq, vs = _int8_pool(gen, (n, bs, hkv, d), dev)
    bt = torch.randint(0, n, (b, p), generator=gen, device=dev,
                       dtype=torch.int32)
    lens = np.random.default_rng(7).integers(1, p * bs + 1, b)
    lens[-1] = 0                                        # padded row
    cl = _ints(lens, dev)
    got = ops.paged_attention_quant(q, kq, vq, ks, vs, bt, cl)
    want = R.paged_attention_quant_ref(q, kq, vq, ks, vs, bt, cl)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype
    torch.testing.assert_close(got.float(), want.float(), **tol(dt))
    assert not got[-1].any()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,c,h,hkv,d,bs,p", [
    (8, 32, 40, 8, 128, 16, 64),  # Qwen2.5-14B prefill chunk
    (2, 12, 32, 2, 64, 8, 6),     # G = 16
    (2, 5, 4, 4, 16, 8, 4),
    (3, 7, 6, 2, 24, 8, 4),       # D % 16 != 0: scalar int8 staging
])
def test_paged_prefill_attention_quant(dev, dt, b, c, h, hkv, d, bs, p):
    gen = torch.Generator(device=dev).manual_seed(8)
    n = p * b + 2
    q = _rand(gen, (b, c, h, d), dt, dev)
    kq, ks = _int8_pool(gen, (n, bs, hkv, d), dev)
    vq, vs = _int8_pool(gen, (n, bs, hkv, d), dev)
    bt = torch.randint(0, n, (b, p), generator=gen, device=dev,
                       dtype=torch.int32)
    rng = np.random.default_rng(8)
    qpos = np.full((b, c), -1)
    for i in range(b - 1):                              # last row padded
        start = int(rng.integers(0, p * bs - c))
        valid = int(rng.integers(1, c + 1))
        qpos[i, :valid] = start + np.arange(valid)
    qp = _ints(qpos, dev)
    got = ops.paged_prefill_attention_quant(q, kq, vq, ks, vs, bt, qp)
    want = R.paged_prefill_attention_quant_ref(q, kq, vq, ks, vs, bt, qp)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype
    torch.testing.assert_close(got.float(), want.float(), **tol(dt))
    assert not got[torch.as_tensor(qpos < 0, device=dev)].any()


# B10's tensor-core instantiation (bf16 q, int8 pages) at B4's tile edges
# (see test_paged_prefill_attention_bf16_tiles), over int8 pools whose
# scales spread 0.3x to 3x per (page, kv head)
@pytest.mark.parametrize("b,c,h,hkv,d,bs,p,ends", [
    (3, 7, 10, 2, 64, 16, 8, (63, -1, 100)),
    (2, 16, 4, 4, 64, 16, 9, (64, 127)),
    (2, 20, 16, 2, 128, 16, 10, (159, 64)),
    (2, 12, 10, 2, 80, 8, 20, (127, 159)),
    (2, 12, 10, 2, 128, 32, 5, (63, 159)),
    (3, 8, 10, 2, 64, 16, 1, (15, 7, -1)),
    (2, 32, 40, 8, 128, 16, 16, (255, 255)),
])
def test_paged_prefill_attention_quant_bf16_tiles(dev, b, c, h, hkv, d, bs,
                                                  p, ends):
    gen = torch.Generator(device=dev).manual_seed(6)
    n = p * b + 2
    q = _rand(gen, (b, c, h, d), "bf16", dev)
    kq, ks = _int8_pool(gen, (n, bs, hkv, d), dev)
    vq, vs = _int8_pool(gen, (n, bs, hkv, d), dev)
    bt = torch.randint(0, n, (b, p), generator=gen, device=dev,
                       dtype=torch.int32)
    qpos = np.full((b, c), -1)
    for i, e in enumerate(ends):
        valid = min(c - i % 3, e + 1)     # some rows end in padding
        qpos[i, :valid] = e - valid + 1 + np.arange(valid)
    qp = _ints(qpos, dev)
    got = ops.paged_prefill_attention_quant(q, kq, vq, ks, vs, bt, qp)
    want = R.paged_prefill_attention_quant_ref(q, kq, vq, ks, vs, bt, qp)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **tol("bf16"))
    assert not got[torch.from_numpy(qpos < 0).to(dev)].any()


# B15's tensor-core kernel (bf16, D a multiple of 16) at its edges: windows
# under one 64-key tile, not a multiple of 64, exactly 64 and at least S;
# D 16 / 32 / 64 / 128; S 96 (a ragged last query tile)
@pytest.mark.parametrize("b,s,h,d,window", [
    (2, 256, 3, 16, 40),
    (2, 256, 3, 32, 100),
    (1, 384, 2, 64, 64),
    (1, 128, 4, 64, 1000),
    (2, 96, 2, 128, 100),
    (2, 96, 3, 32, 96),
])
def test_swa_attention_bf16_tiles(dev, b, s, h, d, window):
    gen = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (_rand(gen, (b, s, h, d), "bf16", dev) for _ in "qkv")
    got = ops.swa_attention(q, k, v, window)
    want = R.swa_attention_ref(q, k, v, window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **tol("bf16"))


def test_bf16_head_dims_outside_the_tensor_cores_take_scalar_kernels(dev):
    """bf16 B2, B9 and B10 at D 24 and 72 and bf16 B15 at D 20 and 72 (no
    multiple of 16) launch the scalar kernels and match their plain
    versions, where bf16 B4 refuses D 72 (test_paged_prefill_attention_
    bf16_head_dim_outside_tiles_raises); B2 and B9 at D 48 run and match in
    float32 (scalar kernel) and bf16 (the tensor-core kernel). The scalar
    C entries refuse a bf16 call in the tensor-core shapes: each shape has
    one kernel."""
    gen = torch.Generator(device=dev).manual_seed(8)
    ops.reset_launches()
    bt = _ints([[0, 3, 5, 7], [1, 2, 4, 6]], dev)
    cl = _ints([29, 7], dev)
    for dt, d in (("bf16", 24), ("bf16", 72), ("f32", 48), ("bf16", 48)):
        q = _rand(gen, (2, 10, d), dt, dev)
        kp, vp = (_rand(gen, (9, 8, 2, d), dt, dev) for _ in "kv")
        got = ops.paged_attention(q, kp, vp, bt, cl)
        want = R.paged_attention_ref(q, kp, vp, bt, cl)
        kq, ks = _int8_pool(gen, (9, 8, 2, d), dev)
        vq, vs = _int8_pool(gen, (9, 8, 2, d), dev)
        got_q = ops.paged_attention_quant(q, kq, vq, ks, vs, bt, cl)
        want_q = R.paged_attention_quant_ref(q, kq, vq, ks, vs, bt, cl)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **tol(dt))
        torch.testing.assert_close(got_q.float(), want_q.float(), **tol(dt))
    assert ops.launches["paged_attention"] == 4
    assert ops.launches["paged_attention_quant"] == 4
    out = torch.empty_like(q)
    rc = ops._fn("paged_attention")(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), bt.data_ptr(),
        cl.data_ptr(), out.data_ptr(), 2, 4, 8, 2, 5, 48, 0.125, 1,
        torch.cuda.current_stream().cuda_stream)
    assert rc != 0                      # bf16 D 48: paged_attention_tc's
    for d in (24, 72):
        q = _rand(gen, (2, 6, 8, d), "bf16", dev)
        kq, ks = _int8_pool(gen, (9, 8, 2, d), dev)
        vq, vs = _int8_pool(gen, (9, 8, 2, d), dev)
        bt = _ints([[0, 3, 5, 7], [1, 2, 4, 6]], dev)
        qp = _ints([[20, 21, 22, 23, -1, -1], [0, 1, 2, 3, 4, 5]], dev)
        got = ops.paged_prefill_attention_quant(q, kq, vq, ks, vs, bt, qp)
        want = R.paged_prefill_attention_quant_ref(q, kq, vq, ks, vs, bt, qp)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **tol("bf16"))
    for d in (20, 72):
        q, k, v = (_rand(gen, (1, 128, 2, d), "bf16", dev) for _ in "qkv")
        got = ops.swa_attention(q, k, v, 50)
        want = R.swa_attention_ref(q, k, v, 50)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **tol("bf16"))
    assert ops.launches["paged_prefill_attention_quant"] == 2
    assert ops.launches["swa_attention"] == 2


def _copy_ids(rng, n, m):
    """``m`` distinct block ids of an ``n``-block pool, the last two first
    (at the largest byte offsets), the rest drawn."""
    return np.concatenate([[n - 1, n - 2],
                           rng.choice(n - 2, max(m - 2, 0),
                                      replace=False)])[:m]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n,bs,hkv,d,m", [
    (2049, 16, 8, 128, 5),       # one layer of Qwen2.5-14B's serve pool
    (2049, 16, 8, 128, 1),       # one block: 8 chunks
    (2049, 16, 8, 128, 1536),    # B5/B6's bytes in one layer
    (1025, 16, 8, 112, 32),      # Kimi-K2's 28 KiB runs (bf16)
    (50, 3, 1, 5, 5),            # 4-byte (f32) and 2-byte (bf16) copies
])
def test_block_gather_scatter(dev, dt, n, bs, hkv, d, m):
    """Gather and scatter equal their plain versions bit for bit, one
    launch each."""
    gen = torch.Generator(device=dev).manual_seed(9)
    rng = np.random.default_rng(9)
    pages = _rand(gen, (n, bs, hkv, d), dt, dev)
    idx = _ints(_copy_ids(rng, n, m), dev)
    ops.reset_launches()
    got = ops.block_gather(pages, idx)
    torch.cuda.synchronize()
    assert ops.launches["block_gather"] == 1
    assert torch.equal(got, R.block_gather_ref(pages, idx))
    st = _rand(gen, (m, bs, hkv, d), dt, dev)
    dst = _ints(rng.permutation(_copy_ids(rng, n, m)), dev)
    want = R.block_scatter_ref(pages.clone(), dst, st)
    out = ops.block_scatter(pages, dst, st)
    torch.cuda.synchronize()
    assert ops.launches["block_scatter"] == 1
    assert out is pages and torch.equal(pages, want)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_block_gather_scatter_skip_ids_outside_the_pool(dev, dt):
    """Ids below 0 or at N and past it are skipped: the gather's rows of
    the others are right, the scatter writes only the others and leaves
    every other byte of the pool as it was."""
    gen = torch.Generator(device=dev).manual_seed(12)
    n = 40
    pages = _rand(gen, (n, 16, 8, 128), dt, dev)
    ids = [-1, 3, n, 7, -2**31, n - 1, 2**31 - 1]
    live = [i for i, b in enumerate(ids) if 0 <= b < n]
    idx = _ints(ids, dev)
    got = ops.block_gather(pages, idx)
    torch.cuda.synchronize()
    assert torch.equal(got[live], pages[[ids[i] for i in live]])
    st = _rand(gen, (len(ids), 16, 8, 128), dt, dev)
    want = pages.clone()
    want[[ids[i] for i in live]] = st[live]
    out = ops.block_scatter(pages, idx, st)
    torch.cuda.synchronize()
    assert out is pages and torch.equal(pages, want)


def test_block_gather_scatter_past_2_31_bytes(dev):
    """One layer's pool of 70000 blocks of 32 KiB (bf16, 2.3 GB): ids at its
    end, whose byte offsets pass 2**31, copy the right blocks."""
    gen = torch.Generator(device=dev).manual_seed(13)
    n = 70000
    pages = torch.empty((n, 16, 8, 128), dtype=torch.bfloat16, device=dev)
    for lo in range(0, n, 10000):          # drawn in parts: 0.33 GB each
        pages[lo:lo + 10000] = _rand(gen, (min(10000, n - lo), 16, 8, 128),
                                     "bf16", dev)
    idx = _ints([n - 1, 65537, 1, n - 2, 2**16 + 5], dev)
    got = ops.block_gather(pages, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, R.block_gather_ref(pages, idx))
    st = _rand(gen, (5, 16, 8, 128), "bf16", dev)
    dst = _ints([n - 2, 3, n - 1, 66000, 2**16], dev)
    rows = dst.long()
    near = pages[[n - 3, 65999, 66001]].clone()    # beside written blocks
    ops.block_scatter(pages, dst, st)
    torch.cuda.synchronize()
    assert torch.equal(pages[rows], st)
    assert torch.equal(pages[[n - 3, 65999, 66001]], near)


def test_block_gather_refuses_a_split_that_misses_the_run(dev):
    """The C entries check the plan they are given: chunks that do not
    cover the run, a chunk past one pass of a thread block, or a vector
    wider than the bases' alignment give cudaErrorInvalidValue and no
    launch."""
    pages = torch.zeros((4, 16, 8, 128), dtype=torch.bfloat16, device=dev)
    out = torch.empty((1, 16, 8, 128), dtype=torch.bfloat16, device=dev)
    idx = _ints([2], dev)
    run = 16 * 8 * 128 * 2
    fn = ops._fn("block_gather")
    stream = torch.cuda.current_stream().cuda_stream
    for vec, chunk, n_chunks in ((16, 4096, 7), (16, 4096, 9),
                                 (16, 8192, 4), (16, 4008, 9),
                                 (32, 4096, 8)):
        rc = fn(pages.data_ptr(), out.data_ptr(), idx.data_ptr(), 4, 1, run,
                vec, chunk, n_chunks, stream)
        assert rc == 1, (vec, chunk, n_chunks)     # cudaErrorInvalidValue
    misaligned = out.view(-1)[1:].data_ptr()
    assert fn(pages.data_ptr(), misaligned, idx.data_ptr(), 4, 1, run, 16,
              4096, 8, stream) == 1
    assert fn(pages.data_ptr(), out.data_ptr(), idx.data_ptr(), 4, 1, run,
              16, 4096, 8, stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(out[0], pages[2])


def test_int8_attention_and_block_copy_launches_and_bad_inputs(dev):
    gen = torch.Generator(device=dev).manual_seed(10)
    q = _rand(gen, (2, 8, 64), "bf16", dev)
    qc = _rand(gen, (2, 4, 8, 64), "bf16", dev)
    kq, ks = _int8_pool(gen, (6, 16, 2, 64), dev)
    vq, vs = _int8_pool(gen, (6, 16, 2, 64), dev)
    bt, cl = _ints([[0, 1], [2, 3]], dev), _ints([20, 5], dev)
    qp = _ints([[0, 1, 2, 3], [10, 11, -1, -1]], dev)
    pages = _rand(gen, (6, 16, 2, 64), "bf16", dev)
    ops.reset_launches()
    ops.paged_attention_quant(q, kq, vq, ks, vs, bt, cl)
    ops.paged_prefill_attention_quant(qc, kq, vq, ks, vs, bt, qp)
    st = ops.block_gather(pages, _ints([1, 4], dev))
    ops.block_scatter(pages, _ints([0, 5], dev), st)
    torch.cuda.synchronize()
    for name in ("paged_attention_quant", "paged_prefill_attention_quant",
                 "block_gather", "block_scatter"):
        assert ops.launches[name] == 1, name
    for fn, qq, pos in ((ops.paged_attention_quant, q, cl),
                        (ops.paged_prefill_attention_quant, qc, qp)):
        with pytest.raises(TypeError, match="q must be"):     # int8 q
            fn(qq.to(torch.int8), kq, vq, ks, vs, bt, pos)
        with pytest.raises(TypeError):                        # f16 scales
            fn(qq, kq, vq, ks.half(), vs, bt, pos)
        with pytest.raises(ValueError, match="v_scale shape"):
            fn(qq, kq, vq, ks, vs[:3].contiguous(), bt, pos)
        with pytest.raises(TypeError):                        # bf16 pages
            fn(qq, kq.to(torch.bfloat16), vq, ks, vs, bt, pos)
    with pytest.raises(ValueError, match="H/Hkv <= 16"):       # G = 20
        ops.paged_attention_quant(_rand(gen, (2, 40, 64), "bf16", dev), kq,
                                  vq, ks, vs, bt, cl)
    with pytest.raises(TypeError):                            # ids not int32
        ops.block_gather(pages, torch.tensor([1], device=dev))
    with pytest.raises(ValueError, match="staging shape"):
        ops.block_scatter(pages, _ints([0, 5], dev), st[:1])
    for name in ("paged_attention_quant", "paged_prefill_attention_quant",
                 "block_gather", "block_scatter"):
        assert ops.launches[name] == 1, name


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,s,h,p,n,q", [
    (4, 256, 24, 64, 128, 64),    # Mamba2-130M widths, a shorter sequence
    (2, 128, 3, 16, 128, 16),     # N = 128 with Q = 16
    (2, 192, 50, 64, 16, 64),     # Hymba-1.5B widths (N = 16)
    (1, 96, 5, 40, 4, 32),        # P not a multiple of the 32-row slice
    (2, 20, 2, 8, 8, 20),         # Q not a multiple of 16
])
def test_ssd_scan(dev, dt, b, s, h, p, n, q):
    gen = torch.Generator(device=dev).manual_seed(3)
    x = _rand(gen, (b, s, h, p), dt, dev)
    dts = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=gen, device=dev))
    A = -torch.exp(0.5 * torch.randn((h,), generator=gen, device=dev))
    bm, cm = (torch.randn((b, s, n), generator=gen, device=dev)
              for _ in "bc")
    y, st = ops.ssd_scan(x, dts, dts * A, bm, cm, chunk=q)
    yr, sr = R.ssd_scan_ref(x, dts, dts * A, bm, cm)
    torch.cuda.synchronize()
    assert y.dtype == st.dtype == torch.float32
    torch.testing.assert_close(y, yr, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(st, sr, atol=2e-3, rtol=2e-3)


def _ssd_inputs(gen, b, s, h, p, n, dt, dev, a_max=None):
    """x, dt, a, b, c as chip_smoke.py draws them: A = -(1 .. a_max)
    over the heads (-1 .. -H, as the models initialize it, by default)."""
    x = _rand(gen, (b, s, h, p), dt, dev)
    dts = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=gen, device=dev))
    big_a = -torch.linspace(1.0, float(a_max or h), h, device=dev)
    bm, cm = (torch.randn((b, s, n), generator=gen, device=dev)
              for _ in "bc")
    return x, dts, dts * big_a, bm, cm


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,s,h,p,n,q,route", [
    (1, 128, 24, 64, 128, 64, "tc"),      # Mamba2-130M widths
    (1, 128, 50, 64, 16, 64, "tc"),       # Hymba-1.5B widths
    (2, 128, 3, 16, 128, 16, "scalar"),   # Q and P 16
    (1, 96, 5, 40, 4, 32, "scalar"),      # P 40, N 4
    (2, 20, 2, 8, 8, 20, "scalar"),       # Q 20
    (1, 128, 2, 64, 40, 64, "scalar"),    # N not a multiple of 16
    (1, 128, 2, 64, 48, 64, "scalar"),    # N 48: no instantiation
])
def test_ssd_scan_route(dev, dt, b, s, h, p, n, q, route):
    """Each shape takes one route, counted in ops.route_launches: the
    tensor-core kernels at Mamba2's and Hymba's widths, the scalar ones at
    the ragged shapes; both within 2e-3 of the plain version."""
    gen = torch.Generator(device=dev).manual_seed(6)
    x, dts, a, bm, cm = _ssd_inputs(gen, b, s, h, p, n, dt, dev)
    ops.reset_launches()
    y, st = ops.ssd_scan(x, dts, a, bm, cm, chunk=q)
    yr, sr = R.ssd_scan_ref(x, dts, a, bm, cm)
    torch.cuda.synchronize()
    other = "scalar" if route == "tc" else "tc"
    assert ops.launches["ssd_scan"] == 1
    assert ops.route_launches == {f"ssd_scan:{route}": 1,
                                  f"ssd_scan:{other}": 0}
    torch.testing.assert_close(y, yr, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(st, sr, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_ssd_scan_misaligned_x_takes_the_scalar_route(dev, dt):
    """At Mamba2's widths an x that does not start on a 16-byte boundary
    takes the scalar kernels (the tensor-core ones load 16-byte rows)."""
    gen = torch.Generator(device=dev).manual_seed(7)
    x, dts, a, bm, cm = _ssd_inputs(gen, 1, 128, 24, 64, 128, dt, dev)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:]
    shifted = shifted.view(x.shape)
    shifted.copy_(x)
    ops.reset_launches()
    y, st = ops.ssd_scan(shifted, dts, a, bm, cm)
    torch.cuda.synchronize()
    assert ops.route_launches["ssd_scan:scalar"] == 1
    assert ops.route_launches["ssd_scan:tc"] == 0
    yr, sr = R.ssd_scan_ref(x, dts, a, bm, cm)
    torch.testing.assert_close(y, yr, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(st, sr, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("h,n,gate", [(24, 128, 1e-3), (50, 16, 1.5e-4)])
def test_ssd_scan_tc_error_against_float64(dev, dt, h, n, gate):
    """At Mamba2-130M's (H 24, N 128) and Hymba-1.5B's (H 50, N 16)
    prefill shapes, B 4, S 2048, P 64, Q 64, the tensor-core route is at
    most ``gate`` from a float64 run of the plain version, outputs and
    final state: chip_smoke.py's SSD_F64_MAX, which a build with two bf16
    parts per float32 operand exceeds (2.2e-3 / 8.9e-4 with bf16 x) and
    the scalar kernels at Mamba2's shape too (1.87e-3)."""
    gen = torch.Generator(device=dev).manual_seed(8)
    x, dts, a, bm, cm = _ssd_inputs(gen, 4, 2048, h, 64, n, dt, dev)
    ops.reset_launches()
    got = ops.ssd_scan(x, dts, a, bm, cm)
    want = R.ssd_scan_ref(x, dts, a, bm, cm, dtype=torch.float64)
    torch.cuda.synchronize()
    assert ops.route_launches["ssd_scan:tc"] == 1
    for g, w in zip(got, want):
        assert float((g.double() - w).abs().max()) <= gate


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_ssd_scan_tc_masked_triangle_stays_finite(dev, dt):
    """dt scaled up to about 8 with A = -24 drives each chunk's cumulative
    decay to about -10^4, where exp of a difference above the diagonal
    would overflow: the tensor-core route gives finite outputs within
    2e-3 of the plain version."""
    gen = torch.Generator(device=dev).manual_seed(9)
    x, dts, _, bm, cm = _ssd_inputs(gen, 1, 256, 4, 64, 32, dt, dev)
    dts = dts * 4.0
    a = dts * -24.0
    ops.reset_launches()
    y, st = ops.ssd_scan(x, dts, a, bm, cm)
    yr, sr = R.ssd_scan_ref(x, dts, a, bm, cm)
    torch.cuda.synchronize()
    assert ops.route_launches["ssd_scan:tc"] == 1
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    torch.testing.assert_close(y, yr, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(st, sr, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,s,h,d,window", [
    (4, 2048, 25, 64, 1024),      # Hymba-1.5B prefill, heads repeated
    (2, 256, 3, 32, 16),          # window smaller than one 64-key tile
    (2, 256, 2, 128, 1000),       # window >= S: plain causal attention
    (1, 96, 2, 20, 40),           # a ragged tile; bf16 rows not 16-byte
])
def test_swa_attention(dev, dt, b, s, h, d, window):
    gen = torch.Generator(device=dev).manual_seed(4)
    q, k, v = (_rand(gen, (b, s, h, d), dt, dev) for _ in "qkv")
    got = ops.swa_attention(q, k, v, window)
    want = R.swa_attention_ref(q, k, v, window)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype
    torch.testing.assert_close(got.float(), want.float(), **tol(dt))


def test_ssd_swa_launches_are_counted_and_bad_inputs_raise(dev):
    gen = torch.Generator(device=dev).manual_seed(5)
    x = _rand(gen, (1, 128, 2, 8), "f32", dev)
    dts = torch.rand((1, 128, 2), generator=gen, device=dev)
    bm = torch.randn((1, 128, 4), generator=gen, device=dev)
    ops.reset_launches()
    ops.ssd_scan(x, dts, -dts, bm, bm, chunk=64)
    q = _rand(gen, (1, 128, 2, 16), "bf16", dev)
    ops.swa_attention(q, q, q, 32)
    assert ops.launches["ssd_scan"] == 1
    assert ops.launches["swa_attention"] == 1
    with pytest.raises(ValueError, match="chunk"):
        ops.ssd_scan(x, dts, -dts, bm, bm, chunk=128)
    with pytest.raises(ValueError, match="multiple"):
        ops.ssd_scan(x, dts, -dts, bm, bm, chunk=48)
    with pytest.raises(TypeError):
        ops.ssd_scan(x, dts.double(), -dts, bm, bm)
    with pytest.raises(ValueError, match="D <="):
        big = _rand(gen, (1, 64, 1, 160), "f32", dev)
        ops.swa_attention(big, big, big, 8)
    with pytest.raises(ValueError, match="multiple"):
        r = _rand(gen, (1, 200, 1, 16), "f32", dev)
        ops.swa_attention(r, r, r, 8)
    assert ops.launches["ssd_scan"] == 1
    assert ops.launches["swa_attention"] == 1


def test_hymba_smoke_prefill_decode_card_equals_cpu(dev):
    """Prefill (the window bites and S is padded for the kernel) and three
    greedy decode steps of the Hymba smoke model in float32: logits and
    every cache on the card within 1e-4 of the CPU run."""
    import dataclasses

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import model as M

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config("hymba_1_5b"),
                              dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 150)), dtype=torch.int32)
    runs = {}
    for d in ("cpu", dev):
        p = {k: ({kk: vv.to(d) for kk, vv in v.items()}
                 if isinstance(v, dict) else v.to(d))
             for k, v in params.items()}
        ops.reset_launches()
        logits, cache = M.prefill(cfg, p, {"tokens": toks.to(d)}, 160)
        out = [logits[:, 0]]
        nxt = logits[:, 0].argmax(-1).to(torch.int32)
        for step in range(3):
            lg, cache = M.decode_step(cfg, p, cache, nxt, 150 + step)
            out.append(lg)
            nxt = lg.argmax(-1).to(torch.int32)
        runs[str(d)] = ([t.cpu() for t in out],
                        {k: v.cpu() for k, v in cache.items()},
                        {**ops.launches, **ops.route_launches})
    (lc, cc, _), (lg, cg, n) = runs["cpu"], runs[str(dev)]
    assert n["ssd_scan"] == cfg.num_layers
    assert n["ssd_scan:tc"] == cfg.num_layers       # P 64, N 16, Q 64
    assert n["swa_attention"] == cfg.num_layers
    for a, b in zip(lg, lc):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    for k in cc:
        torch.testing.assert_close(cg[k], cc[k], atol=1e-4, rtol=1e-4)


def test_kernel_entries_refuse_to_be_differentiated(dev):
    """The kernels fill their outputs through raw pointers, so an output
    would carry no autograd history: with grad mode on, a CUDA input that
    requires grad raises before any launch (and the count stays); under
    ``torch.no_grad()`` the same call launches."""
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((1, 128, 2, 64), generator=gen, device=dev)
               for _ in "qkv")
    x = torch.randn((1, 64, 2, 64), generator=gen, device=dev)
    dt = torch.rand((1, 64, 2), generator=gen, device=dev)
    bc = torch.randn((1, 64, 16), generator=gen, device=dev)
    pages = torch.randn((5, 16, 2, 64), generator=gen, device=dev)
    tables = _ints([[0, 1, 2, 3]], dev)
    lens = _ints([40], dev)
    calls = {
        "swa_attention": lambda t: ops.swa_attention(t, k, v, 32),
        "ssd_scan": lambda t: ops.ssd_scan(t, dt, -dt, bc, bc),
        "paged_attention": lambda t: ops.paged_attention(
            t[0, :1, :, :], pages, pages, tables, lens)}
    inputs = {"swa_attention": q, "ssd_scan": x, "paged_attention": q}
    for name, call in calls.items():
        t = inputs[name].clone().requires_grad_(True)
        ops.reset_launches()
        with pytest.raises(RuntimeError, match="no backward"):
            call(t)
        assert ops.launches[name] == 0, name
        with torch.no_grad():
            call(t)
        torch.cuda.synchronize()
        assert ops.launches[name] == 1, name


@pytest.mark.parametrize("tier", ["fp16", "int8_host"])
def test_mamba2_pool_migration_round_trip_equals_plain(dev, tier):
    """Mamba2-130M's pools (24 layers, no KV heads: rows of one bf16
    element, 2-byte copies) through an offload -> upload round trip, B5 /
    B6 on the fp16 tier and B7 / B8 on the int8 tier, on the card and on
    a CPU twin (the plain versions): host and device pools bit for bit."""
    from repro_torch.configs.base import get_config
    from repro_torch.kvcache.paged import PagedKVCache

    cfg = get_config("mamba2_130m")
    gen = torch.Generator(device=dev).manual_seed(9)
    caches = [PagedKVCache(cfg, 256, 16, host_blocks=32, host_precision=tier,
                           device=d) for d in (dev, "cpu")]
    assert tuple(caches[0].k.shape) == (24, 257, 16, 1, 1)
    for pool in ("k", "v"):
        x = _rand(gen, tuple(caches[0].k.shape), "bf16", dev)
        getattr(caches[0], pool).copy_(x)
        getattr(caches[1], pool).copy_(x.cpu())
    src, host, dst = [3, 255, 256, 40, 41], [0, 7, 2, 3, 31], [9, 1, 200,
                                                                 77, 5]
    ops.reset_launches()
    for c in caches:
        c.offload(src, host)
        c.upload(host, dst)
    torch.cuda.synchronize()
    names = (("block_gather_layers", "block_scatter_layers") if tier == "fp16"
             else ("block_gather_quant_layers",
                   "block_scatter_dequant_layers"))
    assert all(ops.launches[n] == 2 for n in names), dict(ops.launches)
    card, cpu = caches
    for name in ("k", "v", "host_k", "host_v", "host_scales_k",
                 "host_scales_v"):
        a, b = getattr(card, name), getattr(cpu, name)
        if a is not None:
            assert torch.equal(a.cpu(), b), name
    if tier == "fp16":
        assert torch.equal(card.k[:, dst], card.k[:, src])


def test_hymba_smoke_engine_decode_step_kernels_equal_plain(dev,
                                                           monkeypatch):
    """The engine path of the Hymba smoke model in bf16 on the card: two
    requests past its 64-token window prefill one at a time (B15 in the
    dense-cache prefill, B6 writing the pool) and decode one replayed
    step; then the next decode step, eagerly through the kernels and
    through their plain versions on the same pools: logits within four
    bf16 steps of the largest (2**-5 of it), the argmax on every row whose
    top two logits are clearly apart."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core.backend import TorchBackend
    from repro_torch.core.costmodel import A100_PCIE
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.graph import AppGraph
    from repro_torch.core.request import Request
    from repro_torch.models import graphs as G

    cfg = get_smoke_config("hymba_1_5b")
    assert cfg.dtype == "bfloat16" and cfg.sliding_window == 64
    back = TorchBackend(cfg, EngineConfig(mode="baseline", gpu_blocks=32,
                                          host_blocks=8), A100_PCIE,
                        device=dev)
    rng = np.random.default_rng(0)
    reqs = []
    for i, n in enumerate((100, 90)):
        g = AppGraph("t")
        node = g.add_agent("a", "worker", n, decode_len=8)
        r = Request(rid=f"r{i}", app_id="app", node=node, graph=g,
                    arrival=0.0, prompt_tokens=[int(t) for t in
                                                rng.integers(0, 512, n)])
        r.gpu_blocks_by_device[0] = list(range(8 * i, 8 * i + 8))
        reqs.append(r)
    ops.reset_launches()
    back.decode(reqs)
    torch.cuda.synchronize()
    nl = cfg.num_layers
    assert ops.launches["swa_attention"] == 2 * nl
    assert ops.launches["ssd_scan"] == 2 * nl
    assert ops.launches["block_scatter_layers"] == 4
    assert back.cache_len == {"r0": 101, "r1": 91}
    inputs, _ = back.decode_inputs(reqs)
    eager = G.EagerSteps(cfg)
    pools = [back.cache.k, back.cache.v]
    snap = [p.clone() for p in pools]
    got = eager.decode(back.params, *pools, *inputs).float()[:2]
    for p, s in zip(pools, snap):
        p.copy_(s)
    plain = {"rope_kv_token_write": R.rope_kv_token_write_ref,
             "paged_attention": R.paged_attention_ref}
    with monkeypatch.context() as m:
        for k, f in plain.items():
            m.setattr(ops, k, f)
        want = eager.decode(back.params, *pools, *inputs).float()[:2]
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    tol = 2.0 ** -5 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol
    top2 = want.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * tol
    assert bool((got.argmax(-1) == want.argmax(-1))[clear].all())
