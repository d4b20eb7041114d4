"""The port's kernel wrappers on the CPU (their plain PyTorch versions)
against the Pallas kernels in interpret mode, on the same numpy inputs.

Tolerances are those of ``test_kernels.py``: 3e-5 in float32, 2e-2 in
bfloat16 for the attention kernels; the write and copy kernels are exact.
Write kernels are compared on every block but the scratch block, where
padded rows may land in any order.

The int8 quantizers equal the JAX oracle ``quantize_block_ref`` bit for
bit; against the jitted Pallas kernels a payload element may be one step
off and a scale one ulp (``rtol=1e-6``): under ``jit`` XLA turns the
oracle's ``amax / 127`` into ``amax * (1/127)``. Dequantizing is exact
against both.

Attention over int8 pools is held to the Pallas kernels and the JAX
oracles at the same 3e-5 (float32) / 2e-2 (bfloat16), and, like
``test_quant_kernels.py``, within ``LOGITS_TOL`` of full-precision
attention on the pools before quantization. The single-layer block
copies are exact.

The decode and prefill writes fused with the RoPE of q and k
(``rope_kv_token_write``, ``rope_kv_chunk_write``) are held to the JAX
model's ``apply_rope`` followed by the Pallas writes: float32 within 4
ulps of the inputs' largest magnitude, bfloat16 within one bf16 step
(``assert_rope_close`` says why), and the copied V exactly.

The Mamba2 SSD scan is held to the Pallas kernel and to the JAX oracle's
token-sequential recurrence at 2e-3 (``test_kernels.py``'s tolerance: the
chunked and sequential sums run in different orders); sliding-window
attention at the attention tolerances above.

The bf16 tensor-core CUDA kernels cannot run here, so their arithmetic
is emulated in plain torch: paged prefill over bf16 pools and over int8
pages (``emulate_prefill_tc``), split-context paged decode over bf16
pools and over int8 pages (``emulate_decode_tc``) and sliding-window
attention (``emulate_swa_tc``). Each emulation is held to the Pallas
kernel and the JAX oracle at the bf16 tolerance above and, at the main
path's shape (or Hymba-1.5B's widths), to the port's plain version
within ``chip_smoke.py``'s bf16 tolerance for that kernel (2e-3 for
paged prefill and decode; one bf16 step, atol 2e-3 and rtol 8e-3, for
sliding-window attention).

The SSD scan's tensor-core route is emulated by ``emulate_ssd_tc`` of
``torch_ssd_emulation.py`` (no JAX there, so that it also runs on the
card), held to the Pallas kernel and the JAX oracle at test_ssd_scan's
2e-3 and, at Mamba2-130M's and Hymba-1.5B's widths, to a float64 run of
the plain version: no farther from it than the float32 cumsum order.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops
from repro.kernels import ref as JR
from repro_torch.kernels import ops
from repro_torch.kernels import ref as R
from torch_ssd_emulation import (emulate_ssd_cumsum_f32, emulate_ssd_tc,
                                 emulate_ssd_terms, ssd_inputs)

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


# The bf16 paged-prefill kernel's arithmetic (csrc/paged_prefill.cu,
# paged_prefill_tc_kernel), emulated in plain torch: rows r = j * G + g in
# tiles of 64, keys in tiles of 64 up to the row tile's largest q_pos, S in
# f32 from bf16 inputs, online softmax with the running max m in raw score
# units and p = 2^(s c - m c), c = log2(e) / sqrt(D), masked probabilities
# set to 0, P split into bf16 hi and lo parts, f32 accumulation, one
# division by max(l, 1e-20) and one bf16 rounding. With scales (int8
# pages, B10): K and V are the pages' integers (exact in bf16), S is
# multiplied by the key's k_scale before the mask, l sums the unscaled p
# and P V takes p * v_scale[key] before the hi/lo split.
NEG_INF = -1e30


def _online_step(s, keep, m, l, o, vt, scale, vsc=None):
    """One 64-key tile of the tensor-core kernels' loop over scores s
    (heads, rows, keys) with visibility keep: the new (m, l, o)."""
    s = torch.where(keep, s, torch.tensor(NEG_INF))
    m_new = torch.maximum(m, s.amax(-1))
    alpha = torch.exp2((m - m_new) * scale)
    p = torch.where(keep, torch.exp2(
        s * scale - (m_new * scale)[..., None]), torch.zeros(()))
    l = l * alpha + p.sum(-1)
    if vsc is not None:
        p = p * vsc
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()
    o = o * alpha[..., None] + torch.einsum("krt,tkd->krd", hi, vt) \
        + torch.einsum("krt,tkd->krd", lo, vt)
    return m_new, l, o


def emulate_prefill_tc(q, k_pages, v_pages, tables, q_pos, k_scale=None,
                       v_scale=None):
    b, c, h, d = q.shape
    _, bs, hkv, _ = k_pages.shape
    g, rows = h // hkv, c * (h // hkv)
    scale = torch.tensor(1.4426950408889634 / np.sqrt(d), dtype=torch.float32)
    qr = q.float().reshape(b, c, hkv, g, d).permute(0, 2, 1, 3, 4) \
        .reshape(b, hkv, rows, d)
    qpr = q_pos.long()[:, :, None].expand(b, c, g).reshape(b, rows)
    out = torch.zeros(b, hkv, rows, d)
    for bi in range(b):
        for r0 in range(0, rows, 64):
            r = slice(r0, min(rows, r0 + 64))
            qp = qpr[bi, r]
            n_tok = min(int(qp.max()) + 1, tables.shape[1] * bs)
            m = torch.full((hkv, qp.shape[0]), NEG_INF)
            l = torch.zeros(hkv, qp.shape[0])
            o = torch.zeros(hkv, qp.shape[0], d)
            for t0 in range(0, n_tok, 64):
                keys = torch.arange(t0, t0 + 64)
                ok = keys < n_tok               # later rows are zero-filled
                pg = tables[bi].long()[torch.where(ok, keys // bs, 0)]
                kt = k_pages[pg, keys % bs].float() * ok[:, None, None]
                vt = v_pages[pg, keys % bs].float() * ok[:, None, None]
                keep = (keys[None, :] <= qp[:, None]) & ok[None, :]
                s = torch.einsum("krd,tkd->krt", qr[bi, :, r], kt)
                vsc = None
                if k_scale is not None:     # (hkv, 1, keys), 0 past n_tok
                    s = s * (k_scale[pg] * ok[:, None]).T[:, None, :]
                    vsc = (v_scale[pg] * ok[:, None]).T[:, None, :]
                m, l, o = _online_step(s, keep, m, l, o, vt, scale, vsc)
            out[bi, :, r] = o / torch.clamp(l, min=1e-20)[..., None]
    return out.reshape(b, hkv, c, g, d).permute(0, 2, 1, 3, 4) \
        .reshape(b, c, h, d).to(q.dtype)


@pytest.mark.parametrize("b,c,h,hkv,d,bs,p", [
    (2, 12, 10, 2, 32, 8, 6),    # G = 5, C * G = 60: one ragged row tile
    (2, 20, 8, 1, 32, 8, 12),    # G = 8: three row tiles, two key tiles
    (3, 9, 2, 2, 16, 12, 10),    # G = 1, a block size that splits tiles
])
def test_prefill_tc_emulation_matches_pallas(b, c, h, hkv, d, bs, p):
    """The emulated bf16 kernel against the Pallas kernel (interpret mode)
    and the JAX oracle, at the bf16 attention tolerance of this file."""
    rng = np.random.default_rng(13)
    n = p * b + 2
    q, tq = pair(rng.standard_normal((b, c, h, d)), "bf16")
    kp, tkp = pair(rng.standard_normal((n, bs, hkv, d)), "bf16")
    vp, tvp = pair(rng.standard_normal((n, bs, hkv, d)), "bf16")
    bt, tbt = ints(rng.integers(0, n, (b, p)))
    qpos = np.full((b, c), -1, np.int32)
    for i in range(b - 1):
        start = int(rng.integers(0, p * bs - c))
        valid = int(rng.integers(1, c + 1))
        qpos[i, :valid] = start + np.arange(valid)
    qpos[0, -1] = p * bs - 1              # the table's last key
    qp, tqp = ints(qpos)
    got = emulate_prefill_tc(tq, tkp, tvp, tbt, tqp)
    np.testing.assert_allclose(
        npf(got), npf(jops.paged_prefill_attention(q, kp, vp, bt, qp)),
        **tol("bf16"))
    np.testing.assert_allclose(
        npf(got), npf(JR.paged_prefill_attention_ref(q, kp, vp, bt, qp)),
        **tol("bf16"))
    assert not npf(got)[qpos < 0].any()


@pytest.mark.parametrize("p", [64, 16])
def test_prefill_tc_emulation_at_main_path_shape(p):
    """At the main path's shape (Qwen2.5-14B: B 8, C 32, H 40, Hkv 8,
    D 128, bs 16; the last chunk of a 64-page / 16-page context, the last
    row padded), the emulated bf16 kernel stays within chip_smoke.py's
    bf16 tolerance (atol = rtol = 2e-3) of the plain version: the hi/lo
    split of P keeps it about one bf16 step of the output or less."""
    b, c, h, hkv, d, bs = 8, 32, 40, 8, 128, 16
    gen = torch.Generator().manual_seed(0)
    n = b * p + 1
    kp, vp = (torch.randn(n, bs, hkv, d, generator=gen).bfloat16()
              for _ in "kv")
    q = torch.randn(b, c, h, d, generator=gen).bfloat16()
    rng = np.random.default_rng(0)
    tables = torch.from_numpy(
        rng.permutation(b * p).reshape(b, p).astype(np.int32))
    qpos = np.full((b, c), -1, np.int32)
    qpos[:b - 1] = p * bs - c + np.arange(c)
    qp = torch.from_numpy(qpos)
    got = emulate_prefill_tc(q, kp, vp, tables, qp)
    want = R.paged_prefill_attention_ref(q, kp, vp, tables, qp)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-3,
                               rtol=2e-3)
    assert not got[-1].any()


def _spread_int8_pool(gen, shape):
    """int8 pages and (N, Hkv) float32 scales quantized by the plain
    version from normal pages whose magnitude differs by page and kv head
    (0.3x to 3x), as ``test_torch_gpu.py``'s int8 pools."""
    n, _, hkv, _ = shape
    mag = 10.0 ** (torch.rand((n, 1, hkv, 1), generator=gen) - 0.5)
    return R.quantize_block_ref(torch.randn(shape, generator=gen) * mag)


@pytest.mark.parametrize("b,c,h,hkv,d,bs,p", [   # test_quant_kernels.py
    (1, 4, 4, 4, 32, 8, 3),
    (3, 8, 8, 2, 64, 16, 5),
    (2, 5, 5, 5, 16, 8, 4),
])
def test_prefill_tc_int8_emulation_matches_pallas(b, c, h, hkv, d, bs, p):
    """The emulated bf16 kernel over int8 pages (B10) against the Pallas
    kernel (interpret mode) and the JAX oracle, at the bf16 attention
    tolerance of this file."""
    rng = np.random.default_rng(8)
    n = p * b + 4
    q, tq = pair(rng.standard_normal((b, c, h, d)), "bf16")
    _, (kq, tkq), (ks, tks) = int8_pool(rng, (n, bs, hkv, d))
    _, (vq, tvq), (vs, tvs) = int8_pool(rng, (n, bs, hkv, d))
    bt, tbt = ints(rng.integers(0, n, (b, p)))
    qpos = rng.integers(-1, p * bs, (b, c)).astype(np.int32)
    qp, tqp = ints(qpos)
    got = emulate_prefill_tc(tq, tkq, tvq, tbt, tqp, tks, tvs)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        npf(got),
        npf(jops.paged_prefill_attention_quant(q, kq, vq, ks, vs, bt, qp)),
        **tol("bf16"))
    np.testing.assert_allclose(
        npf(got),
        npf(JR.paged_prefill_attention_quant_ref(q, kq, vq, ks, vs, bt, qp)),
        **tol("bf16"))
    assert not npf(got)[qpos < 0].any()


@pytest.mark.parametrize("spread", [False, True])
@pytest.mark.parametrize("p", [64, 16])
def test_prefill_tc_int8_emulation_at_main_path_shape(p, spread):
    """At the main path's shape (as test_prefill_tc_emulation_at_main_path_
    shape), the emulated int8 instantiation against the plain version,
    which dequantizes in f32 first: the scales folded into S and P in f32
    cost no bf16 rounding. Over unit-normal pages quantized per (page, kv
    head), chip_smoke.py's data, it stays within chip_smoke.py's bf16
    tolerance (atol = rtol = 2e-3). With magnitudes spread 0.3x to 3x per
    (page, kv head), as test_torch_gpu.py's int8 pools, outputs reach 2-4,
    where one bf16 step of the output is 2**-7 of it: that case takes the
    card tests' one-step tolerance (atol 2e-3, rtol 8e-3)."""
    b, c, h, hkv, d, bs = 8, 32, 40, 8, 128, 16
    gen = torch.Generator().manual_seed(0)
    n = b * p + 1
    if spread:
        (kq, ks), (vq, vs) = (_spread_int8_pool(gen, (n, bs, hkv, d))
                              for _ in "kv")
    else:
        (kq, ks), (vq, vs) = (R.quantize_block_ref(torch.randn(
            n, bs, hkv, d, generator=gen).bfloat16()) for _ in "kv")
    q = torch.randn(b, c, h, d, generator=gen).bfloat16()
    rng = np.random.default_rng(0)
    tables = torch.from_numpy(
        rng.permutation(b * p).reshape(b, p).astype(np.int32))
    qpos = np.full((b, c), -1, np.int32)
    qpos[:b - 1] = p * bs - c + np.arange(c)
    qp = torch.from_numpy(qpos)
    got = emulate_prefill_tc(q, kq, vq, tables, qp, ks, vs)
    want = R.paged_prefill_attention_quant_ref(q, kq, vq, ks, vs, tables,
                                               qp)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-3,
                               rtol=8e-3 if spread else 2e-3)
    assert not got[-1].any()


# The bf16 split-context decode kernel's arithmetic (csrc/paged_attention.cu,
# paged_decode_tc_kernel), emulated in plain torch: each (sequence, kv
# head) context cut into `splits` runs of ceil(tiles / splits) 64-key
# tiles of the table, the G query heads padded with zero rows to 16, each
# run's tiles through the online step of the paged-prefill emulation (keys
# past context_len zero and masked), then the f32 combine of the runs'
# partials with m in raw score units: m* = max m_s, weights 2^((m_s - m*)
# c), O = sum w O_s / max(sum w l_s, 1e-20), rounded once. A run that
# starts at or past context_len is empty (m = NEG_INF, l = 0, O = 0).
def emulate_decode_tc(q, k_pages, v_pages, tables, context_lens, splits,
                      k_scale=None, v_scale=None):
    b, h, d = q.shape
    _, bs, hkv, _ = k_pages.shape
    g = h // hkv
    scale = torch.tensor(1.4426950408889634 / np.sqrt(d), dtype=torch.float32)
    n_tiles = -(-tables.shape[1] * bs // 64)
    run = max(1, -(-n_tiles // splits)) * 64          # keys per run
    qr = torch.zeros(b, hkv, 16, d)
    qr[:, :, :g] = q.float().reshape(b, hkv, g, d)
    out = torch.zeros(b, hkv, g, d)
    for bi in range(b):
        n_tok = max(0, min(int(context_lens[bi]), tables.shape[1] * bs))
        parts = []
        for s_ in range(splits):
            m = torch.full((hkv, 16), NEG_INF)
            l, o = torch.zeros(hkv, 16), torch.zeros(hkv, 16, d)
            t_end = min(n_tok, (s_ + 1) * run)
            for t0 in range(s_ * run, t_end, 64):
                keys = torch.arange(t0, t0 + 64)
                ok = keys < t_end
                pg = tables[bi].long()[torch.where(ok, keys // bs, 0)]
                kt = k_pages[pg, keys % bs].float() * ok[:, None, None]
                vt = v_pages[pg, keys % bs].float() * ok[:, None, None]
                s = torch.einsum("krd,tkd->krt", qr[bi], kt)
                vsc = None
                if k_scale is not None:     # (hkv, 1, keys), 0 past t_end
                    s = s * (k_scale[pg] * ok[:, None]).T[:, None, :]
                    vsc = (v_scale[pg] * ok[:, None]).T[:, None, :]
                m, l, o = _online_step(s, ok[None, None, :], m, l, o, vt,
                                       scale, vsc)
            parts.append((m, l, o))
        ms = torch.stack([x[0] for x in parts])
        w = torch.exp2((ms - ms.amax(0)) * scale)
        lsum = (torch.stack([x[1] for x in parts]) * w).sum(0)
        osum = (torch.stack([x[2] for x in parts]) * w[..., None]).sum(0)
        out[bi] = (osum / torch.clamp(lsum, min=1e-20)[..., None])[:, :g]
    return out.reshape(b, h, d).to(q.dtype)


def _decode_lens(rng, b, p, bs):
    """Context lengths of a decode sweep: random, one row of the whole
    table, the last row padded (context_lens = 0)."""
    lens = rng.integers(1, p * bs + 1, b)
    lens[0], lens[-1] = p * bs, 0
    return lens


@pytest.mark.parametrize("splits", [1, 2, 7])
@pytest.mark.parametrize("b,h,hkv,d,bs,p", [
    (3, 4, 4, 32, 8, 12),        # G = 1: 96-token tables, two tiles
    (3, 8, 2, 64, 16, 5),        # G = 4 (test_kernels.py)
    (3, 10, 2, 32, 16, 12),      # G = 5, as Qwen2.5-14B: three tiles
])
def test_decode_tc_emulation_matches_pallas(b, h, hkv, d, bs, p, splits):
    """The emulated bf16 split-context decode kernel against the Pallas
    kernel (interpret mode) and the JAX oracle at the bf16 attention
    tolerance of this file, with one run, two runs and more runs than a
    row has tiles (empty runs); the padded row is exact zeros. The JAX
    oracle averages uniformly over a row with context_lens = 0, so that
    row is held to the Pallas kernel only."""
    rng = np.random.default_rng(14)
    n = p * b + 2
    q, tq = pair(rng.standard_normal((b, h, d)), "bf16")
    kp, tkp = pair(rng.standard_normal((n, bs, hkv, d)), "bf16")
    vp, tvp = pair(rng.standard_normal((n, bs, hkv, d)), "bf16")
    bt, tbt = ints(rng.integers(0, n, (b, p)))
    cl, tcl = ints(_decode_lens(rng, b, p, bs))
    got = emulate_decode_tc(tq, tkp, tvp, tbt, tcl, splits)
    np.testing.assert_allclose(
        npf(got), npf(jops.paged_attention(q, kp, vp, bt, cl)),
        **tol("bf16"))
    np.testing.assert_allclose(
        npf(got)[:-1], npf(JR.paged_attention_ref(q, kp, vp, bt, cl))[:-1],
        **tol("bf16"))
    assert not npf(got)[-1].any()


@pytest.mark.parametrize("splits", [1, 2, 7])
@pytest.mark.parametrize("b,h,hkv,d,bs,p", [   # test_quant_kernels.py
    (3, 4, 4, 32, 8, 12),
    (3, 8, 2, 64, 16, 5),
    (3, 10, 2, 32, 16, 12),
])
def test_decode_tc_int8_emulation_matches_pallas(b, h, hkv, d, bs, p,
                                                 splits):
    """The emulated bf16 split-context decode kernel over int8 pages (B9)
    against the Pallas kernel (interpret mode) and the JAX oracle, at the
    bf16 attention tolerance of this file; the padded row is exact
    zeros."""
    rng = np.random.default_rng(15)
    n = p * b + 4
    q, tq = pair(rng.standard_normal((b, h, d)), "bf16")
    _, (kq, tkq), (ks, tks) = int8_pool(rng, (n, bs, hkv, d))
    _, (vq, tvq), (vs, tvs) = int8_pool(rng, (n, bs, hkv, d))
    bt, tbt = ints(rng.integers(0, n, (b, p)))
    cl, tcl = ints(_decode_lens(rng, b, p, bs))
    got = emulate_decode_tc(tq, tkq, tvq, tbt, tcl, splits, tks, tvs)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        npf(got),
        npf(jops.paged_attention_quant(q, kq, vq, ks, vs, bt, cl)),
        **tol("bf16"))
    np.testing.assert_allclose(
        npf(got)[:-1],
        npf(JR.paged_attention_quant_ref(q, kq, vq, ks, vs, bt, cl))[:-1],
        **tol("bf16"))
    assert not npf(got)[-1].any()


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("p,splits", [(64, 6), (16, 4)])
def test_decode_tc_emulation_at_main_path_shape(p, splits, quant):
    """At the main path's decode shape (Qwen2.5-14B: B 8, H 40, Hkv 8, D
    128, bs 16; 64-page tables in 6 runs of 3 tiles and 16-page tables in
    4 runs of 1 tile, the split counts of an H100), with contexts that are
    no multiple of 64 and the last row padded, the emulated split-context
    kernel over bf16 pools (B2) and over int8 pages quantized per (page,
    kv head) (B9) stays within chip_smoke.py's bf16 tolerance (atol = rtol
    = 2e-3) of the plain version."""
    b, h, hkv, d, bs = 8, 40, 8, 128, 16
    gen = torch.Generator().manual_seed(0)
    n = b * p + 1
    kp, vp = (torch.randn(n, bs, hkv, d, generator=gen).bfloat16()
              for _ in "kv")
    q = torch.randn(b, h, d, generator=gen).bfloat16()
    rng = np.random.default_rng(0)
    tables = torch.from_numpy(
        rng.permutation(b * p).reshape(b, p).astype(np.int32))
    lens = np.array([1, 63, 65, 200, p * bs - 1, p * bs - 37, p * bs, 0])
    cl = torch.from_numpy(lens.astype(np.int32))
    if quant:
        (kq, ks), (vq, vs) = (R.quantize_block_ref(x) for x in (kp, vp))
        got = emulate_decode_tc(q, kq, vq, tables, cl, splits, ks, vs)
        want = R.paged_attention_quant_ref(q, kq, vq, ks, vs, tables, cl)
    else:
        got = emulate_decode_tc(q, kp, vp, tables, cl, splits)
        want = R.paged_attention_ref(q, kp, vp, tables, cl)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-3,
                               rtol=2e-3)
    assert not got[-1].any()


# The bf16 sliding-window kernel's arithmetic (csrc/swa_attention.cu,
# swa_attention_tc_kernel), emulated in plain torch: query tiles of 64,
# each walking the 64-key tiles from floor(max(0, q0 - window + 1) / 64) *
# 64 to its last query, keys past S zero, the mask key <= i, key > i -
# window, key < S, and the online step of the paged-prefill emulation
# (all heads at once).
def emulate_swa_tc(q, k, v, window):
    b, s, h, d = q.shape
    window = min(int(window), s)
    scale = torch.tensor(1.4426950408889634 / np.sqrt(d), dtype=torch.float32)
    qf, kf, vf = (x.float() for x in (q, k, v))
    out = torch.zeros(b, h, s, d)
    for bi in range(b):
        for q0 in range(0, s, 64):
            rows = torch.arange(q0, min(q0 + 64, s))
            m = torch.full((h, rows.numel()), NEG_INF)
            l = torch.zeros(h, rows.numel())
            o = torch.zeros(h, rows.numel(), d)
            t_first = max(0, q0 - window + 1) // 64 * 64
            for t0 in range(t_first, int(rows[-1]) + 1, 64):
                keys = torch.arange(t0, t0 + 64)
                ok = keys < s
                idx = torch.where(ok, keys, 0)
                kt = kf[bi, idx] * ok[:, None, None]
                vt = vf[bi, idx] * ok[:, None, None]
                keep = (keys[None, :] <= rows[:, None]) \
                    & (keys[None, :] > rows[:, None] - window) & ok[None, :]
                sc = torch.einsum("rkd,tkd->krt", qf[bi, rows], kt)
                m, l, o = _online_step(sc, keep, m, l, o, vt, scale)
            out[bi, :, q0:q0 + rows.numel()] = \
                o / torch.clamp(l, min=1e-20)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


@pytest.mark.parametrize("s,w,qb", [(128, 32, 64), (256, 96, 64),
                                    (128, 128, 128)])   # test_kernels.py
def test_swa_tc_emulation_matches_pallas(s, w, qb):
    """The emulated bf16 sliding-window kernel against the Pallas kernel
    (interpret mode) and the JAX oracle, at the bf16 attention tolerance
    of this file."""
    rng = np.random.default_rng(11)
    (q, tq), (k, tk), (v, tv) = (pair(rng.standard_normal((2, s, 3, 32)),
                                      "bf16") for _ in "qkv")
    got = emulate_swa_tc(tq, tk, tv, w)
    assert got.dtype == torch.bfloat16
    for want in (jops.swa_attention(q, k, v, w, q_block=qb, kv_block=qb),
                 JR.swa_attention_ref(q, k, v, w)):
        np.testing.assert_allclose(npf(got), npf(want), **tol("bf16"))


def test_swa_tc_emulation_at_hymba_widths():
    """At Hymba-1.5B's widths (H 25, D 64) with B 1, S 512 and a window of
    192 (three key tiles, not a multiple of 64), the emulated kernel stays
    within one bf16 step of the plain version (chip_smoke.py's
    TOL_ONE_STEP: atol 2e-3, rtol 8e-3). S is cut from Hymba's 2048 only
    because the plain version holds (B, H, S, S) f32 scores; chip_smoke.py
    checks the full shape on the card."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 512, 25, 64, generator=gen).bfloat16()
               for _ in "qkv")
    got = emulate_swa_tc(q, k, v, 192)
    want = R.swa_attention_ref(q, k, v, 192)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-3,
                               rtol=8e-3)


def _ssd_inputs(rng, b, s, h, p, n, dt, a_scale=None):
    """test_ssd_scan's inputs as (JAX, torch) pairs, x in ``dt``; with
    a_scale, A = -(1 .. a_scale) over the heads as chip_smoke.py draws
    it."""
    x, *rest = ssd_inputs(rng, b, s, h, p, n, a_scale)
    return (pair(x, dt), *(pair(t, "f32") for t in rest))


def test_meta_inputs_take_the_plain_route():
    """Meta tensors (the dry-run's) take the plain versions, launch
    nothing and give meta outputs of the kernels' shapes; meta beside the
    CPU still raises (``test_mixed_devices_raise``)."""
    ops.reset_launches()
    pools = torch.empty((2, 5, 4, 2, 8), device="meta")
    idx = torch.empty((3,), dtype=torch.int32, device="meta")
    out = ops.block_gather_layers(pools, idx)
    assert out.is_meta and out.shape == (2, 3, 4, 2, 8)
    qkv = torch.empty((1, 128, 2, 16), device="meta")
    assert ops.swa_attention(qkv, qkv, qkv, 32).shape == qkv.shape
    x = torch.empty((1, 128, 2, 8), device="meta")
    dt = torch.empty((1, 128, 2), device="meta")
    bc = torch.empty((1, 128, 4), device="meta")
    y, st = ops.ssd_scan(x, dt, dt, bc, bc, chunk=64)
    assert y.is_meta and y.shape == x.shape and st.shape == (1, 2, 8, 4)
    assert not any(ops.launches.values())


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("s,q", [(64, 16), (128, 64), (96, 32)])
@pytest.mark.parametrize("h,p,n", [(2, 8, 4), (3, 16, 8)])
def test_ssd_tc_emulation_matches_pallas(dt, s, q, h, p, n):
    """The emulated tensor-core SSD scan against the Pallas kernel
    (interpret mode) and the JAX oracle on test_ssd_scan's inputs and at
    its 2e-3 tolerance."""
    (x, tx), (jdt, tdt), (ja, ta), (jb, tb), (jc, tc) = _ssd_inputs(
        np.random.default_rng(10), 2, s, h, p, n, dt)
    y, st = emulate_ssd_tc(tx, tdt, ta, tb, tc, chunk=q)
    for want_y, want_s in (jops.ssd_scan(x, jdt, ja, jb, jc, chunk=q),
                           JR.ssd_scan_ref(x, jdt, ja, jb, jc)):
        np.testing.assert_allclose(npf(y), npf(want_y), atol=2e-3, rtol=2e-3)
        np.testing.assert_allclose(npf(st), npf(want_s), atol=2e-3,
                                   rtol=2e-3)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("h,n,a_scale", [(24, 128, 24), (50, 16, 50)])
def test_ssd_tc_emulation_at_model_widths(dt, h, n, a_scale):
    """At Mamba2-130M's widths (H 24, P 64, N 128, A down to -24) and
    Hymba-1.5B's (H 50, N 16, A down to -50), B 1, S 256: the emulated
    tensor-core scan is no farther from a float64 run of the plain version
    than the float32 chunked scan that takes differences of the in-chunk
    cumsum (the scalar route's and the Pallas kernel's order), and within
    2e-3 of the float32 plain version."""
    (_, x), (_, dtv), (_, av), (_, bm), (_, cm) = _ssd_inputs(
        np.random.default_rng(22), 1, 256, h, 64, n, dt, a_scale)
    want = R.ssd_scan_ref(x, dtv, av, bm, cm, dtype=torch.float64)

    def err(got):
        return max(float((g.double() - w).abs().max())
                   for g, w in zip(got, want))

    got = emulate_ssd_tc(x, dtv, av, bm, cm)
    assert err(got) <= err(emulate_ssd_cumsum_f32(x, dtv, av, bm, cm))
    for g, w in zip(got, R.ssd_scan_ref(x, dtv, av, bm, cm)):
        torch.testing.assert_close(g, w, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_ssd_emulation_in_float64_is_the_scan(dt):
    """Unsplit and in float64 (``parts=None``), the emulation's two terms
    of y sum to a float64 run of the plain version, and its final state
    equals that run's, within 1e-10: the per-term reference that
    tools/ssd_breakdown.py holds the kernel's terms to computes the
    scan."""
    (_, x), (_, dtv), (_, av), (_, bm), (_, cm) = _ssd_inputs(
        np.random.default_rng(24), 2, 128, 3, 16, 8, dt, 24)
    intra, inter, st = emulate_ssd_terms(x, dtv, av, bm, cm, parts=None)
    want_y, want_st = R.ssd_scan_ref(x, dtv, av, bm, cm,
                                     dtype=torch.float64)
    assert intra.dtype == inter.dtype == st.dtype == torch.float64
    torch.testing.assert_close(intra + inter, want_y, atol=1e-10, rtol=0)
    torch.testing.assert_close(st, want_st, atol=1e-10, rtol=0)


def test_ssd_tc_emulation_masked_triangle_stays_finite():
    """dt up to 8 and A = -24 drive the chunk's cumulative decay to about
    -10^4, where exp of any difference above the diagonal would overflow:
    the emulated kernel's outputs stay finite and match the plain
    version."""
    rng = np.random.default_rng(23)
    (_, x), (_, dtv), _, (_, bm), (_, cm) = _ssd_inputs(
        rng, 1, 128, 4, 64, 32, "f32")
    dtv = dtv * 4.0
    av = dtv * -24.0
    got = emulate_ssd_tc(x, dtv, av, bm, cm)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    for g, w in zip(got, R.ssd_scan_ref(x, dtv, av, bm, cm)):
        torch.testing.assert_close(g, w, atol=2e-3, rtol=2e-3)


def test_ssd_tc_emulation_in_hymba_smoke_model(monkeypatch):
    """The float32 Hymba smoke model, whose SSD scans take the tensor-core
    route on the card (P 64, N 16; 150 tokens padded to the 64-token
    chunk): prefill with the emulated kernel in place of the plain scan
    keeps the logits and every cache within 1e-4 of the plain run, the
    tolerance of tests/test_torch_gpu.py's card-vs-CPU check."""
    import dataclasses

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_smoke_config("hymba_1_5b"),
                              dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 150)), dtype=torch.int32)
    want_logits, want_cache = M.prefill(cfg, params, {"tokens": toks}, 160)
    calls = []

    def scan(x, dt, a, b, c, chunk=64):
        calls.append((x.shape[-1], b.shape[-1], chunk))
        return emulate_ssd_tc(x, dt, a, b, c, chunk)

    monkeypatch.setattr(ops, "ssd_scan", scan)
    logits, cache = M.prefill(cfg, params, {"tokens": toks}, 160)
    assert calls == [(64, 16, 64)] * cfg.num_layers
    torch.testing.assert_close(logits, want_logits, atol=1e-4, rtol=1e-4)
    for k in want_cache:
        torch.testing.assert_close(cache[k], want_cache[k], atol=1e-4,
                                   rtol=1e-4)


def test_lib_path_hashes_every_header(tmp_path, monkeypatch):
    """An edit to any csrc/*.cuh header, not only common.cuh, gives a new
    library path, so a stale build is never reused."""
    from repro_torch.kernels import build
    for f in ("common.cuh", "mma.cuh", "a.cu"):
        (tmp_path / f).write_text(f)
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.lib_path("a")
    (tmp_path / "mma.cuh").write_text("edited")
    second = build.lib_path("a")
    (tmp_path / "new.cuh").write_text("new")
    assert len({first, second, build.lib_path("a")}) == 3
    assert first.name.startswith("a-")


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


# ---------------------------------------------------------------------------
# B1 / B3 fused with the RoPE of q and k: against the JAX model's
# apply_rope followed by the Pallas writes
# ---------------------------------------------------------------------------

def _step(a, bits):
    """One step of a float with ``bits`` explicit mantissa bits at |a|."""
    _, e = np.frexp(np.abs(np.asarray(a, np.float64)))
    return np.ldexp(1.0, e - 1 - bits)


def assert_rope_close(got, want, dt, scale):
    """RoPE outputs of the port against JAX's on the CPU. float32: within
    4 ulps of ``scale``, the inputs' largest magnitude: JAX's and torch's
    CPU cos and sin (and, at D 128 and theta 1e6, one frequency) differ by
    one ulp on some angles, which moves an output by about |x| ulps of 1.
    bfloat16: within one bf16 step of the output, plus that float32 bound,
    which only outputs below ~2**-12 can reach (there a float32 difference
    spans several bf16 steps)."""
    got, want = npf(got).astype(np.float64), npf(want).astype(np.float64)
    bound = 4 * 2.0 ** -23 * scale
    if dt == "bf16":
        bound = bound + np.maximum(_step(got, 7), _step(want, 7))
    bad = np.abs(got - want) > bound
    assert not bad.any(), (f"{int(bad.sum())} of {bad.size} outside the "
                           f"bound; max abs {np.abs(got - want).max():.3g}")


def _jax_rope(x, pos, theta):
    from repro.models import layers as JL
    return JL.apply_rope(x, pos, theta)


ROPE_SHAPES = [(16, 1e4), (64, 1e6), (128, 1e6)]     # (D, theta)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("d,theta", ROPE_SHAPES)
def test_rope_kv_token_write(dt, d, theta):
    """Four live rows at positions 0, 4096 and two random ones, then two
    padded rows into the scratch slot; G = 4."""
    rng = np.random.default_rng(11)
    n, bs, h, hkv, b = 9, 8, 8, 2, 6
    scratch = (n - 1) * bs
    x = [rng.standard_normal(s) for s in ((b, h, d), (b, hkv, d),
                                          (b, hkv, d))]
    (q, tq), (k, tk), (v, tv) = (pair(a, dt) for a in x)
    kp, tkp = pair(rng.standard_normal((n, bs, hkv, d)), dt)
    vp, tvp = pair(rng.standard_normal((n, bs, hkv, d)), dt)
    live = rng.choice(scratch, b - 2, replace=False)
    sl, tsl = ints(np.concatenate([live, [scratch, scratch]]))
    positions = np.array([0, 4096, *rng.integers(1, 4096, b - 2)])
    pos, tpos = ints(positions)
    wq = _jax_rope(q[:, None], pos[:, None], theta)[:, 0]
    wk, wv = jops.kv_token_write(
        kp, vp, _jax_rope(k[:, None], pos[:, None], theta)[:, 0], v, sl)
    got = ops.rope_kv_token_write(tq, tk, tv, tkp, tvp, tsl, tpos, theta)
    scale = max(np.abs(a).max() for a in x)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    assert_rope_close(got, wq, dt, scale)
    assert_rope_close(npf(tkp)[:-1], npf(wk)[:-1], dt, scale)
    np.testing.assert_array_equal(npf(tvp)[:-1], npf(wv)[:-1])
    # the pools really changed, and the inputs did not
    assert not np.array_equal(npf(tkp)[:-1], npf(kp)[:-1])
    np.testing.assert_array_equal(npf(tk), npf(k))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("d,theta", ROPE_SHAPES)
def test_rope_kv_chunk_write(dt, d, theta):
    """Row 0 starts mid-page and crosses two page boundaries at positions
    up to 4096; row 1 starts page-aligned with 3 tokens, the rest padded
    queries (q_pos = -1, roped at position 0 after the clamp); row 2 is a
    padded row (wcount = 0); row 3 starts mid-page with its last two
    tokens padded."""
    rng = np.random.default_rng(12)
    n, bs, h, hkv, c = 14, 4, 4, 2, 10
    scratch = n - 1
    pp = (c - 1) // bs + 2
    x = [rng.standard_normal(s) for s in ((4, c, h, d), (4, c, hkv, d),
                                          (4, c, hkv, d))]
    (q, tq), (k, tk), (v, tv) = (pair(a, dt) for a in x)
    kp, tkp = pair(rng.standard_normal((n, bs, hkv, d)), dt)
    vp, tvp = pair(rng.standard_normal((n, bs, hkv, d)), dt)
    wpages = np.full((4, pp), scratch, np.int32)
    wpages[0, :3] = [7, 2, 5]
    wpages[1, :1] = [9]
    wpages[3, :3] = [11, 0, 12]
    wp, twp = ints(wpages)
    ws, tws = ints([3, 0, 0, 1])
    wc, twc = ints([c, 3, 0, c - 2])
    qpos = np.full((4, c), -1)
    qpos[0] = 4096 - c + 1 + np.arange(c)          # up to 4096
    qpos[1, :3] = np.arange(3)
    qpos[3, :c - 2] = 1001 + np.arange(c - 2)
    pos, tpos = ints(np.maximum(qpos, 0))
    wq, kr = _jax_rope(q, pos, theta), _jax_rope(k, pos, theta)
    wk, wv = jops.kv_chunk_write(kp, vp, kr, v, wp, ws, wc)
    got = ops.rope_kv_chunk_write(tq, tk, tv, tkp, tvp, twp, tws, twc, tpos,
                                  theta)
    scale = max(np.abs(a).max() for a in x)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    assert_rope_close(got, wq, dt, scale)        # every token, padded too
    assert_rope_close(npf(tkp)[:-1], npf(wk)[:-1], dt, scale)
    np.testing.assert_array_equal(npf(tvp)[:-1], npf(wv)[:-1])
    # the spill crossed pages: page 2 holds row 0's tokens 1..4, roped
    np.testing.assert_array_equal(npf(tvp)[2], npf(tv)[0, 1:5])
    assert_rope_close(npf(tkp)[2], npf(kr)[0, 1:5], dt, scale)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rope_writes_equal_rope_then_write(dt):
    """On the CPU each fused entry is exactly the model's apply_rope on q
    and k followed by the standalone write: the decoder's old path."""
    from repro_torch.models import layers as L
    gen = torch.Generator().manual_seed(0)
    td = DTYPES[dt][1]
    b, c, h, hkv, d, n, bs = 3, 5, 4, 2, 32, 8, 4

    def rand(*shape):
        return torch.randn(shape, generator=gen).to(td)

    q, k, v = rand(b, h, d), rand(b, hkv, d), rand(b, hkv, d)
    pools = [rand(n, bs, hkv, d) for _ in "kv"]
    want = [p.clone() for p in pools]
    slots = torch.tensor([5, 17, 28], dtype=torch.int32)
    pos = torch.tensor([3, 700, 0], dtype=torch.int32)
    got_q = ops.rope_kv_token_write(q, k, v, *pools, slots, pos, 1e6)
    ops.kv_token_write(*want, L.apply_rope(k, pos, 1e6), v, slots)
    assert torch.equal(got_q, L.apply_rope(q, pos, 1e6))
    assert all(torch.equal(g, w) for g, w in zip(pools, want))

    q, k, v = rand(b, c, h, d), rand(b, c, hkv, d), rand(b, c, hkv, d)
    wp = torch.tensor([[1, 2, 7], [3, 4, 7], [7, 7, 7]], dtype=torch.int32)
    ws = torch.tensor([2, 0, 0], dtype=torch.int32)
    wc = torch.tensor([c, 4, 0], dtype=torch.int32)
    pos = torch.arange(c, dtype=torch.int32)[None].repeat(b, 1) * 9
    got_q = ops.rope_kv_chunk_write(q, k, v, *pools, wp, ws, wc, pos, 1e4)
    ops.kv_chunk_write(*want, L.apply_rope(k, pos, 1e4), v, wp, ws, wc)
    assert torch.equal(got_q, L.apply_rope(q, pos, 1e4))
    assert all(torch.equal(g, w) for g, w in zip(pools, want))


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


# ---------------------------------------------------------------------------
# int8 host tier: B7, B8, B11, B12
# ---------------------------------------------------------------------------

def scaled(rng, shape):
    """Unit normals times one random scale per case, as float32: the
    scale moves where ``x / scale`` lands relative to the rounding ties."""
    return (10.0 ** rng.uniform(-2, 2)
            * rng.standard_normal(shape)).astype(np.float32)


def assert_quant_equal(q, s, want_q, want_s):
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))


def assert_quant_near_pallas(q, s, pallas_q, pallas_s):
    # the jitted Pallas kernels compute the scale as amax * (1/127) (XLA
    # rewrites the division by a constant), one ulp off the oracle in some
    # blocks, which moves a rare payload element by one step
    np.testing.assert_allclose(s.numpy(), np.asarray(pallas_s), rtol=1e-6,
                               atol=0)
    step = np.abs(q.numpy().astype(np.int16)
                  - np.asarray(pallas_q).astype(np.int16))
    assert step.max() <= 1


def assert_round_trip(y, x, s, scale_shape):
    """|dequant(quant(x)) - x| <= scale/2, plus the rounding of the float32
    quotient x / scale and product q * scale (each at most |x| * 2**-24)
    and of the cast to y's dtype (at most |x| * eps)."""
    ax = np.abs(npf(x))
    err = np.abs(npf(y) - npf(x))
    bound = s.numpy().reshape(scale_shape) / 2 + 1e-7 \
        + ax * (2.0 ** -22 + torch.finfo(y.dtype).eps)
    assert np.all(err <= bound), float((err - bound).max())


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("m,bs,hkv,d", [
    (3, 8, 2, 32),
    (1, 16, 1, 64),
    (5, 8, 5, 16),     # odd head count
])
def test_kv_block_quant_and_dequant(dt, seed, m, bs, hkv, d):
    rng = np.random.default_rng(seed)
    x, tx = pair(scaled(rng, (m, bs, hkv, d)), dt)
    np.testing.assert_array_equal(npf(tx), npf(x))   # same inputs
    q, s = ops.kv_block_quant(tx)
    want_q, want_s = JR.quantize_block_ref(x)
    assert_quant_equal(q, s, want_q, want_s)
    assert_quant_near_pallas(q, s, *jops.kv_block_quant(x))
    for odt in ("f32", "bf16"):
        jd, td = DTYPES[odt]
        y = ops.kv_block_dequant(q, s, td)
        assert y.dtype == td
        np.testing.assert_array_equal(
            npf(y), npf(JR.dequantize_block_ref(want_q, want_s, jd)))
        np.testing.assert_array_equal(
            npf(y), npf(jops.kv_block_dequant(want_q, want_s, jd)))
    assert_round_trip(ops.kv_block_dequant(q, s), tx, s, (m, 1, hkv, 1))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_zero_block_quantizes_to_zero_with_floor_scale(dt):
    x, tx = pair(np.zeros((2, 4, 3, 8), np.float32), dt)
    q, s = ops.kv_block_quant(tx)
    assert_quant_equal(q, s, *JR.quantize_block_ref(x))
    assert not q.any()
    assert torch.equal(s, torch.full((2, 3), 1e-8))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("nl,n,bs,hkv,d,src,dst", [
    (2, 10, 8, 2, 32, [7, 2, 5], [1, 8, 4]),
    (2, 8, 8, 5, 16, [0, 3, 6], [6, 0, 3]),    # odd head count
])
def test_block_gather_quant_scatter_dequant_layers(dt, nl, n, bs, hkv, d,
                                                   src, dst):
    rng = np.random.default_rng(6)
    pools, tpools = pair(scaled(rng, (nl, n, bs, hkv, d)), dt)
    orig = npf(tpools).copy()
    idx, tidx = ints(src)
    q, s = ops.block_gather_quant_layers(tpools, tidx)
    want_q, want_s = JR.block_gather_quant_layers_ref(pools, idx)
    assert_quant_equal(q, s, want_q, want_s)
    assert_quant_near_pallas(q, s, *jops.block_gather_quant_layers(pools,
                                                                   idx))

    didx, tdidx = ints(dst)
    want = JR.block_scatter_dequant_layers_ref(pools, didx, want_q, want_s)
    pallas = jops.block_scatter_dequant_layers(pools, didx, want_q, want_s)
    got = ops.block_scatter_dequant_layers(tpools, tdidx, q, s)
    assert got is tpools                  # in place
    np.testing.assert_array_equal(npf(got), npf(want))
    np.testing.assert_array_equal(npf(got), npf(pallas))
    untouched = [i for i in range(n) if i not in dst]
    np.testing.assert_array_equal(npf(got)[:, untouched], orig[:, untouched])
    assert_round_trip(got[:, dst], orig[:, src], s, (nl, len(src), 1, hkv, 1))


# ---------------------------------------------------------------------------
# attention over int8 pools (B9, B10); single-layer block copies (B13a/b)
# ---------------------------------------------------------------------------

LOGITS_TOL = dict(atol=7e-2, rtol=7e-2)       # as test_quant_kernels.py


def int8_pool(rng, shape):
    """Unit-normal pages quantized by the JAX oracle: (the float pages as a
    JAX array, (JAX, torch) int8 pages, (JAX, torch) float32 scales)."""
    x = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
    q, s = (np.asarray(a) for a in JR.quantize_block_ref(x))
    return x, (jnp.asarray(q), torch.from_numpy(q.copy())), \
        (jnp.asarray(s), torch.from_numpy(s.copy()))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,h,hkv,d,bs,p", [     # test_quant_kernels.py
    (1, 4, 4, 32, 8, 3),
    (3, 8, 2, 64, 16, 5),
    (2, 5, 5, 16, 8, 4),
])
def test_paged_attention_quant(dt, b, h, hkv, d, bs, p):
    rng = np.random.default_rng(7)
    n = p * b + 4
    q, tq = pair(rng.standard_normal((b, h, d)), dt)
    kf, (kq, tkq), (ks, tks) = int8_pool(rng, (n, bs, hkv, d))
    vf, (vq, tvq), (vs, tvs) = int8_pool(rng, (n, bs, hkv, d))
    bt, tbt = ints(rng.integers(0, n, (b, p)))
    cl, tcl = ints(rng.integers(1, p * bs + 1, b))
    got = ops.paged_attention_quant(tq, tkq, tvq, tks, tvs, tbt, tcl)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    pallas = jops.paged_attention_quant(q, kq, vq, ks, vs, bt, cl)
    oracle = JR.paged_attention_quant_ref(q, kq, vq, ks, vs, bt, cl)
    np.testing.assert_allclose(npf(got), npf(pallas), **tol(dt))
    np.testing.assert_allclose(npf(got), npf(oracle), **tol(dt))
    full = JR.paged_attention_ref(q, kf, vf, bt, cl)
    np.testing.assert_allclose(npf(got), npf(full), **LOGITS_TOL)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,c,h,hkv,d,bs,p", [   # test_quant_kernels.py
    (1, 4, 4, 4, 32, 8, 3),
    (3, 8, 8, 2, 64, 16, 5),
    (2, 5, 5, 5, 16, 8, 4),
])
def test_paged_prefill_attention_quant(dt, b, c, h, hkv, d, bs, p):
    rng = np.random.default_rng(8)
    n = p * b + 4
    q, tq = pair(rng.standard_normal((b, c, h, d)), dt)
    kf, (kq, tkq), (ks, tks) = int8_pool(rng, (n, bs, hkv, d))
    vf, (vq, tvq), (vs, tvs) = int8_pool(rng, (n, bs, hkv, d))
    bt, tbt = ints(rng.integers(0, n, (b, p)))
    qp, tqp = ints(rng.integers(-1, p * bs, (b, c)))
    got = ops.paged_prefill_attention_quant(tq, tkq, tvq, tks, tvs, tbt,
                                            tqp)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    pallas = jops.paged_prefill_attention_quant(q, kq, vq, ks, vs, bt, qp)
    oracle = JR.paged_prefill_attention_quant_ref(q, kq, vq, ks, vs, bt, qp)
    np.testing.assert_allclose(npf(got), npf(pallas), **tol(dt))
    np.testing.assert_allclose(npf(got), npf(oracle), **tol(dt))
    full = JR.paged_prefill_attention_ref(q, kf, vf, bt, qp)
    np.testing.assert_allclose(npf(got), npf(full), **LOGITS_TOL)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_int8_attention_padded_rows_are_zero(dt):
    """Rows with context_lens = 0 (decode) and queries at q_pos = -1
    (prefill) give exact zeros, as the Pallas kernels do (the JAX decode
    oracle gives a uniform average there instead)."""
    rng = np.random.default_rng(9)
    b, c, h, hkv, d, bs, p = 3, 6, 8, 2, 32, 8, 4
    n = p * b + 2
    kf, (kq, tkq), (ks, tks) = int8_pool(rng, (n, bs, hkv, d))
    vf, (vq, tvq), (vs, tvs) = int8_pool(rng, (n, bs, hkv, d))
    bt, tbt = ints(rng.integers(0, n, (b, p)))
    q, tq = pair(rng.standard_normal((b, h, d)), dt)
    cl, tcl = ints([9, 0, p * bs])
    got = ops.paged_attention_quant(tq, tkq, tvq, tks, tvs, tbt, tcl)
    pallas = jops.paged_attention_quant(q, kq, vq, ks, vs, bt, cl)
    np.testing.assert_allclose(npf(got), npf(pallas), **tol(dt))
    assert not npf(got)[1].any() and not npf(pallas)[1].any()
    assert npf(got)[[0, 2]].all()

    qc, tqc = pair(rng.standard_normal((b, c, h, d)), dt)
    qpos = np.full((b, c), -1, np.int32)
    qpos[0, :4] = 3 + np.arange(4)            # a partly padded row
    qpos[2] = p * bs - c + np.arange(c)       # a full row; row 1 all -1
    qp, tqp = ints(qpos)
    got = ops.paged_prefill_attention_quant(tqc, tkq, tvq, tks, tvs, tbt,
                                            tqp)
    pallas = jops.paged_prefill_attention_quant(qc, kq, vq, ks, vs, bt, qp)
    np.testing.assert_allclose(npf(got), npf(pallas), **tol(dt))
    dead = qpos < 0
    assert not npf(got)[dead].any() and not npf(pallas)[dead].any()
    assert npf(got)[~dead].all()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_block_gather_scatter(dt):
    rng = np.random.default_rng(10)
    n, bs, hkv, d = 10, 4, 2, 8
    pages, tpages = pair(rng.standard_normal((n, bs, hkv, d)), dt)
    idx, tidx = ints([n - 1, 3, 0, 6])        # unique, with the last block
    got = ops.block_gather(tpages, tidx)
    np.testing.assert_array_equal(npf(got), npf(jops.block_gather(pages,
                                                                  idx)))
    np.testing.assert_array_equal(npf(got), npf(JR.block_gather_ref(pages,
                                                                    idx)))

    st, tst = pair(rng.standard_normal((4, bs, hkv, d)), dt)
    dst, tdst = ints([2, n - 1, 7, 5])
    oracle = JR.block_scatter_ref(pages, dst, st)
    pallas = jops.block_scatter(pages, dst, st)
    got = ops.block_scatter(tpages, tdst, tst)
    assert got is tpages                  # in place
    np.testing.assert_array_equal(npf(got), npf(pallas))
    np.testing.assert_array_equal(npf(got), npf(oracle))
    np.testing.assert_array_equal(npf(got)[[2, n - 1, 7, 5]], npf(tst))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_block_gather_scatter_d112(dt):
    """Kimi-K2's blocks (bs 16, Hkv 8, D 112: 28 KiB runs in bf16, which
    the card's copies split into 4 KiB chunks with none left over, 56 KiB
    in f32) against the Pallas kernels and the JAX oracles."""
    rng = np.random.default_rng(11)
    n, bs, hkv, d = 12, 16, 8, 112
    pages, tpages = pair(rng.standard_normal((n, bs, hkv, d)), dt)
    idx, tidx = ints([n - 1, 4, 0, 9, 6])
    got = ops.block_gather(tpages, tidx)
    np.testing.assert_array_equal(npf(got), npf(jops.block_gather(pages,
                                                                  idx)))
    np.testing.assert_array_equal(npf(got), npf(JR.block_gather_ref(pages,
                                                                    idx)))

    st, tst = pair(rng.standard_normal((5, bs, hkv, d)), dt)
    dst, tdst = ints([3, n - 1, 0, 8, 5])
    oracle = JR.block_scatter_ref(pages, dst, st)
    pallas = jops.block_scatter(pages, dst, st)
    got = ops.block_scatter(tpages, tdst, tst)
    assert got is tpages
    np.testing.assert_array_equal(npf(got), npf(pallas))
    np.testing.assert_array_equal(npf(got), npf(oracle))


@pytest.mark.parametrize("m", [1, 32, 1536])
@pytest.mark.parametrize("run", [32 * 1024, 28 * 1024, 30])
def test_block_gather_scatter_split_covers_each_run(m, run):
    """The single-layer copies' plan: (bs, Hkv, D) runs of Qwen2.5-14B
    (32 KiB), Kimi-K2 (28 KiB) and the (50, 3, 1, 5) bf16 test pool (30
    bytes, 2-byte vectors) cut into chunks that cover each run exactly,
    each a whole number of vectors one thread block copies in one pass;
    32 blocks of 32 KiB give at least 256 thread blocks (two per SM)."""
    vec = ops._copy_vec(run, 0, 1 << 20)
    assert vec == {32 * 1024: 16, 28 * 1024: 16, 30: 2}[run]
    chunk, n_chunks = ops._copy_split(m, run, vec)
    starts = [c * chunk for c in range(n_chunks)]
    sizes = [min(chunk, run - lo) for lo in starts]
    assert sum(sizes) == run and all(size > 0 for size in sizes)
    assert all(size % vec == 0 for size in sizes)
    assert chunk // vec <= ops.COPY_THREADS * ops.COPY_VECS
    assert n_chunks <= 65535                     # grid.y
    if run == 32 * 1024:
        assert n_chunks == 8 and (m < 32 or m * n_chunks >= 256)
    if run == 28 * 1024:
        assert sizes == [4096] * 7


def test_block_gather_scatter_split_matches_the_cuda_source():
    """The plan's vector widths follow every base's alignment, and its
    block size is the one the CUDA kernels were built with."""
    assert ops._copy_vec(4096, 256, 512) == 16
    assert ops._copy_vec(4096, 256, 516) == 4
    assert ops._copy_vec(4100, 256, 512) == 4
    assert ops._copy_vec(30, 256, 512) == 2
    src = (Path(ops.__file__).parent / "csrc" / "block_copy.cu").read_text()
    assert f"#define COPY_THREADS {ops.COPY_THREADS}\n" in src
    assert f"#define COPY_VECS {ops.COPY_VECS}\n" in src
    for m, run in ((2**31, 32 * 1024), (1, 65536 * 4096 + 16)):
        with pytest.raises(ValueError, match="exceed a CUDA grid"):
            ops._copy_split(m, run, 16)


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


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("s,q", [(64, 16), (128, 64), (96, 32)])
@pytest.mark.parametrize("h,p,n", [(2, 8, 4), (3, 16, 8)])
def test_ssd_scan(dt, s, q, h, p, n):
    rng = np.random.default_rng(10)
    b = 2
    x, tx = pair(rng.standard_normal((b, s, h, p)), dt)
    dtv = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    av = dtv * -np.exp(0.5 * rng.standard_normal(h)).astype(np.float32)
    (jdt, tdt), (ja, ta) = pair(dtv, "f32"), pair(av, "f32")
    jb, tb = pair(rng.standard_normal((b, s, n)), "f32")
    jc, tc = pair(rng.standard_normal((b, s, n)), "f32")
    y, st = ops.ssd_scan(tx, tdt, ta, tb, tc, chunk=q)
    assert y.dtype == st.dtype == torch.float32
    yk, sk = jops.ssd_scan(x, jdt, ja, jb, jc, chunk=q)
    yr, sr = JR.ssd_scan_ref(x, jdt, ja, jb, jc)
    for want_y, want_s in ((yk, sk), (yr, sr)):
        np.testing.assert_allclose(npf(y), npf(want_y), atol=2e-3, rtol=2e-3)
        np.testing.assert_allclose(npf(st), npf(want_s), atol=2e-3,
                                   rtol=2e-3)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("s,w,qb", [(128, 32, 64), (256, 96, 64),
                                    (128, 128, 128)])
def test_swa_attention(dt, s, w, qb):
    rng = np.random.default_rng(11)
    (q, tq), (k, tk), (v, tv) = (pair(rng.standard_normal((2, s, 3, 32)), dt)
                                 for _ in "qkv")
    got = ops.swa_attention(tq, tk, tv, w, q_block=qb, kv_block=qb)
    assert got.dtype == tq.dtype
    for want in (jops.swa_attention(q, k, v, w, q_block=qb, kv_block=qb),
                 JR.swa_attention_ref(q, k, v, w)):
        np.testing.assert_allclose(npf(got), npf(want), **tol(dt))


def test_ssd_scan_and_swa_attention_shape_checks_raise():
    """As the JAX wrappers' asserts: S must be a multiple of the SSD chunk
    and of the attention blocks (callers pad)."""
    t = torch.zeros((1, 96, 2, 8))
    dt = torch.zeros((1, 96, 2))
    bc = torch.zeros((1, 96, 4))
    with pytest.raises(ValueError, match="multiple of chunk 64"):
        ops.ssd_scan(t, dt, dt, bc, bc, chunk=64)
    qkv = torch.zeros((1, 192, 2, 16))
    with pytest.raises(ValueError, match="multiple of the blocks"):
        ops.swa_attention(qkv, qkv, qkv, 32)
    with pytest.raises(ValueError, match="multiple of the blocks"):
        ops.swa_attention(qkv, qkv, qkv, 32, q_block=64, kv_block=80)
    assert ops.swa_attention(qkv, qkv, qkv, 32, q_block=64,
                             kv_block=96).shape == qkv.shape


def test_swa_window_at_least_s_is_causal_attention():
    """A window as long as the sequence leaves plain causal attention."""
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 64, 2, 8)).astype(
        np.float32)) for _ in "qkv")
    got = ops.swa_attention(q, k, v, 64)
    want = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True).transpose(1, 2)
    np.testing.assert_allclose(npf(got), npf(want), atol=3e-5, rtol=3e-5)
    np.testing.assert_array_equal(npf(R.swa_attention_ref(q, k, v, 10**6)),
                                  npf(got))
