"""Plain PyTorch versions of the port's kernels: the serving path (its
two KV writes also fused with the RoPE of q and k, which the plain
versions take from ``models.layers``), the int8 host tier's quantize /
dequantize kernels, attention over int8 pools, the single-layer block
copies, the Mamba2 SSD scan and sliding-window attention.

Each function computes what its CUDA kernel in ``csrc/`` computes, with
ordinary tensor ops and no tiling: a gather of every table page, an f32
einsum, a masked softmax. ``ops`` calls them for tensors on the CPU; on the
card they serve only as the reference the kernels are checked against.

They follow the kernels' behaviour where it differs from the JAX oracles
(``repro/kernels/ref.py``):

* ``paged_attention_ref`` and ``paged_attention_quant_ref`` give
  **zeros** for a row with ``context_lens=0`` (the JAX oracle gives a
  uniform average there; its Pallas kernels, like the CUDA ones, give
  zeros, and padded decode rows rely on that);
* the write and scatter functions update the pools **in place** (JAX
  returns new arrays), and ``kv_chunk_write_ref`` skips tokens past
  ``wcount`` instead of sending them to the scratch slot.

The quantizers follow ``quantize_block_ref`` of the JAX package bit for
bit: ``scale = max(amax / 127, 1e-8)`` per kv head over each block's
(token, dim) plane, then ``clamp(round(x / scale), -127, 127)`` with
round half to even.
"""
from __future__ import annotations

import math

import torch

# the model's RoPE, for the fused writes' plain versions (and the frequency
# table of ops.rope_freqs)
from repro_torch.models.layers import apply_rope, rope_frequencies

NEG_INF = -1e30


def _masked_probs(scores, mask):
    """Softmax over the last axis of ``scores`` restricted to ``mask``;
    rows with no valid key give all-zero weights (the kernels'
    ``acc / max(l, 1e-20)`` finaliser)."""
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    probs = torch.where(mask, torch.exp(scores - m), torch.zeros_like(scores))
    denom = probs.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    return probs / denom


def paged_attention_ref(q, k_pages, v_pages, block_tables, context_lens):
    """Decode attention over a paged KV pool.

    q: (B, H, D); k_pages/v_pages: (N, bs, Hkv, D); block_tables: (B, P)
    int32; context_lens: (B,) int32. Returns (B, H, D) in ``q.dtype``.
    """
    b, h, d = q.shape
    _, bs, hkv, _ = k_pages.shape
    p = block_tables.shape[1]
    g = h // hkv
    tbl = block_tables.long()
    k = k_pages[tbl].reshape(b, p * bs, hkv, d).float()
    v = v_pages[tbl].reshape(b, p * bs, hkv, d).float()
    qf = q.reshape(b, hkv, g, d).float()
    scores = torch.einsum("bkgd,btkd->bkgt", qf, k) / math.sqrt(d)
    pos = torch.arange(p * bs, device=q.device)
    mask = (pos[None, :] < context_lens.long()[:, None])[:, None, None, :]
    probs = _masked_probs(scores, mask)
    out = torch.einsum("bkgt,btkd->bkgd", probs, v)
    return out.reshape(b, h, d).to(q.dtype)


def paged_prefill_attention_ref(q, k_pages, v_pages, block_tables, q_pos):
    """Chunked suffix-prefill attention over a paged KV pool.

    q: (B, C, H, D); pools (N, bs, Hkv, D); block_tables (B, P) int32;
    q_pos (B, C) int32 absolute positions, -1 = padded query (zeros out).
    Query at position ``q_pos`` attends to pool positions ``<= q_pos``.
    """
    b, c, h, d = q.shape
    _, bs, hkv, _ = k_pages.shape
    p = block_tables.shape[1]
    g = h // hkv
    tbl = block_tables.long()
    k = k_pages[tbl].reshape(b, p * bs, hkv, d).float()
    v = v_pages[tbl].reshape(b, p * bs, hkv, d).float()
    qf = q.reshape(b, c, hkv, g, d).float()
    scores = torch.einsum("bckgd,btkd->bckgt", qf, k) / math.sqrt(d)
    pos = torch.arange(p * bs, device=q.device)
    mask = (pos[None, None, :] <= q_pos.long()[:, :, None])[:, :, None, None, :]
    probs = _masked_probs(scores, mask)
    out = torch.einsum("bckgt,btkd->bckgd", probs, v)
    return out.reshape(b, c, h, d).to(q.dtype)


def paged_attention_quant_ref(q, k_pages, v_pages, k_scale, v_scale,
                              block_tables, context_lens):
    """Decode attention over int8 pools (N, bs, Hkv, D) with float32
    scales (N, Hkv): dequantize, then :func:`paged_attention_ref`."""
    return paged_attention_ref(q, dequantize_block_ref(k_pages, k_scale),
                               dequantize_block_ref(v_pages, v_scale),
                               block_tables, context_lens)


def paged_prefill_attention_quant_ref(q, k_pages, v_pages, k_scale,
                                      v_scale, block_tables, q_pos):
    """Chunked prefill attention over int8 pools (N, bs, Hkv, D) with
    float32 scales (N, Hkv): dequantize, then
    :func:`paged_prefill_attention_ref`."""
    return paged_prefill_attention_ref(
        q, dequantize_block_ref(k_pages, k_scale),
        dequantize_block_ref(v_pages, v_scale), block_tables, q_pos)


def block_gather_ref(pages, indices):
    """Single-layer gather: pages (N, bs, Hkv, D), indices (M,) ->
    (M, bs, Hkv, D)."""
    return pages[indices.long()]


def block_scatter_ref(pages, indices, staging):
    """Single-layer scatter of staging (M, bs, Hkv, D) into blocks
    ``indices`` of pages (N, bs, Hkv, D), in place. Returns ``pages``."""
    pages[indices.long()] = staging.to(pages.dtype)
    return pages


def block_gather_layers_ref(pools, indices):
    """All-layer gather: pools (L, N, bs, Hkv, D), indices (M,) ->
    (L, M, bs, Hkv, D)."""
    return pools[:, indices.long()]


def block_scatter_layers_ref(pools, indices, staging):
    """All-layer scatter of staging (L, M, bs, Hkv, D) into pool blocks
    ``indices``, in place. Returns ``pools``."""
    pools[:, indices.long()] = staging.to(pools.dtype)
    return pools


def kv_token_write_ref(k_pages, v_pages, k_new, v_new, slots):
    """Decode-token write, in place. Pools (N, bs, Hkv, D); new (B, Hkv, D);
    slots (B,) absolute slot ids (block * bs + offset)."""
    n, bs, hkv, d = k_pages.shape
    s = slots.long()
    k_pages.view(n * bs, hkv, d)[s] = k_new.to(k_pages.dtype)
    v_pages.view(n * bs, hkv, d)[s] = v_new.to(v_pages.dtype)
    return k_pages, v_pages


def kv_chunk_write_ref(k_pages, v_pages, k_new, v_new, wpages, wstart,
                       wcount):
    """Suffix-chunk write, in place. Pools (N, bs, Hkv, D); new
    (B, C, Hkv, D); wpages (B, PP) destination pages of each row's window
    in order; wstart (B,) in-page offset of the first token; wcount (B,)
    valid tokens per row. Tokens past ``wcount`` are not written."""
    n, bs, hkv, d = k_pages.shape
    b, c = k_new.shape[:2]
    j = torch.arange(c, device=k_new.device)[None, :]
    pos = wstart.long()[:, None] + j
    live = j < wcount.long()[:, None]
    pidx = torch.where(live, pos // bs, torch.zeros_like(pos))
    pages = torch.gather(wpages.long(), 1, pidx)
    slots = (pages * bs + pos % bs)[live]
    k_pages.view(n * bs, hkv, d)[slots] = k_new[live].to(k_pages.dtype)
    v_pages.view(n * bs, hkv, d)[slots] = v_new[live].to(v_pages.dtype)
    return k_pages, v_pages


def rope_kv_token_write_ref(q, k, v, k_pages, v_pages, slots, positions,
                            theta):
    """The decode layer's RoPE and write: q (B, H, D) and k (B, Hkv, D)
    roped at positions (B,) by the model's ``apply_rope``, then k and v
    written at ``slots`` in place. Returns the roped q."""
    k = apply_rope(k, positions, theta)
    kv_token_write_ref(k_pages, v_pages, k, v, slots)
    return apply_rope(q, positions, theta)


def rope_kv_chunk_write_ref(q, k, v, k_pages, v_pages, wpages, wstart,
                            wcount, positions, theta):
    """The prefill layer's RoPE and write: q (B, C, H, D) and k
    (B, C, Hkv, D) roped at positions (B, C) by the model's ``apply_rope``,
    then k and v written through the row windows in place. Returns the
    roped q."""
    k = apply_rope(k, positions, theta)
    kv_chunk_write_ref(k_pages, v_pages, k, v, wpages, wstart, wcount)
    return apply_rope(q, positions, theta)


def quantize_block_ref(x):
    """Symmetric int8 block quantization, scale per (block, kv head).

    x: (..., bs, Hkv, D) float, any leading block axes. Returns (q int8 of
    the same shape, scales float32 (..., Hkv)).
    """
    xf = x.float()
    amax = xf.abs().amax(dim=(-3, -1))                   # (..., Hkv)
    # divide by a tensor on x's device: on the card, a division by a Python
    # scalar multiplies by its reciprocal instead, which is not the IEEE
    # quotient the kernel and the JAX oracle compute
    scale = torch.maximum(amax / amax.new_full((), 127.0),
                          amax.new_full((), 1e-8))
    q = torch.round(xf / scale[..., None, :, None]).clamp_(-127, 127)
    return q.to(torch.int8), scale


def dequantize_block_ref(q, scale, out_dtype=torch.float32):
    """Inverse of :func:`quantize_block_ref`, up to scale/2 per element:
    ``q * scale`` in float32, rounded once to ``out_dtype``."""
    return (q.float() * scale[..., None, :, None]).to(out_dtype)


def block_gather_quant_layers_ref(pools, indices):
    """Fused all-layer gather + quantize: pools (L, N, bs, Hkv, D), indices
    (M,) -> (int8 (L, M, bs, Hkv, D), scales float32 (L, M, Hkv))."""
    return quantize_block_ref(pools[:, indices.long()])


def block_scatter_dequant_layers_ref(pools, indices, staging, scales):
    """Fused dequantize + all-layer scatter of staging (L, M, bs, Hkv, D)
    int8 with scales (L, M, Hkv) into pool blocks ``indices``, in place.
    Returns ``pools``."""
    pools[:, indices.long()] = dequantize_block_ref(staging, scales,
                                                    pools.dtype)
    return pools


def ssd_scan_ref(x, dt, a, b, c, dtype=torch.float32):
    """Token-sequential SSD recurrence from a zero state.

    x: (B, S, H, P) float; dt, a: (B, S, H) float32 (a = dt * A, A < 0);
    b, c: (B, S, N) float32. Per step ``state = state * exp(a) + dt * x b^T``
    and ``y = state c``. Returns (y (B, S, H, P), final state (B, H, P, N)),
    computed in ``dtype`` (float32; float64 for a reference of the
    float32 sums).
    """
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    xf = x.to(dtype)
    dt, a, b, c = (t.to(dtype) for t in (dt, a, b, c))
    state = torch.zeros((bsz, h, p, n), dtype=dtype, device=x.device)
    ys = []
    for t in range(s):
        state = state * torch.exp(a[:, t])[..., None, None] + torch.einsum(
            "bh,bhp,bn->bhpn", dt[:, t], xf[:, t], b[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", state, c[:, t]))
    return torch.stack(ys, dim=1), state


def swa_attention_ref(q, k, v, window):
    """Causal sliding-window attention, MHA layout: q, k, v (B, S, H, D).
    Query i attends to keys j with ``j <= i`` and ``j > i - window``;
    scores in float32. Returns (B, S, H, D) in ``q.dtype``."""
    s, d = q.shape[1], q.shape[-1]
    scores = torch.einsum("bshd,bthd->bhst", q.float(),
                          k.float()) / math.sqrt(d)
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    mask = (j <= i) & (j > i - window)
    scores = torch.where(mask[None, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, v.float())
    return out.to(q.dtype)
