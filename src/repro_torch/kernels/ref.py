"""Plain PyTorch versions of the six kernels on the serving path.

Each function computes what its CUDA kernel in ``csrc/`` computes, with
ordinary tensor ops and no tiling: a gather of every table page, an f32
einsum, a masked softmax. ``ops`` calls them for tensors on the CPU; on the
card they serve only as the reference the kernels are checked against.

They follow the kernels' behaviour where it differs from the JAX oracles
(``repro/kernels/ref.py``):

* ``paged_attention_ref`` gives **zeros** for a row with ``context_lens=0``
  (the JAX oracle gives a uniform average there; its Pallas kernel, like
  the CUDA one, gives zeros, and padded decode rows rely on that);
* the write functions update the pools **in place** (JAX returns new
  arrays), and ``kv_chunk_write_ref`` skips tokens past ``wcount`` instead
  of sending them to the scratch slot.
"""
from __future__ import annotations

import math

import torch

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
