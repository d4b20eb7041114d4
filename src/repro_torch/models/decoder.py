"""Dense decoder stack on the paged KV pool: batched decode and chunked
suffix prefill.

The counterpart of ``repro.models.decoder.paged_decode`` and
``paged_prefill`` for dense archs. JAX scans the stacked layer params and
threads the donated pools through the scan; here a Python loop walks the
layers and each layer's K/V kernels write that layer's slice of the pools
**in place**, so no pool is ever copied.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers as L


def init_layer_stack(cfg, generator, dtype, device):
    """Stacked (L, ...) params of a dense stack: attention, SwiGLU MLP and
    the two pre-norm gains."""
    if cfg.arch_type != "dense":
        raise NotImplementedError(
            f"arch_type {cfg.arch_type!r}: this port runs dense stacks only; "
            "MoE and the other families come in later slices")
    nl = cfg.num_layers
    p = L.init_attn(cfg, generator, nl, dtype, device)
    p["attn_norm"] = torch.zeros((nl, cfg.d_model), dtype=dtype,
                                 device=device)
    p.update(L.init_mlp(cfg, generator, nl, dtype, device))
    p["mlp_norm"] = torch.zeros((nl, cfg.d_model), dtype=dtype,
                                device=device)
    return p


def _layer(stacked, i):
    return {k: v[i] for k, v in stacked.items()}


def _paged_ffn(lp, h):
    """Pre-norm dense SwiGLU residual block."""
    return h + L.mlp(lp, L.rms_norm(h, lp["mlp_norm"]))


def paged_decode(cfg, stacked, x, k_pool, v_pool, tables, positions,
                 attn_lens, slots):
    """Single-token batched decode against the paged KV pool.

    x:             (B, 1, d) embedded tokens
    k_pool/v_pool: (L, N+1, bs, Hkv, D) pools (incl. scratch block),
                   written in place
    tables:        (B, P) int32 block tables (padded rows arbitrary)
    positions:     (B,) int32 rope position of the new token
    attn_lens:     (B,) int32 tokens to attend over (0 for padded rows)
    slots:         (B,) int32 absolute write slot (scratch slot = masked)
    Returns hidden (B, 1, d).
    """
    pos = positions[:, None]
    h = x
    for i in range(cfg.num_layers):
        lp = _layer(stacked, i)
        xn = L.rms_norm(h, lp["attn_norm"])
        q, k, v = L.qkv_project(cfg, lp, xn)
        q = L.apply_rope(q, pos, cfg.rope_theta)
        k = L.apply_rope(k, pos, cfg.rope_theta)
        ops.kv_token_write(k_pool[i], v_pool[i], k[:, 0], v[:, 0], slots)
        out = ops.paged_attention(q[:, 0], k_pool[i], v_pool[i], tables,
                                  attn_lens)
        h = h + L.attn_out(lp, out[:, None])
        h = _paged_ffn(lp, h)
    return h


def paged_prefill(cfg, stacked, x, k_pool, v_pool, tables, q_pos,
                  wpages, wstart, wcount):
    """One chunk of batched suffix-only prefill against the paged pool.

    x:             (B, C, d) embedded suffix-chunk tokens
    k_pool/v_pool: (L, N+1, bs, Hkv, D) pools, written in place
    tables:        (B, P) int32 block tables (cached prefix + own blocks)
    q_pos:         (B, C) int32 absolute positions (-1 = padded query)
    wpages:        (B, PP) int32 destination pages of each row's window
    wstart:        (B,) int32 in-page offset of the row's first token
    wcount:        (B,) int32 valid tokens per row (0 = padded row)
    Returns hidden (B, C, d).
    """
    pos = q_pos.clamp_min(0)
    h = x
    for i in range(cfg.num_layers):
        lp = _layer(stacked, i)
        xn = L.rms_norm(h, lp["attn_norm"])
        q, k, v = L.qkv_project(cfg, lp, xn)
        q = L.apply_rope(q, pos, cfg.rope_theta)
        k = L.apply_rope(k, pos, cfg.rope_theta)
        ops.kv_chunk_write(k_pool[i], v_pool[i], k, v, wpages, wstart,
                           wcount)
        out = ops.paged_prefill_attention(q, k_pool[i], v_pool[i], tables,
                                          q_pos)
        h = h + L.attn_out(lp, out)
        h = _paged_ffn(lp, h)
    return h
