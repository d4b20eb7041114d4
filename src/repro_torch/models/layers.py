"""Layers of the decoder stacks, as plain functions on tensors.

Conventions follow ``repro.models.layers``: per-layer parameters are
stacked along a leading layer axis; activations stay in the config dtype;
normalisation, RoPE and the SwiGLU gate are computed in float32 and cast
back at the same points as the JAX code, so both compute the same function.
"""
from __future__ import annotations

import itertools
import math

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def dense_init(shape, dtype, generator, device, scale: float | None = None):
    """Normal(0, scale) in float32, cast to ``dtype``; scale defaults to
    1/sqrt(fan_in) with fan_in = shape[-2]."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)


def embed_init(shape, dtype, generator, device):
    return dense_init(shape, dtype, generator, device, scale=0.02)


def stacked_init(layers, shape, dtype, generator, device,
                 scale: float | None = None):
    """(*layers, *shape) drawn one ``shape`` matrix at a time, so no float32
    copy of the whole stack ever exists. ``layers`` is the count of the
    leading layer axis, or a tuple of leading axes (layers, experts): one
    Kimi-K2 layer's experts are 22.5 GB in float32, one expert 59 MB."""
    lead = (layers,) if isinstance(layers, int) else tuple(layers)
    out = torch.empty((*lead, *shape), dtype=dtype, device=device)
    if out.is_meta:            # shapes only (``model.param_specs``)
        return out
    for i in itertools.product(*map(range, lead)):
        out[i] = dense_init(shape, dtype, generator, device, scale)
    return out


def unstack(tree):
    """Per-layer dicts of views of a nested dict of stacked (L, ...)
    tensors, by ``unbind``. Autograd's backward of the L views is one
    stack; indexing each layer (``t[i]``) instead adds L gradients of the
    whole stack's size, zeros but one slice, which at 40 layers moves
    about 160 times the stacked weights' bytes per backward."""
    keys = list(tree)
    cols = [unstack(v) if isinstance(v, dict) else v.unbind(0)
            for v in tree.values()]
    return [dict(zip(keys, vals)) for vals in zip(*cols)]


# ---------------------------------------------------------------------------
# norms and RoPE
# ---------------------------------------------------------------------------

def rms_norm(x, weight, eps: float = 1e-6):
    """RMSNorm with the ``1 + weight`` gain, statistics in float32."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(x.dtype)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm with bias, statistics in float32 (population variance,
    as ``jnp.var``)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """Split-half (not interleaved) rotary embedding in float32.
    x: (..., S, H, D); positions broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)
    angles = positions.float()[..., None] * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# dense-cache attention (prefill without a window, decode), plain PyTorch as
# in the JAX package, which computes these outside any Pallas kernel
# ---------------------------------------------------------------------------

def _gqa_scores(q, k):
    """q (B, S, H, D), k (B, T, Hkv, D) -> float32 scores (B, H, S, T);
    query head h reads KV head h // (H / Hkv)."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    q = q.reshape(b, s, hkv, h // hkv, d)
    scores = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float())
    return scores.reshape(b, h, s, k.shape[1])


def _gqa_values(probs, v):
    """probs (B, H, S, T), v (B, T, Hkv, D) -> float32 (B, S, H, D)."""
    b, h, s, t = probs.shape
    hkv = v.shape[2]
    probs = probs.reshape(b, hkv, h // hkv, s, t)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(b, s, h, v.shape[-1])


def attention_mask(q_pos, k_pos, window=None, causal: bool = True):
    """Boolean mask (..., S_q, S_k), True = attend."""
    m = torch.ones(q_pos.shape[:-1] + (q_pos.shape[-1], k_pos.shape[-1]),
                   dtype=torch.bool, device=q_pos.device)
    if causal:
        m &= k_pos[..., None, :] <= q_pos[..., :, None]
    if window is not None:
        m &= k_pos[..., None, :] > q_pos[..., :, None] - window
    return m


def full_attention(q, k, v, q_pos, k_pos, window=None, causal=True):
    """Quadratic attention. q (B, S, H, D), k/v (B, T, Hkv, D); positions
    (B or 1, S) and (B or 1, T). Returns (B, S, H, D) in v's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = _gqa_scores(q, k) * scale
    mask = attention_mask(q_pos, k_pos, window, causal)
    mask = mask[:, None] if mask.dim() == 3 else mask[None, None]
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    return _gqa_values(probs, v).to(v.dtype)


def chunked_attention(q, k, v, q_pos, k_pos, window=None, causal=True,
                      q_chunk: int = 1024):
    """Query-chunked :func:`full_attention`: each chunk of ``q_chunk``
    queries sees every key (masked), so no (S, T) score matrix beyond one
    chunk's exists. Same numerics as the JAX function (whose padded last
    chunk is sliced off; here the last chunk is simply shorter)."""
    s = q.shape[1]
    if s <= q_chunk:
        return full_attention(q, k, v, q_pos, k_pos, window, causal)
    return torch.cat([
        full_attention(q[:, i:i + q_chunk], k, v, q_pos[..., i:i + q_chunk],
                       k_pos, window, causal)
        for i in range(0, s, q_chunk)], dim=1)


def decode_attention(q, k_cache, v_cache, cache_len: int, window=None):
    """One query per row, q (B, 1, H, D), at position ``cache_len - 1``
    against the cache (B, S, Hkv, D), whose positions [0, cache_len) are
    valid (the new token already written). Returns (B, 1, H, D) in the
    cache's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = _gqa_scores(q, k_cache) * scale                 # (B, H, 1, S)
    kpos = torch.arange(k_cache.shape[1], device=q.device)
    valid = kpos < cache_len
    if window is not None:
        valid &= kpos >= cache_len - window
    scores = torch.where(valid, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    return _gqa_values(probs, v_cache).to(v_cache.dtype)


# ---------------------------------------------------------------------------
# attention projections (GQA, optional qkv bias)
# ---------------------------------------------------------------------------

def init_attn(cfg, generator, layers: int, dtype, device):
    d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim

    def init(shape, scale=None):
        return stacked_init(layers, shape, dtype, generator, device, scale)

    p = {
        "wq": init((d, h * dh)),
        "wk": init((d, hkv * dh)),
        "wv": init((d, hkv * dh)),
        "wo": init((h * dh, d),
                   scale=1.0 / math.sqrt((h * dh) * cfg.num_layers)),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((layers, h * dh), dtype=dtype, device=device)
        p["bk"] = torch.zeros((layers, hkv * dh), dtype=dtype, device=device)
        p["bv"] = torch.zeros((layers, hkv * dh), dtype=dtype, device=device)
    return p


def qkv_project(cfg, lp, x):
    """lp: one layer's attention params. x: (B, S, d) ->
    q (B, S, H, D), k and v (B, S, Hkv, D)."""
    b, s, _ = x.shape
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ lp["wq"]
    k = x @ lp["wk"]
    v = x @ lp["wv"]
    if cfg.qkv_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    return (q.reshape(b, s, h, dh), k.reshape(b, s, hkv, dh),
            v.reshape(b, s, hkv, dh))


def attn_out(lp, o):
    b, s = o.shape[:2]
    return o.reshape(b, s, -1) @ lp["wo"]


# ---------------------------------------------------------------------------
# MLP (SwiGLU; Whisper uses the GELU variant)
# ---------------------------------------------------------------------------

def init_mlp(cfg, generator, layers: int, dtype, device, gelu: bool = False):
    """SwiGLU weights ``w1``, ``w3`` (L, d, f) and ``w2`` (L, f, d); with
    ``gelu``, ``w1``, ``w2`` and the biases ``b1`` (L, f), ``b2`` (L, d)."""
    d, f = cfg.d_model, cfg.d_ff
    p = {"w1": stacked_init(layers, (d, f), dtype, generator, device),
         "w2": stacked_init(layers, (f, d), dtype, generator, device,
                            scale=1.0 / math.sqrt(f * cfg.num_layers))}
    if gelu:
        p["b1"] = torch.zeros((layers, f), dtype=dtype, device=device)
        p["b2"] = torch.zeros((layers, d), dtype=dtype, device=device)
    else:
        p["w3"] = stacked_init(layers, (d, f), dtype, generator, device)
    return p


def mlp(lp, x, gelu: bool = False):
    """SwiGLU, or with ``gelu`` the biased GELU MLP; the activation in
    float32 (GELU's tanh form, as ``jax.nn.gelu``), cast back before
    ``w2``."""
    if gelu:
        h = F.gelu((x @ lp["w1"] + lp["b1"]).float(), approximate="tanh")
        return (h.to(x.dtype) @ lp["w2"]) + lp["b2"]
    gate = F.silu((x @ lp["w1"]).float()).to(x.dtype)
    return (gate * (x @ lp["w3"])) @ lp["w2"]


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def softmax_xent(logits, labels, mask=None):
    """Cross entropy of ``logits`` (..., V) against int ``labels`` (...),
    in float32; with ``mask`` the masked mean over max(mask.sum(), 1)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        return (nll * mask).sum() / mask.sum().clamp_min(1)
    return nll.mean()
