"""Layers of the dense serving decoder, as plain functions on tensors.

Conventions follow ``repro.models.layers``: per-layer parameters are
stacked along a leading layer axis; activations stay in the config dtype;
normalisation, RoPE and the SwiGLU gate are computed in float32 and cast
back at the same points as the JAX code, so both compute the same function.
"""
from __future__ import annotations

import math

import torch


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


def stacked_init(layers: int, shape, dtype, generator, device,
                 scale: float | None = None):
    """(layers, *shape) drawn one layer at a time, so no float32 copy of
    the whole stack ever exists."""
    out = torch.empty((layers, *shape), dtype=dtype, device=device)
    for i in range(layers):
        out[i] = dense_init(shape, dtype, generator, device, scale)
    return out


# ---------------------------------------------------------------------------
# norms and RoPE
# ---------------------------------------------------------------------------

def rms_norm(x, weight, eps: float = 1e-6):
    """RMSNorm with the ``1 + weight`` gain, statistics in float32."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(x.dtype)


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
# MLP (SwiGLU)
# ---------------------------------------------------------------------------

def init_mlp(cfg, generator, layers: int, dtype, device):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w1": stacked_init(layers, (d, f), dtype, generator, device),
        "w2": stacked_init(layers, (f, d), dtype, generator, device,
                           scale=1.0 / math.sqrt(f * cfg.num_layers)),
        "w3": stacked_init(layers, (d, f), dtype, generator, device),
    }


def mlp(lp, x):
    gate = torch.nn.functional.silu((x @ lp["w1"]).float()).to(x.dtype)
    return (gate * (x @ lp["w3"])) @ lp["w2"]
