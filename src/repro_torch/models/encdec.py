"""Whisper-style encoder-decoder transformer. [arXiv:2212.04356]

The counterpart of ``repro.models.encdec``. The mel-spectrogram and conv
feature extractor are stubbed: the model consumes precomputed frame
embeddings (B, frames, d_model). Positions are sinusoidal, computed on the
fly. LayerNorm with bias, GELU MLPs, MHA (num_kv_heads == num_heads); no
kernel of the port runs here: every attention is the plain one of
``layers``, as in the JAX model.

Parameters (stacked along a leading layer axis)::

    {"encoder": {"attn", "ln1", "mlp", "ln2"},
     "decoder": {"self_attn", "ln1", "cross_attn", "ln2", "mlp", "ln3"},
     "enc_ln_post": {"w", "b"}}

The decoder's cache is ``{"k", "v": (L, B, S, H, D), "cross_k",
"cross_v": (L, B, F, H, D)}``; ``decode_step`` writes it in place.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers as L


def _inv_timescales(channels: int, device):
    log_timescale = math.log(10000) / (channels // 2 - 1)
    return torch.exp(-log_timescale * torch.arange(
        channels // 2, dtype=torch.float32, device=device))


def sinusoids(length: int, channels: int, device=None):
    """(length, channels) float32: [sin, cos] of position times each
    inverse timescale."""
    assert channels % 2 == 0
    t = torch.arange(length, dtype=torch.float32, device=device)[:, None] \
        * _inv_timescales(channels, device)[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1)


def position_embed(positions, channels: int):
    """Sinusoidal embedding of integer positions (B, S) or (S,)."""
    t = positions.float()[..., None] * _inv_timescales(channels,
                                                       positions.device)
    return torch.cat([torch.sin(t), torch.cos(t)], dim=-1)


def _init_ln(nl, d, dtype, device):
    return {"w": torch.ones((nl, d), dtype=dtype, device=device),
            "b": torch.zeros((nl, d), dtype=dtype, device=device)}


def init_encdec(cfg, generator, dtype, device):
    """Random encoder and decoder stacks at the JAX package's shapes and
    scales."""
    d = cfg.d_model
    ne, nd = cfg.encoder_layers, cfg.num_layers

    def attn(n):
        return L.init_attn(cfg, generator, n, dtype, device)

    def mlp(n):
        return L.init_mlp(cfg, generator, n, dtype, device, gelu=True)

    enc = {"attn": attn(ne), "ln1": _init_ln(ne, d, dtype, device),
           "mlp": mlp(ne), "ln2": _init_ln(ne, d, dtype, device)}
    dec = {"self_attn": attn(nd), "ln1": _init_ln(nd, d, dtype, device),
           "cross_attn": attn(nd), "ln2": _init_ln(nd, d, dtype, device),
           "mlp": mlp(nd), "ln3": _init_ln(nd, d, dtype, device)}
    return {"encoder": enc, "decoder": dec,
            "enc_ln_post": {"w": torch.ones((d,), dtype=dtype, device=device),
                            "b": torch.zeros((d,), dtype=dtype,
                                             device=device)}}


def _ln(x, p):
    return L.layer_norm(x, p["w"], p["b"])


def encode(cfg, params, frames):
    """frames (B, F, d) -> encoder output (B, F, d); non-causal attention."""
    x = frames + sinusoids(frames.shape[1], cfg.d_model,
                           frames.device).to(frames.dtype)
    pos = torch.arange(x.shape[1], device=x.device)
    for lp in L.unstack(params["encoder"]):
        q, k, v = L.qkv_project(cfg, lp["attn"], _ln(x, lp["ln1"]))
        out = L.full_attention(q, k, v, pos, pos, causal=False)
        x = x + L.attn_out(lp["attn"], out)
        x = x + L.mlp(lp["mlp"], _ln(x, lp["ln2"]), gelu=True)
    return _ln(x, params["enc_ln_post"])


def cross_kv(cfg, params, enc_out):
    """Each decoder layer's cross-attention K and V of ``enc_out``:
    (L, B, F, H, D) each."""
    ks, vs = [], []
    for lp in L.unstack(params["decoder"]["cross_attn"]):
        _, k, v = L.qkv_project(cfg, lp, enc_out)
        ks.append(k)
        vs.append(v)
    return torch.stack(ks), torch.stack(vs)


def _decoder_layer(cfg, lp, h, positions, enc_out):
    """One teacher-forced decoder layer; returns (h', self K, self V,
    cross K, cross V)."""
    q, k, v = L.qkv_project(cfg, lp["self_attn"], _ln(h, lp["ln1"]))
    out = L.chunked_attention(q, k, v, positions, positions)
    h = h + L.attn_out(lp["self_attn"], out)
    q, _, _ = L.qkv_project(cfg, lp["cross_attn"], _ln(h, lp["ln2"]))
    # queries from the decoder, keys and values from the encoder
    _, ek, ev = L.qkv_project(cfg, lp["cross_attn"], enc_out)
    f_pos = torch.arange(enc_out.shape[1], device=h.device)
    out = L.full_attention(q, ek, ev, positions, f_pos, causal=False)
    h = h + L.attn_out(lp["cross_attn"], out)
    h = h + L.mlp(lp["mlp"], _ln(h, lp["ln3"]), gelu=True)
    return h, k, v, ek, ev


def decode_forward(cfg, params, x, positions, enc_out):
    """Teacher-forced decoder. x (B, S, d) token embeddings (the position
    embedding is added here), positions (1, S)."""
    h = x + position_embed(positions, cfg.d_model).to(x.dtype)
    for lp in L.unstack(params["decoder"]):
        h = _decoder_layer(cfg, lp, h, positions, enc_out)[0]
    return h


def decode_prefill(cfg, params, x, positions, enc_out, cache_size: int):
    """The decoder over a prompt. Returns (hidden, cache) with the
    self-attention K/V zero-padded to ``cache_size`` tokens."""
    h = x + position_embed(positions, cfg.d_model).to(x.dtype)
    pad = cache_size - x.shape[1]
    ys = {"k": [], "v": [], "cross_k": [], "cross_v": []}
    for lp in L.unstack(params["decoder"]):
        h, k, v, ek, ev = _decoder_layer(cfg, lp, h, positions, enc_out)
        if pad > 0:
            k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                    for t in (k, v))
        for name, t in zip(ys, (k, v, ek, ev)):
            ys[name].append(t)
    return h, {name: torch.stack(ts) for name, ts in ys.items()}


def decode_step(cfg, params, cache, x, cache_len: int):
    """One decoder token x (B, 1, d) at position ``cache_len`` against the
    cache of :func:`decode_prefill`, whose self-attention K/V it writes in
    place. Returns (hidden (B, 1, d), cache)."""
    pos = torch.full((1, 1), cache_len, dtype=torch.int32, device=x.device)
    h = x + position_embed(pos, cfg.d_model).to(x.dtype)
    f_pos = torch.arange(cache["cross_k"].shape[2], device=x.device)
    for i, lp in enumerate(L.unstack(params["decoder"])):
        q, k, v = L.qkv_project(cfg, lp["self_attn"], _ln(h, lp["ln1"]))
        kc, vc = cache["k"][i], cache["v"][i]
        kc[:, cache_len], vc[:, cache_len] = k[:, 0], v[:, 0]
        out = L.decode_attention(q, kc, vc, cache_len + 1)
        h = h + L.attn_out(lp["self_attn"], out)
        q, _, _ = L.qkv_project(cfg, lp["cross_attn"], _ln(h, lp["ln2"]))
        out = L.full_attention(q, cache["cross_k"][i], cache["cross_v"][i],
                               pos, f_pos, causal=False)
        h = h + L.attn_out(lp["cross_attn"], out)
        h = h + L.mlp(lp["mlp"], _ln(h, lp["ln3"]), gelu=True)
    return h, cache
