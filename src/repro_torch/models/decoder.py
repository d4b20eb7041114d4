"""Decoder stacks: the attention stacks on the paged KV pool (batched
decode and chunked suffix prefill, the serving path: dense and MoE, and
the decode of the windowed, hybrid and VLM stacks with the JAX package's
paged body), the dense-cache
``prefill`` / ``decode_step`` of the dense, VLM, MoE, SSM (Mamba2) and
hybrid (Hymba: attention and SSM heads in parallel) stacks, and the
training ``forward`` of all of them.

The counterparts of ``repro.models.decoder``. JAX scans the stacked layer
params; here a Python loop walks the layers. On the paged path each
layer's RoPE of q and k and its K/V write are one kernel
(``ops.rope_kv_token_write`` / ``ops.rope_kv_chunk_write``, where the JAX
scan has XLA fuse the RoPE beside the Pallas write), which writes that
layer's slice of the pools **in place**, so no pool is ever copied; the
dense cache of ``prefill`` is a dict of stacked (L, ...) tensors that
``decode_step`` updates in place:

    {"k", "v": (L, B, S, Hkv, D)}   (int8, plus "k_scale", "v_scale"
                                     (L, B, S, Hkv) float32 with
                                     kv_quant_int8), attention archs
    {"conv": (L, B, W-1, conv_dim), "state": (L, B, H, P, N) float32}
                                     SSM and hybrid archs

Where the JAX model computes sliding-window prefill attention and the SSD
chunk scan in plain ``jnp``, this port's ``prefill`` runs them through the
kernels of the Pallas versions, ``ops.swa_attention`` (B15) and
``ops.ssd_scan`` (B14). Neither kernel has a backward, so ``forward``
computes both in plain PyTorch, as the JAX ``forward`` does.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as S
from repro_torch.models.sharding import logical

# sequence block of ops.swa_attention (its default q_block and kv_block):
# windowed prefill pads S to a multiple of it
SWA_BLOCK = 128


def init_layer_stack(cfg, generator, dtype, device):
    """Stacked (L, ...) params of a dense, VLM, MoE, SSM or hybrid stack,
    shaped as the JAX package's ``init_layer_stack`` (the audio model's
    stacks are ``encdec.init_encdec``'s)."""
    nl, d = cfg.num_layers, cfg.d_model

    def const(value):
        return torch.full((nl, d), value, dtype=dtype, device=device)

    p = {}
    if cfg.arch_type != "ssm":
        p.update(L.init_attn(cfg, generator, nl, dtype, device))
        p["attn_norm"] = const(0.0)
        p.update(MOE.init_moe(cfg, generator, nl, dtype, device)
                 if cfg.arch_type == "moe"
                 else L.init_mlp(cfg, generator, nl, dtype, device))
        p["mlp_norm"] = const(0.0)
    if cfg.arch_type in ("ssm", "hybrid"):
        p.update(init_ssm_sub(cfg, generator, nl, dtype, device))
    if cfg.arch_type == "hybrid":
        # per-channel fusion gains of the parallel attention and SSM heads
        p["fuse_attn"] = const(1.0)
        p["fuse_ssm"] = const(1.0)
        p["attn_out_norm"] = const(0.0)
        p["ssm_out_norm"] = const(0.0)
    return p


def init_ssm_sub(cfg, generator, nl, dtype, device):
    sub = S.init_ssm(cfg, generator, nl, dtype, device)
    if cfg.arch_type == "ssm":
        sub["norm"] = torch.zeros((nl, cfg.d_model), dtype=dtype,
                                  device=device)
    return sub


def _layer(stacked, i):
    return {k: v[i] for k, v in stacked.items()}


def _ffn(cfg, lp, h, valid=None):
    """Pre-norm FFN residual block h + ffn(rms_norm(h)), where ffn is the
    dense SwiGLU or, in a layer with experts, the MoE FFN, picked by the
    layer's params (h alone in a layer with neither, as the JAX paged
    bodies do). ``valid`` (h's leading shape, True = real token) keeps the
    padded rows of the paged steps' buckets out of the experts' capacity."""
    if "we1" in lp:
        hn = L.rms_norm(h, lp["mlp_norm"])
        return h + MOE.moe_ffn(cfg, lp, hn, pad_mask=valid)
    if "w1" in lp:
        return h + L.mlp(lp, L.rms_norm(h, lp["mlp_norm"]))
    return h


def paged_decode(cfg, stacked, x, k_pool, v_pool, tables, positions,
                 attn_lens, slots):
    """Single-token batched decode against the paged KV pool.

    The body of every attention arch on the engine path, as the JAX
    package's: attention without a window (B2 has none), no SSM branch
    and no fusion norms in a hybrid layer, the FFN its params hold; the
    layer's other params are left alone.

    x:             (B, 1, d) embedded tokens
    k_pool/v_pool: (L, N+1, bs, Hkv, D) pools (incl. scratch block),
                   written in place
    tables:        (B, P) int32 block tables (padded rows arbitrary)
    positions:     (B,) int32 rope position of the new token
    attn_lens:     (B,) int32 tokens to attend over (0 for padded rows)
    slots:         (B,) int32 absolute write slot (scratch slot = masked)
    Returns hidden (B, 1, d).
    """
    valid = (attn_lens > 0)[:, None]                     # real rows
    h = x
    for i in range(cfg.num_layers):
        lp = _layer(stacked, i)
        xn = L.rms_norm(h, lp["attn_norm"])
        q, k, v = L.qkv_project(cfg, lp, xn)
        q = ops.rope_kv_token_write(q[:, 0], k[:, 0], v[:, 0], k_pool[i],
                                    v_pool[i], slots, positions,
                                    cfg.rope_theta)
        out = ops.paged_attention(q, k_pool[i], v_pool[i], tables,
                                  attn_lens)
        h = h + L.attn_out(lp, out[:, None])
        h = _ffn(cfg, lp, h, valid)
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
    valid = q_pos >= 0                                   # real queries
    h = x
    for i in range(cfg.num_layers):
        lp = _layer(stacked, i)
        xn = L.rms_norm(h, lp["attn_norm"])
        q, k, v = L.qkv_project(cfg, lp, xn)
        q = ops.rope_kv_chunk_write(q, k, v, k_pool[i], v_pool[i], wpages,
                                    wstart, wcount, pos, cfg.rope_theta)
        out = ops.paged_prefill_attention(q, k_pool[i], v_pool[i], tables,
                                          q_pos)
        h = h + L.attn_out(lp, out)
        h = _ffn(cfg, lp, h, valid)
    return h


# ---------------------------------------------------------------------------
# dense-cache prefill and decode (dense, moe, ssm, hybrid)
# ---------------------------------------------------------------------------

def _swa(q, k, v, window: int):
    """Causal sliding-window attention through ``ops.swa_attention``: the
    KV heads repeated to MHA layout (query head h reads KV head h // G, as
    the JAX model groups them) and S padded at the end to a multiple of
    the kernel's block. Padded keys lie after every real query, so the
    causal mask hides them; padded queries are sliced off."""
    s = q.shape[1]
    g = q.shape[2] // k.shape[2]
    k, v = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
    pad = (-s) % SWA_BLOCK if s > SWA_BLOCK else 0
    q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)).contiguous()
               for t in (q, k, v))
    return ops.swa_attention(q, k, v, window)[:, :s]


def _rope_qkv(cfg, lp, xn, positions):
    """q, k, v of a sequence, q and k roped, each constrained to its
    logical axes."""
    q, k, v = L.qkv_project(cfg, lp, xn)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return (logical(q, "batch", "seq", "heads", None),
            logical(k, "batch", "seq", "kv_heads", None),
            logical(v, "batch", "seq", "kv_heads", None))


def _attn_seq(cfg, lp, xn, positions):
    """Sequence attention of prefill. Returns (out, k, v)."""
    q, k, v = _rope_qkv(cfg, lp, xn, positions)
    if cfg.sliding_window is not None:
        out = _swa(q, k, v, cfg.sliding_window)
    else:
        out = L.chunked_attention(q, k, v, positions, positions)
    return L.attn_out(lp, out), k, v


def _quantize_kv(t):
    """t (B, S, H, D) -> (int8 values, (B, S, H) float32 scales); the
    scale divides by a tensor so the card computes the IEEE quotient as
    the CPU does."""
    tf = t.float()
    amax = tf.abs().amax(dim=-1)
    scale = torch.maximum(amax / amax.new_full((), 127.0),
                          amax.new_full((), 1e-8))
    q = torch.round(tf / scale[..., None]).clamp_(-127, 127)
    return q.to(torch.int8), scale


def _mix(lp, a_out, s_out):
    """Hymba's fusion of the parallel attention and SSM outputs."""
    return 0.5 * (L.rms_norm(a_out, lp["attn_out_norm"]) * lp["fuse_attn"]
                  + L.rms_norm(s_out, lp["ssm_out_norm"]) * lp["fuse_ssm"])


# ---------------------------------------------------------------------------
# training forward
# ---------------------------------------------------------------------------

# Activation rematerialisation of the training forward: when on, each
# layer keeps only its input and recomputes the rest in the backward pass
# (``cfg.remat_policy`` "full"), or also keeps its matmul outputs ("dots").
# The launcher turns it on for full-size training.
REMAT = False
# the products whose outputs the "dots" policy keeps
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def set_remat(value: bool) -> None:
    global REMAT
    REMAT = bool(value)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _forward_layer(cfg, lp, h, positions):
    """One training layer: h -> (h', its MoE router's aux loss or 0).
    Attention is ``L.chunked_attention`` with the config's window and the
    SSM scan the plain one: both differentiable."""
    zero = h.new_zeros((), dtype=torch.float32)
    if cfg.arch_type == "ssm":
        out, _ = S.ssm_mixer(cfg, lp, L.rms_norm(h, lp["norm"]), plain=True)
        return h + out, zero
    xn = L.rms_norm(h, lp["attn_norm"])
    q, k, v = _rope_qkv(cfg, lp, xn, positions)
    a_out = L.attn_out(lp, L.chunked_attention(
        q, k, v, positions, positions, window=cfg.sliding_window))
    if cfg.arch_type == "hybrid":
        s_out, _ = S.ssm_mixer(cfg, lp, xn, plain=True)
        h = h + _mix(lp, a_out, s_out)
    else:
        h = h + a_out
    if "we1" in lp:
        hn = L.rms_norm(h, lp["mlp_norm"])
        h, aux = h + MOE.moe_ffn(cfg, lp, hn), MOE.aux_loss(cfg, lp, hn)
    else:
        h, aux = _ffn(cfg, lp, h), zero
    return logical(h, "batch", "seq", "embed"), aux


def forward(cfg, stacked, x, positions):
    """Training forward of x (B, S, d) embedded at positions (1, S).
    Returns (hidden (B, S, d), the MoE layers' summed aux loss, float32)."""
    body = functools.partial(_forward_layer, cfg)
    if REMAT:
        kw = dict(use_reentrant=False)
        if cfg.remat_policy == "dots":
            kw["context_fn"] = functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots)
        body = functools.partial(ckpt.checkpoint, body, **kw)
    h, aux = x, x.new_zeros((), dtype=torch.float32)
    for lp in L.unstack(stacked):
        h, aux_i = body(lp, h, positions)
        aux = aux + aux_i
    return h, aux


def prefill(cfg, stacked, x, positions, cache_size=None):
    """Prefill x (B, S, d) embedded at positions (1, S). Returns (hidden,
    cache) with the K/V caches zero-padded to ``cache_size`` tokens."""
    sq = x.shape[1]
    size = cache_size or sq
    ys = {}

    def keep(**kw):
        for name, t in kw.items():
            ys.setdefault(name, []).append(t)

    h = x
    for i in range(cfg.num_layers):
        lp = _layer(stacked, i)
        if cfg.arch_type == "ssm":
            out, (conv, state) = S.ssm_mixer(cfg, lp,
                                             L.rms_norm(h, lp["norm"]))
            keep(conv=conv, state=state)
            h = h + out
            continue
        xn = L.rms_norm(h, lp["attn_norm"])
        a_out, k, v = _attn_seq(cfg, lp, xn, positions)
        if size > sq:
            k, v = (F.pad(t, (0, 0, 0, 0, 0, size - sq)) for t in (k, v))
        if cfg.kv_quant_int8:
            (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
            keep(k=kq, k_scale=ks, v=vq, v_scale=vs)
        else:
            keep(k=k, v=v)
        if cfg.arch_type == "hybrid":
            s_out, (conv, state) = S.ssm_mixer(cfg, lp, xn)
            keep(conv=conv, state=state)
            h = h + _mix(lp, a_out, s_out)
        else:
            h = h + a_out
        h = _ffn(cfg, lp, h)
    return h, {name: torch.stack(ts) for name, ts in ys.items()}


def _attn_decode(cfg, lp, xn, cache, i, cache_len: int):
    """One-token attention of layer ``i``: writes the new K/V (int8 with
    its scales under kv_quant_int8) at ``cache_len``, in place, and
    attends over positions [0, cache_len]."""
    q, k, v = L.qkv_project(cfg, lp, xn)
    pos = torch.full((1, 1), cache_len, dtype=torch.int32, device=xn.device)
    q = L.apply_rope(q, pos, cfg.rope_theta)
    k = L.apply_rope(k, pos, cfg.rope_theta)
    kc, vc = cache["k"][i], cache["v"][i]
    if cfg.kv_quant_int8:
        (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
        kc[:, cache_len], vc[:, cache_len] = kq[:, 0], vq[:, 0]
        ksc, vsc = cache["k_scale"][i], cache["v_scale"][i]
        ksc[:, cache_len], vsc[:, cache_len] = ks[:, 0], vs[:, 0]
        out = L.decode_attention(q, kc.float() * ksc[..., None],
                                 vc.float() * vsc[..., None], cache_len + 1,
                                 window=cfg.sliding_window).to(xn.dtype)
    else:
        kc[:, cache_len], vc[:, cache_len] = k[:, 0], v[:, 0]
        out = L.decode_attention(q, kc, vc, cache_len + 1,
                                 window=cfg.sliding_window)
    return L.attn_out(lp, out)


def decode_step(cfg, stacked, cache, x, cache_len: int):
    """One token x (B, 1, d) embedded, at position ``cache_len``, against
    the cache of :func:`prefill`, which it updates in place. Returns
    (hidden (B, 1, d), cache)."""
    h = x
    for i in range(cfg.num_layers):
        lp = _layer(stacked, i)
        if cfg.arch_type == "ssm":
            out, (conv, state) = S.ssm_decode_step(
                cfg, lp, L.rms_norm(h, lp["norm"]), cache["conv"][i],
                cache["state"][i])
            cache["conv"][i], cache["state"][i] = conv, state
            h = h + out
            continue
        xn = L.rms_norm(h, lp["attn_norm"])
        a_out = _attn_decode(cfg, lp, xn, cache, i, cache_len)
        if cfg.arch_type == "hybrid":
            s_out, (conv, state) = S.ssm_decode_step(
                cfg, lp, xn, cache["conv"][i], cache["state"][i])
            cache["conv"][i], cache["state"][i] = conv, state
            h = h + _mix(lp, a_out, s_out)
        else:
            h = h + a_out
        h = _ffn(cfg, lp, h)
    return h, cache
