"""Model API: parameters, the training loss, the paged decode and prefill
steps of the serving path, the LM head, and dense-cache prefill / decode.

    params = init_params(cfg, generator, device)        # random, from a seed
    params = load_jax_params(numpy_tree, device)        # the JAX weights
    specs  = param_specs(cfg)                           # shapes only
    loss, metrics = loss_fn(cfg, params, batch)         # training
    logits = paged_decode_step(cfg, params, k_pool, v_pool, tokens, ...)
    hidden = paged_prefill_step(cfg, params, k_pool, v_pool, tokens, ...)
    logits = head_logits(cfg, params, hidden_rows)
    logits, cache = prefill(cfg, params, batch, cache_size)
    logits, cache = decode_step(cfg, params, cache, tokens, cache_len)

The paged steps serve dense and MoE stacks; ``loss_fn``, ``prefill`` and
``decode_step`` run every family. Batches hold int ``tokens`` and
``targets`` (B, S), plus ``patches`` (B, P, d) for VLM (precomputed
projected patch embeddings, ahead of the text) and ``frames`` (B, F, d)
for audio (precomputed post-conv frame embeddings).

Parameters are a dict shaped like the JAX ``init_params`` pytree:
``embed`` (V, d), ``unembed`` (d, V), ``final_norm`` (d,) and ``layers``,
a dict of stacked (L, ...) tensors, or for audio ``encoder``, ``decoder``
and ``enc_ln_post`` (``encdec``). The steps write the pools in place (the
JAX steps donate them and return new ones).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.models import decoder as D
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.sharding import logical


def torch_dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def init_params(cfg, generator, device):
    """Random weights at the JAX package's scales, drawn with
    ``generator`` on ``device`` one stacked layer at a time."""
    dtype = torch_dtype(cfg)
    p = {
        "embed": L.embed_init((cfg.vocab_size, cfg.d_model), dtype,
                              generator, device),
        "unembed": L.dense_init((cfg.d_model, cfg.vocab_size), dtype,
                                generator, device),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                  device=device),
    }
    if cfg.arch_type == "audio":
        p.update(ED.init_encdec(cfg, generator, dtype, device))
    else:
        p["layers"] = D.init_layer_stack(cfg, generator, dtype, device)
    return p


def named_leaves(tree, prefix=""):
    """("path/of/leaf", tensor) for every tensor of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from named_leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def param_specs(cfg):
    """{"path/of/leaf": (shape, dtype)} of ``init_params(cfg)``, built on
    the meta device: nothing is allocated (Kimi-K2's tree holds about
    10**12 parameters)."""
    params = init_params(cfg, None, torch.device("meta"))
    return {k: (tuple(v.shape), v.dtype) for k, v in named_leaves(params)}


def param_count(params) -> int:
    return sum(v.numel() for _, v in named_leaves(params))


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)            # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def load_jax_params(np_tree, device):
    """Convert the JAX ``init_params`` pytree, given as nested dicts of
    numpy arrays (bfloat16 included), into this package's params."""
    if isinstance(np_tree, dict):
        return {k: load_jax_params(v, device) for k, v in np_tree.items()}
    return _to_tensor(np_tree, device)


def _embed_tokens(params, tokens):
    return logical(params["embed"][tokens.long()], "batch", "seq", "embed")


def _lm_head(cfg, params, h):
    """Final RMSNorm (none in the audio model) and the unembedding."""
    if cfg.arch_type != "audio":
        h = L.rms_norm(h, params["final_norm"])
    return logical(h @ params["unembed"], "batch", "seq", "vocab")


def paged_decode_step(cfg, params, k_pool, v_pool, tokens, tables,
                      positions, attn_lens, slots):
    """Batched decode step against the paged KV pool (written in place).
    tokens (B,) int; the other arguments as in ``decoder.paged_decode``.
    Returns logits (B, V)."""
    x = _embed_tokens(params, tokens[:, None])
    h = D.paged_decode(cfg, params["layers"], x, k_pool, v_pool, tables,
                       positions, attn_lens, slots)
    return _lm_head(cfg, params, h)[:, 0]


def paged_prefill_step(cfg, params, k_pool, v_pool, tokens, tables,
                       q_pos, wpages, wstart, wcount):
    """Chunked suffix-prefill step against the paged KV pool (written in
    place). tokens (B, C) int; the other arguments as in
    ``decoder.paged_prefill``. Returns hidden (B, C, d)."""
    x = _embed_tokens(params, tokens)
    return D.paged_prefill(cfg, params["layers"], x, k_pool, v_pool, tables,
                           q_pos, wpages, wstart, wcount)


def head_logits(cfg, params, h):
    """Final norm + unembed for selected hidden rows: (B, d) -> (B, V)."""
    return _lm_head(cfg, params, h[:, None])[:, 0]


# ---------------------------------------------------------------------------
# inputs, training loss, dense-cache prefill and decode
# ---------------------------------------------------------------------------

def _assemble_inputs(cfg, params, batch):
    """(embedded inputs (B, S', d), positions (1, S'), loss mask (B, S')
    float32, encoder output or None). VLM puts the patches ahead of the
    text and masks them out of the loss; audio encodes the frames."""
    tokens = batch["tokens"]
    x = _embed_tokens(params, tokens)
    ones = torch.ones(tokens.shape, dtype=torch.float32, device=x.device)
    if cfg.arch_type == "vlm":
        patches = batch["patches"].to(x.dtype)
        x = torch.cat([patches, x], dim=1)
        pos = torch.arange(x.shape[1], device=x.device)[None, :]
        mask = torch.cat([ones.new_zeros(patches.shape[:2]), ones], dim=1)
        return x, pos, mask, None
    pos = torch.arange(tokens.shape[1], device=x.device)[None, :]
    enc_out = None
    if cfg.arch_type == "audio":
        enc_out = ED.encode(cfg, params, batch["frames"].to(x.dtype))
    return x, pos, ones, enc_out


def loss_fn(cfg, params, batch):
    """Causal LM loss. Returns (loss + MoE aux loss, {"xent", "aux"}),
    float32 scalars; VLM scores the text positions only."""
    x, pos, mask, enc_out = _assemble_inputs(cfg, params, batch)
    if cfg.arch_type == "audio":
        h = ED.decode_forward(cfg, params, x, pos, enc_out)
        aux = x.new_zeros((), dtype=torch.float32)
    else:
        h, aux = D.forward(cfg, params["layers"], x, pos)
    logits = _lm_head(cfg, params, h)
    if cfg.arch_type == "vlm":
        # only text positions carry loss; targets align to the text suffix
        logits = logits[:, -batch["tokens"].shape[1]:]
    loss = L.softmax_xent(logits[:, :-1], batch["targets"][:, 1:],
                          mask[:, -logits.shape[1]:][:, 1:])
    return loss + aux, {"xent": loss, "aux": aux}


def prefill(cfg, params, batch, cache_size=None):
    """Prefill a batch (``tokens`` (B, S) int, plus ``patches`` or
    ``frames``). Returns (last-position logits (B, 1, V), cache) with the
    K/V caches sized to ``cache_size`` positions (default: the inputs',
    P + S for VLM); see ``decoder.prefill`` and ``encdec`` for the
    caches' layouts."""
    x, pos, _, enc_out = _assemble_inputs(cfg, params, batch)
    size = cache_size or x.shape[1]
    if cfg.arch_type == "audio":
        h, cache = ED.decode_prefill(cfg, params, x, pos, enc_out, size)
    else:
        h, cache = D.prefill(cfg, params["layers"], x, pos, size)
    return _lm_head(cfg, params, h[:, -1:]), cache


def decode_step(cfg, params, cache, tokens, cache_len: int):
    """tokens (B,) int at position ``cache_len`` (positions already cached,
    P + S after a VLM prefill); updates ``cache`` in place. Returns
    (logits (B, V), cache)."""
    x = _embed_tokens(params, tokens[:, None])
    if cfg.arch_type == "audio":
        h, cache = ED.decode_step(cfg, params, cache, x, cache_len)
    else:
        h, cache = D.decode_step(cfg, params["layers"], cache, x, cache_len)
    return _lm_head(cfg, params, h)[:, 0], cache


def cache_specs(cfg, batch_size: int, cache_size: int, frames: int = 0):
    """{name: (shape, dtype)} of the cache that ``prefill`` returns; the
    audio model's cross-attention K/V hold ``frames`` encoder positions
    (default ``cfg.encoder_frames``)."""
    dtype, nl = torch_dtype(cfg), cfg.num_layers
    specs = {}
    if cfg.arch_type != "ssm":
        kv = (nl, batch_size, cache_size, cfg.num_kv_heads, cfg.head_dim)
        if cfg.kv_quant_int8:
            specs.update(k=(kv, torch.int8), v=(kv, torch.int8),
                         k_scale=(kv[:-1], torch.float32),
                         v_scale=(kv[:-1], torch.float32))
        else:
            specs.update(k=(kv, dtype), v=(kv, dtype))
    if cfg.arch_type == "audio":
        ckv = (nl, batch_size, frames or cfg.encoder_frames,
               cfg.num_kv_heads, cfg.head_dim)
        specs.update(cross_k=(ckv, dtype), cross_v=(ckv, dtype))
    if cfg.arch_type in ("ssm", "hybrid"):
        _, _, conv_dim = S.proj_dims(cfg)
        specs["conv"] = ((nl, batch_size, cfg.ssm_conv_width - 1, conv_dim),
                         dtype)
        specs["state"] = ((nl, batch_size, cfg.ssm_heads, cfg.ssm_head_dim,
                           cfg.ssm_state), torch.float32)
    return specs


def cache_bytes(cfg, batch_size: int, cache_size: int) -> int:
    return sum(math.prod(shape) * dtype.itemsize for shape, dtype
               in cache_specs(cfg, batch_size, cache_size).values())
