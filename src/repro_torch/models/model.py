"""Model API: parameters, the paged decode and prefill steps of the
serving path, the LM head, and dense-cache prefill / decode.

    params = init_params(cfg, generator, device)        # random, from a seed
    params = load_jax_params(numpy_tree, device)        # the JAX weights
    logits = paged_decode_step(cfg, params, k_pool, v_pool, tokens, ...)
    hidden = paged_prefill_step(cfg, params, k_pool, v_pool, tokens, ...)
    logits = head_logits(cfg, params, hidden_rows)
    logits, cache = prefill(cfg, params, {"tokens": tokens}, cache_size)
    logits, cache = decode_step(cfg, params, cache, tokens, cache_len)

The paged steps serve dense and MoE stacks; ``prefill`` / ``decode_step``
run the dense and MoE (with or without a sliding window), SSM and hybrid
stacks on text batches.

Parameters are a dict shaped like the JAX ``init_params`` pytree:
``embed`` (V, d), ``unembed`` (d, V), ``final_norm`` (d,) and ``layers``,
a dict of stacked (L, ...) tensors. The steps write the pools in place
(the JAX steps donate them and return new ones).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import decoder as D
from repro_torch.models import layers as L
from repro_torch.models import ssm as S


def torch_dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def init_params(cfg, generator: torch.Generator, device):
    """Random weights at the JAX package's scales, drawn with
    ``generator`` on ``device`` one stacked layer at a time."""
    dtype = torch_dtype(cfg)
    return {
        "embed": L.embed_init((cfg.vocab_size, cfg.d_model), dtype,
                              generator, device),
        "unembed": L.dense_init((cfg.d_model, cfg.vocab_size), dtype,
                                generator, device),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                  device=device),
        "layers": D.init_layer_stack(cfg, generator, dtype, device),
    }


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
    return params["embed"][tokens.long()]


def _lm_head(params, h):
    return L.rms_norm(h, params["final_norm"]) @ params["unembed"]


def paged_decode_step(cfg, params, k_pool, v_pool, tokens, tables,
                      positions, attn_lens, slots):
    """Batched decode step against the paged KV pool (written in place).
    tokens (B,) int; the other arguments as in ``decoder.paged_decode``.
    Returns logits (B, V)."""
    x = _embed_tokens(params, tokens[:, None])
    h = D.paged_decode(cfg, params["layers"], x, k_pool, v_pool, tables,
                       positions, attn_lens, slots)
    return _lm_head(params, h)[:, 0]


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
    return _lm_head(params, h[:, None])[:, 0]


# ---------------------------------------------------------------------------
# dense-cache prefill and decode (dense, moe, ssm, hybrid; text batches)
# ---------------------------------------------------------------------------

def _assemble_inputs(cfg, params, batch):
    """Embedded tokens (B, S, d) and positions (1, S) of a text batch."""
    if cfg.arch_type in ("vlm", "audio"):
        raise NotImplementedError(
            f"arch_type {cfg.arch_type!r}: image and audio inputs come in a "
            "later slice of the port")
    tokens = batch["tokens"]
    pos = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    return _embed_tokens(params, tokens), pos


def prefill(cfg, params, batch, cache_size=None):
    """Prefill ``batch["tokens"]`` (B, S) int. Returns (last-position
    logits (B, 1, V), cache) with the K/V caches sized to ``cache_size``
    tokens (default S); see ``decoder.prefill`` for the cache's layout."""
    x, pos = _assemble_inputs(cfg, params, batch)
    h, cache = D.prefill(cfg, params["layers"], x, pos,
                         cache_size or x.shape[1])
    return _lm_head(params, h[:, -1:]), cache


def decode_step(cfg, params, cache, tokens, cache_len: int):
    """tokens (B,) int at position ``cache_len`` (tokens already cached);
    updates ``cache`` in place. Returns (logits (B, V), cache)."""
    x = _embed_tokens(params, tokens[:, None])
    h, cache = D.decode_step(cfg, params["layers"], cache, x, cache_len)
    return _lm_head(params, h)[:, 0], cache


def cache_specs(cfg, batch_size: int, cache_size: int):
    """{name: (shape, dtype)} of the cache that ``prefill`` returns."""
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
    if cfg.arch_type in ("ssm", "hybrid"):
        _, _, conv_dim = S.proj_dims(cfg)
        specs["conv"] = ((nl, batch_size, cfg.ssm_conv_width - 1, conv_dim),
                         dtype)
        specs["state"] = ((nl, batch_size, cfg.ssm_heads, cfg.ssm_head_dim,
                           cfg.ssm_state), torch.float32)
    return specs
