"""Model API of the serving path: parameters, paged decode and prefill
steps, and the LM head.

    params = init_params(cfg, generator, device)        # random, from a seed
    params = load_jax_params(numpy_tree, device)        # the JAX weights
    logits = paged_decode_step(cfg, params, k_pool, v_pool, tokens, ...)
    hidden = paged_prefill_step(cfg, params, k_pool, v_pool, tokens, ...)
    logits = head_logits(cfg, params, hidden_rows)

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
