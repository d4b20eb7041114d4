"""Meta-tensor input stand-ins for every (architecture x input shape).

The counterpart of ``repro.launch.specs``: tensors on the meta device, so
nothing is allocated; they are the dry-run's inputs. Decode shapes build
the KV-cache (one new token against a cache of ``seq_len``); modality
frontends contribute patch / frame embedding inputs (the stubbed encoder
per the assignment spec).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import INPUT_SHAPES, config_for_shape
from repro_torch.models import model as M


def _f(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _i(shape):
    return torch.empty(shape, dtype=torch.int32, device="meta")


def input_specs(cfg, shape_name: str) -> dict:
    """Returns the kwargs of the step function of this shape."""
    shp = INPUT_SHAPES[shape_name]
    cfg = config_for_shape(cfg, shp)
    B, S = shp.global_batch, shp.seq_len

    if shp.kind in ("train", "prefill"):
        batch = {"tokens": _i((B, S))}
        if shp.kind == "train":
            batch["targets"] = _i((B, S))
        if cfg.arch_type == "vlm":
            batch["patches"] = _f((B, cfg.num_patch_tokens, cfg.d_model))
        if cfg.arch_type == "audio":
            batch["frames"] = _f((B, cfg.encoder_frames, cfg.d_model))
        return {"batch": batch}

    # decode: ONE new token against a cache of seq_len
    cache = {k: _f(shape, dtype)
             for k, (shape, dtype) in M.cache_specs(cfg, B, S).items()}
    return {"cache": cache, "tokens": _i((B,)), "cache_len": _i(())}
