"""Prompt and output length samplers of the synthetic workloads.

The JAX package's ``data/pipeline.py`` also holds the training token
pipeline, which builds ``jax.numpy`` batches; the serving workloads need
only these two samplers, copied verbatim from it.
"""
from __future__ import annotations

import numpy as np


def prompt_lengths(rng: np.random.Generator, kind: str = "sharegpt") -> int:
    """Sample a prompt length from a ShareGPT-like mixture (tokens)."""
    if kind == "sharegpt":
        # lognormal body + long tail; matches the 1k-5k cached-context range
        # the paper measures in §7.6
        x = int(rng.lognormal(mean=6.6, sigma=0.8))
        return int(np.clip(x, 64, 8192))
    if kind == "agentcode":
        x = int(rng.lognormal(mean=7.2, sigma=0.6))
        return int(np.clip(x, 256, 12288))
    raise ValueError(kind)


def output_lengths(rng: np.random.Generator, kind: str = "sharegpt") -> int:
    x = int(rng.lognormal(mean=5.3, sigma=0.7))
    return int(np.clip(x, 16, 2048))
