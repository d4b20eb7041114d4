"""Deterministic synthetic data: the training token pipeline and the
prompt and output length samplers of the synthetic workloads.

The counterpart of ``repro.data.pipeline``. The offline container has no
ShareGPT / AgentCode, so the pipeline synthesizes token streams with a
Zipf unigram distribution plus injected bigram structure (so models can
actually reduce loss). ``TokenPipeline`` draws the same numpy stream in the
same order as the JAX one, so their batches are equal element for element;
it yields CPU tensors, which the train loop moves to its device. The two
samplers are copied verbatim.
"""
from __future__ import annotations

import numpy as np
import torch


class TokenPipeline:
    """Infinite iterator of training batches for a given config: int32
    ``tokens`` and ``targets`` (B, S), plus float32 ``patches`` (VLM) or
    ``frames`` (audio)."""

    def __init__(self, cfg, batch_size: int, seq_len: int, seed: int = 0):
        self.cfg = cfg
        self.batch = batch_size
        self.seq = seq_len
        self.rng = np.random.default_rng(seed)
        v = cfg.vocab_size
        # Zipf-ish unigram over the vocab
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = 1.0 / ranks ** 1.1
        self.unigram = p / p.sum()
        self.v = v

    def _sample_tokens(self, n):
        toks = self.rng.choice(self.v, size=n, p=self.unigram)
        # token t is followed by (t * 7 + 3) % v with probability 0.5
        follow = (toks[:-1] * 7 + 3) % self.v
        mask = self.rng.random(n - 1) < 0.5
        toks[1:][mask] = follow[mask]
        return toks

    def _embeddings(self, n):
        return torch.from_numpy(self.rng.standard_normal(
            (self.batch, n, self.cfg.d_model), dtype=np.float32) * 0.02)

    def next_batch(self):
        toks = torch.from_numpy(self._sample_tokens(
            self.batch * self.seq).reshape(self.batch, self.seq)
            .astype(np.int32))
        batch = {"tokens": toks, "targets": toks}
        if self.cfg.arch_type == "vlm":
            batch["patches"] = self._embeddings(self.cfg.num_patch_tokens)
        if self.cfg.arch_type == "audio":
            batch["frames"] = self._embeddings(self.cfg.encoder_frames)
        return batch

    def __iter__(self):
        return self

    def __next__(self):
        return self.next_batch()


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
