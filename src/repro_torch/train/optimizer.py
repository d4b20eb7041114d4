"""AdamW and learning-rate schedules, as plain functions on tensors.

The counterpart of ``repro.train.optimizer``: configurable optimizer-state
dtype (bf16 states for the trillion-parameter Kimi-K2) and the WSD
(warmup-stable-decay) schedule of MiniCPM [arXiv:2404.06395]. Parameters,
gradients and the moments are nested dicts of tensors of one structure;
``apply_adamw`` updates the parameters and moments in place. Every
quantity of the update is a tensor on the parameters' device, so a step
never waits for the device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.models.model import named_leaves


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"
    schedule: str = "cosine"        # "cosine" | "wsd" | "const"
    warmup_steps: int = 100
    total_steps: int = 10000
    decay_frac: float = 0.1         # WSD: final fraction spent decaying


def _f32(step):
    return torch.as_tensor(step).float()


def cosine_schedule(cfg: AdamWConfig, step):
    """Linear warmup, then a half cosine to 0 at ``total_steps``; float32."""
    step = _f32(step)
    warm = (step / max(cfg.warmup_steps, 1)).clamp(max=1.0)
    t = ((step - cfg.warmup_steps)
         / max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0, 1)
    return cfg.lr * warm * (0.5 * (1 + torch.cos(math.pi * t)))


def wsd_schedule(cfg: AdamWConfig, step):
    """Warmup-Stable-Decay (MiniCPM): linear warmup, flat, then an
    exponential tail over the last ``decay_frac`` (halving every tenth of
    it); float32."""
    step = _f32(step)
    warm = (step / max(cfg.warmup_steps, 1)).clamp(max=1.0)
    decay_start = cfg.total_steps * (1 - cfg.decay_frac)
    t = (step - decay_start) / max(cfg.total_steps - decay_start, 1)
    decay = torch.where(step > decay_start, 0.5 ** (t * 10.0),
                        torch.ones_like(t))
    return cfg.lr * warm * decay


def schedule_fn(cfg: AdamWConfig) -> Callable:
    return {"cosine": cosine_schedule, "wsd": wsd_schedule,
            "const": lambda c, s: _f32(c.lr)}[cfg.schedule]


def leaves(tree):
    """The tensors of a nested dict, in its order."""
    return (v for _, v in named_leaves(tree))


def tree_map(fn, tree, *rest):
    """A nested dict of ``fn`` over the matching leaves of ``tree`` and of
    the trees in ``rest`` (same structure)."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def _state_dtype(cfg: AdamWConfig):
    return torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32


def init_opt_state(cfg: AdamWConfig, params):
    """Zero first and second moments in ``cfg.state_dtype`` and step 0
    (an int32 scalar on the parameters' device)."""
    dt = _state_dtype(cfg)
    device = next(leaves(params)).device
    return {"mu": tree_map(lambda p: torch.zeros_like(p, dtype=dt), params),
            "nu": tree_map(lambda p: torch.zeros_like(p, dtype=dt), params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(x.float().square().sum() for x in leaves(tree)))


@torch.no_grad()
def apply_adamw(cfg: AdamWConfig, params, grads, state):
    """One AdamW step, in place on ``params`` and ``state``: gradients
    clipped to a global norm of ``grad_clip``, bias-corrected moments, the
    update in float32, decoupled weight decay on tensors with ndim >= 2
    only. Returns {"lr", "grad_norm"} (float32 scalars)."""
    state["step"] += 1
    step = state["step"].float()
    lr = schedule_fn(cfg)(cfg, step)
    gnorm = global_norm(grads)
    scale = (cfg.grad_clip / (gnorm + 1e-9)).clamp(max=1.0)
    bc1 = 1 - torch.tensor(cfg.b1, device=step.device) ** step
    bc2 = 1 - torch.tensor(cfg.b2, device=step.device) ** step
    for p, g, mu, nu in zip(leaves(params), leaves(grads),
                            leaves(state["mu"]), leaves(state["nu"])):
        g = g.float() * scale
        mu_n = cfg.b1 * mu.float() + (1 - cfg.b1) * g
        nu_n = cfg.b2 * nu.float() + (1 - cfg.b2) * g * g
        del g
        mu.copy_(mu_n)
        nu.copy_(nu_n)
        delta = (mu_n / bc1) / (torch.sqrt(nu_n / bc2) + cfg.eps)
        del mu_n, nu_n
        p32 = p.float()
        if p.dim() >= 2:         # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
    return {"lr": lr, "grad_norm": gnorm}
