"""Training loop: the train step (autograd on ``loss_fn``, then AdamW) and
a host loop with logging and checkpointing.

The counterpart of ``repro.train.train_loop``: the same history dicts and
log line. Batches come from the pipeline as CPU tensors and are moved to
the parameters' device here; the loop reads a metric on the host only at
a logged step.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from repro_torch.models import model as M
from repro_torch.train import optimizer as O


def make_grad_step(cfg) -> Callable:
    """Returns ``grad_step(params, batch) -> (loss, metrics, grads)``: the
    loss of ``loss_fn`` and its gradient for every leaf of ``params``
    (a nested dict of the same structure); loss and metrics are detached
    float32 scalars on the device."""

    def grad_step(params, batch):
        leaves = list(O.leaves(params))
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss, metrics = M.loss_fn(cfg, params, batch)
            # a leaf the loss does not read (the audio model's final_norm)
            # gets a zero gradient, as under jax.grad
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        it = iter(grads)
        grads = O.tree_map(lambda _: next(it), params)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    return grad_step


def make_train_step(cfg, opt_cfg: O.AdamWConfig) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``: ``make_grad_step``'s gradients, then
    ``apply_adamw``, which updates ``params`` and ``opt_state`` in place;
    metrics are {"xent", "aux", "loss", "lr", "grad_norm"}, float32
    scalars on the device."""
    grad_step = make_grad_step(cfg)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = grad_step(params, batch)
        opt_metrics = O.apply_adamw(opt_cfg, params, grads, opt_state)
        return params, opt_state, dict(metrics, loss=loss, **opt_metrics)

    return train_step


def train(cfg, opt_cfg: O.AdamWConfig, data_iter, num_steps: int,
          params=None, device="cuda", seed: int = 0, log_every: int = 10,
          checkpoint_path: Optional[str] = None, checkpoint_every: int = 0,
          log_fn=print, on_step: Optional[Callable] = None):
    """Host-side training loop on ``device`` ("cuda" unless the caller asks
    for "cpu"), from ``params`` or from random weights drawn from
    ``seed``. ``on_step(step, params, opt_state, metrics)``, if given, runs
    after every step. Returns (params, opt_state, history)."""
    from repro_torch.train import checkpoint as C
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train(device='cuda') found no CUDA device; pass "
                           "device='cpu' to train on the CPU")
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = M.init_params(cfg, gen, device)
    opt_state = O.init_opt_state(opt_cfg, params)
    step_fn = make_train_step(cfg, opt_cfg)

    history = []
    t0 = time.perf_counter()
    for step in range(1, num_steps + 1):
        batch = {k: v.to(device) for k, v in next(data_iter).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if on_step is not None:
            on_step(step, params, opt_state, metrics)
        if step % log_every == 0 or step == num_steps:
            metrics = {k: float(v) for k, v in metrics.items()}
            metrics["step"] = step
            metrics["wall_s"] = time.perf_counter() - t0
            history.append(metrics)
            log_fn(f"step {step:5d} loss {metrics['loss']:.4f} "
                   f"xent {metrics['xent']:.4f} lr {metrics['lr']:.2e} "
                   f"gnorm {metrics['grad_norm']:.2f}")
        if checkpoint_path and checkpoint_every and \
                step % checkpoint_every == 0:
            C.save(checkpoint_path, {"params": params, "opt": opt_state,
                                     "step": step})
    return params, opt_state, history
