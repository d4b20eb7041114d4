"""Mixture-of-Experts FFN with sort-based capacity dispatch.

The counterpart of ``repro.models.moe``, step for step. Tokens are routed
by a float32 top-k softmax router, their (token, slot) entries sorted
stably by expert id (so within an expert they keep the order token·k +
slot, and the same entries overflow as in the reference), packed into a
dense (experts, capacity, d_model) buffer, run through three batched
expert products, gathered back and summed with their gates in float32.
Entries past an expert's capacity are dropped; so are padded rows, which
``pad_mask`` routes to the sentinel expert id E.

No step synchronises with the host (no ``.item()``, boolean indexing,
``nonzero`` or ``bincount``), so the paged serving steps that call it
capture into CUDA graphs: the per-expert counts come from ``index_add_``,
and a dropped entry is packed into one extra row of the buffer, which the
products never read, and reads back from a zero row appended to their
output.

The JAX function returns the router's auxiliary loss beside its output;
here it is a helper of its own, :func:`aux_loss`, which only training
calls: the serving steps never compute it (XLA drops it from the jitted
paged steps of the JAX package).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.sharding import logical


def init_moe(cfg, generator, n_layers: int, dtype, device):
    """Stacked expert params at the JAX package's shapes and scales: the
    router ``wr`` (L, d, E) float32 whatever ``dtype`` is, ``we1`` and
    ``we3`` (L, E, d, f), ``we2`` (L, E, f, d). Each expert's matrices are
    drawn one at a time, straight into the stack."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts

    def init(shape, scale=None):
        return L.stacked_init((n_layers, e), shape, dtype, generator, device,
                              scale)

    return {
        "wr": L.stacked_init(n_layers, (d, e), torch.float32, generator,
                             device),
        "we1": init((d, f)),
        "we3": init((d, f)),
        "we2": init((f, d), scale=1.0 / math.sqrt(f * cfg.num_layers)),
    }


def capacity(num_tokens: int, cfg, factor: float = None) -> int:
    """Slots per expert for ``num_tokens`` tokens (the padded count: the
    shape, not the data, sets it)."""
    factor = cfg.moe_capacity_factor if factor is None else factor
    cap = int(math.ceil(num_tokens * cfg.experts_per_token
                        / cfg.num_experts * factor))
    return max(cap, cfg.experts_per_token, 4)


def route(cfg, lp, xt, valid=None):
    """The router over tokens xt (T, d): float32 logits (T, E), their
    softmax, the top-k gates renormalised to sum 1 (T, k), and the expert
    id of each (token, slot) entry, flat (T·k,) int64. With ``valid`` (T,)
    bool, padded tokens get gates 0 and the sentinel id E."""
    e, k = cfg.num_experts, cfg.experts_per_token
    logits = xt.float() @ lp["wr"]
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_e = idx.reshape(-1)
    if valid is not None:
        flat_e = torch.where(valid[:, None].expand(-1, k).reshape(-1),
                             flat_e, e)
        gate = gate * valid.float()[:, None]
    return logits, probs, gate, flat_e


def dispatch(cfg, flat_e, cap: int):
    """Where the flat (token, slot) entries go: ``sort_idx``, the stable
    argsort of their expert ids ``flat_e`` (T·k,), and ``slot`` (T·k,),
    the row of the j-th sorted entry in the packed (E·cap + 1, d) buffer:
    expert · cap + its rank within the expert's segment, or E·cap, the
    last row, for an entry that is dropped (rank >= ``cap``, or the
    sentinel expert E). Ranks come from per-expert counts over E + 1 ids
    and their exclusive cumsum, so the sentinel segment has ranks too."""
    e = cfg.num_experts
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    counts = torch.zeros(e + 1, dtype=torch.int32, device=flat_e.device)
    counts.index_add_(0, sorted_e, torch.ones_like(sorted_e,
                                                   dtype=torch.int32))
    starts = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    rank = torch.arange(flat_e.shape[0], device=flat_e.device) \
        - starts[sorted_e]
    keep = (rank < cap) & (sorted_e < e)
    return sort_idx, torch.where(keep, sorted_e * cap + rank, e * cap)


def moe_ffn(cfg, lp, x, pad_mask=None):
    """x (B, S, d) -> (B, S, d).

    ``lp`` holds one layer's expert params: wr (d, E), we1 / we3 (E, d, f),
    we2 (E, f, d). ``pad_mask`` (B, S) bool marks real tokens; padded rows
    take no expert capacity and come out exactly zero. Without a mask
    every token is real."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    xt = x.reshape(t, d)
    valid = None if pad_mask is None else pad_mask.reshape(t)
    _, _, gate, flat_e = route(cfg, lp, xt, valid)
    cap = capacity(t, cfg)
    sort_idx, slot = dispatch(cfg, flat_e, cap)
    buf = x.new_zeros((e * cap + 1, d)).index_copy_(0, slot,
                                                    xt[sort_idx // k])
    xb = logical(buf[:e * cap].view(e, cap, d), "experts", "expert_cap",
                 None)

    # the experts, batched
    h = torch.bmm(xb, lp["we1"])
    g = torch.bmm(xb, lp["we3"])
    h = logical(F.silu(h.float()).to(x.dtype) * g, "experts", "expert_cap",
                "ffn")
    out = logical(torch.bmm(h, lp["we2"]), "experts", "expert_cap", None)

    # combine: dropped entries read the appended zero row; unsort to the
    # (token, slot) order and sum the k slots weighted by their gates
    expert_out = F.pad(out.view(e * cap, d), (0, 0, 0, 1))[slot]
    unsorted = torch.empty_like(expert_out).index_copy_(0, sort_idx,
                                                        expert_out)
    y = (unsorted.view(t, k, d).float() * gate[..., None]).sum(1)
    return y.to(x.dtype).view(b, s, d)


def aux_loss(cfg, lp, x, pad_mask=None):
    """The router's auxiliary loss on x (B, S, d), as
    ``repro.models.moe.moe_ffn`` returns it beside its output: the
    Switch-style load-balance term (E · sum of mean probability times
    routed fraction per expert, times ``moe_router_aux_coef``) plus 1e-4
    times the mean squared logsumexp of the logits (z-loss); with
    ``pad_mask``, over real tokens only. A float32 scalar."""
    e, k = cfg.num_experts, cfg.experts_per_token
    t = x.shape[0] * x.shape[1]
    xt = x.reshape(t, -1)
    valid = None if pad_mask is None else pad_mask.reshape(t)
    logits, probs, _, flat_e = route(cfg, lp, xt, valid)
    z = torch.logsumexp(logits, dim=-1) ** 2
    routed = torch.zeros(e + 1, dtype=torch.float32, device=x.device)
    if valid is None:
        me = probs.mean(0)
        ce = routed.index_add_(0, flat_e, torch.ones_like(
            flat_e, dtype=torch.float32))[:e] / (t * k)
        zl = z.mean()
    else:
        vf = valid.float()
        nv = vf.sum().clamp_min(1.0)
        me = (probs * vf[:, None]).sum(0) / nv
        # padded entries carry the sentinel id E, whose count is dropped
        ce = routed.index_add_(0, flat_e, vf[:, None].expand(-1, k)
                               .reshape(-1))[:e] / (nv * k)
        zl = (z * vf).sum() / nv
    return e * (me * ce).sum() * cfg.moe_router_aux_coef + 1e-4 * zl
