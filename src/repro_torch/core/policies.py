"""Waiting-request selection policies for the opportunistic gate (§4.2/§7.5).

``first_fit`` is the published default: it preserves the queue order the
Spatial Scheduler already optimized, achieving the best latency/throughput
balance in the paper's Fig. 15. ``best_fit`` and ``priority_first`` are the
compared alternatives.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.core.request import Request


def _fits(req: Request, freed_blocks: int, token_capacity: float,
          block_tokens: int) -> bool:
    need = req.blocks_needed(block_tokens)
    return need <= freed_blocks and req.remaining_tokens <= token_capacity


def first_fit(waiting: List[Request], freed_blocks: int,
              token_capacity: float, block_tokens: int) -> Optional[Request]:
    for r in waiting:
        if _fits(r, freed_blocks, token_capacity, block_tokens):
            return r
    return None


def best_fit(waiting: List[Request], freed_blocks: int,
             token_capacity: float, block_tokens: int) -> Optional[Request]:
    fit = [r for r in waiting
           if _fits(r, freed_blocks, token_capacity, block_tokens)]
    if not fit:
        return None
    return min(fit, key=lambda r: freed_blocks - r.blocks_needed(block_tokens))


def priority_first(waiting: List[Request], freed_blocks: int,
                   token_capacity: float, block_tokens: int) -> Optional[Request]:
    """Highest-priority request that fits the freed *blocks* — deliberately
    ignores the token-capacity window (paper §7.5: it favors important long
    requests over small ones that would complete within the window, which
    lowers the mean but inflates the tail)."""
    fit = [r for r in waiting
           if r.blocks_needed(block_tokens) <= freed_blocks]
    if not fit:
        return None
    return max(fit, key=lambda r: r.priority)


POLICIES = {"first_fit": first_fit, "best_fit": best_fit,
            "priority_first": priority_first}
