"""The Spatial Scheduler (paper §5).

Solves *critical inversion* at the memory level: GPU KV blocks are split into
a shared pool (all agents) and a reserved pool (critical agent types only).
Partition sizes adapt via watermark feedback (Alg. 2); criticality comes from
the hybrid priority metric (Eq. 5 per-request, Eq. 6 per-agent-type).

Published constants (§5.1): reserved ratio starts at 0.05, +-0.05 step at
usage >= 0.75 / <= 0.40, clamped to [0.05, 0.30]; critical-agent ratio 0.75.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.block_pool import DevicePool
from repro_torch.core.pressure import PressureSnapshot
from repro_torch.core.request import Request, ReqState


@dataclass
class SpatialConfig:
    # Alg. 2 step 1 (published §5.1)
    rho_init: float = 0.05
    rho_step: float = 0.05
    rho_min: float = 0.05
    rho_max: float = 0.30
    high_watermark: float = 0.75
    low_watermark: float = 0.40
    critical_ratio: float = 0.75          # top fraction of types protected
    adjust_window: float = 2.0            # seconds between re-partitions
    # Eq. 5 weights
    alpha_struct: float = 1.0
    alpha_sync: float = 0.6
    alpha_aging: float = 0.4
    # Eq. 6 weights (preemption weighted highest inside U_a)
    w_priority: float = 1.0
    w_urgency: float = 0.8
    w_recompute: float = 0.5
    w_graph: float = 0.4
    aging_halflife: float = 30.0          # seconds for the wait-time term


@dataclass
class AgentTypeStats:
    """Runtime statistics per agent type feeding S_a (Eq. 6)."""
    active: int = 0
    waiting: int = 0
    preemptions: int = 0
    gpu_blocks: int = 0
    total_tokens: int = 0
    total_exec_time: float = 0.0
    total_throughput: float = 0.0
    struct_max: float = 0.0               # static priority P_a
    depth_sum: float = 0.0
    fan_sum: float = 0.0


class SpatialScheduler:
    def __init__(self, pools: Sequence[DevicePool],
                 cfg: Optional[SpatialConfig] = None):
        self.pools = list(pools)
        self.cfg = cfg or SpatialConfig()
        self.rho = self.cfg.rho_init
        self.last_adjust = -1e9
        self.critical_types: set = set()
        self.scores: Dict[str, float] = {}

    # ------------------------------------------------------------------ Eq. 5
    def request_priority(self, req: Request, now: float,
                         app_progress: Dict[str, float],
                         branch_progress: Dict[Tuple[str, int], float]) -> float:
        """P_req = a_struct*f_struct + a_sync*f_sync + a_aging*f_aging."""
        c = self.cfg
        f_struct = req.graph.struct_score(req.node.node_id)

        # synchronization pressure: boost straggler branches at join points
        f_sync = 0.0
        for child in req.graph.children[req.node.node_id]:
            siblings = req.graph.nodes[child].deps
            if len(siblings) < 2:
                continue
            mine = branch_progress.get((req.app_id, req.node.node_id), 0.0)
            best = max(branch_progress.get((req.app_id, s), 0.0)
                       for s in siblings)
            if best > 0:
                f_sync = max(f_sync, 1.0 - mine / (best + 1e-9))
        f_sync = min(f_sync, 1.0)

        # temporal aging: graph remaining + queue wait + completion pressure
        remaining = 1.0 - app_progress.get(req.app_id, 0.0)
        wait = max(0.0, now - req.enqueue_time)
        wait_term = 1.0 - math.exp(-wait / c.aging_halflife)
        completion_push = app_progress.get(req.app_id, 0.0) ** 2
        f_aging = (remaining + wait_term + completion_push) / 3.0

        p = (c.alpha_struct * f_struct + c.alpha_sync * f_sync
             + c.alpha_aging * f_aging)
        if req.critical:
            p += 0.25   # static critical-path bonus
        return p

    # ------------------------------------------------------------------ Eq. 6
    def agent_type_score(self, st: AgentTypeStats,
                         norm: Dict[str, float]) -> float:
        """S_a = w1*P_a + w2*U_a + w3*H_a + w4*G_a."""
        c = self.cfg
        p_a = st.struct_max
        # urgency: preemption signals KV capacity loss -> larger coefficient
        u_a = (2.0 * st.preemptions + st.waiting) / max(norm["urgency"], 1.0)
        n = max(st.active, 1)
        h_a = (math.log1p(st.total_tokens / n)
               + math.log1p(st.total_exec_time / n)
               + math.log1p(st.total_throughput / n)) / max(norm["recomp"], 1.0)
        g_a = (st.depth_sum + st.fan_sum) / n / max(norm["graph"], 1.0)
        return (c.w_priority * p_a + c.w_urgency * min(u_a, 2.0)
                + c.w_recompute * min(h_a, 2.0) + c.w_graph * min(g_a, 2.0))

    def compute_scores(self, stats: Dict[str, AgentTypeStats]) -> Dict[str, float]:
        if not stats:
            return {}
        norm = {
            "urgency": max((2.0 * s.preemptions + s.waiting)
                           for s in stats.values()) or 1.0,
            "recomp": max((math.log1p(s.total_tokens / max(s.active, 1))
                           + math.log1p(s.total_exec_time / max(s.active, 1))
                           + math.log1p(s.total_throughput / max(s.active, 1)))
                          for s in stats.values()) or 1.0,
            "graph": max((s.depth_sum + s.fan_sum) / max(s.active, 1)
                         for s in stats.values()) or 1.0,
        }
        self.scores = {a: self.agent_type_score(s, norm)
                       for a, s in stats.items()}
        return self.scores

    # ----------------------------------------------------------------- Alg. 2
    def update_reservations(self, now: float,
                            stats: Dict[str, AgentTypeStats],
                            force: bool = False) -> bool:
        c = self.cfg
        if not force and now - self.last_adjust < c.adjust_window:
            return False
        self.last_adjust = now

        for pool in self.pools:
            n = pool.num_blocks
            usage = pool.usage
            # Step 1: adjust total reserved pool size
            if usage >= c.high_watermark:
                self.rho += c.rho_step
            elif usage <= c.low_watermark:
                self.rho -= c.rho_step
            self.rho = min(max(self.rho, c.rho_min), c.rho_max)

            # Step 2: select critical agent types via S_a
            scores = self.compute_scores(stats)
            active_types = [a for a, s in stats.items()
                            if s.active + s.waiting > 0]
            if not active_types:
                pool.reserved_quota = {}
                continue
            k = max(1, math.ceil(len(active_types) * c.critical_ratio))
            ranked = sorted(active_types, key=lambda a: -scores.get(a, 0.0))
            critical = ranked[:k]
            self.critical_types = set(critical)

            # Step 3: distribute reserved blocks among critical types
            total_s = sum(scores.get(a, 0.0) for a in critical) or 1.0
            quota = {}
            for a in critical:
                share = 0.5 * (stats[a].gpu_blocks / n
                               + scores.get(a, 0.0) / total_s)
                quota[a] = int(share * self.rho * n)
            pool.reserved_quota = quota
        return True

    # ------------------------------------------------------------- admission
    def admit(self, req: Request, n_blocks: int,
              headroom: int = 0) -> Optional[str]:
        """Try to allocate ``n_blocks`` on every device.

        Returns "reserved" | "shared" | None (defer). TP admission requires
        all devices to fit (paper §5 Multi-GPU). ``headroom`` keeps slack in
        the shared pool for decode growth (not applied to reserved draws).
        """
        a = req.agent_type
        if not all(p.free >= n_blocks for p in self.pools):
            return None   # physically out of blocks on some device
        # floor semantics: a critical type may draw from the shared pool plus
        # the unmet part of its own reservation floor; non-critical types use
        # the shared pool only and must leave the growth headroom intact
        critical = a in self.critical_types
        route = "shared"
        for p in self.pools:
            own_floor = p.reserved_free(a) if critical else 0
            shared = p.shared_free()
            if critical:
                if n_blocks + headroom > shared + own_floor:
                    return None
                if own_floor > 0:
                    route = "reserved"
            elif n_blocks + headroom > shared:
                return None
        for p in self.pools:
            blocks = p.allocate(n_blocks, req.rid, agent_type=a)
            req.gpu_blocks_by_device.setdefault(p.device, []).extend(blocks)
        return route

    def release(self, req: Request, cache: bool = False) -> None:
        for p in self.pools:
            blocks = req.gpu_blocks_by_device.get(p.device, [])
            p.release(blocks, agent_type=req.agent_type,
                      cache=cache and p.device == 0)
        req.gpu_blocks_by_device = {}
