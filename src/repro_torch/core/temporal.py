"""The Temporal Scheduler (paper §4).

Converts function-call stalls into productive scheduling windows:

 * event-driven offload — ``call_start`` triggers the opportunistic gate
   (Alg. 1 + hard rejections + soft scoring, §4.2); approved caches move to
   the host pool asynchronously.
 * predictive upload — as the forecast completion approaches, destination
   blocks are reserved *gradually* (at most half the remaining deficit per
   step, Eq. 4) within a budget that protects critical waiting demand
   (Eq. 3), ranked by P_upload = importance + urgency.
 * ``call_finish`` feeds the observed duration back into the forecaster
   (Eq. 1) and triggers an immediate upload if the tool beat the forecast.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.core.block_pool import DevicePool, HostPool
from repro_torch.core.costmodel import PlatformModel
from repro_torch.core.forecast import Forecaster
from repro_torch.core.policies import POLICIES
from repro_torch.core.pressure import PressureSnapshot
from repro_torch.core.request import Request, ReqState


@dataclass
class TemporalConfig:
    enabled: bool = True
    selection_policy: str = "first_fit"      # §7.5 default
    pressure_watermark: float = 0.05         # min GPU usage to consider offload
    score_threshold: float = 0.35            # soft-score gate
    upload_safety: float = 1.25              # start uploads this x T_upload early
    emergency_usage: float = 0.97            # emergency exception pressure
    emergency_margin: float = 3.0            # stall/transfer ratio for override
    agent_aware: bool = True                 # False = "offload-only" ablation
    # soft score weights (§4.2): positives
    w_window: float = 0.5                    # stall long relative to transfer
    w_pressure: float = 0.25
    w_fit: float = 0.15
    w_cpu: float = 0.10
    # penalties
    w_critical: float = 0.6                  # dominant penalty
    w_near_done: float = 0.25
    w_churn: float = 0.15
    # prefix-aware selection (ROADMAP): penalize shared-heavy victims —
    # their pinned prefix blocks stay resident, so each transferred byte
    # frees less memory. Mostly-private requests (share 0) are unchanged.
    w_private: float = 0.15
    # host-tier capacity policy (ROADMAP): retired prefix copies in the
    # CPU cache tier are governed by a frequency+TTL score instead of
    # pure LRU. ``host_ttl`` expires copies idle that long (inf = never;
    # the per-step sweep frees them before offload allocations have to
    # reclaim), ``host_hit_decay`` is the hotness-score decay constant,
    # and ``host_group_quota`` caps one request group's cached fraction
    # of the pool (0 = no quota). See HostPool's docstring.
    host_ttl: float = math.inf
    host_hit_decay: float = 600.0
    host_group_quota: float = 0.0
    # workflow-aware KV prefetch (KVFlow-style steps-to-execution): pre-warm
    # host->device promotions for agents the AppGraph says will activate
    # within the horizon, so admission pins already-resident blocks instead
    # of paying upload_time on the critical path. Off by default — every
    # legacy mode keeps the purely reactive PR 5 behavior bit-identically.
    prefetch: bool = False
    prefetch_horizon_s: float = 30.0         # absolute activation horizon
    prefetch_safety: float = 2.0             # x upload_lead_time fallback
    # conservative quantile of the forecaster's per-tool interval used to
    # price pending ancestors' tool time: a LOW quantile shortens the
    # predicted gap, so a jittery tool prefetches earlier, never later
    prefetch_quantile: float = 0.25
    # optional quantile for the predictive-upload trigger: replace the
    # fixed upload_safety multiplier with a conservative completion-time
    # quantile (None keeps the legacy multiplier rule bit-identically)
    upload_quantile: Optional[float] = None
    # multi-turn sessions (ROADMAP "Multi-turn sessions with KV TTL"):
    # at each turn boundary the scheduler prices the *inter-turn gap*
    # exactly like a function-call stall — short predicted gap keeps the
    # session KV resident, a medium gap offloads it to the host tier
    # with a predictive upload scheduled ahead of the expected next
    # turn, and a gap past the TTL drops it. The gap forecast rides the
    # same Forecaster the tools use, keyed per session.
    session_policy: str = "ttl"              # "ttl" | "pin" | "drop"
    session_ttl: float = 120.0               # hard cap on the pin TTL (s)
    session_ttl_quantile: float = 0.9        # gap quantile the TTL prices
    session_gap_quantile: float = 0.5        # gap quantile decisions use
    session_ttl_safety: float = 2.0          # x quantile gap -> TTL
    session_default_gap: float = 10.0        # prior before any observation
    session_resident_margin: float = 2.0     # gap <= margin x roundtrip stays
    # precision tier of the host-cached KV (ROADMAP "Quantized KV tier"):
    # "fp16" keeps every legacy row bit-identical; "int8_host" quantizes
    # blocks as they cool — fp16 hot on device, int8 payload + per-(block,
    # kv-head) fp32 scales in the host pool and on every wire (D2H, H2D,
    # cross-replica pulls). Halved wire bytes reprice offload_time/
    # upload_time and shift every promotion cutoff toward promoting.
    kv_precision: str = "fp16"


@dataclass
class OffloadDecision:
    offload: bool
    reason: str
    score: float = 0.0
    fit_request: Optional[str] = None


@dataclass
class SessionDecision:
    """Turn-boundary verdict for a session's published KV.

    ``action`` is one of ``resident`` (stay pinned on device until
    ``ttl``), ``offload`` (move to the host tier now, warm it back at
    ``warm_at``), or ``drop`` (release everything). ``gap`` is the
    forecast inter-turn gap the decision was priced on."""
    action: str
    ttl: float = math.inf
    warm_at: float = 0.0
    gap: float = 0.0


class TemporalScheduler:
    def __init__(self, device_pools: List[DevicePool], host_pool: HostPool,
                 platform: PlatformModel, forecaster: Forecaster,
                 cfg: Optional[TemporalConfig] = None):
        self.pools = device_pools
        self.host = host_pool
        self.platform = platform
        self.forecaster = forecaster
        self.cfg = cfg or TemporalConfig()
        # counters for the evaluation
        self.offload_count = 0
        self.upload_count = 0
        self.promotion_count = 0
        self.prefetch_count = 0
        self.rejected_offloads = 0
        self.swapped_blocks = 0
        self.emergency_offloads = 0
        self.host_expired = 0
        # wire the host-tier capacity policy into the pool: the scheduler
        # owns the knobs (it is what arbitrates host capacity between the
        # offload plans and the cached promotion inventory)
        if host_pool is not None:
            host_pool.cache_ttl = self.cfg.host_ttl
            host_pool.hit_decay = self.cfg.host_hit_decay
            host_pool.group_quota_frac = self.cfg.host_group_quota

    def sweep_host_cache(self, now: float) -> int:
        """Per-step host-cache hygiene: age the hotness scores and free
        cached copies idle past ``host_ttl``. Keeping this on the
        scheduler (not lazily inside allocation) is what lets predictive-
        upload debt outrank cold cached copies — the capacity an offload
        plan needs is reclaimed from expired inventory *before* the
        allocation happens, never from a copy that is still hot."""
        if self.host is None:
            return 0
        n = len(self.host.expire(now))
        self.host_expired += n
        return n

    @staticmethod
    def private_frac(req: Request) -> float:
        """Fraction of a request's device blocks that would actually move
        on offload (shared prefix blocks stay pinned on device)."""
        return req.offloadable_blocks / max(req.num_gpu_blocks, 1)

    # ------------------------------------------------------------- forecasting
    def predict_fc(self, req: Request) -> float:
        fc = req.current_fc
        return self.forecaster.predict(fc.tool, fc.predict_time)

    # ------------------------------------------------------ Alg. 1 + soft gate
    def should_offload(self, req: Request, waiting: List[Request],
                       snapshot: PressureSnapshot,
                       type_scores: Dict[str, float]) -> OffloadDecision:
        """``type_scores``: the Spatial Scheduler's S_a normalized to [0,1];
        the critical penalty scales with it (§4.2: "using the Spatial
        Scheduler's priority metric")."""
        c = self.cfg
        n_blocks = req.offloadable_blocks   # shared prefix blocks stay put
        if n_blocks == 0:
            return OffloadDecision(False, "no blocks")

        t_transfer = self.platform.transfer_time(
            n_blocks, self.cfg.kv_precision)                     # Eq. 2
        t_fc = self.predict_fc(req)

        # ---- hard rejections (§4.2) ----
        if self.host.free < n_blocks:
            return OffloadDecision(False, "cpu capacity")
        if t_fc <= t_transfer:                                   # Alg. 1 l.4
            return OffloadDecision(False, "stall too short")
        # spatial pressure watermark (§7.5 Fig. 16): offload only when the
        # waiting queue actually demands a meaningful fraction of the pool —
        # freed blocks must be able to admit useful work
        waiting_pressure = (snapshot.waiting_demand_total
                            / max(snapshot.total_blocks, 1))
        if waiting_pressure < c.pressure_watermark:
            return OffloadDecision(False, "gpu pressure low")

        t_window = t_fc - t_transfer                             # Alg. 1 l.6
        v = self.platform.per_seq_decode_rate(snapshot.running_count)
        n_capacity = t_window * v                                # Alg. 1 l.7
        policy = POLICIES[c.selection_policy]
        fit = policy(waiting, n_blocks, n_capacity,
                     self.platform.block_tokens)
        if fit is None:                                          # Alg. 1 l.8-10
            return OffloadDecision(False, "no waiting fit")

        # ---- soft scoring ----
        window_ratio = min(t_window / t_fc, 1.0)
        fit_quality = fit.blocks_needed(self.platform.block_tokens) / n_blocks
        cpu_headroom = self.host.free / max(self.host.num_blocks, 1)
        score = (c.w_window * window_ratio
                 + c.w_pressure * snapshot.usage
                 + c.w_fit * min(fit_quality, 1.0)
                 + c.w_cpu * cpu_headroom)
        penalty = 0.0
        if c.agent_aware:
            importance = type_scores.get(req.agent_type, 0.0)
            if req.critical:
                importance = max(importance, 0.8)
            penalty += c.w_critical * importance
            penalty += c.w_near_done * req.completion_frac()
            penalty += c.w_churn * min(req.migration_count / 3.0, 1.0)
        # prefix-aware offload policy: prefer victims whose blocks are
        # mostly private — the cheapest freed byte. A shared-heavy victim
        # moves few blocks per request disrupted (its pinned prefix stays
        # resident either way), and its private remainder is what the
        # host tier indexes for later promotion.
        penalty += c.w_private * (1.0 - self.private_frac(req))
        score -= penalty

        if score <= c.score_threshold:
            # emergency exception: severe pressure + large stall margin
            if (snapshot.usage >= c.emergency_usage
                    and t_fc / t_transfer >= c.emergency_margin):
                self.emergency_offloads += 1
                return OffloadDecision(True, "emergency", score, fit.rid)
            return OffloadDecision(False, f"score {score:.2f}", score)
        return OffloadDecision(True, "opportunistic", score, fit.rid)

    # -------------------------------------------------------------- events
    def on_call_start(self, req: Request, now: float) -> None:
        req.state = ReqState.STALLED
        req.fc_start = now
        req.fc_actual_end = 0.0          # reset stale value from previous FC
        req.fc_predicted_end = now + self.predict_fc(req)

    def on_call_finish(self, req: Request, now: float) -> None:
        if req.current_fc is not None:
            self.forecaster.observe(req.current_fc.tool, now - req.fc_start)
        req.fc_actual_end = now

    # --------------------------------------------- inter-turn scheduling
    def on_turn_start(self, key: str, gap: float) -> None:
        """A session's next turn arrived ``gap`` seconds after the last
        one ended: feed the observation into the per-session forecast
        stream so later turn-end decisions price the real think time."""
        self.forecaster.observe(key, gap)

    def on_turn_end(self, key: str, n_blocks: int, now: float,
                    stream_backlog: float) -> SessionDecision:
        """Price the inter-turn gap like a function-call stall (§4).

        The TTL is a conservative quantile of the session's observed
        gap distribution (capped by ``session_ttl``); the action
        compares the median-ish gap against the host round-trip the
        same way the offload gate compares a stall against its
        transfer time."""
        c = self.cfg
        if c.session_policy == "pin":
            return SessionDecision("resident", ttl=math.inf)
        if c.session_policy == "drop":
            return SessionDecision("drop")
        if self.forecaster.n_obs(key) == 0:
            # cold start: no observed gap yet — plan transfers around the
            # default gap but keep the TTL at the generous cap; a tight
            # quantile of a synthetic number would drop first-time users
            # whose think time merely exceeds it
            gap = c.session_default_gap
            ttl = c.session_ttl
        else:
            gap = self.forecaster.predict_interval(
                key, c.session_gap_quantile, c.session_default_gap)
            ttl = min(c.session_ttl,
                      self.forecaster.predict_interval(
                          key, c.session_ttl_quantile,
                          c.session_default_gap)
                      * c.session_ttl_safety)
        if gap >= ttl or n_blocks == 0:
            return SessionDecision("drop", gap=gap)
        t_off = self.platform.offload_time(n_blocks, c.kv_precision)
        roundtrip = t_off + self.platform.upload_time(n_blocks,
                                                      c.kv_precision)
        if (gap <= roundtrip * c.session_resident_margin
                or self.host is None or self.host.free < n_blocks):
            return SessionDecision("resident", ttl=ttl, gap=gap)
        lead = self.platform.upload_lead_time(n_blocks, stream_backlog,
                                              c.kv_precision)
        warm_at = now + max(gap - lead * c.prefetch_safety, t_off)
        return SessionDecision("offload", ttl=ttl, warm_at=warm_at, gap=gap)

    # ------------------------------------------------- Eq. 3/4 upload planning
    def upload_budget(self, snapshot: PressureSnapshot) -> int:
        """B_upload = max(0, B_free - max(0, D_critical - B_shared_free))."""
        d_crit = snapshot.waiting_demand_critical
        b_shared = snapshot.shared_free
        return max(0, snapshot.free_blocks - max(0, d_crit - b_shared))

    def promotion_budget(self, snapshot: PressureSnapshot) -> int:
        """Device blocks a prefix promotion may claim this step.

        Promotions share the transfer stream *and* the device headroom
        with predictive uploads; blocks already owed to offloaded agents
        (the pending upload debt) are served first — a promotion must
        never displace the resume of a stalled agent whose return the
        Temporal Scheduler planned for (§4.3)."""
        return max(0, self.upload_budget(snapshot)
                   - snapshot.pending_upload_debt)

    def upload_priority(self, req: Request, now: float,
                        importance: float) -> float:
        """P_upload = I + U (importance + urgency)."""
        horizon = max(req.fc_predicted_end - now, 0.0)
        t_up = self.platform.upload_time(len(req.host_blocks),
                                         self.cfg.kv_precision)
        urgency = 1.0 / (1.0 + max(horizon - t_up, 0.0))
        return importance + urgency

    def reserve_step(self, req: Request, budget: int) -> int:
        """Gradual reservation: at most half the remaining deficit (Eq. 4)."""
        deficit = len(req.host_blocks) - len(req.reserved_upload_blocks)
        if deficit <= 0:
            return 0
        b_remain = min(p.free for p in self.pools)
        n = min(b_remain, math.ceil(deficit / 2), budget)
        return max(n, 0)

    def upload_ready(self, req: Request) -> bool:
        return (len(req.reserved_upload_blocks) >= len(req.host_blocks)
                and len(req.host_blocks) > 0)

    def should_start_upload(self, req: Request, now: float) -> bool:
        """Begin reserving when predicted completion is within the safety
        margin of the transfer time (predictive upload, §4.3).

        With ``upload_quantile`` set, the fixed multiplier is replaced by
        a conservative quantile of the tool's forecast interval: upload
        when ``now + t_up`` reaches the q-quantile completion time, so
        the margin adapts to the tool's observed jitter instead of
        scaling uniformly."""
        t_up = self.platform.upload_time(len(req.host_blocks),
                                         self.cfg.kv_precision)
        q = self.cfg.upload_quantile
        if q is not None and req.current_fc is not None:
            fc = req.current_fc
            t_q = self.forecaster.predict_interval(fc.tool, q,
                                                   fc.predict_time)
            return now + t_up >= req.fc_start + t_q
        return now + t_up * self.cfg.upload_safety >= req.fc_predicted_end

    # ------------------------------------------- workflow-aware prefetch (§4.3+)
    def prefetch_horizon(self, n_blocks: int, stream_backlog: float) -> float:
        """How far ahead of an agent's activation a prefetch may launch:
        at least the transfer's lead time (backlog + copy) with safety
        slack — otherwise the blocks would land late and the prefetch
        degenerates into a reactive promotion — widened to the absolute
        horizon so cheap early warming is allowed when capacity permits."""
        lead = self.platform.upload_lead_time(n_blocks, stream_backlog,
                                              self.cfg.kv_precision)
        return max(self.cfg.prefetch_horizon_s,
                   lead * self.cfg.prefetch_safety)

    def activation_eta(self, graph, nid: int, finished: set,
                       node_requests: Dict[int, Request]) -> float:
        """Forecast-priced seconds until node ``nid`` can start
        (steps-to-execution over the app DAG): each unfinished ancestor
        contributes its LLM work plus its tools priced at the
        conservative ``prefetch_quantile`` of the forecaster's interval,
        scaled down by observed progress for ancestors already running."""
        q = self.cfg.prefetch_quantile

        def cost(d: int) -> float:
            node = graph.nodes[d]
            t = node.prompt_len * 5e-4 + node.total_decode * 0.03
            t += sum(self.forecaster.predict_interval(fc.tool, q,
                                                      fc.predict_time)
                     for fc in node.func_calls if fc)
            req = node_requests.get(d)
            if req is not None:
                t *= max(0.0, 1.0 - req.completion_frac())
            return t

        return graph.steps_to_execution(nid, finished=frozenset(finished),
                                        node_cost=cost)
