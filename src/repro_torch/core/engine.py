"""TokenCake serving engine.

Continuous-batching engine with the paper's 4-phase scheduling step (§3.2):

  1. refresh application metadata, build the pressure snapshot;
  2. Spatial Scheduler re-partitions reservations if the window expired;
  3. Temporal Scheduler reserves blocks for imminent uploads, starts ready
     H2D transfers, and evaluates newly stalled requests for offload;
  4. Spatial Scheduler forms the next batch under agent-aware admission
     (shared capacity / reserved capacity / deferral).

The engine is mode-configurable so every evaluation baseline runs on the
same machinery (§7.3): ``baseline`` (vLLM), ``vllm_prefix``, ``agent``
(spatial only), ``offload`` (temporal only, agent-unaware), ``tokencake``
(both), ``mooncake`` (reactive pressure offload + CPU prefix store), and
``parrot`` (compute-centric priority scheduling, no memory management).

Time is virtual: the execution backend returns per-iteration durations
(cost model in simulation, wall clock for the JAX backend).

Batching granularity: by default the 4-phase pass runs once per
scheduling quantum (``sched_quantum`` decode iterations execute between
passes). ``EngineConfig(continuous_batching=True)`` interleaves a light
admission pass *between individual decode iterations* — arrivals, tool
returns and transfer completions landing mid-quantum join the very next
iteration's batch instead of waiting for the quantum boundary (the
token-level continuous batching the serving front door runs on; see
docs/SERVING_API.md). Both paths produce token-identical outputs on the
real data plane: paged attention rows are independent, so batch
composition never changes a request's decoded tokens
(tests/test_http_server.py pins the equivalence).

Key invariants this module maintains (details in docs/ARCHITECTURE.md):

* **Pin-before-allocate** — admission pins matched prefix blocks (and
  takes promotion holds on host sources) *before* allocating private
  blocks, so an allocation can never reclaim the blocks the same
  request is about to share; deferral rolls the pins back.
* **Exactly-once cancel** — evicting a request with an in-flight
  transfer cancels through ``TransferManager.cancel_owner``; teardown
  (e.g. promotion host-pin release) runs exactly once whether the slot
  was still pending or already copying.
* **Compute gating** — a request whose prefix promotion is still on the
  copy stream cannot prefill or decode until ``promo_ready_at``: the
  transfer's latency lands on the requester, not just the stream.
* **Unready-entry discipline** — published prefix entries flip ready
  only after the publisher's prefill actually executed; sharers never
  read unwritten KV.
"""
from __future__ import annotations

import heapq
import itertools
import math
import zlib
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import block_pool as BP
from repro_torch.core.costmodel import PlatformModel
from repro_torch.core.forecast import Forecaster
from repro_torch.core.graph import AppGraph
from repro_torch.core.pressure import DevicePressure, PressureSnapshot
from repro_torch.core.request import DEVICE_RESIDENT, Request, ReqState
from repro_torch.core.spatial import AgentTypeStats, SpatialConfig, SpatialScheduler
from repro_torch.core.temporal import TemporalConfig, TemporalScheduler
from repro_torch.core.transfers import Transfer, TransferManager
from repro_torch.kvcache.prefix_store import PrefixMatch, PrefixStore


# ---------------------------------------------------------------------------
# configuration / modes
# ---------------------------------------------------------------------------

@dataclass
class EngineConfig:
    mode: str = "tokencake"
    num_devices: int = 1
    gpu_blocks: int = 4096
    host_blocks: int = 16384
    max_running: int = 256
    max_prefill_tokens: int = 16384      # per iteration
    prefix_cache: bool = False           # device prefix cache (vLLM-Prefix)
    cpu_prefix_cache: bool = False       # §6.3 CPU prefix index
    # host-tier promotion: on a host hit, upload the CPU-cached prefix
    # blocks into fresh device blocks (charged upload_time on the shared
    # transfer stream) instead of recomputing them. Composes with any
    # mode that indexes offloaded prompt blocks (mooncake / tokencake).
    host_promotion: bool = False
    # transfer economics for the promotion admission:
    #   "cost"   — cut the budget-feasible host run at the marginal block
    #              where upload stops beating recompute
    #              (PlatformModel.promotion_cutoff, charged with the
    #              current stream backlog), falling back to a full
    #              recompute when the stream is backlogged past the
    #              crossover. Zero-backlog on an unchunked platform this
    #              is bit-identical to "always".
    #   "always" — promote the whole budget-feasible run (PR 4 behavior;
    #              kept for the fig12/fig18 policy-comparison rows and
    #              for tests that exercise raw transfer mechanics).
    promotion_policy: str = "cost"
    # cluster plane: let admissions wait on (and account for) in-flight
    # cross-replica pulls. The pulls themselves are issued by the cluster
    # Router through ``start_remote_pull``; this flag makes the prefix
    # lookup run with promote=True so matches into an unready
    # source="remote" run defer (pending-promotion gate) instead of
    # recomputing blocks a pull is already delivering.
    remote_pull: bool = False
    spatial_enabled: bool = True
    temporal_enabled: bool = True
    reactive_offload: bool = False       # Mooncake-style pressure offload
    priority_sched: bool = True          # priority queue vs FCFS
    tool_noise: float = 0.0              # Fig. 14 multiplicative noise scale
    seed: int = 0
    # simulation fidelity: decode tokens per scheduling step. Capped so no
    # request overshoots a segment boundary and no pending event is skipped;
    # 1 = schedule every iteration (vLLM-exact), 4 = default speedup.
    sched_quantum: int = 8
    # token-level continuous batching: run the quantum one decode
    # iteration at a time, draining due events and re-running (light)
    # admission between iterations, so arrivals / tool returns / transfer
    # completions join the next iteration's batch instead of waiting for
    # the quantum boundary. The heavyweight phases (spatial re-partition,
    # temporal offload/upload planning, prefetch) still run once per
    # quantum. Off by default: every figure row and test keeps the
    # legacy per-quantum semantics bit-identical.
    continuous_batching: bool = False
    # multi-turn agent sessions (serving front door): requests tagged
    # with a session_id keep their published KV alive across turns
    # behind a session pin whose TTL the Temporal Scheduler prices over
    # observed inter-turn gaps (see TemporalConfig.session_*). Off by
    # default: the sessions-off engine path is byte-identical to the
    # legacy figures.
    sessions: bool = False
    spatial: SpatialConfig = field(default_factory=SpatialConfig)
    temporal: TemporalConfig = field(default_factory=TemporalConfig)

    @staticmethod
    def preset(mode: str, **kw) -> "EngineConfig":
        base = dict(mode=mode)
        presets = {
            "baseline": dict(spatial_enabled=False, temporal_enabled=False,
                             priority_sched=False),
            "vllm_prefix": dict(spatial_enabled=False, temporal_enabled=False,
                                priority_sched=False, prefix_cache=True),
            "agent": dict(spatial_enabled=True, temporal_enabled=False),
            "offload": dict(spatial_enabled=False, temporal_enabled=True,
                            priority_sched=False,
                            temporal=TemporalConfig(agent_aware=False,
                                                    score_threshold=0.0)),
            "tokencake": dict(spatial_enabled=True, temporal_enabled=True),
            "mooncake": dict(spatial_enabled=False, temporal_enabled=False,
                             priority_sched=False, reactive_offload=True,
                             cpu_prefix_cache=True),
            "parrot": dict(spatial_enabled=False, temporal_enabled=False,
                           priority_sched=True),
        }
        cfg = dict(base, **presets[mode])
        cfg.update(kw)
        return EngineConfig(**cfg)


@dataclass
class AppState:
    app_id: str
    graph: AppGraph
    arrival: float
    # user-supplied per-node prompt tokens, kept for the app's whole
    # lifetime: deep nodes spawn long after arrival (and the prefetch
    # phase needs a node's prompt *before* it spawns)
    prompts: Dict[int, List[int]] = field(default_factory=dict)
    finished_nodes: set = field(default_factory=set)
    node_request: Dict[int, Request] = field(default_factory=dict)
    finish_time: Optional[float] = None
    # cluster plane: ``external`` marks a *mirror* of an app homed on
    # another replica — this engine runs individual nodes the router
    # placed here, but DAG progression and app-completion accounting stay
    # with the home replica. ``external_nodes`` (on the home copy) are
    # nodes the router placed away; their Requests live elsewhere.
    external: bool = False
    external_nodes: set = field(default_factory=set)

    def progress(self) -> float:
        return len(self.finished_nodes) / max(len(self.graph.nodes), 1)


@dataclass
class SessionState:
    """One multi-turn agent session (cfg.sessions).

    ``tokens`` is the block-aligned context the session keeps alive
    between turns, capped at the turn's *prompt* block boundary: only
    prefill-written KV is position-faithful under the decode plane's
    re-feed convention, so the generated tail (plus the partial trailing
    block) is recomputed by the next turn's suffix prefill. ``generation`` bumps on every turn start *and* end so
    scheduled ``session_ttl`` / ``session_warm`` events carry the
    generation they were priced for and go stale the moment the session
    moves on. ``state`` walks idle → active → (resident | offloading →
    offloaded) → … → dropped."""
    sid: str
    turn: int = 0
    generation: int = 0
    state: str = "idle"
    tokens: List[int] = field(default_factory=list)
    host_blocks: List[int] = field(default_factory=list)
    planned_gen: List[int] = field(default_factory=list)
    last_turn_end: float = 0.0
    ttl_deadline: float = math.inf
    active_rid: Optional[str] = None
    warm_tag: Optional[str] = None

    @property
    def tag(self) -> str:
        """Synthetic pin owner in the prefix store / transfer plane."""
        return f"<session>/{self.sid}"

    @property
    def key(self) -> str:
        """Forecast stream for this session's inter-turn gaps."""
        return f"session:{self.sid}"


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

class Engine:
    def __init__(self, cfg: EngineConfig, platform: PlatformModel,
                 backend=None):
        self.cfg = cfg
        self.platform = platform
        self.backend = backend           # None => pure cost-model simulation
        self.clock = 0.0
        self._seq = itertools.count()
        self.rng = np.random.default_rng(cfg.seed)

        self.pools = [BP.DevicePool(cfg.gpu_blocks, d)
                      for d in range(cfg.num_devices)]
        self.host = BP.HostPool(cfg.host_blocks)
        # KV precision of the host tier and every transfer payload:
        # "fp16" is the legacy full-precision path (bit-identical timings
        # and ledgers); "int8_host" halves every wire byte and reprices
        # the transfer economics accordingly
        self.kv_precision = cfg.temporal.kv_precision
        # ref-counted COW prefix store over every device pool + host tier;
        # the device tier engages when cfg.prefix_cache, the host tier when
        # cfg.cpu_prefix_cache (mooncake §6.3)
        self.prefix_store = PrefixStore(self.pools, self.host,
                                        platform.block_tokens,
                                        host_precision=self.kv_precision)
        self._pending_ready: List[str] = []
        self.forecaster = Forecaster()
        self.spatial = SpatialScheduler(self.pools, cfg.spatial)
        self.temporal = TemporalScheduler(self.pools, self.host, platform,
                                          self.forecaster, cfg.temporal)

        self.apps: Dict[str, AppState] = {}
        self.waiting: List[Request] = []
        self.running: List[Request] = []
        self.stalled: Dict[str, Request] = {}      # resident, on FC
        self.offloaded: Dict[str, Request] = {}    # incl. pending transfers
        self.events: List[Tuple[float, int, str, object]] = []
        self._fresh_stalled: List[Request] = []
        self._prefetched: set = set()              # (app_id, nid) issued

        # multi-turn sessions (cfg.sessions): sid -> state, plus the
        # rid -> sid map the finish hook consults. Metrics live in a
        # SEPARATE dict merged into report() only when sessions are on,
        # so the sessions-off report stays byte-identical.
        self.sessions: Dict[str, SessionState] = {}
        self._rid_session: Dict[str, str] = {}
        self.session_metrics = {
            "sessions_opened": 0, "session_turns": 0,
            "session_resident": 0, "session_offloads": 0,
            "session_offload_blocks": 0, "session_warms": 0,
            "session_warm_skipped": 0, "session_drops": 0,
            "session_expired": 0,
        }

        # cluster plane (all inert in single-replica runs): the router
        # installs ``router_cb(app, nid, toks) -> bool`` to intercept node
        # spawns (False = placed on another replica); ``outbox`` carries
        # replica->router messages (node finishes, pull deliveries) the
        # router drains after each step; ``_pull_seq`` names pull tags.
        self.router_cb = None
        self.outbox: List[tuple] = []
        self._pull_seq = itertools.count()

        # live-serving flag (HTTP pump): when True, an idle engine whose
        # only remaining work is future timer events (session TTL/warm
        # deadlines) returns False from step() instead of jumping the
        # clock onto them — the serving loop maps WALL time onto the
        # virtual clock across the gap, so timers age at wall speed
        # rather than firing the instant the engine drains
        self.hold_clock = False

        # ---- metrics ----
        self.metrics = {
            "offloads": 0, "uploads": 0, "swap_blocks": 0,
            "preemptions": 0, "critical_inversions": 0,
            "prefix_hits": 0, "cpu_prefix_hits": 0,
            "recomputed_tokens": 0, "decoded_tokens": 0,
            "prefix_saved_tokens": 0, "cow_forks": 0,
            # host-tier promotion (H2D upload of CPU-cached prefixes)
            "promotions": 0, "promoted_blocks": 0,
            "promotion_saved_tokens": 0, "promotion_waits": 0,
            "prefill_tokens": 0, "h2d_bytes": 0, "d2h_bytes": 0,
            # transfer economics: cost-model decisions at admission.
            # promotion_cutoffs   = runs cut short of the feasible length
            # recompute_elections = runs skipped entirely (recompute won)
            # promo_blocks_trimmed = blocks the cost model declined, both
            # cases; stream_wait_s = total serialization wait transfers
            # spent queued behind the shared copy stream (the backlog the
            # crossover decision prices in)
            "promotion_cutoffs": 0, "recompute_elections": 0,
            "promo_blocks_trimmed": 0, "stream_wait_s": 0.0,
            "host_cache_expired": 0,
            # workflow-aware prefetch: speculative promotions issued ahead
            # of their consumer's activation; hits/earliness counted when
            # a consumer pins the delivered blocks, waste when reclaim
            # takes them first (store-side, merged into report())
            "prefetch_issued": 0, "prefetch_hits": 0,
            "prefetch_early_s": 0.0,
            # cluster plane: cross-replica KV pulls landing on this
            # replica (issued by the router, priced per link); pull_hits
            # counts consumers pinning pulled blocks, remote_bytes the
            # wire traffic (accounted by the TransferManager)
            "remote_pulls": 0, "remote_pulled_blocks": 0,
            "pull_hits": 0, "remote_bytes": 0,
        }
        # unified transfer plane: every offload/upload/promotion/prefetch
        # books a lifecycle record on the single copy stream, priority-
        # arbitrated; counts/bytes/waits accounted into self.metrics
        self.transfers = TransferManager(platform, lambda: self.clock,
                                         self._push, self.metrics)
        self.util_samples: List[Tuple[float, float, float]] = []
        self.app_latencies: List[float] = []
        self.req_latencies: List[float] = []
        self.type_stats: Dict[str, AgentTypeStats] = {}

    # ------------------------------------------------------------------ events
    def _push(self, t: float, kind: str, payload) -> None:
        heapq.heappush(self.events, (t, next(self._seq), kind, payload))

    def submit_app(self, graph: AppGraph, arrival: float,
                   prompt_tokens: Optional[Dict[int, List[int]]] = None,
                   app_id: Optional[str] = None):
        """Register an app. ``app_id`` override: the cluster router
        assigns globally unique ids (its registry counts apps across
        replicas); standalone engines keep the local counter."""
        app_id = app_id or f"{graph.name}#{len(self.apps)}"
        app = AppState(app_id, graph, arrival, prompts=prompt_tokens or {})
        self.apps[app_id] = app
        self._push(arrival, "app_arrival", app_id)
        return app_id

    def _node_prompt(self, app: AppState, nid: int) -> List[int]:
        """The prompt a node will run with — user-supplied if given,
        synthetic otherwise. Deterministic, so the prefetch phase can
        compute it *before* the node spawns and the spawned request sees
        the identical token sequence."""
        return (app.prompts.get(nid)
                or self._synth_prompt(app, app.graph.nodes[nid]))

    def _spawn_ready_nodes(self, app: AppState):
        on_cp = app.graph.on_critical_path()
        for nid, node in app.graph.nodes.items():
            if nid in app.node_request or nid in app.external_nodes:
                continue
            if all(d in app.finished_nodes for d in node.deps):
                toks = self._node_prompt(app, nid)
                if self.router_cb is not None \
                        and not self.router_cb(app, nid, toks):
                    # the router placed this node on another replica; its
                    # finish comes back through ``external_finished``
                    app.external_nodes.add(nid)
                    continue
                req = Request(rid=f"{app.app_id}/{node.name}",
                              app_id=app.app_id, node=node, graph=app.graph,
                              arrival=self.clock, prompt_tokens=toks,
                              critical=on_cp[nid], enqueue_time=self.clock,
                              group=app.graph.name)
                app.node_request[nid] = req
                self.waiting.append(req)

    def _synth_prompt(self, app: AppState, node) -> List[int]:
        # shared app-level system prefix (prefix caching opportunity) +
        # agent-specific remainder
        sys_len = min(512, node.prompt_len // 2)
        seed_a = zlib.crc32(app.app_id.encode())
        seed_n = zlib.crc32(f"{app.app_id}/{node.node_id}".encode())
        sys_prefix = [(seed_a * 31 + i * 2654435761) % 50000
                      for i in range(sys_len)]
        rest = [(seed_n * 31 + i * 2654435761) % 50000
                for i in range(node.prompt_len - sys_len)]
        return sys_prefix + rest

    # ---------------------------------------------------- cluster plane (router)
    def submit_external(self, app_id: str, graph: AppGraph, arrival: float,
                        nid: int, toks: List[int], when: float) -> None:
        """Router placement: run one node of an app homed on another
        replica. Creates (or reuses) a *mirror* AppState — external apps
        never spawn their own successors and never count toward this
        replica's app completions; the home replica owns both. The spawn
        lands as an event at ``when`` (the home replica's clock when the
        placement was decided), so replica clock skew stays bounded by
        the co-simulation's event ordering, not wall clock."""
        app = self.apps.get(app_id)
        if app is None:
            app = AppState(app_id, graph, arrival, external=True)
            self.apps[app_id] = app
        self._push(when, "ext_spawn", (app_id, nid, toks))

    def _spawn_external(self, app_id: str, nid: int,
                        toks: List[int]) -> None:
        app = self.apps[app_id]
        node = app.graph.nodes[nid]
        on_cp = app.graph.on_critical_path()
        req = Request(rid=f"{app.app_id}/{node.name}", app_id=app_id,
                      node=node, graph=app.graph, arrival=self.clock,
                      prompt_tokens=toks, critical=on_cp[nid],
                      enqueue_time=self.clock, group=app.graph.name)
        app.node_request[nid] = req
        self.waiting.append(req)

    def external_finished(self, app_id: str, nid: int, when: float) -> None:
        """Router notification: a node of a *locally homed* app finished
        on another replica — progress the DAG here."""
        self._push(when, "ext_finish", (app_id, nid))

    def mirror_finished(self, app_id: str, nid: int) -> None:
        """Router sync for non-home mirrors: record a node finish decided
        elsewhere so priority/progress inputs stay consistent."""
        app = self.apps.get(app_id)
        if app is not None:
            app.finished_nodes.add(nid)

    def queue_remote_pull(self, tokens: List[int], start: int, k: int,
                          link: PlatformModel, tag: str,
                          when: float) -> None:
        """Router-side pull booking rides the event loop: the transfer
        stream books at this replica's clock, so an idle replica whose
        clock lags the placement decision would otherwise get the wire
        time for free. The event lands at ``when`` (decision time) and
        the booking happens once the clock has caught up."""
        self._push(when, "pull_start", (tokens, start, k, link, tag))

    def start_remote_pull(self, tokens: List[int], start: int, k: int,
                          link: PlatformModel,
                          tag: Optional[str] = None) -> Tuple[Optional[str], int]:
        """Import ``k`` blocks of a prefix resident on a peer replica,
        starting at block index ``start`` of ``tokens``: allocate
        destination blocks, publish unready ``source="remote"`` entries
        along the token path (sharers wait on the pending-promotion gate,
        never double-transfer), and book a ``"remote"`` transfer priced
        by the inter-replica ``link`` model on this replica's stream.
        Returns ``(pull tag, blocks booked)`` — ``(None, 0)`` when pool
        pressure or a race with local coverage voids the pull."""
        if k <= 0 or any(p.free < k + self._headroom() for p in self.pools):
            return None, 0
        tag = tag or f"<pull>/{next(self._pull_seq)}"
        dests = {p.device: p.allocate(k, tag) for p in self.pools}
        pid, used = self.prefix_store.remote_import(tag, tokens, start,
                                                    dests)
        if used < k:             # local coverage won part of the race
            for p in self.pools:
                p.release(dests[p.device][used:])
        if used == 0:
            return None, 0
        self._submit_transfer("remote", used, pid, owner=tag,
                              duration=link.upload_time(
                                  used, self.kv_precision))
        self.metrics["remote_pulls"] += 1
        self.metrics["remote_pulled_blocks"] += used
        return tag, used

    def _finish_pull(self, tr: Transfer) -> None:
        """Delivery of a cross-replica pull: entries flip ready and drop
        to the cached tier (the admission that deferred on them pins them
        next step); the router learns via the outbox so it can release
        the source replica's pins."""
        self.prefix_store.remote_done(tr.payload, self.clock)
        self.outbox.append(("pull_done", tr.owner, self.clock))

    # ------------------------------------------------------------ MCP endpoints
    def call_start(self, req: Request) -> None:
        """§6.2 call_start endpoint: request enters the stalled state."""
        fc = req.next_fc()
        assert fc is not None
        req.current_fc = fc
        self.temporal.on_call_start(req, self.clock)
        self.stalled[req.rid] = req
        self._fresh_stalled.append(req)
        # actual tool duration (noise model, Fig. 14) — deterministic per
        # (app, node, segment) so every engine mode sees identical tool times
        rng = np.random.default_rng(zlib.crc32(
            f"{req.app_id}/{req.node.node_id}/{req.segment}/"
            f"{self.cfg.seed}".encode()))
        base = fc.predict_time
        jitter = rng.uniform(-fc.variability, fc.variability) * base
        actual = max(0.05, base + jitter)
        if self.cfg.tool_noise > 0:
            s = self.cfg.tool_noise
            actual = max(0.05, actual * rng.uniform(1 - s, 1 + s))
        self._push(self.clock + actual, "call_finish", req.rid)

    def call_finish(self, req: Request) -> None:
        """§6.2 call_finish endpoint: observed time feeds Eq. 1; resume."""
        self.temporal.on_call_finish(req, self.clock)
        if req.state == ReqState.STALLED:
            self.stalled.pop(req.rid, None)
            self._resume_segment(req)
        # offloaded / transfer in flight: resume via the upload path, which
        # sees fc_actual_end set and treats the request as overdue

    def _headroom(self) -> int:
        """Blocks to keep free for decode growth of the running batch,
        vLLM-watermark style. Two quanta: admission runs before growth in a
        step, so one quantum of slack is consumed before the next admission
        round can re-evaluate."""
        bt = self.platform.block_tokens
        return max(1, 2 * -(-len(self.running) * self.cfg.sched_quantum // bt))

    # ---------------------------------------------------------------- snapshot
    def snapshot(self) -> PressureSnapshot:
        dev = []
        for p in self.pools:
            outstanding = sum(max(0, q - p.type_held.get(t, 0))
                              for t, q in p.reserved_quota.items())
            dev.append(DevicePressure(
                p.device, p.num_blocks, p.free, p.reserved_total(),
                outstanding, p.shared_free()))
        bt = self.platform.block_tokens
        # D_critical (Eq. 3) = demand of critical-path requests within the
        # *admissible frontier* of the priority queue — the blocks the next
        # admission round would actually hand to critical work. Counting the
        # whole backlog would zero the upload budget for the entire run.
        # Agent-agnostic modes (offload ablation, mooncake) see none of it.
        wd_crit = 0
        if self.cfg.spatial_enabled and self.waiting:
            free_now = min(p.free for p in self.pools)
            acc = 0
            for r in sorted(self.waiting, key=lambda r: -r.priority):
                need = r.blocks_needed(bt)
                if acc + need > free_now:
                    break
                acc += need
                if r.critical:
                    wd_crit += need
        wd_tot = sum(r.blocks_needed(bt) for r in self.waiting)
        stalled_blocks = sum(r.offloadable_blocks
                             for r in self.stalled.values()
                             if r.state == ReqState.STALLED)
        debt = sum(len(r.host_blocks) - len(r.reserved_upload_blocks)
                   for r in self.offloaded.values()
                   if r.state in (ReqState.OFFLOADED, ReqState.PENDING_UPLOAD))
        return PressureSnapshot(
            time=self.clock, devices=dev,
            waiting_demand_critical=wd_crit, waiting_demand_total=wd_tot,
            waiting_count=len(self.waiting),
            offloadable_stalled_blocks=stalled_blocks,
            pending_upload_debt=max(debt, 0),
            host_free_blocks=self.host.free,
            running_count=len(self.running),
            stream_backlog_s=self.transfers.backlog())

    # ------------------------------------------------------------------- stats
    def _refresh_type_stats(self):
        stats: Dict[str, AgentTypeStats] = {}
        bt = self.platform.block_tokens
        live = (self.running + self.waiting + list(self.stalled.values())
                + list(self.offloaded.values()))
        for r in live:
            st = stats.setdefault(r.agent_type, AgentTypeStats())
            if r.state == ReqState.WAITING:
                st.waiting += 1
            else:
                st.active += 1
            st.preemptions += r.preempt_count
            st.gpu_blocks += r.num_gpu_blocks
            st.total_tokens += r.context_len
            st.total_exec_time += max(self.clock - r.arrival, 0.0)
            st.total_throughput += r.generated_total / max(
                self.clock - r.arrival, 1e-3)
            st.struct_max = max(st.struct_max,
                                r.graph.struct_score(r.node.node_id)
                                + (0.5 if r.critical else 0.0))
            rd = r.graph.remaining_depth()[r.node.node_id]
            st.depth_sum += rd
            st.fan_sum += len(r.graph.children[r.node.node_id]) \
                + len(r.node.deps)
        # carry preemption history for types with no live requests
        for a, old in self.type_stats.items():
            if a not in stats:
                s = AgentTypeStats()
                s.preemptions = old.preemptions
                stats[a] = s
        self.type_stats = stats
        return stats

    def _app_progress(self) -> Dict[str, float]:
        return {a: s.progress() for a, s in self.apps.items()}

    def _branch_progress(self) -> Dict[Tuple[str, int], float]:
        out = {}
        for app in self.apps.values():
            for nid, req in app.node_request.items():
                out[(app.app_id, nid)] = (1.0 if nid in app.finished_nodes
                                          else req.completion_frac())
        return out

    # ---------------------------------------------------------------- transfers
    @property
    def stream_free_at(self) -> float:
        """End of the last slot booked on the shared copy stream (read-only
        view of the TransferManager's timeline; kept for tests and
        introspection that watched the PR 5 scalar)."""
        return self.transfers.free_at

    def stream_backlog(self) -> float:
        """Seconds until the shared copy stream's earliest free slot — the
        wait a transfer scheduled *now* would pay before its first byte
        moves. This is the ``stream_backlog`` input of the cost model's
        promote-vs-recompute crossover."""
        return self.transfers.backlog()

    def _submit_transfer(self, kind: str, n_blocks: int, payload,
                         owner: Optional[str] = None,
                         on_reschedule=None,
                         duration: Optional[float] = None) -> Transfer:
        """Book a block transfer on the unified transfer plane (offloads,
        uploads, promotions, prefetches and cross-replica pulls share the
        one serial copy stream, priority-arbitrated) and return its
        lifecycle record; the ``transfer_done`` event fires at the slot's
        end. ``duration`` overrides the local platform timing (remote
        pulls are priced by their link's PlatformModel).

        A non-fp16 ``kv_precision`` reprices the slot (quantized payloads
        move fewer wire bytes, so per-block time shrinks by the same
        ratio) and tells the ledgers the true per-block wire bytes. The
        fp16 path passes None for both so submissions stay byte-identical
        to the legacy engine."""
        bpb = None
        if self.kv_precision != "fp16":
            bpb = self.platform.block_bytes_for(self.kv_precision)
            if duration is None:
                duration = (
                    self.platform.offload_time(n_blocks, self.kv_precision)
                    if kind == "offload"
                    else self.platform.upload_time(n_blocks,
                                                   self.kv_precision))
        tr = self.transfers.submit(kind, n_blocks, payload, owner=owner,
                                   on_reschedule=on_reschedule,
                                   duration=duration,
                                   bytes_per_block=bpb)
        self.temporal.swapped_blocks += n_blocks
        return tr

    def _start_offload(self, req: Request) -> None:
        # only the private blocks move; the store-pinned shared prefix (the
        # leading ``shared_prefix_blocks`` of every device table) stays
        # resident — it is refcounted and may be serving other requests
        shared = req.shared_prefix_blocks
        n = req.offloadable_blocks
        req.host_blocks = self.host.allocate(n, req.rid,
                                             group=req.group or None)
        bt = self.platform.block_tokens
        # only whole prompt blocks are content-addressable (decode-grown
        # blocks past the prompt are private). The radix tree attaches
        # host ids at any depth along the token path, so a suffix offload
        # behind a device-resident shared prefix is still matchable (the
        # PR 2 hash chain could only index root-anchored runs)
        n_prompt_full = len(req.prompt_tokens) // bt
        idxable = max(0, min(shared + n, n_prompt_full) - shared)
        if idxable and (self.cfg.cpu_prefix_cache or self.cfg.temporal_enabled
                        or self.cfg.host_promotion):
            self.prefix_store.host_publish(req.prompt_tokens,
                                           req.host_blocks[:idxable],
                                           start=shared)
        for p in self.pools:
            p.mark_pending_free(
                req.gpu_blocks_by_device.get(p.device, [])[shared:],
                agent_type=req.agent_type)
        req.state = ReqState.PENDING_OFFLOAD
        self.offloaded[req.rid] = req
        self.stalled.pop(req.rid, None)
        self.metrics["offloads"] += 1
        self.temporal.offload_count += 1
        if self.backend is not None:
            self.backend.copy_out(req)
        self._submit_transfer("offload", n, req.rid, owner=req.rid)

    def _finish_offload(self, req: Request) -> None:
        shared = req.shared_prefix_blocks
        for p in self.pools:
            p.complete_pending_free(
                req.gpu_blocks_by_device.get(p.device, [])[shared:])
        req.gpu_blocks_by_device = {
            d: blks[:shared]
            for d, blks in req.gpu_blocks_by_device.items()}
        req.migration_count += 1
        if req.state == ReqState.PENDING_OFFLOAD:
            req.state = ReqState.OFFLOADED

    def _start_upload(self, req: Request) -> None:
        n = len(req.host_blocks)
        req.state = ReqState.PENDING_UPLOAD
        self.metrics["uploads"] += 1
        self.temporal.upload_count += 1
        if self.backend is not None:
            self.backend.copy_in(req)
        self._submit_transfer("upload", n, req.rid, owner=req.rid)

    def _finish_upload(self, req: Request) -> None:
        # reserved device-0 blocks become the live KV blocks, appended after
        # any resident shared-prefix blocks; blocks on non-zero devices (TP
        # mirrors) were already placed into gpu_blocks_by_device at
        # reservation time and stay put
        req.gpu_blocks_by_device[0] = (req.gpu_blocks_by_device.get(0, [])
                                       + list(req.reserved_upload_blocks))
        req.reserved_upload_blocks = []
        # shared H2D handoff (also used by promotion completion): host
        # copies still indexed in the radix tree retire into the cached
        # host tier — a later same-prefix request promotes them without a
        # fresh D2H — the rest free outright
        self.prefix_store.host_handoff(req.host_blocks)
        req.host_blocks = []
        req.state = ReqState.UPLOADED
        self.offloaded.pop(req.rid, None)
        # resume: if the tool already finished, rejoin the running batch
        if req.fc_actual_end and req.fc_actual_end <= self.clock:
            self._resume_segment(req)
        else:
            # early upload: wait (resident) for call_finish
            req.state = ReqState.STALLED
            self.stalled[req.rid] = req

    def _resume_segment(self, req: Request) -> None:
        """Shared post-stall resume bookkeeping (``call_finish`` for
        resident requests, ``_finish_upload`` for offloaded ones)."""
        req.current_fc = None
        req.segment += 1
        req.generated_in_segment = 0
        if req.done:
            self._finish_request(req)
        else:
            req.state = ReqState.RUNNING
            self.running.append(req)

    # ---- host-tier prefix promotion (H2D upload of CPU-cached prefixes) -----
    def _start_promotion(self, req: Request, m: PrefixMatch) -> None:
        """Admission found host-cached prefix blocks the device tier
        cannot serve: upload them into the destination blocks just
        allocated at table positions ``[n_full, n_full + k)`` and publish
        them (unready) into the same radix nodes the host copies sit on.
        The transfer is charged ``upload_time(k)`` on the shared stream;
        the entries flip ready at ``promotion_done`` so concurrent
        sharers only ever read post-``upload_done`` KV. The requester's
        own suffix prefill starts right after the promoted run."""
        k = len(m.promo)
        dests = {p.device: req.gpu_blocks_by_device[p.device][
            m.n_full:m.n_full + k] for p in self.pools}
        pid = self.prefix_store.promote(req.rid, m, dests)
        if self.backend is not None:
            self.backend.promote_blocks([hb for _, hb in m.promo], dests[0])
        self.metrics["promotions"] += 1
        self.metrics["promoted_blocks"] += k
        self.metrics["promotion_saved_tokens"] += k * self.platform.block_tokens
        self.temporal.promotion_count += 1
        # the requester's suffix prefill attends over the promoted KV, so
        # its compute is gated until the copy stream delivers it — the
        # promotion's latency cost lands on the requester, not just on
        # later transfers sharing the stream. A later higher-priority
        # stream insert can push the slot back; the reschedule hook keeps
        # the compute gate in sync with the live booking.
        tr = self._submit_transfer(
            "promotion", k, pid, owner=req.rid,
            on_reschedule=lambda end, r=req: setattr(r, "promo_ready_at",
                                                     end))
        req.promo_ready_at = tr.end
        req.promo_tid = tr.tid

    def _finish_promotion(self, pid: int) -> None:
        """``upload_done`` for a promotion: entries become readable by
        sharers; a cancelled promotion (requester evicted mid-transfer)
        only drops the host pins — exactly once, never a double release."""
        self.prefix_store.promotion_done(pid)

    # ---- workflow-aware prefetch (speculative ownerless promotion) ----------
    def _phase_prefetch(self, snap: PressureSnapshot) -> None:
        """Pre-warm host->device promotions for agents the AppGraph says
        will activate soon (KVFlow-style steps-to-execution): walk live
        apps' unspawned nodes in topo order and, within the promotion
        budget, upload their host-cached prefix runs *now* — overlapped
        behind the current step's compute — so the eventual admission
        pins ready resident blocks instead of gating its prefill on
        ``upload_time(k)``. Mispredictions retire through the normal
        cached-LRU path (no pins leak; reclaim counts the waste)."""
        budget = (self.temporal.promotion_budget(snap)
                  - self.transfers.live_blocks("prefetch"))
        if budget <= 0:
            return
        bt = self.platform.block_tokens
        backlog = snap.stream_backlog_s
        # cheapest-possible horizon (1 block, current backlog) gates the
        # expensive store walk; the exact per-run check happens after
        min_horizon = self.temporal.prefetch_horizon(1, backlog)
        for app in self.apps.values():
            if (app.arrival > self.clock or app.finish_time is not None
                    or app.external):
                # mirrors don't own their DAG: the home replica decides
                # what activates next, so speculating here double-spends
                continue
            for nid in app.graph.topo_order():
                if budget <= 0:
                    return
                if (nid in app.node_request or nid in app.finished_nodes
                        or (app.app_id, nid) in self._prefetched):
                    continue
                eta = self.temporal.activation_eta(
                    app.graph, nid, app.finished_nodes, app.node_request)
                if eta > min_horizon:
                    continue
                m = self.prefix_store.match(self._node_prompt(app, nid),
                                            promote=True)
                if not m.promo or m.pending_promo:
                    continue
                k = min(len(m.promo), budget)
                if eta > self.temporal.prefetch_horizon(k, backlog):
                    continue
                if any(p.free < k + self._headroom() for p in self.pools):
                    continue
                if k < len(m.promo):
                    m.trim_promo(k, bt)
                if self._start_prefetch(app, nid, m):
                    budget -= k

    def _start_prefetch(self, app: AppState, nid: int,
                        m: PrefixMatch) -> bool:
        """Issue one speculative promotion under a synthetic tag (no
        consumer request exists yet): same pin-before-allocate
        discipline as a demand promotion — the tag pins the token path
        and host sources, then owns the destination blocks until
        delivery releases them into the cached tier. Returns False (all
        holds rolled back) if the pool cannot take the destinations: the
        hold itself pins previously-reclaimable cached blocks, so free
        capacity must be re-checked after it."""
        tag = f"<prefetch>/{app.app_id}/{nid}"
        k = len(m.promo)
        self.prefix_store.promote_hold(tag, m)
        if any(p.free < k + self._headroom() for p in self.pools):
            self.prefix_store.release(tag)
            return False
        dests = {p.device: p.allocate(k, tag) for p in self.pools}
        pid = self.prefix_store.promote(tag, m, dests, source="prefetch")
        if self.backend is not None:
            self.backend.promote_blocks([hb for _, hb in m.promo], dests[0])
        self.metrics["prefetch_issued"] += 1
        self.temporal.prefetch_count += 1
        self._submit_transfer("prefetch", k, pid, owner=tag)
        self._prefetched.add((app.app_id, nid))
        return True

    def _finish_prefetch(self, pid: int) -> None:
        """Delivery: entries flip ready, get their delivery stamp, and
        drop to the refcount-0 cached tier where the anticipated
        consumer's admission will match and pin them with zero stream
        wait."""
        self.prefix_store.prefetch_done(pid, self.clock)

    # ---- multi-turn sessions (TTL-scheduled KV pinning) ----------------------
    def session_open(self, sid: Optional[str] = None) -> str:
        """Explicit session creation (POST /v1/session/open); ``/generate``
        with an unseen session_id creates one implicitly via
        :meth:`session_track`."""
        sid = sid or f"s{len(self.sessions)}"
        if sid not in self.sessions:
            self.sessions[sid] = SessionState(sid)
            self.session_metrics["sessions_opened"] += 1
        return sid

    def session_info(self, sid: str) -> Optional[dict]:
        sess = self.sessions.get(sid)
        if sess is None:
            return None
        return {
            "sid": sid, "turns": sess.turn, "state": sess.state,
            "context_tokens": len(sess.tokens),
            "device_blocks": len(
                self.prefix_store.session_blocks(sess.tag)),
            "host_blocks": len(sess.host_blocks),
            "ttl_deadline": (sess.ttl_deadline
                             if math.isfinite(sess.ttl_deadline) else None),
        }

    def session_close(self, sid: str) -> bool:
        """Drop the session's KV now (client hangup beats the TTL)."""
        sess = self.sessions.get(sid)
        if sess is None:
            return False
        if sess.state != "dropped":
            self._session_drop(sess)
        return True

    def session_track(self, sid: str, rid: str,
                      planned_tokens: Optional[List[int]] = None) -> None:
        """Front-door hook: request ``rid`` is the next turn of session
        ``sid``. Feeds the observed inter-turn gap into the per-session
        forecast stream and invalidates any pending TTL/warm event — an
        arriving turn always beats the clock that would have dropped it.
        ``planned_tokens`` is the deterministic response the front door
        will synthesize (sim mode); a real backend's decoded tokens take
        precedence at turn end."""
        if not self.cfg.sessions:
            return
        sess = self.sessions.get(sid)
        if sess is None:
            sess = self.sessions[sid] = SessionState(sid)
            self.session_metrics["sessions_opened"] += 1
        if sess.turn > 0 and sess.state != "active":
            self.temporal.on_turn_start(
                sess.key, max(self.clock - sess.last_turn_end, 0.0))
        sess.generation += 1       # stale-out pending ttl/warm events
        sess.state = "active"
        sess.active_rid = rid
        sess.planned_gen = list(planned_tokens or [])
        self._rid_session[rid] = sid

    def _session_turn_end(self, req: Request) -> Optional[List[int]]:
        """The turn's request finished: decide — on the virtual timeline,
        exactly like a function-call stall — what happens to its KV over
        the predicted inter-turn gap. Runs BEFORE the request's pins are
        released, so covered entries move seamlessly from the request pin
        to the session pin and adopted blocks never transit the free
        list. Returns a token path the caller must actively drop after
        the request's own release (drop decision), else None."""
        sid = self._rid_session.pop(req.rid, None)
        sess = self.sessions.get(sid) if sid is not None else None
        if sess is None:
            return
        gen_toks = None
        if self.backend is not None:
            gen_toks = self.backend.generated_tokens(req.rid)
        if gen_toks is None:
            gen_toks = sess.planned_gen[:req.generated_total]
        context = list(req.prompt_tokens) + list(gen_toks)
        bt = self.platform.block_tokens
        # only prefill-written KV may be republished across requests: the
        # decode data plane re-feeds the last prompt token, so a
        # generated-token slot holds the KV of the token *before* it —
        # adopting those blocks would poison the next turn's prefix match
        # (greedy outputs silently diverge from a dense recompute). Cap
        # the published run at the prompt's block boundary; the next turn
        # re-prefills the generated tail as part of its suffix.
        n = len(req.prompt_tokens) // bt
        sess.tokens = context[:n * bt]
        sess.turn += 1
        sess.generation += 1
        sess.last_turn_end = self.clock
        sess.active_rid = None
        self.session_metrics["session_turns"] += 1
        dec = self.temporal.on_turn_end(sess.key, n, self.clock,
                                        self.stream_backlog())
        if dec.action == "drop" or n == 0:
            self._session_drop(sess)
            # the finishing request still holds refs on the prompt path,
            # so the drop above skipped those nodes — return the path so
            # _finish_request re-drops it AFTER the request's release
            # (otherwise the "dropped" KV stays LRU-indexed and the next
            # turn silently prefix-hits it)
            return sess.tokens
        adopted = self.prefix_store.session_publish(
            sess.tag, sess.tokens, req.gpu_blocks_by_device,
            agent_type=req.agent_type)
        # strip the adopted ids from the request's tables: the finish
        # path must free only what stayed private (the partial trailing
        # block); covered ids are stripped by the request's own release
        for d, ids in adopted.items():
            lst = req.gpu_blocks_by_device.get(d)
            if lst:
                for bid in ids:
                    if bid in lst:
                        lst.remove(bid)
        if math.isfinite(dec.ttl):
            sess.ttl_deadline = self.clock + dec.ttl
            self._push(sess.ttl_deadline, "session_ttl",
                       (sess.sid, sess.generation))
        else:
            sess.ttl_deadline = math.inf
        if dec.action == "resident":
            sess.state = "resident"
            self.session_metrics["session_resident"] += 1
            return
        self._session_start_offload(sess, n, dec)

    def _session_start_offload(self, sess: SessionState, n: int,
                               dec) -> None:
        """Medium predicted gap: move the session KV to the host tier
        (the device copy frees when the transfer lands) and schedule the
        predictive warm-back ahead of the forecast next turn. Host copies
        accumulate monotonically — a turn that extends an already-saved
        context copies only the delta blocks."""
        start = len(sess.host_blocks)
        delta = n - start
        if delta > 0 and self.host.free < delta:
            sess.state = "resident"     # host full: stay pinned instead
            self.session_metrics["session_resident"] += 1
            return
        if delta > 0:
            new_hb = self.host.allocate(delta, sess.tag, group=sess.sid)
            self.prefix_store.host_publish(sess.tokens, new_hb,
                                           start=start)
            if self.backend is not None:
                dev0 = self.prefix_store.session_blocks(sess.tag)
                self.backend.offload_blocks(dev0[start:n], new_hb)
            sess.host_blocks.extend(new_hb)
        sess.state = "offloading"
        self.session_metrics["session_offloads"] += 1
        self.session_metrics["session_offload_blocks"] += max(delta, 0)
        self._submit_transfer("offload", max(delta, 1), sess.tag,
                              owner=sess.tag)
        if dec.warm_at > self.clock:
            self._push(dec.warm_at, "session_warm",
                       (sess.sid, sess.generation))

    def _session_offload_done(self, tag: str) -> None:
        """The session's D2H save landed: release the session pin and
        actively free the now-redundant device copy. A turn that arrived
        mid-transfer (state flipped back to active) keeps the pin — its
        admission is about to re-use exactly those entries."""
        sid = tag.split("/", 1)[1]
        sess = self.sessions.get(sid)
        if sess is None or sess.state != "offloading":
            return
        self.prefix_store.release(tag)
        if sess.tokens:
            self.prefix_store.drop_cached_path(sess.tokens)
        sess.state = "offloaded"

    def _session_warm(self, sid: str, gen: int) -> None:
        """Predictive upload for the forecast next turn: promote the
        session's host-saved run back into fresh device blocks under an
        ownerless per-turn tag (the PR 6 prefetch discipline verbatim) so
        the turn's admission pins ready resident blocks with zero stream
        wait."""
        sess = self.sessions.get(sid)
        if sess is None or sess.generation != gen \
                or sess.state != "offloaded":
            return
        m = self.prefix_store.match(sess.tokens, promote=True)
        if not m.promo or m.pending_promo:
            return
        k = len(m.promo)
        tag = f"<session-warm>/{sid}/{sess.turn}"
        self.prefix_store.promote_hold(tag, m)
        if any(p.free < k + self._headroom() for p in self.pools):
            self.prefix_store.release(tag)
            self.session_metrics["session_warm_skipped"] += 1
            return
        dests = {p.device: p.allocate(k, tag) for p in self.pools}
        pid = self.prefix_store.promote(tag, m, dests, source="prefetch")
        if self.backend is not None:
            self.backend.promote_blocks([hb for _, hb in m.promo],
                                        dests[0])
        sess.warm_tag = tag
        sess.state = "warming"
        self.session_metrics["session_warms"] += 1
        self.metrics["prefetch_issued"] += 1
        self.temporal.prefetch_count += 1
        self._submit_transfer("prefetch", k, pid, owner=tag)

    def _session_drop(self, sess: SessionState) -> None:
        """Past-TTL (or closed/drop-policy) teardown: cancel any transfer
        the session still owns, release the pin, free the device copy and
        the host-tier save. Exactly-once discipline mirrors ``_evict``:
        a still-queued slot's teardown (host-pin release) runs here, an
        in-flight slot's runs at its cancelled completion event."""
        for owner in (sess.tag, sess.warm_tag):
            if not owner:
                continue
            for tr in self.transfers.cancel_owner(owner):
                if tr.kind in ("promotion", "prefetch"):
                    self.prefix_store.promotion_done(tr.payload)
            self.prefix_store.release(owner)
        sess.warm_tag = None
        if sess.tokens:
            self.prefix_store.drop_cached_path(sess.tokens)
        if sess.host_blocks:
            self.host.release(sess.host_blocks)
            sess.host_blocks = []
        sess.state = "dropped"
        sess.ttl_deadline = math.inf
        self.session_metrics["session_drops"] += 1

    # ----------------------------------------------------------------- finish
    def _finish_request(self, req: Request) -> None:
        req.state = ReqState.FINISHED
        req.finish_time = self.clock
        if self.backend is not None:
            self.backend.invalidate(req.rid)   # prune per-request state
        self.req_latencies.append(self.clock - req.arrival)
        # session turn boundary: runs BEFORE the pin release below, so the
        # session pin takes over the request's entries without a gap
        drop_path = None
        if self.cfg.sessions and req.rid in self._rid_session:
            drop_path = self._session_turn_end(req)
        # shared prefix blocks go back to the store (pins dropped; refcount-0
        # entries become LRU-reclaimable but stay indexed); private blocks
        # free normally. Prompt blocks were published at admission, so there
        # is nothing to index here.
        self.prefix_store.release(req.rid, req)
        req.shared_prefix_blocks = 0
        self.spatial.release(req, cache=False)
        if drop_path:
            # drop-policy turn end: now that the request's own refs are
            # gone, actively free the cached path its KV left behind
            self.prefix_store.drop_cached_path(drop_path)
        app = self.apps[req.app_id]
        app.finished_nodes.add(req.node.node_id)
        if app.external:
            # mirror of a remotely-homed app: the router relays the finish
            # to the home replica, which owns DAG progression and the
            # app-completion accounting
            self.outbox.append(("node_finished", req.app_id,
                                req.node.node_id, self.clock))
            return
        self._spawn_ready_nodes(app)
        if len(app.finished_nodes) == len(app.graph.nodes):
            app.finish_time = self.clock
            self.app_latencies.append(self.clock - app.arrival)
        elif self.router_cb is not None:
            # home-side finish of a clustered app: mirrors elsewhere need
            # the progress update (priority inputs), via the router
            self.outbox.append(("node_finished", req.app_id,
                                req.node.node_id, self.clock))

    # -------------------------------------------------------------- preemption
    def _preempt_for(self, needed: int, victim_pool: List[Request],
                     requester: Optional[Request]) -> bool:
        """Evict lowest-priority victims until ``needed`` blocks are free."""
        if not victim_pool:
            return False
        if self.cfg.spatial_enabled:
            # memory-level protection: evict non-critical victims first,
            # then by lowest priority (the Spatial Scheduler's whole point)
            order = sorted(victim_pool,
                           key=lambda r: (r.critical or r.agent_type
                                          in self.spatial.critical_types,
                                          r.priority))
        else:
            # compute-centric systems (vLLM, Parrot) are memory-agnostic:
            # eviction ignores criticality (vLLM preempts newest first)
            order = list(reversed(victim_pool))
        freed_any = False
        for victim in order:
            if requester is not None and victim.rid == requester.rid:
                continue
            if self.pools[0].free >= needed:
                break
            self._evict(victim, requester)
            freed_any = True
        return freed_any and self.pools[0].free >= needed

    def _evict(self, victim: Request, requester: Optional[Request]) -> None:
        victim.preempt_count += 1
        victim.recompute_tokens += victim.context_len
        self.metrics["preemptions"] += 1
        if victim.critical and (requester is None or not requester.critical):
            self.metrics["critical_inversions"] += 1
        # drop the victim's shared-prefix pins first: the prefix blocks
        # survive in the store (LRU), so the recompute after re-admission
        # can re-pin them and prefill only the suffix
        self.prefix_store.release(victim.rid, victim)
        victim.shared_prefix_blocks = 0
        victim.prefix_cached_tokens = 0
        # the in-flight promotion (if any) was just cancelled: drop the
        # compute gate too, or the readmission would idle out the rest of
        # a transfer it no longer depends on. The transfer plane mirrors
        # the cancel: a slot already copying runs out (its event fires
        # with state "cancelled" and promotion_done drops the host pins),
        # while a still-queued slot is removed outright — its event goes
        # stale, so ITS teardown (host-pin release) runs here instead,
        # exactly once either way.
        victim.promo_ready_at = 0.0
        victim.promo_tid = None
        for tr in self.transfers.cancel_owner(victim.rid):
            if tr.kind == "promotion":
                self.prefix_store.promotion_done(tr.payload)
        self.spatial.release(victim, cache=False)
        if self.backend is not None:
            # the data plane must forget the evicted cache: the allocator
            # can hand the same block ids to (or back from) other requests
            self.backend.invalidate(victim.rid)
        if victim in self.running:
            self.running.remove(victim)
        self.stalled.pop(victim.rid, None)
        victim.state = ReqState.WAITING
        victim.enqueue_time = self.clock
        # generation state survives (tokens regenerate from recompute)
        self.waiting.append(victim)

    # ------------------------------------------------------------------- phases
    def schedule_step(self) -> PressureSnapshot:
        # Phase 1: refresh metadata + pressure snapshot
        stats = self._refresh_type_stats()
        snap = self.snapshot()

        # Phase 2: spatial re-partition
        if self.cfg.spatial_enabled:
            self.spatial.update_reservations(self.clock, stats)

        # Phase 3: temporal — host-cache hygiene first (frequency/TTL
        # capacity policy ages scores and expires cold cached copies so
        # offload plans never contend with dead inventory), then uploads,
        # then offload evaluation. The sweep runs in every mode that can
        # hold cached host copies (mooncake's reactive path included).
        self.metrics["host_cache_expired"] += \
            self.temporal.sweep_host_cache(self.clock)
        if self.cfg.temporal_enabled:
            self._phase_uploads(snap)
            self._phase_offloads(snap)
        elif self.cfg.reactive_offload:
            self._reactive_offload(snap)
            self._phase_uploads(snap, reactive=True)

        # Phase 4: admission
        self._phase_admission(snap)

        # Phase 5 (workflow-aware prefetch): speculative promotions run
        # AFTER admission so demand work gets first claim on blocks and
        # the stream this step; the prefetch targets agents of *future*
        # steps and rides whatever budget is left over.
        if self.cfg.host_promotion and self.temporal.cfg.prefetch:
            self._phase_prefetch(snap)
        return snap

    def _phase_uploads(self, snap: PressureSnapshot, reactive=False):
        cands = [r for r in self.offloaded.values()
                 if r.state == ReqState.OFFLOADED]
        if not cands:
            return
        budget = self.temporal.upload_budget(snap)   # Eq. 3
        scores = self.spatial.scores
        # rank by P_upload = importance + urgency (§4.3)
        total = max(max(scores.values(), default=1.0), 1e-9)
        ranked = sorted(
            cands, key=lambda r: -self.temporal.upload_priority(
                r, self.clock, scores.get(r.agent_type, 0.0) / total))
        for req in ranked:
            overdue = req.fc_actual_end and req.fc_actual_end <= self.clock
            if not (overdue or self.temporal.should_start_upload(req, self.clock)):
                continue
            n = self.temporal.reserve_step(req, budget)
            if overdue:  # tool returned early: grab the whole deficit now
                deficit = len(req.host_blocks) - len(req.reserved_upload_blocks)
                n = min(deficit, min(p.free for p in self.pools), budget) \
                    if deficit > 0 else 0
            if n > 0:
                for p in self.pools:
                    blocks = p.allocate(n, req.rid, agent_type=req.agent_type)
                    if p.device == 0:
                        req.reserved_upload_blocks.extend(blocks)
                    else:
                        req.gpu_blocks_by_device.setdefault(
                            p.device, []).extend(blocks)
                budget -= n
            if self.temporal.upload_ready(req) and \
                    req.state == ReqState.OFFLOADED:
                self._start_upload(req)

    def _phase_offloads(self, snap: PressureSnapshot):
        fresh, self._fresh_stalled = self._fresh_stalled, []
        # prefix-aware selection (ROADMAP): when several requests stall in
        # the same step, evaluate the mostly-private ones first — they free
        # the most device bytes per transferred block (their pinned shared
        # prefix stays resident either way) and their indexed remainder
        # becomes promotable host inventory
        fresh.sort(key=lambda r: -self.temporal.private_frac(r))
        for req in fresh:
            if req.state != ReqState.STALLED:
                continue
            top = max(self.spatial.scores.values(), default=1.0) or 1.0
            norm_scores = {a: s / top for a, s in self.spatial.scores.items()}
            dec = self.temporal.should_offload(
                req, self.waiting, snap, norm_scores)
            if dec.offload:
                self._start_offload(req)
            else:
                self.temporal.rejected_offloads += 1

    def _reactive_offload(self, snap: PressureSnapshot):
        """Mooncake-style: offload under memory pressure, LRU, FC-blind."""
        if snap.usage < 0.90:
            return
        victims = sorted(self.stalled.values(), key=lambda r: r.fc_start)
        for req in victims:
            if self.snapshot().usage < 0.85:
                break
            if req.state == ReqState.STALLED and req.offloadable_blocks and \
                    self.host.free >= req.offloadable_blocks:
                self._start_offload(req)

    def _phase_admission(self, snap: Optional[PressureSnapshot] = None):
        if not self.waiting:
            return
        # host-tier promotion budget (blocks): arbitrated by the Temporal
        # Scheduler against the pending predictive uploads that share the
        # transfer stream and the device headroom
        promo_budget = 0
        if self.cfg.host_promotion or self.cfg.sessions:
            promo_budget = self.temporal.promotion_budget(
                snap if snap is not None else self.snapshot())
        # refresh P_req (Eq. 5) before every batch decision
        ap = self._app_progress()
        bp = self._branch_progress()
        for r in self.waiting:
            r.priority = self.spatial.request_priority(r, self.clock, ap, bp)
        if self.cfg.priority_sched or self.cfg.spatial_enabled:
            self.waiting.sort(key=lambda r: -r.priority)
        else:
            self.waiting.sort(key=lambda r: r.enqueue_time)

        bt = self.platform.block_tokens
        admitted, deferred = [], []
        prefill_budget = self.cfg.max_prefill_tokens
        # pending upload debt (§3.2): blocks owed to offloaded agents, with
        # their predicted return times. A waiting request may only borrow
        # lien'd blocks if it will release them before the owed upload fires
        # — otherwise the resume displaces active work (preemption cascade).
        upload_liens = [
            (r.fc_predicted_end,
             len(r.host_blocks) - len(r.reserved_upload_blocks))
            for r in self.offloaded.values()
            if r.state in (ReqState.OFFLOADED, ReqState.PENDING_OFFLOAD)]
        rate = self.platform.per_seq_decode_rate(max(len(self.running), 1))
        for req in self.waiting:
            if len(self.running) + len(admitted) >= self.cfg.max_running:
                deferred.append(req)
                continue
            m = self._prefix_match(req)
            if m.pending_promo:
                # the block this request needs next is already riding an
                # in-flight promotion: wait for its upload_done instead of
                # recomputing it (or paying a duplicate transfer) — the
                # entry becomes pinnable at the next scheduling step
                self.metrics["promotion_waits"] += 1
                deferred.append(req)
                continue
            k_promo = min(len(m.promo), promo_budget) if m.promo else 0
            promo_trimmed = 0
            if k_promo and self.cfg.promotion_policy == "cost":
                # transfer economics: cut the budget-feasible run at the
                # marginal block where upload stops beating recompute,
                # priced with the stream's current backlog — a backlogged
                # stream past the crossover elects a full recompute.
                # (Counted below only when the admission commits — a
                # deferred request must not re-count its decision every
                # retry, same convention as cpu_hits.)
                k_cut = self.platform.promotion_cutoff(
                    k_promo, self.stream_backlog(), self.kv_precision)
                promo_trimmed = k_promo - k_cut
                k_promo = k_cut
            if k_promo < len(m.promo):   # budget-/cost-trimmed: shrink
                m.trim_promo(k_promo, bt)       # the run and its pin scope
            covered = (m.n_full + k_promo) * bt if k_promo else m.tokens
            new_tokens = max(req.context_len - covered, 1)
            if new_tokens > prefill_budget:
                deferred.append(req)
                continue
            need = req.blocks_needed(bt)
            need_new = max(need - m.n_full, 0)
            est_release = self.clock + req.remaining_tokens / rate
            debt_due = sum(d for due, d in upload_liens
                           if due <= est_release and d > 0)
            # pin the matched prefix BEFORE allocating: pinned blocks are
            # unreclaimable, so the allocation below cannot evict the very
            # blocks this request is about to share (rolled back on defer).
            # The promotion hold extends the same discipline to the host
            # sources and their radix nodes.
            if m:
                self._claim_prefix(req, m)
            if k_promo:
                self.prefix_store.promote_hold(req.rid, m)
            if self.cfg.spatial_enabled:
                route = self.spatial.admit(
                    req, need_new, headroom=self._headroom() + debt_due)
                if route is None:
                    self._rollback_prefix(req)
                    deferred.append(req)
                    continue
            else:
                # vLLM-style admission: never preempts; requires free blocks
                # plus growth headroom for the running batch (+ upload liens
                # when the temporal scheduler is active)
                headroom = self._headroom() + debt_due
                if any(p.free < need_new + headroom for p in self.pools):
                    self._rollback_prefix(req)
                    deferred.append(req)
                    if not self.cfg.priority_sched:
                        deferred.extend(
                            w for w in self.waiting
                            if w is not req and w not in deferred
                            and w not in admitted)
                        break  # FCFS head-of-line blocking (vLLM)
                    continue
                for p in self.pools:
                    blocks = p.allocate(need_new, req.rid,
                                        agent_type=req.agent_type)
                    req.gpu_blocks_by_device.setdefault(
                        p.device, []).extend(blocks)
            if m:
                self._commit_prefix(req, m)
            if promo_trimmed:            # cost decision, now committed
                self.metrics["promo_blocks_trimmed"] += promo_trimmed
                self.metrics["promotion_cutoffs" if k_promo
                             else "recompute_elections"] += 1
            if k_promo:
                self._start_promotion(req, m)
                promo_budget -= k_promo
            if m.cpu_hits:
                self.metrics["cpu_prefix_hits"] += m.cpu_hits
            req.cached_prefix_blocks = m.n_full
            req.prefix_cached_tokens = covered
            if self.cfg.prefix_cache:
                self._publish_prefix(req, m, start=m.n_full + k_promo)
            req.shared_prefix_blocks = self.prefix_store.pinned_count(req.rid)
            req.state = ReqState.RUNNING
            req.prefill_pending = new_tokens
            prefill_budget -= new_tokens
            admitted.append(req)
        self.waiting = [r for r in deferred if r.state == ReqState.WAITING]
        for r in admitted:
            self.running.append(r)
            if r.first_token_time is None:
                r.first_token_time = self.clock

    def _prefix_match(self, req: Request) -> PrefixMatch:
        """Longest shared-prefix hit for this request's prompt.

        Device tier (cfg.prefix_cache): the radix-tree store, which
        matches at arbitrary branch points — mid-block divergence shares
        the full blocks and COW-forks the partial one (a hit requires the
        blocks on every TP mirror). Matching covers *recompute* admissions
        too — a preempted request re-pins its surviving prefix blocks and
        prefills only the suffix. Host tier (cfg.cpu_prefix_cache,
        mooncake): walks the same tree; a hit saves no device recompute
        here, modeled as H2D in timing (§6.3). Host hits are deduplicated
        against device coverage — only blocks the device tier cannot serve
        count as cpu hits, so ``prefix_saved_tokens`` (device-tier) and
        ``cpu_prefix_hits`` never double-count a block. With
        ``host_promotion`` the same walk also returns the host-backed run
        past the device coverage as a promotion candidate (``m.promo``) —
        promoted entries live in the device tier afterwards, so the tree
        is matched even when the vLLM-style device cache is off."""
        m = PrefixMatch()
        if (self.cfg.prefix_cache or self.cfg.host_promotion
                or self.cfg.remote_pull or self.cfg.sessions):
            m = self.prefix_store.match(
                req.prompt_tokens,
                promote=(self.cfg.host_promotion or self.cfg.remote_pull
                         or self.cfg.sessions))
        if self.cfg.cpu_prefix_cache and req.generated_total == 0:
            # carried on the match, counted only when admission commits —
            # a deferred request must not re-count its hit every retry
            host_n = self.prefix_store.host_match(req.prompt_tokens)
            m.cpu_hits = max(host_n - m.n_full, 0)
        return m

    def _claim_prefix(self, req: Request, m: PrefixMatch):
        """Pin the matched blocks on every device (refcount, not exclusive
        claim) and prepend them to the request's block tables."""
        blocks = self.prefix_store.acquire(req.rid, m)
        for d, blks in blocks.items():
            if blks:
                req.gpu_blocks_by_device.setdefault(d, [])[:0] = blks

    def _rollback_prefix(self, req: Request):
        """Deferred after pinning: undo the claim (unpin + strip tables)."""
        self.prefix_store.release(req.rid, req)
        req.shared_prefix_blocks = 0
        req.prefix_cached_tokens = 0

    def _commit_prefix(self, req: Request, m: PrefixMatch):
        """Admission succeeded: count the hit and COW-fork the partially
        matched block — the request diverges (or decodes) mid-block, so
        writes would land past the shared boundary. The store drops the
        source pins and the data plane clones the content into the
        request's first private block; the suffix prefill then overwrites
        everything from the divergence offset on."""
        if m.n_full:
            self.metrics["prefix_hits"] += m.n_full
        self.metrics["prefix_saved_tokens"] += m.tokens
        # first consumer of a prefetched block: the speculation paid off.
        # Earliness = how long the delivered KV sat warm before being
        # pinned; counted once per entry (the stamp clears on the hit).
        for e in m.full_entries:
            if e.prefetched_at is not None:
                if e.source == "remote":
                    self.metrics["pull_hits"] += 1
                else:
                    self.metrics["prefetch_hits"] += 1
                    self.metrics["prefetch_early_s"] += max(
                        self.clock - e.prefetched_at, 0.0)
                e.prefetched_at = None
        if m.partial_len:
            src = self.prefix_store.cow_fork(req.rid, m)
            self.metrics["cow_forks"] += 1
            if self.backend is not None:
                # clone every TP mirror; the backend decides which devices
                # it actually materializes (JaxBackend models device 0)
                for d, s in src.items():
                    dst = req.gpu_blocks_by_device[d][m.n_full]
                    self.backend.copy_blocks([s], [dst], device=d)

    def _publish_prefix(self, req: Request, m: PrefixMatch,
                        start: Optional[int] = None):
        """Register the request's prompt blocks as shared entries along
        its token path, splitting the radix tree at the branch point (live
        sharing: concurrent same-prefix requests pin them once the prefill
        has executed and ``mark_ready`` fires). ``start`` skips the
        already-shared leading run — the acquired full blocks plus any
        promotion destinations published by ``_start_promotion``."""
        made = self.prefix_store.publish(
            req.rid, req.prompt_tokens, req.gpu_blocks_by_device,
            start=m.n_full if start is None else start,
            agent_type=req.agent_type)
        if made:
            self._pending_ready.append(req.rid)

    # ---------------------------------------------------------------- execute
    def execute_iteration(self) -> float:
        """Run one engine step (a quantum of decode iterations).

        Each running request decodes up to ``sched_quantum`` tokens (capped
        at its own segment boundary); the step lasts a full quantum of batch
        iterations. Events landing mid-quantum are handled at the next step
        boundary (max skew = quantum * iter_time, well under tool latency).

        With ``cfg.continuous_batching`` the quantum is executed one
        iteration at a time instead (see :meth:`_execute_continuous`):
        the clock advances *inside* the call and the return value is only
        the minimum-progress epsilon when nothing could run.
        """
        if self.cfg.continuous_batching:
            return self._execute_continuous()
        prefill_tokens = 0
        # a request whose prefix promotion is still on the copy stream
        # cannot compute yet — its suffix prefill attends over KV the
        # transfer has not delivered. Gate both its prefill and decode
        # until ``promo_ready_at``: the transfer's latency lands on the
        # requester itself, not only on later transfers sharing the stream
        gated = [r.promo_ready_at for r in self.running
                 if r.promo_ready_at > self.clock]
        for req in self.running:
            if req.prefill_pending and req.promo_ready_at <= self.clock:
                prefill_tokens += req.prefill_pending
                self.metrics["prefill_tokens"] += req.prefill_pending
                self.metrics["recomputed_tokens"] += max(
                    req.prefill_pending - len(req.prompt_tokens), 0)
                req.prefill_pending = 0

        decode_batch = [r for r in self.running
                        if r.promo_ready_at <= self.clock]
        duration = 0.0
        if prefill_tokens:
            duration += self.platform.recompute_time(prefill_tokens)
        if not decode_batch and gated:
            # nothing computable this step: jump to the earliest promotion
            # delivery instead of micro-stepping toward it
            duration = max(duration, min(gated) - self.clock)
        if decode_batch:
            q = self.cfg.sched_quantum
            pre_grown = self.backend is not None
            if pre_grown:
                # with a real data plane, blocks must exist BEFORE the KV
                # writes land: grow (or evict) every request for its share
                # of the quantum up front so no in-quantum token is ever
                # written past the allocated blocks
                for req in list(decode_batch):
                    self._grow_blocks(req, q)
                decode_batch = [r for r in decode_batch
                                if r.state == ReqState.RUNNING]
            duration += q * self.platform.decode_iter_time(len(decode_batch))
            if self.backend is not None:
                for _ in range(q):
                    self.backend.decode(decode_batch)
            # prefix entries published this step now hold real KV (the
            # prefill just executed) — unless their publisher was evicted
            # in the pre-grow above, in which case its release already
            # deleted the unfilled entries. This must run BEFORE
            # _post_decode: a publisher finishing within its first quantum
            # releases its pins there, and unready entries would be
            # dropped instead of cached.
            if self._pending_ready:
                pending, self._pending_ready = self._pending_ready, []
                gated_rids = {r.rid for r in self.running
                              if r.promo_ready_at > self.clock}
                for rid in pending:
                    if rid in gated_rids:
                        # promotion-gated publisher: its suffix prefill
                        # was deferred with its decode — entries stay
                        # unready until the prefill actually executes
                        self._pending_ready.append(rid)
                    else:
                        self.prefix_store.mark_ready(rid)
            self._post_decode(decode_batch, q, grown=pre_grown)
        return max(duration, 1e-4)

    def _execute_continuous(self) -> float:
        """Token-level continuous batching: one decode iteration at a
        time, with due events drained and a light admission pass run
        *between* iterations — an arrival or tool return landing after
        iteration ``i`` is in iteration ``i+1``'s batch, not next
        quantum's. Shapes stay bucketed (``backend._bucket``), so a batch
        that grows mid-quantum re-uses the existing (batch, table) jit
        caches instead of retracing.

        The clock advances in here (events must be compared against the
        true mid-quantum time); the caller's ``clock += returned`` is a
        no-op except for the minimum-progress epsilon when nothing was
        computable at all."""
        q = self.cfg.sched_quantum
        advanced = 0.0
        for _ in range(q):
            # (re)compute prefills whose promotion gate has passed —
            # newly admitted requests from the mid-quantum admission
            # below land here on the next iteration
            prefill_tokens = 0
            for req in self.running:
                if req.prefill_pending and req.promo_ready_at <= self.clock:
                    prefill_tokens += req.prefill_pending
                    self.metrics["prefill_tokens"] += req.prefill_pending
                    self.metrics["recomputed_tokens"] += max(
                        req.prefill_pending - len(req.prompt_tokens), 0)
                    req.prefill_pending = 0
            if prefill_tokens:
                dt = self.platform.recompute_time(prefill_tokens)
                self.clock += dt
                advanced += dt
            decode_batch = [r for r in self.running
                            if r.promo_ready_at <= self.clock]
            gated = [r.promo_ready_at for r in self.running
                     if r.promo_ready_at > self.clock]
            if not decode_batch:
                if gated:
                    # jump to the earliest promotion delivery; events due
                    # in between (e.g. the promotion's own transfer_done)
                    # are drained below before the next iteration
                    dt = min(gated) - self.clock
                    self.clock += dt
                    advanced += dt
                    self._process_events_until(self.clock)
                    continue
                break
            pre_grown = self.backend is not None
            if pre_grown:
                for req in list(decode_batch):
                    self._grow_blocks(req, 1)
                decode_batch = [r for r in decode_batch
                                if r.state == ReqState.RUNNING]
                if not decode_batch:
                    continue
            dt = self.platform.decode_iter_time(len(decode_batch))
            if self.backend is not None:
                self.backend.decode(decode_batch)
            # same unready-entry discipline as the quantum path: entries
            # published by requests whose prefill just executed flip
            # ready; promotion-gated publishers stay unready
            if self._pending_ready:
                pending, self._pending_ready = self._pending_ready, []
                gated_rids = {r.rid for r in self.running
                              if r.promo_ready_at > self.clock}
                for rid in pending:
                    if rid in gated_rids:
                        self._pending_ready.append(rid)
                    else:
                        self.prefix_store.mark_ready(rid)
            self._post_decode(decode_batch, 1, grown=pre_grown)
            self.clock += dt
            advanced += dt
            # continuous admission: drain events that landed inside this
            # iteration (call_finish, transfer_done, arrivals) and admit
            # newly ready work into the NEXT iteration's batch. The
            # heavyweight phases (spatial re-partition, offload/upload
            # planning, prefetch) stay on the quantum boundary.
            self._process_events_until(self.clock)
            if self.waiting:
                self._phase_admission()
        return 1e-4 if advanced == 0.0 else 0.0

    def _grow_blocks(self, req: Request, q_step: int) -> bool:
        """Allocate the blocks ``req`` needs to decode its share of a
        quantum; evicts (self-preempts) on failure. Returns False iff
        evicted. Growth of admitted work uses physical free blocks —
        reservation floors guard *admission*, not growth (denying growth
        would evict the very caches the floors protect)."""
        bt = self.platform.block_tokens
        q = min(q_step,
                max(req.target_in_segment - req.generated_in_segment, 1))
        have = -(-req.context_len // bt) if req.context_len else 0
        need = -(-(req.context_len + q) // bt)
        grow = max(need - have, 0)
        if not grow:
            return True
        ok = all(p.free >= grow for p in self.pools)
        if not ok:
            ok = self._preempt_for(grow, self.running, req)
        if not ok:
            self._evict(req, None)   # self-preempt, recompute later
            return False
        for p in self.pools:
            blocks = p.allocate(grow, req.rid, agent_type=req.agent_type)
            req.gpu_blocks_by_device.setdefault(
                p.device, []).extend(blocks)
        return True

    def _post_decode(self, batch: List[Request], q_step: int = 1,
                     grown: bool = False) -> None:
        for req in list(batch):
            if req.state != ReqState.RUNNING:
                continue
            q = min(q_step,
                    max(req.target_in_segment - req.generated_in_segment, 1))
            # block growth across the quantum (unless pre-grown above)
            if not grown and not self._grow_blocks(req, q_step):
                continue
            req.generated_in_segment += q
            req.generated_total += q
            self.metrics["decoded_tokens"] += q
            if req.segment_done:
                self.running.remove(req)
                if req.next_fc() is not None:
                    self.call_start(req)
                elif req.done:
                    self._finish_request(req)
                else:
                    req.segment += 1
                    req.generated_in_segment = 0
                    self.running.append(req)

    # --------------------------------------------------------------- main loop
    def _process_events_until(self, t: float) -> None:
        while self.events and self.events[0][0] <= t:
            when, _, kind, payload = heapq.heappop(self.events)
            self.clock = max(self.clock, when)
            if kind == "app_arrival":
                self._spawn_ready_nodes(self.apps[payload])
            elif kind == "ext_spawn":
                self._spawn_external(*payload)
            elif kind == "pull_start":
                toks, start, k, link, tag = payload
                got, _used = self.start_remote_pull(toks, start, k, link,
                                                    tag=tag)
                if got is None:
                    # voided at booking time (pool pressure / local
                    # coverage won the race) — the router still holds
                    # source pins keyed by ``tag``; tell it to drop them
                    self.outbox.append(("pull_done", tag, self.clock))
            elif kind == "ext_finish":
                app_id, nid = payload
                app = self.apps[app_id]
                app.finished_nodes.add(nid)
                self._spawn_ready_nodes(app)
                if (app.finish_time is None
                        and len(app.finished_nodes)
                        == len(app.graph.nodes)):
                    app.finish_time = self.clock
                    self.app_latencies.append(self.clock - app.arrival)
            elif kind == "call_finish":
                req = self._find(payload)
                if req is not None:
                    self.call_finish(req)
            elif kind == "transfer_done":
                tr = self.transfers.on_event(payload)
                if tr is not None:
                    self._transfer_done(tr)
            elif kind == "session_ttl":
                sid, gen = payload
                sess = self.sessions.get(sid)
                if (sess is not None and sess.generation == gen
                        and sess.state not in ("active", "dropped")):
                    self._session_drop(sess)
                    self.session_metrics["session_expired"] += 1
            elif kind == "session_warm":
                self._session_warm(*payload)
            elif kind == "callback":
                # deferred external action on the virtual timeline (the
                # serving front door schedules trace arrivals this way so
                # admission — and its cache / backpressure decisions —
                # happens at the arrival instant, mid-quantum under
                # continuous batching, not at the next step boundary)
                payload(self.clock)

    def _transfer_done(self, tr: Transfer) -> None:
        """Completion dispatch for the unified transfer plane. Cancelled
        in-flight slots still land here (the copy engine ran them out);
        the per-kind finishers are cancel-aware — ``promotion_done``
        drops only the host pins of a cancelled promotion."""
        if tr.kind == "offload":
            if isinstance(tr.payload, str) \
                    and tr.payload.startswith("<session>/"):
                self._session_offload_done(tr.payload)
            else:
                req = self._find(tr.payload)
                if req is not None:
                    self._finish_offload(req)
        elif tr.kind == "upload":
            req = self._find(tr.payload)
            if req is not None:
                self._finish_upload(req)
        elif tr.kind == "promotion":
            self._finish_promotion(tr.payload)
        elif tr.kind == "prefetch":
            self._finish_prefetch(tr.payload)
        elif tr.kind == "remote":
            self._finish_pull(tr)

    def _find(self, rid: str) -> Optional[Request]:
        for coll in (self.stalled, self.offloaded):
            if rid in coll:
                return coll[rid]
        for r in self.running + self.waiting:
            if r.rid == rid:
                return r
        for app in self.apps.values():
            for r in app.node_request.values():
                if r.rid == rid:
                    return r
        return None

    def _sample_utilization(self):
        p = self.pools[0]
        used = 1.0 - p.free / p.num_blocks
        # physical blocks: concurrent sharers hold the SAME prefix blocks,
        # so summing per-request counts would double-count (utilization >1)
        active = set()
        for r in self.running:
            active.update(r.gpu_blocks)
        self.util_samples.append(
            (self.clock, used, len(active) / p.num_blocks))

    def _wall_gated(self) -> bool:
        """True when the earliest pending event is an inter-turn session
        timer lying in the future and ``hold_clock`` is set: the engine
        must not fast-forward onto it — in a live server those deadlines
        age at wall speed (the serving pump parks and maps the wall gap
        onto the virtual clock). Work events (transfers, simulated call
        returns, arrivals) always free-run regardless."""
        return (self.hold_clock and bool(self.events)
                and self.events[0][2] in ("session_ttl", "session_warm")
                and self.events[0][0] > self.clock)

    def step(self) -> bool:
        """One main-loop iteration (events -> schedule -> execute).

        Returns False when the engine can make no further progress on its
        own: fully drained, or starved (waiting work, nothing admissible,
        no pending events). The cluster replica handle drives this same
        body, so a single-replica cluster run is the bare ``run`` loop —
        bit-identical, not merely equivalent. A False return is not
        final in a cluster: router-injected events (ext_spawn, pulls)
        revive the replica."""
        self._process_events_until(self.clock)
        if not (self.running or self.waiting):
            if not self.events and not self.offloaded:
                return False
            if not self.events and self.offloaded:
                # offloaded requests awaiting upload: run a scheduling
                # step so phase 3 can reserve blocks / start transfers
                self.schedule_step()
                self.clock += 1e-3
                return True
            if self._wall_gated():
                # live serving: the next event is an inter-turn timer —
                # let wall time carry the clock there (pump parks)
                return False
            # idle: jump to next event
            self.clock = self.events[0][0]
            return True
        self.schedule_step()
        if not self.running and not self.events and self.waiting:
            return False   # genuine starvation: nothing admissible
        dur = self.execute_iteration()
        self.clock += dur
        if not self.running and self.events and not self._wall_gated():
            # nothing runnable (e.g. pool held by stalled agents):
            # jump to the next event instead of micro-stepping
            self.clock = max(self.clock, self.events[0][0])
        self._sample_utilization()
        return True

    def run(self, max_time: float = 1e9, max_iters: int = 2_000_000) -> dict:
        iters = 0
        while iters < max_iters and self.clock < max_time:
            iters += 1
            if not self.step():
                break
        return self.report()

    # ----------------------------------------------------------------- report
    def transfer_report(self) -> dict:
        """Per-kind transfer-plane ledger (counts / blocks / queue waits,
        byte totals, live backlog) — the unified accounting the serving
        frontend exposes next to the flat metrics."""
        return self.transfers.describe()

    def report(self) -> dict:
        lat = sorted(self.app_latencies)
        pct = lambda q: lat[min(int(q * len(lat)), len(lat) - 1)] if lat else 0.0
        util = [u for _, u, _ in self.util_samples]
        eff = [e for _, _, e in self.util_samples]
        elapsed = max(self.clock, 1e-9)
        rep = {
            "apps_finished": len(lat),
            "total_latency": sum(lat),
            "avg_latency": sum(lat) / len(lat) if lat else 0.0,
            "p50_latency": pct(0.50), "p90_latency": pct(0.90),
            "p95_latency": pct(0.95), "p99_latency": pct(0.99),
            "throughput_rps": len(lat) / elapsed,
            "avg_utilization": float(np.mean(util)) if util else 0.0,
            "effective_utilization": float(np.mean(eff)) if eff else 0.0,
            "clock": self.clock,
            "truncated_prompt_tokens": getattr(
                self.backend, "truncated_prompt_tokens", 0),
            # prefetch waste is store-side: a delivered-but-unhit entry is
            # only known wasted when reclaim takes it
            "prefetch_wasted": self.prefix_store.stats["prefetch_wasted"],
            "pull_wasted": self.prefix_store.stats["pull_wasted"],
            **self.metrics,
        }
        if self.cfg.sessions:
            # merged conditionally: the sessions-off report dict stays
            # byte-identical to the legacy figures
            rep.update(self.session_metrics)
        return rep
