"""Cluster router: prefix-affinity placement over N engine replicas.

One ``Router`` fronts N independent :class:`~repro_torch.core.engine.Engine`
replicas and places every agent-node spawn:

1. **Home** by consistent hash of the app id — an app's agents share its
   system prefix, so the hash keeps the sharing group on one replica
   even with zero coverage information.
2. **Override** when a gossiped radix summary (``summary.py``) says
   another replica already holds materially more of the node's prompt.
3. **Spill** off a saturated replica to the least-loaded one.

When the decision leaves the best prefix on a *different* replica, the
router prices a **cross-replica KV pull** with the same machinery the
host-tier promotion cutoff uses (``PlatformModel.promotion_cutoff`` on
a per-link model from ``costmodel.make_link``): pull the blocks over
the wire only where that beats recomputing them in the prefill the
destination runs anyway. A pull pins the source run, books a
``"remote"`` transfer on the destination's stream, and publishes
unready entries into the destination's radix tree — sharers wait on the
pending-promotion gate, never double-transfer.

The cluster is co-simulated conservatively: the router always advances
the replica with the earliest next virtual time, and every cross-replica
message (external spawn, node finish, pull booking) lands as an event
stamped with the sender's clock. Everything is virtual-time-driven, so
a run is a pure function of (engines' seeds, arrival trace, policy).

Key invariants:

* **Source pins outlive the pull** — a booked pull pins the source
  replica's radix run until the destination's ``pull_done`` (or a
  booking-time void) releases it; the source can never reclaim blocks
  a wire transfer is still reading.
* **N=1 is bit-identical** — a single-replica cluster routes everything
  home and must reproduce the bare engine's report exactly (fig20's
  ``parity1`` row gates this); the router adds behavior only at N>1.
* **Earliest-clock scheduling** — the co-simulation always advances the
  replica with the smallest next virtual time, so cross-replica events
  are never delivered into a replica's past.

Layer placement (cluster above core, below launch) and the pull pricing
table are in docs/ARCHITECTURE.md; the cluster frontend's serving
surface is in docs/SERVING_API.md.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.kvcache.radix_index import token_chain

from .placement import POLICIES, HashRing, PlacementDecision
from .replica import ReplicaHandle
from .summary import GossipConfig, ReplicaSummary

_KIND_METRIC = {"home": "affinity_hits", "override": "overrides",
                "spill": "spills", "rr": "rr_placements"}


class ClusterApp:
    """Router-side app registry entry (the home replica owns the DAG)."""

    __slots__ = ("app_id", "graph", "home", "placed", "finished")

    def __init__(self, app_id: str, graph, home: int):
        self.app_id = app_id
        self.graph = graph
        self.home = home
        self.placed: Dict[int, int] = {}      # nid -> replica
        self.finished: Set[int] = set()


class Router:
    def __init__(self, make_engine, n_replicas: int,
                 policy: str = "affinity",
                 link=None,
                 gossip: Optional[GossipConfig] = None,
                 policy_kw: Optional[dict] = None):
        """``make_engine(i)`` builds replica ``i``; ``link`` is the
        inter-replica :class:`PlatformModel` (``costmodel.make_link``) —
        ``None`` disables pulls entirely (placement-only affinity)."""
        self.replicas = [ReplicaHandle(i, make_engine(i))
                         for i in range(n_replicas)]
        self.bt = self.replicas[0].engine.platform.block_tokens
        self.policy = POLICIES[policy](n_replicas, **(policy_kw or {}))
        self.link = link
        self.gossip = gossip or GossipConfig()
        self.ring = HashRing(n_replicas)
        self.summaries = [ReplicaSummary(i) for i in range(n_replicas)]
        self.apps: Dict[str, ClusterApp] = {}
        self._pulls: Dict[Tuple[int, str], Tuple[int, str]] = {}
        self._pull_seq = itertools.count()
        self._now = 0.0
        self.metrics = {
            "placements": 0, "affinity_hits": 0, "overrides": 0,
            "spills": 0, "rr_placements": 0,
            "pull_requests": 0, "pull_declined": 0,
            "gossip_refreshes": 0, "lookups": 0, "stale_lookups": 0,
            "staleness_sum_s": 0.0, "staleness_max_s": 0.0,
        }
        for h in self.replicas:
            h.engine.router_cb = (
                lambda app, nid, toks, _i=h.index:
                self._route_node(_i, app, nid, toks))

    # ------------------------------------------------------------- submission
    def submit_app(self, graph, arrival: float, prompts=None) -> str:
        """Register an app cluster-wide: the hash-home replica owns the
        canonical AppState (arrivals, DAG progression, completion); other
        replicas only ever see mirror states for nodes placed there."""
        app_id = f"{graph.name}#{len(self.apps)}"
        home = self.ring.lookup(app_id)
        self.apps[app_id] = ClusterApp(app_id, graph, home)
        self.replicas[home].engine.submit_app(graph, arrival, prompts,
                                              app_id=app_id)
        return app_id

    # ----------------------------------------------------- summary/gossip view
    def now(self) -> float:
        return max(h.engine.clock for h in self.replicas)

    def _maybe_gossip(self, now: float) -> None:
        for h in self.replicas:
            s = self.summaries[h.index]
            if now - s.refreshed_at >= self.gossip.interval:
                self.summaries[h.index] = ReplicaSummary.capture(
                    h.index, h.engine.prefix_store, now,
                    self.gossip.max_entries)
                self.metrics["gossip_refreshes"] += 1

    def coverage(self, i: int, chain: List[int]) -> Tuple[int, int]:
        """Placement view: replica ``i``'s advertised (device, any-tier)
        coverage of a prompt chain, zero when the summary is too stale."""
        s = self.summaries[i]
        age = self._now - s.refreshed_at
        self.metrics["lookups"] += 1
        if age > self.gossip.max_stale:
            self.metrics["stale_lookups"] += 1
            return 0, 0
        self.metrics["staleness_sum_s"] += max(age, 0.0)
        self.metrics["staleness_max_s"] = max(
            self.metrics["staleness_max_s"], age)
        return s.coverage(chain)

    def loads(self) -> List[int]:
        return [h.load() for h in self.replicas]

    # --------------------------------------------------------------- placement
    def _route_node(self, home_idx: int, app, nid: int,
                    toks: List[int]) -> bool:
        """Engine callback at node-spawn time on the home replica.

        Returns True to let the home replica run the node itself; False
        after shipping the spawn to the decided replica."""
        self._now = self.now()
        self._maybe_gossip(self._now)
        chain = token_chain(toks, self.bt)
        ca = self.apps[app.app_id]
        dec = self.policy.place(ca.home, chain, self)
        ca.placed[nid] = dec.replica
        self.metrics["placements"] += 1
        self.metrics[_KIND_METRIC[dec.kind]] += 1
        if self.link is not None and dec.pull_src is not None:
            self._maybe_pull(dec, toks)
        if dec.replica == home_idx:
            return True
        dst = self.replicas[dec.replica].engine
        when = self.replicas[home_idx].engine.clock
        dst.submit_external(app.app_id, app.graph, app.arrival, nid, toks,
                            when=when)
        return False

    def _maybe_pull(self, dec: PlacementDecision, toks: List[int]) -> None:
        """Price and (maybe) start a cross-replica KV pull.

        The summary only *nominates* a source; before anything moves we
        run the pull handshake against live trees — destination coverage
        sets the start block, the source's actual device run bounds
        ``k_max``, and ``link.promotion_cutoff`` (same crossover as the
        PR 5 host-promotion cutoff, with the wire's per-block cost and
        the destination stream's backlog) elects pull-vs-recompute. A
        winning pull pins the source run for the duration of the copy
        and books the transfer at decision time on the destination's
        event loop."""
        dst = self.replicas[dec.replica].engine
        src = self.replicas[dec.pull_src].engine
        have = dst.prefix_store.match(toks).n_full
        m_src = src.prefix_store.match(toks)
        k_max = m_src.n_full - have
        if k_max <= 0:
            self.metrics["pull_declined"] += 1
            return
        k = self.link.promotion_cutoff(k_max, dst.transfers.backlog(),
                                       dst.kv_precision)
        if k <= 0:
            self.metrics["pull_declined"] += 1   # recompute election
            return
        tag = f"<pull>/{next(self._pull_seq)}"
        src_tag = f"{tag}/src"
        src.prefix_store.acquire(src_tag, m_src)
        self._pulls[(dec.replica, tag)] = (dec.pull_src, src_tag)
        dst.queue_remote_pull(list(toks), have, k, self.link, tag,
                              when=self._now)
        self.metrics["pull_requests"] += 1

    # -------------------------------------------------------------- event loop
    def _drain(self, h: ReplicaHandle) -> None:
        for msg in h.drain_outbox():
            kind = msg[0]
            if kind == "node_finished":
                _, app_id, nid, t = msg
                ca = self.apps[app_id]
                ca.finished.add(nid)
                for other in self.replicas:
                    if other.index == h.index:
                        continue
                    if other.index == ca.home:
                        other.engine.external_finished(app_id, nid, t)
                    else:
                        other.engine.mirror_finished(app_id, nid)
            elif kind == "pull_done":
                _, tag, _t = msg
                hit = self._pulls.pop((h.index, tag), None)
                if hit is not None:
                    src_i, src_tag = hit
                    self.replicas[src_i].engine.prefix_store.release(src_tag)

    def run(self, max_time: float = 1e9, max_steps: int = 50_000_000) -> dict:
        steps = 0
        while steps < max_steps:
            best, t = None, math.inf
            for h in self.replicas:            # strict < keeps lowest index
                nt = h.next_time()
                if nt < t:
                    best, t = h, nt
            if best is None or best.engine.clock >= max_time:
                break
            steps += 1
            best.advance()
            self._drain(best)
        return self.report()

    # ------------------------------------------------------------------ report
    def report(self) -> dict:
        per = [h.engine.report() for h in self.replicas]
        lats = sorted(l for h in self.replicas
                      for l in h.engine.app_latencies)
        pct = (lambda q: lats[min(int(q * len(lats)), len(lats) - 1)]
               if lats else 0.0)
        clock = max(self.now(), 1e-9)
        work = [p["prefill_tokens"] + p["decoded_tokens"] for p in per]
        mean_work = sum(work) / len(work)
        hit_rates = [
            p["prefix_saved_tokens"]
            / max(p["prefix_saved_tokens"] + p["prefill_tokens"], 1)
            for p in per]
        routing = dict(self.metrics)
        routing["staleness_avg_s"] = (
            routing.pop("staleness_sum_s")
            / max(routing["lookups"] - routing["stale_lookups"], 1))
        return {
            "replicas": len(self.replicas),
            "policy": self.policy.name,
            "apps_finished": len(lats),
            "avg_latency": sum(lats) / len(lats) if lats else 0.0,
            "p50_latency": pct(0.50), "p90_latency": pct(0.90),
            "p95_latency": pct(0.95), "p99_latency": pct(0.99),
            "throughput_rps": len(lats) / clock,
            "clock": clock,
            "load_skew": (max(work) / mean_work) if mean_work else 0.0,
            "prefix_hit_rates": hit_rates,
            "cross_replica_bytes": sum(p["remote_bytes"] for p in per),
            "pulls": sum(p["remote_pulls"] for p in per),
            "pulled_blocks": sum(p["remote_pulled_blocks"] for p in per),
            "pull_hits": sum(p["pull_hits"] for p in per),
            "pull_wasted": sum(p["pull_wasted"] for p in per),
            "routing": routing,
            "per_replica": per,
        }
