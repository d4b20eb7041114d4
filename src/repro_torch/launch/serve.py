"""Serving launcher: the TokenCake engine as a service loop, on PyTorch.

``MCPFrontend`` exposes the paper's three endpoints (§6.2) —
``register_graph``, ``call_start``, ``call_finish`` — as methods, driven
here by the workload generator. Results are structured ``{"ok": ...}``
dicts: an unknown rid or a wrong-state call is reported back, logged and
counted in ``frontend_bad_calls``.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode tokencake \\
        --apps 20 --qps 1.0 [--real-compute [--device cuda|cpu]] [--prefetch]
    PYTHONPATH=src python -m repro_torch.launch.serve --replicas 3 \\
        [--route affinity|round_robin] [--link rdma_100g|tcp_25g|none]
    PYTHONPATH=src python -m repro_torch.launch.serve --http PORT [--sessions]

``--real-compute`` serves a small dense model through ``TorchBackend`` on
the card (or on the CPU with ``--device cpu``). ``--replicas N`` routes the
workload over N simulated engine replicas (``cluster.Router``, behind
``ClusterFrontend``). ``--http PORT`` serves the §6.2 endpoints and
``/generate`` over HTTP (``launch.http_server``) from the engine on the
A100 cost model, as the JAX launcher does; a real-compute server is built
in code: ``HttpServer(engine=Engine(..., backend=TorchBackend(...)))``.
"""
from __future__ import annotations

import argparse
import json
import logging

from repro_torch.configs.base import get_smoke_config
from repro_torch.core.costmodel import PLATFORMS
from repro_torch.core.engine import Engine, EngineConfig
from repro_torch.core.request import ReqState
from repro_torch.core.temporal import TemporalConfig
from repro_torch.data.workloads import build_workload

log = logging.getLogger("repro_torch.serve")


class MCPFrontend:
    """§6.2 endpoints, object form. The engine drives call_start/call_finish
    internally for simulated tools; external tools would call these."""

    def __init__(self, engine: Engine):
        self.engine = engine
        self.bad_calls = 0

    def register_graph(self, graph, arrival: float = 0.0,
                       prompts=None) -> str:
        return self.engine.submit_app(graph, arrival, prompts)

    def _bad(self, op: str, rid: str, error: str) -> dict:
        self.bad_calls += 1
        log.warning("%s(%s): %s", op, rid, error)
        return {"ok": False, "op": op, "rid": rid, "error": error}

    def call_start(self, rid: str, estimate: float | None = None) -> dict:
        req = self.engine._find(rid)
        if req is None:
            return self._bad("call_start", rid, "unknown rid")
        if req.state != ReqState.RUNNING:
            return self._bad("call_start", rid,
                             f"bad state {req.state.value!r} "
                             f"(expected 'running')")
        if req.next_fc() is None:
            return self._bad("call_start", rid, "no pending function call")
        if estimate is not None:
            req.next_fc().predict_time = estimate
        self.engine.call_start(req)
        return {"ok": True, "op": "call_start", "rid": rid}

    def call_finish(self, rid: str, elapsed: float | None = None) -> dict:
        req = self.engine._find(rid)
        if req is None:
            return self._bad("call_finish", rid, "unknown rid")
        if req.current_fc is None:
            return self._bad("call_finish", rid, "no call in flight")
        self.engine.call_finish(req)
        return {"ok": True, "op": "call_finish", "rid": rid}

    def states(self, verbose: bool = False) -> dict:
        """rid -> state map; ``verbose`` wraps it with the engine's
        transfer-plane ledger and the frontend's bad-call count."""
        reqs = {}
        for app in self.engine.apps.values():
            for r in app.node_request.values():
                reqs[r.rid] = r.state.value
        if not verbose:
            return reqs
        return {
            "requests": reqs,
            "transfers": self.engine.transfer_report(),
            "frontend_bad_calls": self.bad_calls,
        }

    def report(self) -> dict:
        rep = self.engine.report()
        rep["frontend_bad_calls"] = self.bad_calls
        rep["transfers"] = self.engine.transfer_report()
        return rep


class ClusterFrontend:
    """The same §6.2 surface over a replicated deployment: one router,
    N engines. ``call_start``/``call_finish`` locate the replica that
    owns the rid (the router may have placed any node anywhere), and the
    observability endpoints add the routing plane — placement decisions,
    cross-replica pulls, summary staleness — next to each replica's
    transfer ledger."""

    def __init__(self, router):
        self.router = router
        self.bad_calls = 0

    def register_graph(self, graph, arrival: float = 0.0,
                       prompts=None) -> str:
        return self.router.submit_app(graph, arrival, prompts)

    def _find(self, rid: str):
        for h in self.router.replicas:
            req = h.engine._find(rid)
            if req is not None:
                return h.engine, req
        return None, None

    def call_start(self, rid: str, estimate: float | None = None) -> dict:
        eng, req = self._find(rid)
        if req is None or req.state != ReqState.RUNNING \
                or req.next_fc() is None:
            self.bad_calls += 1
            return {"ok": False, "op": "call_start", "rid": rid,
                    "error": "unknown rid or bad state"}
        if estimate is not None:
            req.next_fc().predict_time = estimate
        eng.call_start(req)
        return {"ok": True, "op": "call_start", "rid": rid}

    def call_finish(self, rid: str, elapsed: float | None = None) -> dict:
        eng, req = self._find(rid)
        if req is None or req.current_fc is None:
            self.bad_calls += 1
            return {"ok": False, "op": "call_finish", "rid": rid,
                    "error": "unknown rid or no call in flight"}
        eng.call_finish(req)
        return {"ok": True, "op": "call_finish", "rid": rid}

    def states(self, verbose: bool = False) -> dict:
        reqs = {}
        for h in self.router.replicas:
            for app in h.engine.apps.values():
                for r in app.node_request.values():
                    reqs[r.rid] = r.state.value
        if not verbose:
            return reqs
        return {
            "requests": reqs,
            "routing": dict(self.router.metrics),
            "replicas": [
                {"index": h.index,
                 "load": h.load(),
                 "clock": h.engine.clock,
                 "summary_age_s": (h.engine.clock
                                   - self.router.summaries[h.index]
                                   .refreshed_at),
                 "transfers": h.engine.transfer_report()}
                for h in self.router.replicas],
            "frontend_bad_calls": self.bad_calls,
        }

    def report(self) -> dict:
        rep = self.router.report()
        rep["frontend_bad_calls"] = self.bad_calls
        rep["transfers"] = [h.engine.transfer_report()
                            for h in self.router.replicas]
        return rep


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="tokencake",
                    choices=["baseline", "vllm_prefix", "agent", "offload",
                             "tokencake", "mooncake", "parrot"])
    ap.add_argument("--app", default="code_writer")
    ap.add_argument("--apps", type=int, default=20)
    ap.add_argument("--qps", type=float, default=1.0)
    ap.add_argument("--blocks", type=int, default=640)
    ap.add_argument("--platform", default="a100_pcie_qwen14b",
                    choices=list(PLATFORMS))
    ap.add_argument("--real-compute", action="store_true",
                    help="small dense model + real paged KV + CUDA kernels")
    ap.add_argument("--device", default="cuda",
                    help="device of --real-compute (cuda, or cpu for the "
                         "kernels' plain PyTorch versions)")
    ap.add_argument("--prefetch", action="store_true",
                    help="host-tier promotion + workflow-aware KV prefetch")
    ap.add_argument("--sessions", action="store_true",
                    help="multi-turn sessions with TTL-scheduled KV "
                         "pinning (session_id on /generate + "
                         "/v1/session/* endpoints)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="cluster mode: route over N engine replicas")
    ap.add_argument("--route", default="affinity",
                    choices=["affinity", "round_robin"],
                    help="cluster placement policy")
    ap.add_argument("--link", default="rdma_100g",
                    choices=["rdma_100g", "tcp_25g", "none"],
                    help="inter-replica fabric for KV pulls")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="serve the §6.2 endpoints + /generate over HTTP "
                         "on PORT instead of running a simulated workload "
                         "(see docs/SERVING_API.md)")
    args = ap.parse_args(argv)
    if args.real_compute and (args.http is not None or args.replicas > 1):
        ap.error("--real-compute serves one engine in-process; --http and "
                 "--replicas run the simulated engine")

    plat = PLATFORMS[args.platform]
    kw = dict(gpu_blocks=args.blocks, max_running=64)
    if args.prefetch:
        kw.update(host_promotion=True,
                  temporal=TemporalConfig(prefetch=True))
    if args.sessions:
        kw.update(sessions=True)
    if args.http is not None:
        import asyncio

        from repro_torch.launch.http_server import HttpServer
        srv = HttpServer(port=args.http,
                         engine_kw=dict(kw, continuous_batching=True))
        log.info("serving on http://%s:%d", srv.host, args.http)
        asyncio.run(srv.serve_forever())
        return None
    if args.replicas > 1:
        return _serve_cluster(args, plat, kw)
    ecfg = EngineConfig.preset(args.mode, **kw)
    backend = None
    if args.real_compute:
        from repro_torch.core.backend import TorchBackend
        backend = TorchBackend(get_smoke_config("glm4_9b"), ecfg, plat,
                               device=args.device)
    eng = Engine(ecfg, plat, backend=backend)
    front = MCPFrontend(eng)

    for t, g in build_workload(args.app, qps=args.qps, n_apps=args.apps,
                               seed=1):
        if args.real_compute:
            for n in g.nodes.values():
                n.prompt_len = min(n.prompt_len, 64)
                n.decode_segments = [min(s, 16) for s in n.decode_segments]
        front.register_graph(g, t)

    eng.run(max_time=1e6)
    rep = front.report()
    if args.json:
        print(json.dumps(rep, indent=1))
    else:
        print(f"[{args.mode}] {rep['apps_finished']}/{args.apps} apps, "
              f"avg {rep['avg_latency']:.1f}s p90 {rep['p90_latency']:.1f}s "
              f"offloads {rep['offloads']} "
              f"prefetch {rep['prefetch_hits']}/{rep['prefetch_issued']} "
              f"effective-util {rep['effective_utilization']:.1%}")
    return rep


def _serve_cluster(args, plat, kw) -> dict:
    from repro_torch.cluster import Router
    from repro_torch.core.costmodel import make_link

    pull = args.link != "none"
    if pull:
        kw = dict(kw, remote_pull=True)
    router = Router(
        lambda i: Engine(EngineConfig.preset(args.mode, **kw), plat),
        args.replicas, policy=args.route,
        link=make_link(plat, args.link) if pull else None)
    front = ClusterFrontend(router)
    for t, g in build_workload(args.app, qps=args.qps, n_apps=args.apps,
                               seed=1):
        front.register_graph(g, t)
    router.run(max_time=1e6)
    rep = front.report()
    if args.json:
        print(json.dumps(rep, indent=1))
    else:
        r = rep["routing"]
        print(f"[{args.mode} x{args.replicas} {args.route}] "
              f"{rep['apps_finished']}/{args.apps} apps, "
              f"avg {rep['avg_latency']:.1f}s p90 {rep['p90_latency']:.1f}s "
              f"skew {rep['load_skew']:.2f} "
              f"affinity {r['affinity_hits']}/{r['placements']} "
              f"overrides {r['overrides']} spills {r['spills']} "
              f"pulls {rep['pulls']} ({rep['cross_replica_bytes']} B) "
              f"stale {r['staleness_avg_s']:.1f}s")
    return rep


if __name__ == "__main__":
    main()
