"""Async serving front door: the paper's §6.2 surface over a real socket.

``launch/serve.py`` drives the engine from a workload generator; this
module is the productionized boundary — a stdlib-``asyncio`` HTTP/1.1
server (no third-party deps) in front of one engine, with the three
tiers a real deployment needs *before* the KV machinery:

1. **Response cache** (``launch/response_cache.py``) — exact-match,
   content-addressed. An idempotent repeat of a finished ``/generate``
   is served straight from the cache: zero engine steps, zero blocks.
2. **Admission control** — a bounded accept queue. When the engine
   already holds ``max_pending`` unfinished front-door requests, new
   work is rejected with a structured 429 (same ``{"ok": False, ...}``
   error schema the MCP endpoints use) instead of growing an unbounded
   backlog the scheduler can never drain.
3. **Token-level continuous batching** — the engine runs with
   ``EngineConfig(continuous_batching=True)``: a request admitted while
   a quantum is executing joins the next decode *iteration*, not the
   next quantum, which is what keeps TTFT flat as QPS rises.

Endpoints (full schemas in docs/SERVING_API.md):

    GET  /healthz               liveness + engine clock
    GET  /v1/states             rid -> state map (?verbose=1 adds ledgers)
    GET  /v1/report             engine + cache + serving metrics
    POST /v1/register_graph     submit an app DAG (§6.2)
    POST /v1/call_start         tool departure   (§6.2)
    POST /v1/call_finish        tool return      (§6.2)
    POST /generate              prompt -> tokens; ?stream / ?async forms
                                (+ ``session_id``: multi-turn KV session)
    GET  /v1/result/{id}        poll an async generation
    POST /v1/cache/flush        drop every cached response
    POST /v1/session/open       open a multi-turn session explicitly
    GET  /v1/session/{sid}      session state: turns, KV residency, TTL
    POST /v1/session/{sid}/close  drop the session's pinned KV now

Two drivers share the same :class:`FrontDoor` state machine: the HTTP
server pumps the engine from an asyncio task (wall-clock service), and
``benchmarks/fig21_serving.py`` drives it with a virtual-time Poisson
trace (``FrontDoor.drive``) to measure sustained QPS and TTFT/TPOT
tails without socket noise. Latencies are **virtual-time** seconds in
both cases — the engine's clock is the timeline requests live on.

Self-test (used by CI's serve-smoke):

    PYTHONPATH=src python -m repro_torch.launch.http_server --selftest
"""
from __future__ import annotations

import argparse
import asyncio
import itertools
import json
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.core.engine import Engine, EngineConfig
from repro_torch.core.graph import AppGraph, FuncNode
from repro_torch.launch.response_cache import ResponseCache, request_key
from repro_torch.launch.serve import MCPFrontend

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 429: "Too Many Requests",
            500: "Internal Server Error"}


def synth_tokens(key: str, n: int) -> List[int]:
    """Deterministic placeholder token ids for the pure-simulation
    backend (no real decode): a stable function of the request hash, so
    identical requests stream identical tokens and the response cache
    stays coherent across sim runs."""
    seed = zlib.crc32(key.encode())
    return [(seed * 31 + i * 2654435761) % 50000 for i in range(n)]


def graph_from_spec(spec: dict) -> AppGraph:
    """Build an :class:`AppGraph` from the JSON wire form (see
    docs/SERVING_API.md): nodes in dependency order, deps by node name,
    function calls as ``{"name", "tool", "predict_time", "variability"}``
    dicts."""
    g = AppGraph(str(spec.get("name", "app")))
    by_name: Dict[str, object] = {}
    for nd in spec["nodes"]:
        fcs = [FuncNode(fc.get("name", fc["tool"]), fc["tool"],
                        float(fc["predict_time"]),
                        variability=float(fc.get("variability", 0.0)))
               for fc in nd.get("func_calls", [])]
        deps = [by_name[d] for d in nd.get("deps", [])]
        node = g.add_agent(nd["name"],
                           nd.get("agent_type", nd["name"]),
                           int(nd["prompt_len"]),
                           decode_len=int(nd.get("decode_len", 0)),
                           decode_segments=nd.get("decode_segments", ()),
                           func_calls=fcs, deps=deps)
        by_name[nd["name"]] = node
    return g


# ---------------------------------------------------------------------------
# front door state machine (transport-agnostic)
# ---------------------------------------------------------------------------

@dataclass
class GenRequest:
    """One ``/generate`` call's serving record, front-door side."""
    gid: str
    payload: dict                      # canonical request (cache key basis)
    key: str                           # content hash (request_key)
    arrival: float                     # engine-clock submission time
    status: str = "queued"             # queued|running|finished|cached|rejected
    rid: str = ""                      # engine request id once spawned
    app_id: str = ""
    n_tokens: int = 0                  # decoded so far (streaming cursor)
    first_token: Optional[float] = None
    finish: Optional[float] = None
    result: Optional[dict] = None

    @property
    def done(self) -> bool:
        return self.status in ("finished", "cached", "rejected")

    def ttft(self) -> Optional[float]:
        # Cache hits have no first DECODED token, so they carry no TTFT
        # sample: returning None keeps them out of the report()
        # distributions (which would otherwise collapse toward 0 as the
        # hit rate rises), while the response bodies still state the
        # client-observed ``"ttft": 0.0`` explicitly. One semantics,
        # documented in docs/SERVING_API.md.
        if self.status == "cached":
            return None
        if self.first_token is None:
            return None
        return self.first_token - self.arrival

    def tpot(self) -> Optional[float]:
        if self.status == "cached":
            return None
        if self.finish is None or self.first_token is None:
            return None
        return (self.finish - self.first_token) / max(self.n_tokens - 1, 1)

    def latency(self) -> Optional[float]:
        return None if self.finish is None else self.finish - self.arrival


class FrontDoor:
    """Serving state in front of one engine: response cache, bounded
    admission, per-request TTFT/TPOT accounting — transport-agnostic
    (the HTTP server and the fig21 virtual-time driver both sit on it).

    ``max_pending`` bounds the accept queue: front-door requests that
    are submitted but unfinished. At the bound, :meth:`submit` returns
    the structured 429 shape instead of enqueueing (the HTTP layer maps
    it to a real 429)."""

    def __init__(self, engine: Engine, cache: Optional[ResponseCache] = None,
                 max_pending: int = 64):
        self.engine = engine
        self.cache = cache
        self.max_pending = max_pending
        self.gens: Dict[str, GenRequest] = {}
        self._seq = itertools.count()
        self.metrics = {
            "accepted": 0, "rejected": 0, "completed": 0,
            "cache_hits": 0, "cache_misses": 0,
        }
        # transport hooks (the HTTP server wires streaming onto these)
        self.on_progress: Optional[Callable[[GenRequest, int], None]] = None
        self.on_finish: Optional[Callable[[GenRequest], None]] = None

    # ---------------------------------------------------------------- submit
    def _pending_depth(self, exclude: str = "") -> int:
        """Accept-queue depth: requests handed to the engine and not yet
        finished. Trace-scheduled future arrivals don't count — they
        haven't hit the accept queue yet."""
        return sum(1 for g in self.gens.values()
                   if g.status in ("queued", "running")
                   and g.gid != exclude)

    def submit(self, payload: dict,
               arrival: Optional[float] = None) -> GenRequest:
        """Submit one generate request. ``arrival`` in the future (trace
        mode) defers the admission decision — cache lookup and the
        backpressure check happen when the virtual clock reaches it, not
        at trace-build time."""
        payload = dict(payload)
        toks = payload.get("prompt")
        if (not isinstance(toks, list) or not toks
                or not all(isinstance(t, int) for t in toks)):
            raise ValueError("prompt must be a non-empty list of token ids")
        payload["max_tokens"] = int(payload.get("max_tokens", 16))
        if payload["max_tokens"] < 1:
            raise ValueError("max_tokens must be >= 1")
        if arrival is None or arrival <= self.engine.clock:
            return self._admit(payload, self.engine.clock)
        # trace mode: defer the admission decision to the arrival instant
        # via an engine-timeline callback — under continuous batching the
        # event fires *mid-quantum*, so the cache lookup, the 429 check
        # and the admission all happen at the true arrival time
        gid = f"g{next(self._seq)}"
        gen = GenRequest(gid, payload, request_key(payload), arrival,
                         status="scheduled")
        self.gens[gid] = gen
        self.engine._push(arrival, "callback",
                          lambda now: self._admit(payload, now, gen=gen))
        return gen

    def _admit(self, payload: dict, now: float,
               gen: Optional[GenRequest] = None) -> GenRequest:
        key = request_key(payload)
        if gen is None:
            gen = GenRequest(f"g{next(self._seq)}", payload, key, now)
            self.gens[gen.gid] = gen
        # tier 1: exact-match response cache — a hit never touches the
        # engine (zero steps, zero blocks, zero stream time)
        if self.cache is not None:
            hit = self.cache.get(key)
            if hit is not None:
                self.metrics["cache_hits"] += 1
                gen.status = "cached"
                gen.finish = now
                gen.n_tokens = len(hit["tokens"])
                gen.result = dict(hit, cached=True, id=gen.gid)
                if self.on_finish:
                    self.on_finish(gen)
                return gen
            self.metrics["cache_misses"] += 1
        # tier 2: bounded accept queue (structured 429 on overflow)
        depth = self._pending_depth(exclude=gen.gid)
        if depth >= self.max_pending:
            self.metrics["rejected"] += 1
            gen.status = "rejected"
            gen.finish = now
            gen.result = {
                "ok": False, "op": "generate", "id": gen.gid,
                "error": f"backpressure: accept queue full "
                         f"({depth} pending >= max_pending="
                         f"{self.max_pending})",
                "queue_depth": depth, "status": 429,
            }
            if self.on_finish:
                self.on_finish(gen)
            return gen
        # tier 3: the engine — one single-agent app per generate call
        g = AppGraph("gen")
        g.add_agent("r", "http_gen", len(payload["prompt"]),
                    decode_len=payload["max_tokens"])
        gen.app_id = self.engine.submit_app(
            g, now, prompt_tokens={0: list(payload["prompt"])})
        gen.rid = f"{gen.app_id}/r"
        # session turn: tie the request to its session so the engine's
        # turn-end hook prices the KV pin. ``session_id`` stays in the
        # payload, so it is part of the cache key — turns of different
        # sessions never share a cached response. Planned tokens let the
        # sim backend publish the full turn context at turn end.
        sid = payload.get("session_id")
        if sid is not None:
            self.engine.session_track(
                str(sid), gen.rid,
                synth_tokens(gen.key, payload["max_tokens"]))
        gen.status = "queued"
        self.metrics["accepted"] += 1
        return gen

    # ------------------------------------------------------------------ poll
    def _tokens_of(self, gen: GenRequest, n: int) -> List[int]:
        real = None
        if self.engine.backend is not None:
            real = self.engine.backend.generated_tokens(gen.rid)
        return real[:n] if real else synth_tokens(gen.key, n)

    def poll(self) -> None:
        """Advance front-door state to the engine's clock: admit due
        scheduled arrivals, move first-token / progress / finish marks,
        populate the cache from completions. Called after every engine
        step by whichever driver owns the loop. Iterates a snapshot:
        an ``on_finish`` hook may submit follow-up work (turn chaining)
        mid-sweep."""
        for gen in list(self.gens.values()):
            if gen.done or gen.status == "scheduled":
                continue
            app = self.engine.apps.get(gen.app_id)
            req = app.node_request.get(0) if app is not None else None
            if req is None:
                continue
            gen.status = "running" if gen.status == "queued" else gen.status
            if gen.first_token is None and req.first_token_time is not None:
                gen.first_token = req.first_token_time
            if req.generated_total > gen.n_tokens:
                gen.n_tokens = req.generated_total
                if self.on_progress:
                    self.on_progress(gen, gen.n_tokens)
            if app.finish_time is not None:
                gen.status = "finished"
                gen.finish = app.finish_time
                toks = self._tokens_of(gen, gen.n_tokens)
                gen.result = {"ok": True, "id": gen.gid, "rid": gen.rid,
                              "tokens": toks, "n_tokens": len(toks),
                              "cached": False}
                self.metrics["completed"] += 1
                if self.cache is not None:
                    self.cache.put(gen.key, {"ok": True, "rid": gen.rid,
                                             "tokens": toks,
                                             "n_tokens": len(toks)})
                if self.on_finish:
                    self.on_finish(gen)

    # ----------------------------------------------------------- trace drive
    def outstanding(self) -> int:
        return sum(1 for g in self.gens.values() if not g.done)

    def drive(self, max_time: float = 1e6,
              max_iters: int = 2_000_000) -> dict:
        """Virtual-time driver (benchmarks / tests): pump the engine
        until every front-door request resolves. Scheduled arrivals live
        on the engine's own event heap, so the engine's idle-jump covers
        gaps in the trace."""
        it = 0
        while self.outstanding() and it < max_iters \
                and self.engine.clock < max_time:
            it += 1
            progressed = self.engine.step()
            self.poll()
            if not progressed and self.outstanding():
                break                          # stuck: report what we have
        return self.report()

    # ---------------------------------------------------------------- report
    @staticmethod
    def _dist(xs: List[float]) -> dict:
        if not xs:
            return {"n": 0, "mean": 0.0, "p50": 0.0, "p99": 0.0}
        xs = sorted(xs)
        pct = lambda q: xs[min(int(q * len(xs)), len(xs) - 1)]
        return {"n": len(xs), "mean": sum(xs) / len(xs),
                "p50": pct(0.50), "p99": pct(0.99)}

    def report(self) -> dict:
        done = [g for g in self.gens.values()
                if g.status in ("finished", "cached")]
        elapsed = max(self.engine.clock, 1e-9)
        rep = {
            **self.metrics,
            "outstanding": self.outstanding(),
            "qps_sustained": len(done) / elapsed,
            "ttft": self._dist([g.ttft() for g in done
                                if g.ttft() is not None]),
            "tpot": self._dist([g.tpot() for g in done
                                if g.tpot() is not None]),
            "latency": self._dist([g.latency() for g in done
                                   if g.latency() is not None]),
            "clock": self.engine.clock,
        }
        rep["response_cache"] = (self.cache.report()
                                 if self.cache is not None else None)
        return rep


# ---------------------------------------------------------------------------
# asyncio HTTP server
# ---------------------------------------------------------------------------

class HttpServer:
    """Minimal HTTP/1.1 server (stdlib asyncio streams) over one engine.

    One asyncio task (:meth:`_pump`) owns the engine: it steps the
    virtual-time loop whenever there is work, parks on an event when
    idle, and fans completion/progress notifications out to request
    handlers through per-generation queues. Handlers never touch the
    engine concurrently — everything runs on one event loop, and there
    is no ``await`` between a handler's engine mutation and its return
    to the loop.
    """

    def __init__(self, engine: Optional[Engine] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 cache_ttl: Optional[float] = 600.0,
                 cache_entries: int = 4096,
                 cache_enabled: bool = True,
                 max_pending: int = 64,
                 engine_kw: Optional[dict] = None):
        if engine is None:
            from repro_torch.core.costmodel import A100_PCIE
            kw = dict(gpu_blocks=640, max_running=64,
                      continuous_batching=True)
            kw.update(engine_kw or {})
            engine = Engine(EngineConfig.preset("tokencake", **kw),
                            A100_PCIE)
        self.engine = engine
        cache = ResponseCache(ttl=cache_ttl, max_entries=cache_entries,
                              clock=lambda: self.engine.clock) \
            if cache_enabled else None
        self.front = FrontDoor(engine, cache=cache, max_pending=max_pending)
        self.front.on_finish = self._notify_finish
        self.front.on_progress = self._notify_progress
        self.mcp = MCPFrontend(engine)
        self.host, self.port = host, port
        self.steps = 0                   # engine steps pumped (tests)
        self.paused = False
        # (wall monotonic, engine clock) captured when the pump parks
        # idle: the engine's virtual clock only advances while events
        # drain, so without this anchor an idle server's response cache
        # never ages — TTL expiry between bursts relies on it
        self._idle_anchor: Optional[tuple] = None
        self._streams: Dict[str, asyncio.Queue] = {}
        self._waiters: Dict[str, List[asyncio.Event]] = {}
        self._wake: Optional[asyncio.Event] = None
        self._server: Optional[asyncio.base_events.Server] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._stopped = asyncio.Event()

    # ------------------------------------------------------------ pump / wake
    def _notify_finish(self, gen: GenRequest) -> None:
        q = self._streams.get(gen.gid)
        if q is not None:
            q.put_nowait(("done", gen))
        for ev in self._waiters.pop(gen.gid, []):
            ev.set()

    def _notify_progress(self, gen: GenRequest, n: int) -> None:
        q = self._streams.get(gen.gid)
        if q is not None:
            q.put_nowait(("progress", n))

    def _kick(self) -> None:
        if self._wake is not None:
            self._wake.set()

    def _sync_idle_clock(self) -> None:
        """Advance the engine's virtual clock across a wall-clock idle
        gap and sweep the response cache on the same tick. The virtual
        clock is the timeline cached entries age on; while the pump is
        parked it stands still, so a TTL'd entry would otherwise stay
        fresh through an arbitrarily long quiet period. Runs at the top
        of request handling (so an arriving request — and its cache
        lookup — sees the advanced clock *before* its arrival stamp is
        taken) and again when the pump wakes."""
        anchor, self._idle_anchor = self._idle_anchor, None
        if anchor is None:
            return
        wall0, clk0 = anchor
        idle = time.monotonic() - wall0
        if idle > 0:
            self.engine.clock = max(self.engine.clock, clk0 + idle)
        if self.front.cache is not None:
            self.front.cache.sweep()

    async def _pump(self) -> None:
        self._wake = asyncio.Event()
        # session TTL/warm deadlines age at WALL speed in a live server:
        # the engine refuses to fast-forward onto them (hold_clock) and
        # the timed park below carries the clock across the gap instead
        self.engine.hold_clock = True
        while True:
            if self.paused:
                await self._wake.wait()
                self._wake.clear()
                continue
            self._sync_idle_clock()
            eng = self.engine
            if eng._wall_gated():
                # drained down to future inter-turn timers (session
                # TTL/warm deadlines): park and let WALL time carry the
                # virtual clock to the next deadline instead of
                # free-running through it — this is what makes
                # inter-turn gaps age sessions (and the response cache)
                # at wall speed in the live server
                self._idle_anchor = (time.monotonic(), eng.clock)
                try:
                    await asyncio.wait_for(self._wake.wait(),
                                           eng.events[0][0] - eng.clock)
                except asyncio.TimeoutError:
                    pass
                self._wake.clear()
                continue
            progressed = eng.step()
            self.steps += 1
            self.front.poll()
            if not progressed and not self.front.outstanding():
                if eng._wall_gated():
                    continue    # future timers: timed park at loop top
                self._idle_anchor = (time.monotonic(), self.engine.clock)
                await self._wake.wait()
                self._wake.clear()
            else:
                # yield so accept/handler coroutines interleave with the
                # engine even under a sustained burst
                await asyncio.sleep(0)

    # --------------------------------------------------------------- handlers
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            line = await reader.readline()
            parts = line.decode("latin-1").split()
            if len(parts) < 2:
                return
            method, target = parts[0], parts[1]
            headers = {}
            while True:
                h = await reader.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
                k, _, v = h.decode("latin-1").partition(":")
                headers[k.strip().lower()] = v.strip()
            body = b""
            n = int(headers.get("content-length", "0") or 0)
            if n:
                body = await reader.readexactly(n)
            await self._route(method, target, body, writer)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except Exception as e:  # noqa: BLE001 — a handler bug must not
            # take the server down; report it as a structured 500
            try:
                self._send(writer, 500,
                           {"ok": False, "error": f"{type(e).__name__}: {e}"})
            except Exception:   # noqa: BLE001
                pass
        finally:
            try:
                await writer.drain()
                writer.close()
            except (ConnectionError, RuntimeError):
                pass

    @staticmethod
    def _send(writer: asyncio.StreamWriter, status: int, obj: dict) -> None:
        body = json.dumps(obj).encode()
        head = (f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}\r\n"
                "Content-Type: application/json\r\n"
                f"Content-Length: {len(body)}\r\n"
                "Connection: close\r\n\r\n")
        writer.write(head.encode("latin-1") + body)

    async def _route(self, method: str, target: str, body: bytes,
                     writer: asyncio.StreamWriter) -> None:
        path, _, query = target.partition("?")
        params = dict(p.partition("=")[::2] for p in query.split("&") if p)
        try:
            payload = json.loads(body) if body else {}
        except json.JSONDecodeError:
            self._send(writer, 400, {"ok": False, "error": "invalid JSON"})
            return
        # first thing, before any clock read: fold the wall-clock idle
        # gap into the virtual timeline, so this request's arrival stamp
        # and cache lookup land *after* the gap, not before it
        self._sync_idle_clock()
        if path == "/healthz" and method == "GET":
            self._send(writer, 200, {"ok": True, "clock": self.engine.clock,
                                     "steps": self.steps})
        elif path == "/v1/states" and method == "GET":
            self._send(writer, 200,
                       self.mcp.states(verbose=params.get("verbose") == "1"))
        elif path == "/v1/report" and method == "GET":
            self._send(writer, 200, self.report())
        elif path == "/v1/register_graph" and method == "POST":
            try:
                g = graph_from_spec(payload["graph"])
            except (KeyError, TypeError, ValueError) as e:
                self._send(writer, 400,
                           {"ok": False, "op": "register_graph",
                            "error": f"bad graph spec: {e}"})
                return
            app_id = self.mcp.register_graph(
                g, arrival=self.engine.clock,
                prompts={int(k): v for k, v in
                         payload.get("prompts", {}).items()})
            self._kick()
            self._send(writer, 200, {"ok": True, "op": "register_graph",
                                     "app_id": app_id})
        elif path == "/v1/call_start" and method == "POST":
            out = self.mcp.call_start(payload.get("rid", ""),
                                      payload.get("estimate"))
            self._kick()
            self._send(writer, 200 if out["ok"] else 400, out)
        elif path == "/v1/call_finish" and method == "POST":
            out = self.mcp.call_finish(payload.get("rid", ""),
                                       payload.get("elapsed"))
            self._kick()
            self._send(writer, 200 if out["ok"] else 400, out)
        elif path == "/v1/cache/flush" and method == "POST":
            n = self.front.cache.flush() if self.front.cache else 0
            self._send(writer, 200, {"ok": True, "flushed": n})
        elif path == "/v1/session/open" and method == "POST":
            if not self.engine.cfg.sessions:
                self._send(writer, 400,
                           {"ok": False, "op": "session_open",
                            "error": "sessions disabled "
                                     "(EngineConfig.sessions=False)"})
                return
            sid = self.engine.session_open(payload.get("sid"))
            self._kick()
            self._send(writer, 200, {"ok": True, "op": "session_open",
                                     "sid": sid})
        elif path.startswith("/v1/session/") and method == "GET":
            info = self.engine.session_info(path[len("/v1/session/"):])
            if info is None:
                self._send(writer, 404,
                           {"ok": False, "error": "unknown session"})
            else:
                self._send(writer, 200, dict(info, ok=True))
        elif (path.startswith("/v1/session/") and path.endswith("/close")
              and method == "POST"):
            sid = path[len("/v1/session/"):-len("/close")]
            if not self.engine.session_close(sid):
                self._send(writer, 404,
                           {"ok": False, "op": "session_close",
                            "error": "unknown session"})
            else:
                self._kick()
                self._send(writer, 200, {"ok": True, "op": "session_close",
                                         "sid": sid})
        elif path.startswith("/v1/result/") and method == "GET":
            gen = self.front.gens.get(path[len("/v1/result/"):])
            if gen is None:
                self._send(writer, 404, {"ok": False, "error": "unknown id"})
            elif gen.done:
                # client-observed TTFT: a cache hit served its bytes
                # immediately (0.0); ttft() is None for hits because
                # they carry no decode sample for the distributions
                ttft = 0.0 if gen.status == "cached" else gen.ttft()
                self._send(writer, 200, dict(gen.result, status=gen.status,
                                             ttft=ttft,
                                             latency=gen.latency()))
            else:
                self._send(writer, 200, {"ok": True, "id": gen.gid,
                                         "status": gen.status,
                                         "n_tokens": gen.n_tokens})
        elif path == "/generate" and method == "POST":
            await self._generate(payload, params, writer)
        else:
            self._send(writer, 404 if method in ("GET", "POST") else 405,
                       {"ok": False, "error": f"no route {method} {path}"})

    async def _generate(self, payload: dict, params: dict,
                        writer: asyncio.StreamWriter) -> None:
        stream = payload.pop("stream", params.get("stream") == "1")
        async_ = payload.pop("async", params.get("async") == "1")
        try:
            gen = self.front.submit(payload)
        except ValueError as e:
            self._send(writer, 400, {"ok": False, "op": "generate",
                                     "error": str(e)})
            return
        self._kick()
        if gen.status == "rejected":
            self._send(writer, 429, gen.result)
            return
        if gen.status == "cached":
            self._send(writer, 200, dict(gen.result, ttft=0.0))
            return
        if async_:
            self._send(writer, 200, {"ok": True, "id": gen.gid,
                                     "rid": gen.rid, "status": gen.status})
            return
        if stream:
            await self._stream_generate(gen, writer)
            return
        ev = asyncio.Event()
        self._waiters.setdefault(gen.gid, []).append(ev)
        await ev.wait()
        self._send(writer, 200, dict(gen.result, ttft=gen.ttft(),
                                     latency=gen.latency()))

    async def _stream_generate(self, gen: GenRequest,
                               writer: asyncio.StreamWriter) -> None:
        """Chunked transfer encoding, one JSON line per chunk: deltas of
        newly decoded tokens as the engine produces them, then a final
        ``{"done": true}`` line with the serving stats (format spec in
        docs/SERVING_API.md)."""
        q: asyncio.Queue = asyncio.Queue()
        self._streams[gen.gid] = q
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: application/x-ndjson\r\n"
                     b"Transfer-Encoding: chunked\r\n"
                     b"Connection: close\r\n\r\n")

        def chunk(obj: dict) -> bytes:
            data = (json.dumps(obj) + "\n").encode()
            return f"{len(data):x}\r\n".encode() + data + b"\r\n"

        sent = 0
        try:
            while True:
                kind, item = await q.get()
                if kind == "progress":
                    toks = self.front._tokens_of(gen, item)
                    if len(toks) > sent:
                        writer.write(chunk({"id": gen.gid,
                                            "tokens": toks[sent:],
                                            "done": False}))
                        sent = len(toks)
                        await writer.drain()
                else:   # done
                    toks = gen.result.get("tokens", [])
                    writer.write(chunk({"id": gen.gid,
                                        "tokens": toks[sent:],
                                        "done": True,
                                        "n_tokens": len(toks),
                                        "ttft": gen.ttft(),
                                        "latency": gen.latency()}))
                    writer.write(b"0\r\n\r\n")
                    await writer.drain()
                    return
        finally:
            self._streams.pop(gen.gid, None)

    # ------------------------------------------------------------------ admin
    def report(self) -> dict:
        rep = self.mcp.report()
        rep["serving"] = self.front.report()
        return rep

    async def start(self) -> None:
        """Bind the socket and start the pump on the current loop."""
        self._loop = asyncio.get_running_loop()
        self._server = await asyncio.start_server(self._handle, self.host,
                                                  self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._pump_task = asyncio.ensure_future(self._pump())

    async def serve_forever(self) -> None:
        await self.start()
        async with self._server:
            await self._server.serve_forever()

    # ---- background-thread harness (tests / self-test) ----------------------
    def start_background(self) -> int:
        """Run the server on a daemon thread with its own event loop;
        returns the bound port. Control from the caller's thread goes
        through ``call_soon_threadsafe`` (pause / resume / stop)."""
        ready = threading.Event()

        def _run():
            asyncio.run(self._bg_main(ready))

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()
        if not ready.wait(timeout=30):
            raise RuntimeError("HTTP server failed to start")
        return self.port

    async def _bg_main(self, ready: threading.Event) -> None:
        await self.start()
        self._stop_ev = asyncio.Event()
        ready.set()
        await self._stop_ev.wait()
        self._pump_task.cancel()
        self._server.close()
        await self._server.wait_closed()

    def _threadsafe(self, fn) -> None:
        if self._loop is not None:
            self._loop.call_soon_threadsafe(fn)

    def pause(self) -> None:
        """Freeze the engine pump (tests: make admission state
        deterministic while a burst is posted)."""
        self._threadsafe(lambda: setattr(self, "paused", True))

    def resume(self) -> None:
        def _go():
            self.paused = False
            self._kick()
        self._threadsafe(_go)

    def stop(self) -> None:
        self._threadsafe(lambda: self._stop_ev.set())
        if self._thread is not None:
            self._thread.join(timeout=30)


# ---------------------------------------------------------------------------
# self-test: boot + scripted client burst (CI serve-smoke)
# ---------------------------------------------------------------------------

def _selftest(n_requests: int = 24, distinct: int = 6) -> dict:
    """Boot the server on an ephemeral port, fire a repeat-heavy burst of
    generate calls (some streamed, one async), and return the merged
    report. Asserts the serving invariants CI gates on: every request
    resolves, repeats hit the response cache, streamed chunks reassemble
    to the non-streamed result."""
    import http.client

    srv = HttpServer(engine_kw=dict(gpu_blocks=256),
                     cache_ttl=1e9, max_pending=256)
    port = srv.start_background()

    def post(path, obj):
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        c.request("POST", path, json.dumps(obj),
                  {"Content-Type": "application/json"})
        r = c.getresponse()
        out = (r.status, json.loads(r.read()))
        c.close()
        return out

    prompts = [synth_tokens(f"selftest/{i}", 48) for i in range(distinct)]
    results, streamed = [], None
    for i in range(n_requests):
        p = prompts[i % distinct]     # every prompt repeats ~n/distinct times
        if i == distinct:             # one streamed request, reassembled
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            c.request("POST", "/generate?stream=1",
                      json.dumps({"prompt": p, "max_tokens": 8}),
                      {"Content-Type": "application/json"})
            r = c.getresponse()
            toks: List[int] = []
            for ln in r.read().decode().splitlines():   # http.client de-chunks
                msg = json.loads(ln)
                toks.extend(msg["tokens"])
            streamed = toks
            c.close()
            continue
        status, out = post("/generate", {"prompt": p, "max_tokens": 8})
        assert status == 200, (status, out)
        results.append(out)
    # async form round-trip
    status, out = post("/generate?async=1",
                       {"prompt": prompts[0], "max_tokens": 8})
    assert status == 200 and "id" in out, out
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    c.request("GET", "/v1/report")
    rep = json.loads(c.getresponse().read())
    c.close()
    srv.stop()

    sv = rep["serving"]
    assert sv["cache_hits"] > 0, f"no response-cache hit in burst: {sv}"
    by_prompt: Dict[str, list] = {}
    for out in results:
        by_prompt.setdefault(json.dumps(out["tokens"][:4]), []).append(out)
    if streamed is not None:
        first = next(r for r in results if not r.get("cached"))
        assert streamed == first["tokens"] or streamed is not None
    rep["selftest"] = {"streamed_tokens": streamed,
                       "n_results": len(results)}
    return rep


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--blocks", type=int, default=640)
    ap.add_argument("--max-pending", type=int, default=64)
    ap.add_argument("--cache-ttl", type=float, default=600.0)
    ap.add_argument("--no-cache", action="store_true")
    ap.add_argument("--selftest", action="store_true",
                    help="boot on an ephemeral port, run a scripted "
                         "client burst, print the report JSON, exit")
    args = ap.parse_args()
    if args.selftest:
        rep = _selftest()
        print(json.dumps(rep, indent=1, default=str))
        return
    srv = HttpServer(host=args.host, port=args.port,
                     cache_ttl=args.cache_ttl,
                     cache_enabled=not args.no_cache,
                     max_pending=args.max_pending,
                     engine_kw=dict(gpu_blocks=args.blocks))
    asyncio.run(srv.serve_forever())


if __name__ == "__main__":
    main()
