"""The serving front door on the port (``repro_torch.launch.http_server``,
a verbatim copy of the JAX package's): ``FrontDoor`` traces on the
simulated engine give the JAX package's reports, continuous and quantum
admission give ``JaxBackend``'s tokens through ``TorchBackend``, and an
``HttpServer`` over a real localhost socket serves ``TorchBackend``'s own
tokens. Also the HTTP session tests of ``tests/test_sessions.py`` on the
port's server, and its ``--selftest``.
"""
import http.client
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from torch_engine_pair import torch_one_thread  # noqa: F401 (autouse)
from torch_engine_pair import JAX, TORCH, assert_same

ROOT = Path(__file__).resolve().parents[1]
BT = 16
TINY = dict(name="tiny-f32", arch_type="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
            dtype="float32")


# ---------------------------------------------------------------------------
# FrontDoor traces on the simulated engine: the port's reports == JAX's
# ---------------------------------------------------------------------------

def mk_front(P, continuous=True, cache=True, ttl=1e9, max_pending=64,
             **engine_kw):
    kw = dict(gpu_blocks=256, max_running=32, sched_quantum=8,
              continuous_batching=continuous)
    kw.update(engine_kw)
    eng = P.Engine(P.EngineConfig.preset("tokencake", **kw), P.A100_PCIE)
    rc = (P.ResponseCache(ttl=ttl, clock=lambda: eng.clock)
          if cache else None)
    return P.FrontDoor(eng, cache=rc, max_pending=max_pending)


def gens(fd):
    return {gid: dict(status=g.status, rid=g.rid, n=g.n_tokens,
                      result=g.result, ttft=g.ttft(), latency=g.latency())
            for gid, g in fd.gens.items()}


def result(fd):
    return dict(front=fd.report(), engine=fd.engine.report(), gens=gens(fd))


def trace_cache(P):
    """A hit serves from the cache, past the TTL the engine decodes again."""
    fd = mk_front(P, ttl=0.5)
    prompt = P.synth_tokens("prompt/a", 48)
    fd.submit({"prompt": prompt, "max_tokens": 8})
    fd.drive()
    fd.submit({"prompt": prompt, "max_tokens": 8})
    fd.submit({"prompt": prompt, "max_tokens": 8},
              arrival=fd.engine.clock + 1.0)
    fd.drive()
    return result(fd)


def trace_backpressure(P):
    """A burst of 10 at ``max_pending`` 4: six structured 429s."""
    fd = mk_front(P, cache=False, max_pending=4)
    for i in range(10):
        fd.submit({"prompt": P.synth_tokens(f"bp/{i}", 32), "max_tokens": 4})
    fd.drive()
    return result(fd)


def trace_spread(P):
    """24 arrivals over time under ``max_pending`` 8, repeats cached."""
    fd = mk_front(P, max_pending=8)
    for i in range(24):
        fd.submit({"prompt": P.synth_tokens(f"q/{i % 6}", 32),
                   "max_tokens": 4}, arrival=0.2 * i)
    fd.drive()
    return result(fd)


def trace_quantum(P, continuous=False):
    fd = mk_front(P, continuous=continuous, cache=False)
    for i in range(12):
        fd.submit({"prompt": P.synth_tokens(f"eq/{i % 4}", 48),
                   "max_tokens": 16}, arrival=0.07 * i)
    fd.drive()
    return result(fd)


def trace_continuous(P):
    return trace_quantum(P, continuous=True)


def trace_sessions(P):
    """Two turns of a session on the simulated engine: turn-end offload,
    predictive warm, suffix-only second turn."""
    eng = P.Engine(P.EngineConfig.preset(
        "tokencake", gpu_blocks=256, max_running=8, continuous_batching=True,
        sessions=True), P.A100_PCIE)
    fd = P.FrontDoor(eng, cache=None)
    p1 = P.synth_tokens("sess/p", 8 * BT)
    g1 = fd.submit({"prompt": p1, "max_tokens": 16, "session_id": "A"})
    fd.drive()
    p2 = p1 + P.synth_tokens("sess/r", 16 + BT)
    fd.submit({"prompt": p2, "max_tokens": 16, "session_id": "A"},
              arrival=g1.finish + 12.0)
    fd.drive()
    return dict(result(fd), sessions=dict(eng.session_metrics),
                info=eng.session_info("A"))


TRACES = {f.__name__: f for f in (trace_cache, trace_backpressure,
                                  trace_spread, trace_quantum,
                                  trace_continuous, trace_sessions)}


@pytest.mark.parametrize("name", TRACES)
def test_front_door_trace_matches_jax(name):
    want, got = TRACES[name](JAX), TRACES[name](TORCH)
    assert_same(want, got)
    assert got["front"]["outstanding"] == 0


def test_traces_cover_cache_backpressure_and_admission():
    cache = trace_cache(TORCH)["front"]
    assert cache["cache_hits"] == 1 and cache["completed"] == 2
    assert cache["response_cache"]["expirations"] >= 1
    bp = trace_backpressure(TORCH)["front"]
    assert bp["rejected"] == 6 and bp["completed"] == 4
    q, c = trace_quantum(TORCH), trace_continuous(TORCH)
    assert q["front"]["completed"] == c["front"]["completed"] == 12
    for key in ("decoded_tokens", "prefill_tokens"):
        assert q["engine"][key] == c["engine"][key], key
    assert q["front"]["ttft"] != c["front"]["ttft"]
    s = trace_sessions(TORCH)
    assert s["sessions"]["session_offloads"] >= 1
    assert s["sessions"]["session_warms"] == 1


# ---------------------------------------------------------------------------
# real compute: continuous admission == quantum admission == JaxBackend
# ---------------------------------------------------------------------------

def admission_tokens(P, continuous):
    cfg = P.ModelConfig(**TINY)
    rng = np.random.default_rng(11)
    trace = [(0.05 * i, [int(t) for t in rng.integers(0, 128, 24 + 4 * i)])
             for i in range(4)]
    ecfg = P.EngineConfig.preset(
        "tokencake", gpu_blocks=96, host_blocks=64, max_running=8,
        sched_quantum=8, continuous_batching=continuous)
    backend = P.backend(cfg, ecfg, P.A100_PCIE)
    fd = P.FrontDoor(P.Engine(ecfg, P.A100_PCIE, backend=backend),
                     cache=None, max_pending=16)
    for t, prompt in trace:
        fd.submit({"prompt": prompt, "max_tokens": 8}, arrival=t)
    rep = fd.drive()
    assert rep["completed"] == len(trace)
    return {g.rid: list(backend.generated[g.rid]) for g in fd.gens.values()}


def test_continuous_equals_quantum_tokens_torch():
    quantum = admission_tokens(TORCH, False)
    continuous = admission_tokens(TORCH, True)
    assert set(quantum) == set(continuous)
    for rid in quantum:
        assert quantum[rid] == continuous[rid], rid
        assert len(quantum[rid]) > 0
    assert quantum == admission_tokens(JAX, False)
    assert continuous == admission_tokens(JAX, True)


# ---------------------------------------------------------------------------
# HTTP over a real localhost socket
# ---------------------------------------------------------------------------

def _req(port, method, path, body=None):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    c.request(method, path,
              json.dumps(body) if body is not None else None,
              {"Content-Type": "application/json"})
    r = c.getresponse()
    raw = r.read()
    c.close()
    return r.status, json.loads(raw)


def _drain(port, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        _, rep = _req(port, "GET", "/v1/report")
        if rep["serving"]["outstanding"] == 0:
            return rep
        time.sleep(0.02)
    raise AssertionError("server did not drain")


def test_generate_over_socket_serves_torch_backend_tokens():
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.backend import TorchBackend
    from repro_torch.core.costmodel import A100_PCIE
    from repro_torch.core.engine import Engine, EngineConfig
    from repro_torch.launch.http_server import HttpServer

    cfg = ModelConfig(**TINY)
    ecfg = EngineConfig.preset("tokencake", gpu_blocks=96, host_blocks=64,
                               continuous_batching=True, prefix_cache=True)
    backend = TorchBackend(cfg, ecfg, A100_PCIE, device="cpu")
    srv = HttpServer(engine=Engine(ecfg, A100_PCIE, backend=backend))
    port = srv.start_background()
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(0, 128, 40 + 8 * i)]
               for i in range(3)]
    try:
        outs = [_req(port, "POST", "/generate",
                     {"prompt": p, "max_tokens": 6}) for p in prompts]
        status, hit = _req(port, "POST", "/generate",
                           {"prompt": prompts[0], "max_tokens": 6})
        rep = _drain(port)
    finally:
        srv.stop()
    assert not srv._thread.is_alive()
    for status, out in outs:
        assert status == 200 and out["ok"] and not out["cached"]
        assert out["tokens"] == backend.generated[out["rid"]][:6]
        assert len(out["tokens"]) == 6
    assert status == 200 and hit["cached"]
    assert hit["tokens"] == outs[0][1]["tokens"]
    assert rep["serving"]["completed"] == 3
    assert rep["serving"]["cache_hits"] == 1
    assert backend.truncated_prompt_tokens == 0


@pytest.fixture(scope="module")
def session_server():
    from repro_torch.launch.http_server import HttpServer
    srv = HttpServer(engine_kw=dict(gpu_blocks=256, sessions=True),
                     cache_ttl=0.75)
    port = srv.start_background()
    yield srv, port
    srv.stop()


def test_http_session_endpoints_roundtrip(session_server):
    srv, port = session_server
    synth = TORCH.synth_tokens
    status, out = _req(port, "POST", "/v1/session/open", {"sid": "chat1"})
    assert status == 200 and out["ok"] and out["sid"] == "chat1"
    status, out = _req(port, "POST", "/generate",
                       {"prompt": synth("http/p", 4 * BT),
                        "max_tokens": 8, "session_id": "chat1"})
    assert status == 200 and out["ok"]
    _drain(port)
    status, info = _req(port, "GET", "/v1/session/chat1")
    assert status == 200 and info["turns"] == 1
    assert info["state"] in ("resident", "offloading", "offloaded",
                             "warming")
    assert info["context_tokens"] > 0
    status, _ = _req(port, "GET", "/v1/session/nope")
    assert status == 404
    status, out = _req(port, "POST", "/v1/session/chat1/close")
    assert status == 200 and out["ok"]
    status, info = _req(port, "GET", "/v1/session/chat1")
    assert status == 200 and info["state"] == "dropped"
    status, _ = _req(port, "POST", "/v1/session/nope/close")
    assert status == 404


def test_http_sessions_disabled_rejected():
    from repro_torch.launch.http_server import HttpServer
    srv = HttpServer(engine_kw=dict(gpu_blocks=128))
    port = srv.start_background()
    try:
        status, out = _req(port, "POST", "/v1/session/open", {})
        assert status == 400 and out["ok"] is False
        assert "disabled" in out["error"]
    finally:
        srv.stop()


def test_http_idle_server_expires_cached_response(session_server):
    srv, port = session_server
    _drain(port)
    body = {"prompt": TORCH.synth_tokens("idle/p", 3 * BT), "max_tokens": 6}
    status, out = _req(port, "POST", "/generate", body)
    assert status == 200 and out["cached"] is False
    status, hit = _req(port, "POST", "/generate", body)
    assert status == 200 and hit["cached"] is True
    time.sleep(1.5)                        # wall idle > cache_ttl=0.75
    status, out2 = _req(port, "POST", "/generate", body)
    assert status == 200 and out2["cached"] is False
    assert srv.front.cache.metrics["expirations"] >= 1


def test_selftest_subprocess():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.http_server",
         "--selftest"], env=env, capture_output=True, text=True,
        timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    rep = json.loads(proc.stdout)
    assert rep["serving"]["cache_hits"] > 0
    assert rep["serving"]["outstanding"] == 0
    assert rep["selftest"]["n_results"] > 0


# ---------------------------------------------------------------------------
# chip_smoke.py's front-door phase and check, rehearsed on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    """``chip_smoke.py`` as a module (its phases run on the CPU here with
    the tiny model; on the card ``python3 chip_smoke.py`` runs them at
    Qwen2.5-14B's size)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tiny():
    import torch

    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import model as M
    cfg = ModelConfig(**TINY)
    return cfg, M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def test_chip_smoke_front_door_serve_on_the_cpu(smoke, tiny):
    out = smoke.frontdoor_serve(*tiny, "cpu", 256, 128)
    sv = out["serving"]
    assert sv["cache_hits"] == 1 and sv["outstanding"] == 0
    assert sv["completed"] == 5                    # four + the session turn
    assert out["engine"]["cow_forks"] >= 1
    assert out["burst_tokens"] == 4 * smoke.FD_MAX_TOKENS
    assert set(out["tool_app_states"].values()) == {"finished"}


def test_chip_smoke_session_roundtrip_on_the_cpu(smoke, tiny):
    runs = smoke.session_roundtrip(*tiny, "cpu", 256, 128)
    ttl = runs["ttl"]
    assert ttl["sessions"]["session_warms"] == 1
    assert ttl["d2h_bytes"] > 0 and ttl["h2d_bytes"] > 0
    assert runs["pin"]["d2h_bytes"] == 0
    assert len(ttl["turn2"]) == smoke.FD_TURN_TOKENS


def test_chip_smoke_front_door_trace_on_the_cpu(smoke):
    import torch

    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import model as M
    cfg = ModelConfig(**smoke.CHECK_TINY)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    a = smoke.frontdoor_trace(cfg, params, "cpu")
    assert a == smoke.frontdoor_trace(cfg, params, "cpu")
    assert a["metrics"]["cow_forks"] >= 1
    assert a["sessions"]["session_warms"] == 1
    assert a["front"] == dict(accepted=4, completed=4, cache_hits=1,
                              outstanding=0)
    statuses = sorted(s for s, _ in a["responses"].values())
    assert statuses == ["cached"] + ["finished"] * 4
