"""The port's tracer, ``repro_torch.trace``, on the CPU.

* Off (the default), ``span`` hands out one shared no-op and a served run
  records nothing; on, the engine serves the same token ids.
* On, the decode step's four parts lie inside their ``tc.decode``; a
  batched prefill has one ``tc.prefill.inputs`` / ``tc.prefill.launch``
  pair per replay of its plan, as many as the backend counts; every
  request prefilled is stamped ``prefill_start`` just before its prefill's span; the
  engine's offloads and a forced ``copy_out`` / ``copy_in`` record the
  ``tc.kv.*`` spans.
* With ranges on, every span is a ``torch.profiler`` range of its name,
  whose start lies within 1 ms of the span's own once mapped through
  the clock pair ``enable`` read.
"""
from collections import Counter, defaultdict
from itertools import accumulate

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.configs.base import ModelConfig
from repro_torch.core.backend import TorchBackend
from repro_torch.core.costmodel import A100_PCIE
from repro_torch.core.engine import Engine, EngineConfig
from repro_torch.core.graph import AppGraph
from repro_torch.core.request import Request
from repro_torch.core.temporal import TemporalConfig
from repro_torch.data.workloads import build_workload

TINY = dict(name="tiny-f32", arch_type="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
            dtype="float32")
DECODE_PARTS = ("tc.decode.inputs", "tc.decode.launch", "tc.decode.readback",
                "tc.decode.commit")


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _serve(records: bool):
    """Two deep_research apps, shrunk, through the engine's tokencake
    preset on a tiny f32 ``TorchBackend``, with offloads forced; returns
    the backend and the tracer's records of the run."""
    ecfg = EngineConfig.preset(
        "tokencake", gpu_blocks=96, host_blocks=128, max_running=8,
        temporal=TemporalConfig(score_threshold=-1.0,
                                pressure_watermark=0.0))
    back = TorchBackend(ModelConfig(**TINY), ecfg, A100_PCIE, seed=0,
                        device="cpu")
    eng = Engine(ecfg, A100_PCIE, backend=back)
    for t, g in build_workload("deep_research", qps=2.0, n_apps=2, seed=0):
        for n in g.nodes.values():
            n.prompt_len = min(n.prompt_len, 48)
            n.decode_segments = [min(s, 8) for s in n.decode_segments]
        eng.submit_app(g, t)
    trace.reset()
    if records:
        trace.enable()
    rep = eng.run(max_time=5000)
    trace.disable()
    assert rep["apps_finished"] == 2 and rep["offloads"] >= 1
    return back, (list(trace.spans), list(trace.stamps))


@pytest.fixture(scope="module")
def served():
    trace.disable()
    off = _serve(False)
    on = _serve(True)
    trace.reset()
    return {"off": off, "on": on}


def _backend(gpu_blocks=24, host_blocks=16, kv_precision="fp16", **cfg):
    ecfg = EngineConfig(mode="baseline", gpu_blocks=gpu_blocks,
                        host_blocks=host_blocks,
                        temporal=TemporalConfig(kv_precision=kv_precision))
    return TorchBackend(ModelConfig(**dict(TINY, **cfg)), ecfg, A100_PCIE,
                        seed=0, device="cpu")


def _req(rid, n, blocks, seed=0):
    prompt = [int(t) for t in np.random.default_rng(seed).integers(0, 128, n)]
    g = AppGraph("t")
    node = g.add_agent("a", "worker", n, decode_len=64)
    r = Request(rid=rid, app_id="app", node=node, graph=g, arrival=0.0,
                prompt_tokens=prompt)
    r.gpu_blocks_by_device[0] = list(blocks)
    return r


def _next_span(spans, t):
    """The name of the first span that starts at or after ``t``."""
    return min((a, n) for n, a, _, _ in spans if a >= t)[1]


# -- off -----------------------------------------------------------------------

def test_off_span_is_the_shared_noop_and_stamp_returns():
    assert trace.span("tc.decode") is trace.NOOP
    assert trace.span("tc.decode", rows=3, bucket=4) is trace.NOOP
    with trace.span("tc.x") as sp:
        sp.set(tokens=1)
    trace.stamp("r", "prefill_start")
    assert not trace.spans and not trace.stamps


def test_off_a_served_run_records_nothing(served):
    back, (spans, stamps) = served["off"]
    assert back.generated
    assert spans == [] and stamps == []


def test_on_the_engine_serves_the_same_tokens(served):
    off, _ = served["off"]
    on, (spans, _) = served["on"]
    assert spans
    assert on.generated.keys() == off.generated.keys()
    for rid, toks in off.generated.items():
        assert on.generated[rid] == toks, rid


# -- on ------------------------------------------------------------------------

def test_decode_parts_lie_inside_their_step(served):
    _, (spans, _) = served["on"]
    steps = [(a, b, f) for n, a, b, f in spans if n == "tc.decode"]
    assert steps
    for n, a, b, _ in spans:
        if n in DECODE_PARTS:
            assert sum(sa <= a <= b <= sb for sa, sb, _ in steps) == 1, n
    for part in DECODE_PARTS:
        assert sum(n == part for n, *_ in spans) == len(steps)
    for _, _, f in steps:
        assert 1 <= f["rows"] <= f["bucket"]


def test_every_request_is_stamped_as_its_prefill_starts(served):
    back, (spans, stamps) = served["on"]
    assert {rid for rid, _, _ in stamps} == back.generated.keys()
    assert {e for _, e, _ in stamps} == {"prefill_start"}
    # one stamp per request of each prefill call, taken just before it
    calls = sorted((a, f["reqs"]) for n, a, _, f in spans if n == "tc.prefill")
    assert len(stamps) == sum(k for _, k in calls)
    ends = [0, *accumulate(k for _, k in calls)]
    for (a, k), i in zip(calls, ends):
        for _, _, t in stamps[i:i + k]:
            assert t <= a and _next_span(spans, t) == "tc.prefill"
    # the engine's offloads and uploads (forced) open the cache's spans
    names = Counter(n for n, *_ in spans)
    assert names["tc.kv.offload.gather"] >= 1
    assert names["tc.kv.upload.scatter"] >= 2


# lengths -> (replays, slots) of the dense plan: replays of max(32,
# 256 // bb) positions a row of the rows whose suffix is left, the lock
# step's C once none has more than 32 left
REPLAYS = {(70, 20): (1, 2 * 128), (5,): (1, 8), (32, 33): (1, 2 * 128),
           (64,): (1, 256), (600, 40): (3, 2 * 128 + 2 * 256)}


@pytest.mark.parametrize("lengths", list(REPLAYS))
def test_one_inputs_and_launch_pair_per_chunk(lengths):
    back = _backend(gpu_blocks=64)
    reqs, o = [], 0
    for i, n in enumerate(lengths):
        nb = n // 16 + 2
        reqs.append(_req(f"r{i}", n, range(o, o + nb), seed=i))
        o += nb
    trace.enable()
    back.decode(reqs)
    trace.disable()
    replays, slots = REPLAYS[lengths]
    names = Counter(n for n, *_ in trace.spans)
    assert names["tc.prefill.inputs"] == names["tc.prefill.launch"] \
        == replays == back.prefill_replays
    assert names["tc.prefill"] == names["tc.prefill.head"] == 1
    assert names["tc.prefill.readback"] == names["tc.decode"] == 1
    (f,) = [f for n, _, _, f in trace.spans if n == "tc.prefill"]
    assert f == {"reqs": len(lengths), "tokens": sum(lengths),
                 "replays": replays, "slots": slots}
    assert (back.prefill_tokens, back.prefill_slots) == (sum(lengths), slots)
    pre = [(a, b) for n, a, b, _ in trace.spans if n == "tc.prefill"][0]
    for n, a, b, _ in trace.spans:
        if n.startswith("tc.prefill."):
            assert pre[0] <= a <= b <= pre[1], n
    assert [(rid, e) for rid, e, _ in trace.stamps] == [
        (r.rid, "prefill_start") for r in reqs]
    assert all(t <= pre[0] for _, _, t in trace.stamps)


def test_the_per_request_prefill_is_stamped():
    back = _backend(sliding_window=8)
    assert not back.batched_prefill
    r = _req("w", 20, [0, 1, 2])
    trace.enable()
    back.decode([r])
    back.decode([r])
    trace.disable()
    names = Counter(n for n, *_ in trace.spans)
    assert names["tc.prefill_one"] == 1 and names["tc.decode"] == 2
    ((rid, e, t),) = trace.stamps
    assert (rid, e) == ("w", "prefill_start")
    assert _next_span(trace.spans, t) == "tc.prefill_one"


@pytest.mark.parametrize("kv_precision", ["fp16", "int8_host"])
def test_a_forced_move_records_the_kv_spans(kv_precision):
    back = _backend(kv_precision=kv_precision)
    r = _req("r", 20, [1, 2, 3])
    back.decode([r])
    trace.enable()
    r.host_blocks = [0, 1, 2]
    back.copy_out(r)
    r.reserved_upload_blocks = [10, 11, 12]
    back.copy_in(r)
    trace.disable()
    names = Counter(n for n, *_ in trace.spans)
    # pinned staging and the stream's wait exist on the card only
    assert names == {"tc.kv.offload.gather": 1, "tc.kv.offload.host_copy": 1,
                     "tc.kv.upload.stage": 2, "tc.kv.upload.scatter": 2}
    assert trace.stamps == []


def test_reset_clears_and_disable_stops():
    trace.enable()
    with trace.span("tc.a", rows=1):
        pass
    trace.stamp("r", "e")
    assert trace.spans[0][0] == "tc.a" and trace.spans[0][3] == {"rows": 1}
    assert len(trace.stamps) == 1
    trace.disable()
    with trace.span("tc.b"):
        pass
    trace.stamp("r", "e")
    assert len(trace.spans) == 1 and len(trace.stamps) == 1
    trace.reset()
    assert not trace.spans and not trace.stamps


def test_spans_are_profiler_ranges_on_one_clock():
    from torch.profiler import ProfilerActivity, profile
    back = _backend(gpu_blocks=40)
    reqs = [_req("a", 40, range(0, 6)), _req("b", 9, range(6, 12), seed=1)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trace.enable(ranges=True)
        for _ in range(3):
            back.decode(reqs)
        trace.disable()
    ranges = defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(trace.PREFIX):
            ranges[e.name()].append(e.start_ns())
    own = defaultdict(list)
    for n, a, _, _ in trace.spans:
        own[n].append(trace.unix_ns(a))
    assert set(own) >= {"tc.decode", "tc.prefill", *DECODE_PARTS}
    assert {n: len(v) for n, v in ranges.items()} == \
        {n: len(v) for n, v in own.items()}
    for n, starts in own.items():
        for r, s in zip(sorted(ranges[n]), sorted(starts)):
            assert abs(r - s) < 1_000_000, (n, (r - s) / 1e6)


@pytest.mark.gpu
def test_the_card_records_pinned_staging_and_the_wait():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (pinned staging and the stream's "
                    "wait run on the card only)")
    ecfg = EngineConfig(mode="baseline", gpu_blocks=24, host_blocks=16)
    back = TorchBackend(ModelConfig(**TINY), ecfg, A100_PCIE, seed=0,
                        device="cuda")
    r = _req("r", 20, [1, 2, 3])
    back.decode([r])
    back.decode([r])
    trace.enable()
    back.decode([r])
    r.host_blocks = [0, 1, 2]
    back.copy_out(r)
    r.reserved_upload_blocks = [10, 11, 12]
    back.copy_in(r)
    trace.disable()
    names = Counter(n for n, *_ in trace.spans)
    for n in ("tc.kv.offload.gather", "tc.kv.offload.pin",
              "tc.kv.offload.wait", "tc.kv.offload.host_copy"):
        assert names[n] == 1, n
    assert names["tc.kv.upload.stage"] == names["tc.kv.upload.scatter"] == 2
    assert names["tc.graph.wait"] == 1 and names["tc.decode"] == 1
