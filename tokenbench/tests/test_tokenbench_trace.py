"""The port's tracer read through the harness's Python API
(``tokenbench/porttrace.py``), on the CPU: its two readings, a smoke run
with the tracer recording and one with it off."""
import bisect
import collections
import math
import time
import types

import numpy as np
import pytest

from repro_torch import trace
from tokenbench import porttrace

# readers of the accepted benchmark that need no device trace
OLD = ("gen_tok_per_s", "ttft_p90_ms", "setup_s", "decode_iter_ms",
       "sched_ms_per_step")


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _ns(t):
    return round(t * 1e9)


def _step(t, inputs, launch, readback, commit):
    """One ``tc.decode`` with its four parts from ``t`` seconds, as the
    tracer records them: each span as it closes."""
    out, a = [], t
    for n, d in (("inputs", inputs), ("launch", launch),
                 ("readback", readback), ("commit", commit)):
        out.append((f"tc.decode.{n}", _ns(a), _ns(a + d), {}))
        a += d
    return out + [("tc.decode", _ns(t), _ns(a), {"rows": 1, "bucket": 1})]


def _ctx(spawns=None):
    return types.SimpleNamespace(window=(1.0, 10.0), spawns=spawns or {},
                                 rec=types.SimpleNamespace(t0=0.0))


def test_decode_host_ms_is_the_window_steps_host_parts():
    trace.spans.extend(
        _step(0.5, 1e-3, 2e-3, 20e-3, 1e-3)          # before the window
        + _step(1.5, 1e-3, 1e-3, 20e-3, 1e-3)        # 3 ms of host work
        + [("tc.graph.wait", _ns(3.0), _ns(3.001), {})]
        + _step(3.0, 2e-3, 2e-3, 20e-3, 1e-3)        # 5 ms
        + _step(10.0, 1e-3, 9e-3, 20e-3, 1e-3))      # after it
    assert porttrace.decode_host_ms(_ctx()) == pytest.approx(4.0)


def test_prefill_wait_p90_ms_reads_each_agents_first_prefill_start():
    trace.spans.append(("tc.prefill", 0, 1, {}))
    trace.stamps.extend([("a", "prefill_start", _ns(2.5)),
                         ("a", "prefill_start", _ns(4.0)),
                         ("b", "prefill_start", _ns(3.0))])
    # "c" waits past the window's close; "d" spawned before the window
    ctx = _ctx({"a": 2.0, "b": 2.0, "c": 9.0, "d": 0.5})
    assert porttrace.prefill_wait_p90_ms(ctx) == pytest.approx(
        float(np.percentile([500.0, 1000.0, 1000.0], 90)))


def test_nothing_recorded_reads_nothing():
    assert porttrace.decode_host_ms(_ctx()) is None
    assert porttrace.prefill_wait_p90_ms(_ctx({"a": 2.0})) is None


def _serve(root, tb, on, seed=2**31 + 11):
    return porttrace.serve(root, "dense.mini", seed, 6.0, on,
                           time.perf_counter(), device="cpu", bench_dir=tb,
                           log=lambda m: None)


def test_a_recorded_run_reads_both_and_agrees_with_the_recorder(smoke):
    root, tb = smoke
    run = _serve(root, tb, True)
    got = run.out["metrics"]
    for name in (*porttrace.READINGS, *OLD):
        assert math.isfinite(got[name]["value"]), name
        assert got[name]["value"] >= 0, name
    # on the harness's clock: each of the port's decode steps and prefill
    # stamps lies within 1 ms after the Recorder's call that holds it, and
    # every call of the Recorder's from the first of them on holds its own
    t0 = run.rec.t0

    def held(port_ns, calls):
        port_t = [t / 1e9 - t0 for t in port_ns]
        starts = sorted(t for t, _ in calls)
        first = bisect.bisect_right(starts, min(port_t)) - 1
        assert first >= 0
        n = collections.Counter()
        for a in port_t:
            i = bisect.bisect_right(starts, a) - 1
            assert 0 <= a - starts[i] < 1e-3
            n[i] += 1
        want = {i: k for i, (_, k) in enumerate(sorted(calls)) if i >= first}
        assert n == want

    held([a for n, a, *_ in trace.spans if n == "tc.decode"],
         [(t, 1) for t, *_ in run.rec.decodes])
    held([t for _, e, t in trace.stamps if e == "prefill_start"],
         [(t, n) for t, _, _, n in run.rec.prefills])


def test_an_untraced_run_leaves_the_tracer_off(smoke):
    root, tb = smoke
    run = _serve(root, tb, False)
    assert not trace.spans and not trace.stamps
    assert set(run.out["metrics"]) == set(OLD)


def test_a_recorded_run_loads_neither_jax_nor_the_jax_package(smoke):
    from tokenbench.tests.test_tokenbench_harness import _loaded_after
    root, tb = smoke
    loaded = _loaded_after(
        "import time, pathlib\n"
        "from tokenbench import porttrace\n"
        f"porttrace.serve(pathlib.Path({str(root)!r}), 'dense.mini', 3, 1.0,"
        f" True, time.perf_counter(), device='cpu',"
        f" bench_dir=pathlib.Path({str(tb)!r}), log=lambda m: None)")
    assert "repro_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}
