"""Reduction of a ``torch.profiler`` trace of the traced slice.

Reads the profiler's raw events (no per-event Python objects are built
for the whole trace) and keeps, inside the slice that the host range
``SLICE`` spans: every device operation (kernels, copies, memsets) with
its interval, the host ranges the harness opened around each call into
the serving package (``tb.*``), and from them the busy time (the union of
the device intervals), the device time by operation name, and the idle
gaps by what the host was doing. The idle-share method is
``chip_smoke.step_device_kernels``' (device events of the profile, not
the host rows that also carry their kernels' time), taken here over a
slice of the run.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

SLICE = "tb.slice"
HOST_PREFIX = "tb."


def _is_device(ev) -> bool:
    if "CPU" in str(ev.device_type()):
        return False
    kind = str(ev.activity_type()) if hasattr(ev, "activity_type") else ""
    return "annotation" not in kind and not ev.name().startswith(HOST_PREFIX)


def reduce(kineto_results) -> dict:
    """{"window_s", "busy_s", "ops": {name: [seconds, count]},
    "gaps": {host range: seconds}, "device_events": n} of the slice."""
    events = kineto_results.events()
    spans = [(e.start_ns(), e.end_ns(), e.name()) for e in events
             if e.name().startswith(HOST_PREFIX)
             and "CPU" in str(e.device_type())]
    sl = [(a, b) for a, b, n in spans if n == SLICE]
    if not sl:
        raise RuntimeError(f"the trace holds no {SLICE!r} range")
    t0, t1 = sl[0]
    dev: List[Tuple[int, int, str]] = []
    for e in events:
        if _is_device(e):
            a, b = max(e.start_ns(), t0), min(e.end_ns(), t1)
            if b > a:
                dev.append((a, b, e.name()))
    dev.sort()
    ops: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for a, b, name in dev:
        ops[name][0] += (b - a) / 1e9
        ops[name][1] += 1
    busy, gaps, end = 0, [], t0
    for a, b, _ in dev:
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if end < t1:
        gaps.append((end, t1))
    inner = sorted((b - a, a, b, n) for a, b, n in spans if n != SLICE)
    by_host: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) // 2
        label = next((n for _, sa, sb, n in inner if sa <= mid < sb),
                     "outside the harness's ranges")
        by_host[label] += (b - a) / 1e9
    return {"window_s": (t1 - t0) / 1e9, "busy_s": busy / 1e9,
            "ops": dict(ops), "gaps": dict(by_host),
            "device_events": len(dev)}


def ops_matching(red: dict, patterns) -> Tuple[float, int]:
    """Device seconds and launches of the operations whose names hold one
    of ``patterns``."""
    sec = n = 0
    for name, (s, c) in red["ops"].items():
        if any(p in name for p in patterns):
            sec += s
            n += c
    return sec, n


def breakdown(red: dict, top: int = 10) -> dict:
    ops = sorted(red["ops"].items(), key=lambda kv: -kv[1][0])[:top]
    gaps = sorted(red["gaps"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[name[:120], s] for name, (s, _) in ops],
            "idle_gaps": [[name, s] for name, s in gaps]}
