"""The port's own tracer (``repro_torch.trace``) read through the
harness's Python API; the harness itself never switches it on. Serves a
cell on the card several times in one process, untraced and unjudged,
with the tracer off and recording in turn, and prints one JSON line per
run.

    python3 tokenbench/porttrace.py --workload W --seeds A,B,C --seconds S

Per seed two runs, the first of the pair alternating between off and
on; the tracer records over the whole run. Each line holds the cell's
end-to-end metrics, ``decode_iter_ms`` and ``sched_ms_per_step`` (what
the tracer's cost would move), and, from the tracer's records in the
window (absent with the tracer off):

``decode_host_ms``
    the mean, over the port's ``tc.decode`` steps begun in the window,
    of the time in ``tc.decode.inputs``, ``tc.decode.launch`` and
    ``tc.decode.commit``: the decode step's host work outside its wait
    on the device (``tc.decode.readback``).
``prefill_wait_p90_ms``
    the 90th percentile, over the agents spawned in the window, of the ms
    from the spawn (as ``ttft_p90_ms`` takes it) to the agent's first
    ``prefill_start`` stamp; an agent not prefilled when the window
    closes counts its wait so far.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from tokenbench import harness  # noqa: E402
from tokenbench.run import ROOT, environment  # noqa: E402

CARRIED = ("decode_iter_ms", "sched_ms_per_step")
HOST_PARTS = ("tc.decode.inputs", "tc.decode.launch", "tc.decode.commit")


def _records(ctx):
    """The tracer's spans ``(name, start, end)`` and stamps ``(rid,
    event, t)`` on the harness's clock (seconds since the Recorder's
    start), or None where it recorded nothing."""
    from repro_torch import trace
    if not trace.spans:
        return None
    t0 = ctx.rec.t0

    def s(ns):
        return ns / 1e9 - t0
    return ([(n, s(a), s(b)) for n, a, b, _ in trace.spans],
            [(rid, ev, s(t)) for rid, ev, t in trace.stamps])


def decode_host_ms(ctx):
    port = _records(ctx)
    if port is None:
        return None
    w0, w1 = ctx.window
    # a span is recorded as it closes: a step's parts come before it
    steps, acc = [], 0.0
    for n, a, b in port[0]:
        if n in HOST_PARTS:
            acc += b - a
        elif n == "tc.decode":
            steps.append((a, acc))
            acc = 0.0
    vals = [h for a, h in steps if w0 <= a < w1]
    return 1e3 * sum(vals) / len(vals) if vals else None


def prefill_wait_p90_ms(ctx):
    port = _records(ctx)
    if port is None:
        return None
    w0, w1 = ctx.window
    start = {}
    for rid, event, t in port[1]:
        if event == "prefill_start":
            start.setdefault(rid, t)
    vals = [(min(start.get(rid, w1), w1) - s) * 1e3
            for rid, s in ctx.spawns.items() if w0 <= s <= w1]
    return float(np.percentile(vals, 90)) if vals else None


READINGS = {"decode_host_ms": decode_host_ms,
            "prefill_wait_p90_ms": prefill_wait_p90_ms}


class Bench(harness.Bench):
    """An untraced run's metrics, with ``CARRIED`` and ``READINGS``."""

    def metrics(self, cell, kind):
        carried = [m for m in self.spec["per_layer"] if m["name"] in CARRIED]
        return (super().metrics(cell, kind) + carried
                + [{"name": n, "unit": "ms"} for n in READINGS])

    def reader(self, metric):
        return READINGS.get(metric) or super().reader(metric)


def serve(root: Path, cell: str, seed: int, seconds: float, on: bool,
          t_start: float, device: str = "cuda",
          bench_dir: Path = harness.HERE, log=print):
    """One untraced run with the tracer recording (``on``) or off;
    returns the harness's ``serve`` namespace. The records stay in
    ``repro_torch.trace`` until its next ``reset``."""
    from repro_torch import trace
    trace.reset()
    if on:
        trace.enable()
    try:
        return harness.serve(Bench(root, bench_dir), cell, seed, seconds,
                             False, t_start, device, log)
    finally:
        trace.disable()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    environment()
    import torch

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    runs = [(int(s), on) for i, s in enumerate(args.seeds.split(","))
            for on in ((False, True) if i % 2 == 0 else (True, False))]
    t_start = T_START
    for seed, on in runs:
        log(f"== seed {seed} tracer {'on' if on else 'off'}")
        run = serve(ROOT, args.workload, seed, args.seconds, on, t_start,
                    log=log)
        print(json.dumps({"seed": seed, "tracer": on, "metrics": {
            k: m["value"] for k, m in run.out["metrics"].items()}}),
            flush=True)
        del run
        torch.cuda.empty_cache()
        t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
