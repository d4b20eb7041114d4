"""How a cell's fixed numbers were found, kept so that a later change can
find them again. Serves the cell several times in one process on the
card, through the benchmark's own ``harness.serve`` and ``harness.judge``,
and prints one JSON line per run.

    python3 tokenbench/calibrate.py sweep --workload W --rates 0.2,0.3 \\
        --seed N --seconds S [--preroll P]
        the knee: the cell at each Poisson rate (apps per second), with a
        series per 10 s from the open loop's start of served tokens/s,
        waiting agents, the pool's share held by running requests, the
        blocks moved, prefilled tokens and decode rows
    python3 tokenbench/calibrate.py control --workload W --seeds A,B,C \\
        --seconds S [--quantum Q]
        the limit of the comparison: per seed, the served tokens' verdict
        and the fp8 control's, each through the harness's own ``correct``;
        ``--quantum`` sets the engine's scheduling quantum in place of the
        cell's
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
from tokenbench.run import ROOT, environment  # noqa: E402

SERIES_S = 10.0


def series_of(rec, end: float, step: float = SERIES_S) -> list:
    """Per ``step`` seconds from the start of the open loop: served tokens
    per second, agents waiting (mean over steps), the pool's share held
    by running requests (mean), blocks offloaded and uploaded, prefilled
    tokens, and decode rows per decode step (mean)."""
    out = []
    for a in np.arange(0.0, end, step):
        b = a + step
        inb = lambda t: a <= t < b  # noqa: E731
        wait = [n for t, n in rec.queue if inb(t)]
        util = [u for t, u in rec.util if inb(t)]
        rows = [n for t, _, n in rec.decodes if inb(t)]
        out.append({
            "t": round(float(b), 1),
            "tok_s": sum(1 for t, *_ in rec.tokens if inb(t)) / step,
            "waiting": float(np.mean(wait)) if wait else 0.0,
            "kv_eff": float(np.mean(util)) if util else 0.0,
            "off_blocks": sum(n for t, _, n, k in rec.moves
                              if inb(t) and k == "offload"),
            "up_blocks": sum(n for t, _, n, k in rec.moves
                             if inb(t) and k == "upload"),
            "prefill_tok": sum(n for t, _, n, _ in rec.prefills if inb(t)),
            "rows": float(np.mean(rows)) if rows else 0.0})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("sweep", "control"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--rates", default="")
    ap.add_argument("--preroll", type=float)
    ap.add_argument("--quantum", type=int)
    args = ap.parse_args(argv)
    environment()
    import torch

    from tokenbench import harness

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    class Bench(harness.Bench):
        """The cell with this run's traffic and engine settings."""
        mix: dict = {}

        def traffic(self, name):
            return dict(super().traffic(name), **self.mix)

        def deployment(self, cell):
            dep = super().deployment(cell)
            if args.quantum is not None:
                dep["engine"] = dict(dep.get("engine", {}),
                                     sched_quantum=args.quantum)
            return dep

    runs = ([(args.seed, {"arrivals": {"process": "poisson",
                                        "rate": float(r)}})
             for r in args.rates.split(",")] if args.mode == "sweep"
            else [(int(s), {}) for s in args.seeds.split(",")])
    t_start = T_START
    for seed, mix in runs:
        if args.preroll is not None:
            mix["preroll_s"] = args.preroll
        log(f"== {args.mode} seed {seed} {mix} quantum {args.quantum}")
        bench = Bench(ROOT)
        bench.mix = mix
        run = harness.serve(bench, args.workload, seed, args.seconds, False,
                            t_start, log=log)
        correct, checks = harness.judge(run, log)
        line = dict(correct=correct, **run.out, checks=checks, seed=seed,
                    traffic=mix, quantum=args.quantum)
        if args.mode == "control":
            ctl, ctl_checks = harness.judge(run, log, control="fp8")
            line["control"] = {"correct": ctl, "checks": ctl_checks}
            log(f"control fp8: correct {ctl}, {ctl_checks}")
        else:
            line["series"] = series_of(run.rec, run.window[1])
        print(json.dumps(line), flush=True)
        del run
        torch.cuda.empty_cache()
        t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
