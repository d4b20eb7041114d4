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
        the limit of the comparison: per seed, in one reference pass, the
        served tokens, the split-K witness and the fp8 control, each with
        its verdict through the harness's own ``correct``, its widest gap
        over every judged token and, for a routed model, over the decided
        tokens at each route margin of ``MARGINS`` with their share; per
        request the reference's seconds, and per token its route margin
        and the three gaps; ``--quantum`` sets the engine's scheduling
        quantum in place of the cell's

Every mode takes ``--calibration FILE`` in place of ``--workload``: a
configuration, traffic and deployment given by file (``calibration/``),
served without a cell of ``BENCHMARK.json``.
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
# the sides the control mode reads, by the name it prints them under:
# the served tokens, the split-K witness, the fp8 control
SIDES = {"served": None, "witness": "splitk", "control": "fp8"}
# the route margins the control mode reads the decided tokens at
MARGINS = (0.02, 0.05, 0.075, 0.09, 0.095, 0.1, 0.11, 0.12)


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


def _widest(gaps) -> dict:
    return {"widest": float(gaps.max()) if len(gaps) else None,
            "tokens": len(gaps)}


def sides(run, margins_at, log) -> dict:
    """The served tokens', the split-K witness's and the fp8 control's
    readings over ``run``'s judged sample (``harness.readings``): each
    side's verdict, its widest gap over every token and over the decided
    tokens at each route margin of ``margins_at``; per request, in the
    order drawn, its served tokens, positions and the reference's
    seconds, so that what a sample of the first n requests holds and
    costs can be read; and per judged token its route margin (0 for a
    dense model) and the three sides' gaps."""
    import torch

    from tokenbench import harness
    gaps, margins, seconds = harness.readings(run, log, tuple(SIDES.values()))
    lim = run.dep["limits"]
    out = {}
    for name, side in SIDES.items():
        g = gaps[side]
        correct, checks = harness.verdict(g, lim, margins)
        out[name] = {"correct": correct, "checks": checks,
                     "every": _widest(g)}
        if margins is not None:
            out[name]["decided"] = {
                str(d): dict(_widest(g[margins >= d]),
                             share=int((margins >= d).sum()) / len(g))
                for d in margins_at}
        log(f"{name}: {out[name]}")
    out["sample"] = [[len(sv), len(p) + len(sv), round(t, 3)]
                     for (p, sv), t in zip(run.items, seconds)]
    cols = [margins if margins is not None else torch.zeros(len(gaps[None]))]
    out["tokens"] = torch.stack(cols + [gaps[side] for side in SIDES.values()],
                                1).round(decimals=5).tolist()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("sweep", "control"))
    where = ap.add_mutually_exclusive_group(required=True)
    where.add_argument("--workload")
    where.add_argument("--calibration", type=Path)
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

    cal = (json.loads((ROOT / args.calibration).read_text())
           if args.calibration else None)
    workload = args.calibration.stem if cal else args.workload

    class Bench(harness.Bench):
        """The cell, or the calibration file's configuration, traffic and
        deployment, with this run's traffic and engine settings."""
        mix: dict = {}

        def cell(self, name):
            if cal is None:
                return super().cell(name)
            return {"name": name, "config": cal["config"],
                    "traffic": cal["traffic"], "chips": 1}

        def config(self, name):
            if cal is None:
                return super().config(name)
            from tokenbench import model
            return model.load(ROOT / name)

        def traffic(self, name):
            return dict(super().traffic(name), **self.mix)

        def deployment(self, cell):
            dep = (super().deployment(cell) if cal is None
                   else dict(cal["deployment"]))
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
        run = harness.serve(bench, workload, seed, args.seconds, False,
                            t_start, log=log)
        line = dict(run.out, seed=seed, traffic=mix, quantum=args.quantum)
        if args.mode == "control":
            line.update(sides(run, MARGINS, log))
        else:
            correct, checks = harness.judge(run, log)
            line.update(correct=correct, checks=checks,
                        series=series_of(run.rec, run.window[1]))
        print(json.dumps(line), flush=True)
        del run
        torch.cuda.empty_cache()
        t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
