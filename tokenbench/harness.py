"""One run of one cell: set-up, the open loop on the wall clock, the
metrics, and the comparison with the reference.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``
names its configuration (``configs/<name>.json``, through the ``file``
of the ``configs`` entry) and its traffic (``traffic/<name>.json``);
``cells/<cell>.json`` holds the cell's deployment (pool sizes, the
engine's settings over the ``tokencake`` preset, the graph buckets its
traffic uses, the sample and the limits of its comparison);
each metric is read by ``metrics/<metric>.py``.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import time
import types
import warnings
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from tokenbench import driver, model, profile, traffic
from tokenbench.reference import check

HERE = Path(__file__).resolve().parent
# seconds of the window that a traced run profiles
TRACE_SLICE_S = 3.0


class Bench:
    """``BENCHMARK.json`` and the files it names, under ``root`` (the
    checkout)."""

    def __init__(self, root: Path, bench_dir: Path = HERE):
        self.root = Path(root)
        self.dir = Path(bench_dir)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return model.load(self.root / c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return traffic.load(self.dir / "traffic" / f"{name}.json")

    def deployment(self, cell: str) -> dict:
        return json.loads((self.dir / "cells" / f"{cell}.json").read_text())

    def metrics(self, cell: str, kind: str) -> list:
        """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
        return [m for m in self.spec[kind]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        path = self.dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"tokenbench.metrics.{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def warm(backend, buckets: dict) -> None:
    """Capture the listed graph buckets of ``backend.steps`` with inputs
    that read one token of block 0 and write only the scratch block."""
    sg, p, cache = backend.steps, backend.params, backend.cache
    k, v, scratch = cache.k, cache.v, cache.scratch_slot
    bs = cache.block_size
    for bb, pb in buckets.get("decode", []):
        lens = np.zeros(bb, np.int32)
        lens[0] = 1
        sg.decode(p, k, v, np.zeros(bb, np.int32),
                  np.zeros((bb, pb), np.int32), np.zeros(bb, np.int32), lens,
                  np.full(bb, scratch, np.int32))
    for bb, c, pb, pp in buckets.get("prefill", []):
        qpos = np.full((bb, c), -1, np.int32)
        n = min(c, pb * bs)
        qpos[0, :n] = np.arange(n)
        sg.prefill(p, k, v, np.zeros((bb, c), np.int32),
                   np.zeros((bb, pb), np.int32), qpos,
                   np.full((bb, pp), cache.scratch_block, np.int32),
                   np.zeros(bb, np.int32), np.zeros(bb, np.int32))
    for (bb,) in buckets.get("head", []):
        sg.head(p, torch.zeros((bb, backend.cfg.d_model),
                               dtype=torch.bfloat16, device=k.device))


def accounting(eng, now: float) -> dict:
    """Every registered app as finished, arrived and unfinished, or not
    yet arrived, at wall second ``now``."""
    fin = sum(a.finish_time is not None for a in eng.apps.values())
    due = sum(a.arrival <= now for a in eng.apps.values())
    return {"registered": len(eng.apps), "finished": fin,
            "unfinished": due - fin, "not_arrived": len(eng.apps) - due}


def judged(rec, eng, apps, dep, seed):
    """(prompt, served tokens) of a sample, drawn from the seed, of the
    requests finished by the window's end, with the longest in it, and
    what the sample holds: tokens, segments, and the tokens of segments
    resumed after a tool or an upload."""
    done = []
    for app_id, app in eng.apps.items():
        for nid, req in app.node_request.items():
            served = rec.served.get(req.rid, [])
            if req.finish_time is not None and served:
                done.append((req.rid, apps[app_id]["prompts"][nid], served,
                             req.node.decode_segments))
    n = {"tokens": 0, "requests": 0, "segments": 0, "resumed_tokens": 0,
         "after_upload": 0}
    if not done:
        return [], n
    done.sort(key=lambda x: x[0])
    rng = np.random.default_rng(seed)
    longest = max(range(len(done)), key=lambda i: len(done[i][2]))
    order = [longest] + [i for i in rng.permutation(len(done))
                         if i != longest]
    items, budget = [], dep["judge"]
    for i in order:
        rid, prompt, served, segs = done[i]
        if (len(items) >= budget["max_requests"]
                or (n["tokens"] >= budget["tokens"] and items)):
            break
        items.append((prompt, served))
        n["tokens"] += len(served)
        n["requests"] += 1
        n["segments"] += len(segs)
        n["resumed_tokens"] += len(served) - min(segs[0], len(served))
        n["after_upload"] += len(served) - rec.upload_at.get(rid,
                                                             len(served))
    return items, n


def verdict(gaps: torch.Tensor, lim: dict, margins=None):
    """``correct`` and the numbers compared, each beside its limit: the
    widest gap over the judged tokens, and their count. The judged tokens
    are every token, or, where ``lim`` holds ``route_margin`` and the
    model is routed, the decided ones: those whose route ``margins`` are
    at least that at every layer."""
    if "route_margin" in lim and margins is not None:
        gaps = gaps[margins >= lim["route_margin"]]
    widest = float(gaps.max()) if len(gaps) else None
    checks = {
        "tokens_judged": {"value": int(len(gaps)),
                          "limit": lim["tokens_judged"]},
        "logit_gap_max": {"value": widest, "limit": lim["logit_gap_max"]},
    }
    correct = (widest is not None and widest <= lim["logit_gap_max"]
               and len(gaps) >= lim["tokens_judged"])
    return bool(correct), checks


def readings(run, log=print, sides=(None,)):
    """Of every judged token of ``run``'s sample, the gaps of each side of
    ``sides`` (``check.gaps``: the served tokens, or the reference computed
    another way), the reference's route margins (None for a dense model),
    and per judged request the seconds of the reference's pass."""
    t = time.perf_counter()
    res = check.gaps(run.shapes, run.params, run.items, sides)
    gaps = {side: torch.cat([r[side] for r, _, _ in res]) if res
            else torch.zeros(0) for side in sides}
    margins = (torch.cat([m for _, m, _ in res])
               if res and res[0][1] is not None else None)
    log(f"reference over "
        f"{sum(len(p) + len(g) for p, g in run.items)} positions in "
        f"{time.perf_counter() - t:.1f} s")
    for side, g in gaps.items():
        if len(g):
            top = torch.sort(g, descending=True).values[:6]
            who = f"{side} reference" if side else "served tokens"
            log(f"{who}: widest gaps {[round(float(x), 4) for x in top]}")
    return gaps, margins, [sec for _, _, sec in res]


def judge(run, log=print, control: Optional[str] = None):
    """The verdict on ``run``'s served tokens, or with ``control`` on the
    tokens that the reference computed that way (``check.VARIANTS``) puts
    first at the same positions. Near ties, when the cell's limits name
    a ``route_margin``, are logged and not judged."""
    gaps, margins, _ = readings(run, log, (control,))
    gaps, lim = gaps[control], run.dep["limits"]
    if "route_margin" in lim and margins is not None:
        tie = gaps[margins < lim["route_margin"]]
        log(f"near ties (route margin < {lim['route_margin']}): "
            f"{len(tie)} of {len(gaps)} tokens, widest gap "
            f"{float(tie.max()) if len(tie) else None}")
    return verdict(gaps, lim, margins)


def run_cell(root: Path, cell_name: str, seed: int, seconds: float,
             trace: bool, t_start: float, device: str = "cuda",
             bench_dir: Path = HERE, log=print) -> dict:
    """One run; returns the result line's object, the numbers compared
    last under ``"checks"``. ``t_start``: ``time.perf_counter()`` at the
    process's start."""
    run = serve(Bench(root, bench_dir), cell_name, seed, seconds, trace,
                t_start, device, log)
    correct, checks = judge(run, log)
    return dict(correct=correct, **run.out, checks=checks)


def serve(bench: Bench, cell_name: str, seed: int, seconds: float,
          trace: bool, t_start: float, device: str = "cuda", log=print):
    """Set-up, the pre-roll and the window of one run, its metrics and the
    sample to judge; the program's state is freed on return. Returns a
    namespace: ``out`` (the result line but ``correct`` and ``checks``),
    ``rec``, ``items``, ``shapes``, ``params``, ``dep``, ``window``."""
    cell = bench.cell(cell_name)
    spec = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    dep = bench.deployment(cell_name)
    cuda = torch.device(device).type == "cuda"
    if trace and not cuda:
        raise RuntimeError("a traced run reads the device's profile: it "
                           "needs a card")

    from repro_torch.core.backend import TorchBackend
    from repro_torch.core.costmodel import A100_PCIE
    from repro_torch.core.engine import Engine, EngineConfig
    from repro_torch.launch.http_server import graph_from_spec
    from repro_torch.launch.serve import MCPFrontend

    marks = [("imports", time.perf_counter())]
    if cuda:
        from repro_torch.kernels import build
        build.build()
        torch.cuda.reset_peak_memory_stats()
        marks.append(("kernel build", time.perf_counter()))
    s = model.shapes(spec)
    params = model.make_params(s, seed, device)
    if cuda:
        torch.cuda.synchronize()
    marks.append(("weights", time.perf_counter()))
    # the tool durations are part of the cell's fixed work: the engine
    # draws them from the schedule's seed, not the run's
    ecfg = EngineConfig.preset("tokencake", gpu_blocks=dep["gpu_blocks"],
                               host_blocks=dep["host_blocks"],
                               seed=mix["schedule_seed"],
                               **dep.get("engine", {}))
    backend = TorchBackend(model.model_config(spec), ecfg, A100_PCIE,
                           device=device, params=params)
    marks.append(("pools", time.perf_counter()))
    if cuda:
        warm(backend, dep.get("warm", {}))
        marks.append(("graph buckets", time.perf_counter()))
    eng = Engine(ecfg, A100_PCIE, backend=backend)
    front = MCPFrontend(eng)
    mix["vocab"] = s["vocab"]
    apps = {}
    for a in traffic.schedule(mix, seed):
        app_id = front.register_graph(graph_from_spec(a["spec"]),
                                      a["arrival"], a["prompts"])
        apps[app_id] = a
    rec = driver.Recorder(eng, backend,
                          sync=torch.cuda.synchronize if trace else None)
    w0 = float(mix["preroll_s"])
    w1 = w0 + seconds
    prof, stack, red, traced = None, contextlib.ExitStack(), None, None
    # the traced slice: the first steps from the window's middle on that
    # span TRACE_SLICE_S seconds
    slice_s = min(TRACE_SLICE_S, seconds / 2)

    def on_mark(t):
        nonlocal prof, traced
        if prof is None:
            from torch.profiler import ProfilerActivity, profile as tprof
            prof = tprof(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA])
            prof.start()
            rec.begin_slice()
            stack.enter_context(torch.profiler.record_function(
                profile.SLICE))
            return rec.now() + slice_s
        stack.close()
        traced = rec.end_slice()
        prof.stop()
        return None

    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        marks.append(("traffic", time.perf_counter()))
        driver.drive(eng, rec, w0)
        marks.append(("pre-roll", time.perf_counter()))
        # up to the window's start (a step may run on past it)
        setup_s = rec.t0 + w0 - t_start
        mem0 = torch.cuda.memory_reserved() if cuda else 0
        captures0 = dict(getattr(backend.steps, "captures", {}))
        driver.drive(eng, rec, w1, marks=((w0 + w1) / 2,) if trace else (),
                     on_mark=on_mark)
    if cuda:
        torch.cuda.synchronize()
    if trace and traced is None:        # the window closed inside the slice
        on_mark(w1)
    if trace:
        t = time.perf_counter()
        red = profile.reduce(prof.profiler.kineto_results)
        log(f"trace: {red['device_events']} device events in "
            f"{red['window_s']:.3f} s, read in {time.perf_counter() - t:.1f} s")
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    spawns = {}
    segments = {}
    for app in eng.apps.values():
        for req in app.node_request.values():
            spawns[req.rid] = (app.arrival if not req.node.deps
                               else req.arrival)
            segments[req.rid] = req.node.decode_segments
    ctx = types.SimpleNamespace(window=(w0, w1), rec=rec, spawns=spawns,
                                segments=segments, shapes=s, trace=red,
                                traced=traced, setup_s=setup_s)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench.metrics(cell_name, kind):
        value = bench.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    moved = {"offload": [0, 0], "upload": [0, 0]}
    for a, _, blocks, kind_ in rec.moves:
        if w0 <= a <= w1:
            moved[kind_][0] += 1
            moved[kind_][1] += blocks
    log(f"migrations in the window: offloads {moved['offload'][0]} "
        f"({moved['offload'][1]} blocks), uploads {moved['upload'][0]} "
        f"({moved['upload'][1]} blocks); whole run: engine offloads "
        f"{eng.metrics['offloads']}, "
        f"uploads {eng.metrics['uploads']}, preemptions "
        f"{eng.metrics['preemptions']}")
    prev = t_start
    split = []
    for name, t in marks:
        split.append(f"{name} {t - prev:.2f}")
        prev = t
    log(f"set-up s: {', '.join(split)}; window waiting agents "
        f"{rec.queue_at(w0)} -> {rec.queue_at(w1)}; apps "
        f"{accounting(eng, w1)}; decode steps {len(rec.decodes)}, "
        f"prefill calls {len(rec.prefills)}")
    if cuda:
        free, total = torch.cuda.mem_get_info()
        log(f"memory GiB: reserved after pre-roll {mem0 / 2**30:.2f}, "
            f"now {torch.cuda.memory_reserved() / 2**30:.2f}, peak "
            f"allocated {peak / 2**30:.2f}, free {free / 2**30:.2f} of "
            f"{total / 2**30:.2f}")
    sg = backend.steps
    if cuda:
        new = {k: sg.captures[k] - captures0.get(k, 0) for k in sg.captures}
        log(f"graph buckets: {sorted(k for k in sg.graphs)}; captured "
            f"inside the window: {new}; capture s {sg.capture_s:.3f}")
    attempted = sum(1 for t in spawns.values() if w0 <= t <= w1)
    failed = len({str(w.message) for w in warned
                  if "prefill truncation" in str(w.message)})

    items, n = judged(rec, eng, apps, dep, seed)
    log(f"judged: {n['tokens']} served tokens of {n['requests']} finished "
        f"requests, {n['segments']} segments; {n['resumed_tokens']} tokens "
        f"in segments resumed after a tool, {n['after_upload']} after an "
        f"upload")
    out = {"attempted": attempted, "failed": failed, "metrics": metrics}
    if cuda:
        out["device"] = {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(0), "count": 1,
                         "memory_peak_bytes": int(peak)}
        if trace:
            out["device"].update(busy_s=red["busy_s"],
                                 window_s=red["window_s"])
            out["breakdown"] = profile.breakdown(red)
    else:
        out["device"] = {"platform": "cpu", "kind": "cpu", "count": 0,
                         "memory_peak_bytes": 0}
    # free the program's state (the engine, the backend, its pools and
    # graphs) before the reference runs; the records stay
    rec.eng = rec.backend = None
    del eng, front, backend, ctx, sg
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return types.SimpleNamespace(out=out, rec=rec, items=items, shapes=s,
                                 params=params, dep=dep, window=(w0, w1))
