"""Traffic of a cell: the apps, their arrival times and their prompts.

A traffic file (``traffic/<name>.json``) holds only parameters: the app's
agent graph as a template, the two length samplers, the tools with their
predicted durations, the arrival rate, how many apps the schedule holds,
the seed of the schedule and the pre-roll. ``schedule`` reads it.

The template and the samplers are a frozen copy of the code_writer and
deep_research builders and of ``prompt_lengths`` / ``output_lengths`` of
the serving package (its ``data/workloads.py`` and ``data/pipeline.py``),
which draw in the same order from one ``numpy`` generator: arrivals
first, then each app's agents in order, each agent's prompt before its
decode segments. ``tests/test_tokenbench_traffic.py`` holds the copy to
the originals.

Sizes and arrival times come from the file's ``schedule_seed``, so every
run of a cell serves the same apps at the same times (the harness also
seeds the engine's tool durations with it); the run's seed draws the
prompt token ids.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

import numpy as np


def lognormal_length(rng: np.random.Generator, spec: dict) -> int:
    """``int(lognormal(mean, sigma))`` clipped to [min, max]."""
    x = int(rng.lognormal(mean=spec["mean"], sigma=spec["sigma"]))
    return int(np.clip(x, spec["min"], spec["max"]))


def segment_length(o: int, spec: dict) -> int:
    """A decode segment from one output-length draw ``o``:
    ``max(min, int(o * scale) // div)``."""
    return max(spec.get("min", 0),
               int(o * spec.get("scale", 1)) // spec.get("div", 1))


def app_spec(rng: np.random.Generator, mix: dict, name: str) -> dict:
    """One app in the JSON wire form that ``graph_from_spec`` takes."""
    nodes = []
    for node in mix["nodes"]:
        prompt = (lognormal_length(rng, mix["lengths"]["prompt"])
                  // node.get("prompt_div", 1))
        segs = [segment_length(lognormal_length(rng,
                                                mix["lengths"]["output"]), s)
                for s in node["segments"]]
        calls = [dict(mix["tools"][fc["kind"]], name=fc["kind"],
                      **{k: v for k, v in fc.items() if k != "kind"})
                 for fc in node.get("func_calls", [])]
        nodes.append({"name": node["name"],
                      "agent_type": node["agent_type"],
                      "prompt_len": prompt, "decode_segments": segs,
                      "func_calls": calls, "deps": node.get("deps", [])})
    return {"name": name, "nodes": nodes}


def load(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def schedule(mix: dict, seed: int) -> List[dict]:
    """[{"arrival": s, "spec": wire form, "prompts": {node index: ids}}]
    for the mix's ``n_apps`` apps, in arrival order. ``vocab`` bounds the
    token ids (``mix["vocab"]`` is set by the caller)."""
    rng = np.random.default_rng(mix["schedule_seed"])
    rate = mix["arrivals"]["rate"]
    n = mix["n_apps"]
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n))
    specs = [app_spec(rng, mix, mix["app"]) for _ in range(n)]
    run_rng = np.random.default_rng(seed)
    out = []
    for t, spec in zip(arrivals, specs):
        prompts: Dict[int, List[int]] = {
            i: run_rng.integers(0, mix["vocab"], nd["prompt_len"]).tolist()
            for i, nd in enumerate(spec["nodes"])}
        out.append({"arrival": float(t), "spec": spec, "prompts": prompts})
    return out
