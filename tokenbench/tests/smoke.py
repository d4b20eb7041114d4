"""A benchmark of smoke size for the CPU tests: the harness's metric
readers, a Qwen2.5-shaped and a Mixtral-shaped configuration cut to 2
layers of width 256 (vocabulary 512), a short deep_research mix with
half-second tools, and two cells over them, in a temporary directory
laid out as a checkout (``BENCHMARK.json`` at its root)."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

SMOKE = dict(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
             num_attention_heads=8, num_key_value_heads=2, vocab_size=512)
# limits of the smoke cells, from CPU readings over every served token
# (three seeds): the widest gap reads up to 0.014 (dense) and 0.013
# (MoE), the fp8 control from 0.44 and 1.49
CELL = {"gpu_blocks": 256, "host_blocks": 256,
        "engine": {"sched_quantum": 1},
        "limits": {"logit_gap_max": 0.1, "tokens_judged": 10},
        "judge": {"tokens": 200, "max_requests": 4}}


def write_bench(root: Path, host_blocks: int = 256) -> Path:
    """The smoke benchmark under ``root``; returns its harness directory."""
    tb = root / "tb"
    for d in ("configs", "traffic", "cells"):
        (tb / d).mkdir(parents=True, exist_ok=True)
    shutil.copytree(BENCH / "metrics", tb / "metrics")
    configs = []
    for name, src, extra in (
            ("dense-smoke", "qwen2.5-14b", {}),
            ("moe-smoke", "mixtral-8x22b.l12", {"num_local_experts": 4})):
        cfg = json.loads((BENCH / "configs" / f"{src}.json").read_text())
        cfg["name"] = name
        cfg["config"].update(SMOKE, **extra)
        (tb / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        configs.append({"name": name, "source": cfg["source"],
                        "file": f"tb/configs/{name}.json", "reduced": [],
                        "why": "smoke size"})
    mix = json.loads((BENCH / "traffic" / "deep_research.json").read_text())
    mix["lengths"]["prompt"].update(min=16, max=96)
    mix["lengths"]["output"].update(min=8, max=24)
    for t in mix["tools"].values():
        t["predict_time"] = 0.5
    mix.update(n_apps=8, preroll_s=1.0)
    mix["arrivals"]["rate"] = 1.0
    (tb / "traffic" / "mini.json").write_text(json.dumps(mix))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = ["dense.mini", "moe.mini"]
    bench["configs"] = configs
    bench["workloads"] = [
        {"name": c, "config": cfg["name"], "traffic": "mini", "chips": 1,
         "why": "smoke"} for c, cfg in zip(cells, configs)]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m["workloads"] = cells
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for c in cells:
        (tb / "cells" / f"{c}.json").write_text(
            json.dumps(dict(CELL, host_blocks=host_blocks)))
    return tb


def run_smoke(root: Path, tb: Path, cell: str = "dense.mini",
              seconds: float = 4.0, seed: int = 2**31 + 7, **kw) -> dict:
    import time

    from tokenbench import harness
    return harness.run_cell(root, cell, seed, seconds, False,
                            time.perf_counter(), device="cpu", bench_dir=tb,
                            log=lambda m: None, **kw)
