"""The serving benchmark of the PyTorch/CUDA port (``src/repro_torch``).

    python3 tokenbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the card: agent applications
arrive on the wall clock and are served by the port's engine in the
``tokencake`` preset over ``TorchBackend``, after a pre-roll of the open
loop; the window then measures for ``--seconds``. With ``--trace 0`` the
last line of standard output holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (a slice of the window under
``torch.profiler``). Every run then checks the served tokens against the
plain reference (``reference/``) and prints the numbers compared, each
beside its limit, as the last lines of standard error and under
``"checks"``.

Exits with 1 and prints no result without a CUDA device, when the JAX
package or JAX was loaded, or when anything fails.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_loaded(modules=None) -> list:
    """Top-level names of loaded modules that belong to JAX or the JAX
    package, compared whole (``repro_torch`` is not ``repro``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def environment() -> None:
    """Build and kernel caches inside the checkout, at fixed paths; no
    library loads JAX behind the port's back."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()
    import torch

    from tokenbench import harness

    chips = harness.Bench(ROOT).cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"tokenbench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace), T_START, log=log)
    bad = forbidden_loaded()
    if bad:
        log(f"tokenbench: loaded {bad}: the benchmark runs the port alone")
        return 1
    for name, c in out["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
