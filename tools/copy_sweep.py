#!/usr/bin/env python3
"""The single-layer block copies (B13a ``block_gather``, B13b
``block_scatter``) at other thread-block shapes, on one GPU.

    python3 tools/copy_sweep.py

Builds ``src/repro_torch/kernels/csrc/block_copy.cu`` once per (threads per
block, vectors per thread) in ``SHAPES`` (its ``COPY_THREADS`` and
``COPY_VECS``; the first is the file as it is), swaps each build's entries
into ``ops._fns`` with ``ops.COPY_THREADS`` / ``COPY_VECS`` set to match,
so ``ops._copy_split`` plans its chunks, and on one layer of
``chip_smoke.py``'s serve pool, (2049, 16, 8, 128) bf16, at 1, 32 and 1536
block ids: holds gather and scatter to their plain versions bit for bit,
then times each in a 50-launch CUDA graph (``chip_smoke.graph_ms``), the
builds in order and then in reverse, beside ``index_select`` /
``index_copy_`` in the same graph harness. Prints one line per build and
block count (the two turns' times) and the card's name and power limit.
Exits 1 without a CUDA device.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "copy_sweep"
# (threads per block, 16-byte vectors per thread)
SHAPES = ((128, 2), (64, 2), (128, 1), (256, 1), (64, 4), (128, 4),
          (256, 2))
ENTRIES = ("block_gather", "block_scatter")


def build_all() -> dict:
    """Each shape's build, compiled in parallel: {(threads, vecs):
    {entry: its C function, typed as ``ops`` types it}}."""
    from repro_torch.kernels import build, ops
    OUT.mkdir(parents=True, exist_ok=True)
    src = (CSRC / "block_copy.cu").read_text()
    base = (f"#define COPY_THREADS {ops.COPY_THREADS}\n"
            f"#define COPY_VECS {ops.COPY_VECS}\n")
    if src.count(base) != 1:
        raise SystemExit("copy_sweep: block_copy.cu no longer defines "
                         f"its block shape as\n{base}")
    procs = {}
    for t, u in SHAPES:
        cu = OUT / f"t{t}_u{u}.cu"
        cu.write_text(src.replace(base, f"#define COPY_THREADS {t}\n"
                                        f"#define COPY_VECS {u}\n"))
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(CSRC), "-o",
               str(cu.with_suffix(".so")), str(cu)]
        procs[t, u] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    builds = {}
    for shape, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {shape}:\n{log}")
        lib = ctypes.CDLL(str(OUT / f"t{shape[0]}_u{shape[1]}.so"))
        builds[shape] = {}
        for name in ENTRIES:
            fn = getattr(lib, name)
            fn.argtypes = ops._SIGNATURES[name][1]
            fn.restype = ctypes.c_int
            builds[shape][name] = fn
    return builds


def use(builds, shape) -> None:
    from repro_torch.kernels import ops
    ops.COPY_THREADS, ops.COPY_VECS = shape
    ops._fns.update(builds[shape])


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("copy_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as R
    card = CS.smi()
    print(f"[device] {card}", flush=True)
    builds = build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    nb = CS.GPU_BLOCKS + 1
    pages = torch.randn((nb, CS.BS, CS.HKV, CS.D), generator=gen,
                        device=dev).to(torch.bfloat16)
    cases = {}
    for m in (1, CS.M_BLOCKS, CS.M_BLOCKS * CS.LAYERS):
        ids = np.concatenate([[nb - 1, nb - 2],
                              rng.choice(nb - 2, max(m - 2, 0),
                                         replace=False)])[:m]
        idx = torch.as_tensor(ids.astype(np.int32), device=dev)
        st = torch.randn((m, CS.BS, CS.HKV, CS.D), generator=gen,
                         device=dev).to(torch.bfloat16)
        cases[m] = (idx, idx.long(), st)
    times = {}
    for turn in (list(SHAPES), list(reversed(SHAPES))):
        for shape in turn:
            use(builds, shape)
            for m, (idx, idx64, st) in cases.items():
                assert torch.equal(ops.block_gather(pages, idx),
                                   R.block_gather_ref(pages, idx)), shape
                want = R.block_scatter_ref(pages.clone(), idx, st)
                ops.block_scatter(pages, idx, st)
                torch.cuda.synchronize()
                assert torch.equal(pages, want), shape
                times.setdefault((shape, m), []).append((
                    CS.graph_ms(lambda: ops.block_gather(pages, idx)),
                    CS.graph_ms(lambda: ops.block_scatter(pages, idx, st))))
        for m, (idx, idx64, st) in cases.items():
            times.setdefault(("library", m), []).append((
                CS.graph_ms(lambda: pages.index_select(0, idx64)),
                CS.graph_ms(lambda: pages.index_copy_(0, idx64, st))))
    use(builds, SHAPES[0])
    print(f"[copy_sweep] {card}: device ms per call, 50 launches in a CUDA "
          "graph, two turns (builds in order, then in reverse)")
    for (shape, m), runs in times.items():
        label = "index_select / index_copy_" if shape == "library" else \
            f"threads {shape[0]:3d} x vectors {shape[1]}"
        print(f"  {label:28s} m {m:5d}: gather "
              + " / ".join(f"{g:.5f}" for g, _ in runs) + "  scatter "
              + " / ".join(f"{s:.5f}" for _, s in runs), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
