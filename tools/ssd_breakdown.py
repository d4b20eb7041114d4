#!/usr/bin/env python3
"""Where the SSD scan's tensor-core route (B14, ``ssd_scan_tc``) spends its
time, and where its distance from float64 comes from, on one GPU.

    python3 tools/ssd_breakdown.py

Builds variants of ``src/repro_torch/kernels/csrc/ssd_scan.cu`` and runs
each through ``ops.ssd_scan`` (its ``ssd_scan_tc`` entry swapped in) on the
inputs of ``chip_smoke.py``'s B14 cases (``family_kernel_cases``: B 4,
S 2048, P 64, Q 64; Mamba2-130M: H 24, N 128; Hymba-1.5B: H 50, N 16),
bf16 and f32 x:

- ``base``: the file as it is (held to the plain version at ``TOL_SSD``);
- ``two_part``: every product over two bf16 parts per f32 operand (hi hi +
  hi lo + lo hi, three MMAs; two with bf16 x) instead of three;
- ``fadd_acc``: every MMA of a split product into a zeroed accumulator,
  added to the running sum by a float32 add (the MMAs then never sum
  their products with a large running sum);
- ``no_chunk_mma``: the chunk launch without its MMAs (it stores zeros);
- ``no_chunk_b``: the chunk launch without staging dec o b (its MMAs read
  what shared memory holds);
- ``no_inter``: the y launch without (exp(pre) c) state_in^T (it still
  stages the state), so y is the intra term alone;
- ``no_state``: the y launch without staging the entering state (its
  MMAs read what shared memory holds);
- ``no_intra``: the y launch without (G o L) x, so y is the inter term
  alone.

Times, in turns (each build in order, then in reverse): the whole call in
a CUDA graph (``chip_smoke.graph_ms``) and each launch's device time in a
profile of 20 calls (``chip_smoke.ssd_launch_ms``). Distances from float64
(``chip_smoke.ssd_errors``: max abs and the ``TOL_SSD`` ratio, y and the
final state), against the plain version run in float64 and, for the one-
term builds, against that term of ``emulate_ssd_terms`` unsplit in float64
(``tests/torch_ssd_emulation.py``): ``base``, ``two_part``, ``fadd_acc``,
``no_inter``, ``no_intra``, the float32 plain version, and the emulation
of the route (three and two parts, and each term of the three-part one)
run on the card in float32. Each build prints the ptxas registers and
spills of its tensor-core kernels. Exits 1 without a CUDA device.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "ssd_breakdown"

# variant -> (code of base, what replaces it)
VARIANTS = {
    "two_part": ("  for (int s = 2; s >= 0; --s)\n",
                 "  for (int s = 1; s >= 0; --s)\n"),
    "fadd_acc": ("        mma_bf16_16816(d, a[i], b[j][2 * half], "
                 "b[j][2 * half + 1]);\n",
                 "        {\n          float t[4] = {0.f, 0.f, 0.f, 0.f};\n"
                 "          mma_bf16_16816(t, a[i], b[j][2 * half], "
                 "b[j][2 * half + 1]);\n"
                 "#pragma unroll\n"
                 "          for (int e = 0; e < 4; ++e) d[e] += t[e];\n"
                 "        }\n"),
    "no_chunk_mma": ("      mma_split<NX, 3>(acc[2 * np], xa, bf, 0);\n"
                     "      mma_split<NX, 3>(acc[2 * np + 1], xa, bf, 1);\n",
                     ""),
    "no_chunk_b": ("  store_split<3, N / 4>(ds, PART, LDN, bv, sfx_s);\n", ""),
    "no_inter": ("  if (ck > 0) {\n    float tpre = 0.f;",
                 "  if (ck < 0) {\n    float tpre = 0.f;"),
    "no_state": ("  if (ck > 0) {\n    float4 v[N / 8];",
                 "  if (ck < 0) {\n    float4 v[N / 8];"),
    "no_intra": ("    if (kk > warp) break;\n    float mid = 0.f;",
                 "    if (kk >= 0) break;\n    float mid = 0.f;"),
}


def build_all(src: str) -> dict:
    """Each variant's source compiled in parallel; returns {name: its
    ``ssd_scan_tc`` entry, typed as ``ops`` types it} and prints the
    tensor-core kernels' ptxas registers and spills."""
    from repro_torch.kernels import build, ops
    OUT.mkdir(parents=True, exist_ok=True)
    texts = {"base": src}
    for name, (old, new) in VARIANTS.items():
        if src.count(old) != 1:
            raise SystemExit(f"ssd_breakdown: ssd_scan.cu no longer has the "
                             f"code {name} changes:\n{old}")
        texts[name] = src.replace(old, new)
    procs = {}
    for name, text in texts.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(CSRC), "-o",
               str(OUT / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        entry = None
        for line in log.splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1]
            elif entry and "_tc_kernel" in entry and (
                    "Used" in line or "spill" in line):
                print(f"  {name}: {entry[:56]}: {line.strip()[14:]}",
                      flush=True)
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).ssd_scan_tc
        fn.argtypes = ops._SIGNATURES["ssd_scan_tc"][1]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ssd_breakdown: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 emulation
    import chip_smoke as CS
    import torch_ssd_emulation as E
    from repro_torch.kernels import ops
    print(f"[device] {CS.smi()}", flush=True)
    fns = build_all((CSRC / "ssd_scan.cu").read_text())

    def dist(label, got, want):
        e = CS.ssd_errors(got, want)
        print(f"    {label:34s} " + ", ".join(
            f"{k} max abs {v['max_abs']:.3g} ratio {v['ratio']:.3g}"
            for k, v in e.items()), flush=True)

    for dt in ("bf16", "f32"):
        for case in CS.family_kernel_cases(dt):
            if case["name"] != "ssd_scan":
                continue
            arch = case["shape"].split(":")[0]
            x, dts, a, bm, cm, q = case["kernel"].args
            print(f"  {arch} {dt} x: distance from float64 (ratio under "
                  "TOL_SSD)", flush=True)
            ref = case["plain64"]()
            intra64, inter64, _ = E.emulate_ssd_terms(x, dts, a, bm, cm, q,
                                                      parts=None)
            dist("plain version, f32", case["plain"](), ref)
            intra, inter, st = E.emulate_ssd_terms(x, dts, a, bm, cm, q)
            dist("emulation, three-part", (intra + inter, st), ref)
            dist("emulation, two-part",
                 E.emulate_ssd_tc(x, dts, a, bm, cm, q, parts=2), ref)
            dist("emulation, three-part, intra term", (intra, st),
                 (intra64, ref[1]))
            dist("emulation, three-part, inter term", (inter, st),
                 (inter64, ref[1]))
            del intra, inter, st
            for name, want in (("base", ref[0]), ("two_part", ref[0]),
                               ("fadd_acc", ref[0]), ("no_inter", intra64),
                               ("no_intra", inter64)):
                ops._fns["ssd_scan_tc"] = fns[name]
                got = case["kernel"]()
                if name == "base":
                    for g, w in zip(got, case["plain"]()):
                        torch.testing.assert_close(g, w, **CS.TOL_SSD)
                dist(f"kernel {name}", got, (want, ref[1]))
            del ref, intra64, inter64
            times = {}
            for name in [*fns, *reversed(list(fns))]:
                ops._fns["ssd_scan_tc"] = fns[name]
                times.setdefault(name, []).append(
                    {"call": CS.graph_ms(case["kernel"]),
                     **CS.ssd_launch_ms(case["kernel"])})
            ops._fns["ssd_scan_tc"] = fns["base"]
            for name, runs in times.items():
                print(f"  {arch} {dt} x {name:13s} " + " | ".join(
                    ", ".join(f"{k} {v:.4f}" for k, v in t.items())
                    for t in runs) + " ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
