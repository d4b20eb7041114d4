#!/usr/bin/env python3
"""Where the bf16 paged-prefill kernel (B4) spends its time, and the
decode kernel's block shape, on one GPU.

    python3 tools/prefill_breakdown.py [--against DIR ...]

Builds variants of ``src/repro_torch/kernels/csrc/paged_prefill.cu`` (with
its header ``mma.cuh``) that each drop one part of the tensor-core tile
loop, and times them with ``chip_smoke.py``'s CUDA-graph timer at the main
path's shape (Qwen2.5-14B: B 8, C 32, H 40, Hkv 8, D 128, bs 16, the last
chunk of a 1024-token context, the last row padded), at 256-token contexts
and at B 4 (96 blocks, at most one per SM):

- ``base``: the files as they are;
- ``no_lo``: without the lo half of the hi/lo P V product;
- ``no_load``: without the K/V copies after the first tile (the block
  computes on stale tiles);
- ``no_compute``: without S, the softmax and P V (copies and barriers
  only).

Only ``base`` computes the right answer; its error against the plain
version is printed, the others' are not meaningful.

The split-context decode kernel of ``paged_attention.cu`` (bf16 B2 and
B9) is timed as it is (``base``), with two warps per block (``warps2``:
two runs per block, each warp with its own ring; correct too) and
without the combine kernel (``no_combine``: the partials are left
uncombined), at the main path's decode shape (q (8, 40, 128), 64-page
tables, 7 rows of 1024 tokens, the last row padded) and at 256-token
contexts through 16-page tables.

``--against DIR`` also builds ``DIR/paged_prefill.cu``,
``DIR/swa_attention.cu`` and ``DIR/paged_attention.cu`` (for example the
``csrc`` of a parent commit unpacked with ``git archive``) and times them
and ``base`` in turns (other, base, base, other): bf16 B4, f32 B4 and
bf16 B10 (int8 pages) at the main path's shape, bf16 B15 (sliding-window
attention) at Hymba-1.5B's prefill shape, q/k/v (4, 2048, 25, 64) with a
1024-token window, and bf16 B2, f32 B2 and bf16 B9 at the main path's
decode shape, so two versions compare inside one run on one card (a
``paged_attention.cu`` without the split-context entries runs its scalar
kernel on bf16). Each build prints the ptxas registers, spills and static
shared memory of its tensor-core kernels (D 128 for paged prefill and
decode, D 64 for sliding-window attention). Exits 1 without a CUDA
device.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

OUT = ROOT / "build" / "prefill_breakdown"
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"

# the code that the variants remove: the lo MMAs of P V (mma.cuh), the
# next tile's copies and the tile's compute (paged_prefill.cu)
_LO_MMA = """      mma_bf16_16816(o[2 * dp], pl, vb[0], vb[1]);
      mma_bf16_16816(o[2 * dp + 1], pl, vb[2], vb[3]);
"""
_NEXT_TILE = "    if (it + 1 < n_tiles) issue(st ^ 1);\n"
_COMPUTE_FROM = ("    const __nv_bfloat16* ks = kv_s + (QUANT ? 0 : 2 * st * "
                 "TILE);\n")
_COMPUTE_TO = ("\n#pragma unroll\n  for (int i = 0; i < 2; ++i) {\n"
               "    float l = l_r[i];")
# the tensor-core kernels whose ptxas report each build prints
_TC_ENTRY = re.compile(r"Compiling entry function '(_Z\w*(?:"
                       r"paged_prefill_tc_kernelI\w*Li128E|"
                       r"paged_decode_tc_kernelI\w*Li128E|"
                       r"swa_attention_tc_kernelILi64E)\w*)'")
# the decode kernel's warps per block, which the warps2 variant doubles,
# and its combine launch, which no_combine removes
_DC_WARPS = "constexpr int DC_WARPS = 1;"
_DC_COMBINE = """  paged_decode_combine_kernel<<<(unsigned)(batch * H), D, 0, s>>>(
      part_o, part_ml, (__nv_bfloat16*)out, splits, D, scale_log2);
"""


def variants(src: str, hdr: str) -> dict:
    """``{variant: (paged_prefill.cu, mma.cuh)}`` from the sources of
    ``base``."""
    for text, part in ((hdr, _LO_MMA), (src, _NEXT_TILE),
                       (src, _COMPUTE_FROM), (src, _COMPUTE_TO)):
        if part not in text:
            raise SystemExit("prefill_breakdown: paged_prefill.cu / mma.cuh "
                             "no longer have the code a variant removes:\n"
                             + part)
    a, b = src.index(_COMPUTE_FROM), src.index(_COMPUTE_TO)
    return {"base": (src, hdr), "no_lo": (src, hdr.replace(_LO_MMA, "")),
            "no_load": (src.replace(_NEXT_TILE, ""), hdr),
            "no_compute": (src[:a] + "    (void)t0;\n  }\n" + src[b:], hdr)}


def build_all(sources: dict) -> dict:
    """Compile every ``{name: path to .cu}`` in parallel (headers next to
    the source first, then ``csrc/``); returns the loaded libraries and
    prints the ptxas report of each tensor-core kernel."""
    from repro_torch.kernels import build
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, cu in sources.items():
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(CSRC),
               "-o", str(OUT / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            m = _TC_ENTRY.search(line)
            if m:
                print(f"  {name}: {m.group(1)}: {lines[i + 2].strip()} | "
                      f"{lines[i + 3].strip()}", flush=True)
        libs[name] = ctypes.CDLL(str(OUT / f"{name}.so"))
    return libs


def case(b: int, p: int, dt):
    """Inputs of one B4 call: the last 32-token chunk of a p-page context
    per row, the last row padded, random tables; plus the pools quantized
    to int8 for B10."""
    import numpy as np
    import torch

    from chip_smoke import BS, C, D, H, HKV
    from repro_torch.kernels import ref as R
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n = b * p + 1
    kp, vp = (torch.randn((n, BS, HKV, D), generator=gen, device=dev).to(dt)
              for _ in "kv")
    q = torch.randn((b, C, H, D), generator=gen, device=dev).to(dt)
    tables = torch.as_tensor(np.random.default_rng(0).permutation(b * p)
                             .reshape(b, p).astype(np.int32)).to(dev)
    qpos = np.full((b, C), -1, np.int32)
    qpos[:b - 1] = p * BS - C + np.arange(C)
    qp = torch.as_tensor(qpos).to(dev)
    return dict(q=q, kp=kp, vp=vp, tables=tables, qp=qp,
                kq=R.quantize_block_ref(kp), vq=R.quantize_block_ref(vp))


def _bind(lib, name: str):
    from repro_torch.kernels import ops
    fn = getattr(lib, name)
    fn.argtypes = ops._SIGNATURES[name][1]       # the stream included
    fn.restype = ctypes.c_int
    return fn


def _checked(fn, name: str, args):
    import torch

    def call():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name}: cudaError {rc}")
    return call


def caller(lib, c: dict, kind: str):
    """A closure launching ``kind`` (``b4`` or ``b10``) from ``lib`` on the
    inputs ``c``, and the output it writes."""
    import torch

    from chip_smoke import BS, HKV
    from repro_torch.kernels import ops
    q, tables, qp = c["q"], c["tables"], c["qp"]
    b, ch, h, d = q.shape
    out = torch.empty_like(q)
    code = 1 if q.dtype == torch.bfloat16 else 0
    name = ("paged_prefill_attention" if kind == "b4"
            else "paged_prefill_attention_quant")
    pools = ([c["kp"].data_ptr(), c["vp"].data_ptr()] if kind == "b4" else
             [c["kq"][0].data_ptr(), c["vq"][0].data_ptr(),
              c["kq"][1].data_ptr(), c["vq"][1].data_ptr()])
    args = (q.data_ptr(), *pools, tables.data_ptr(), qp.data_ptr(),
            out.data_ptr(), b, ch, tables.shape[1], BS, HKV, h // HKV, d,
            ops.PREFILL_Q_TILE, 1.0 / math.sqrt(d), code)
    return _checked(_bind(lib, name), name, args), out


def decode_case(p: int, dt):
    """Inputs of one B2 call at the main path's decode shape over p-page
    tables, every live row's context the whole table, the last row padded;
    plus the pools quantized to int8 for B9."""
    import numpy as np
    import torch

    from chip_smoke import B, BS, D, H, HKV
    from repro_torch.kernels import ref as R
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n = B * p + 1
    kp, vp = (torch.randn((n, BS, HKV, D), generator=gen, device=dev).to(dt)
              for _ in "kv")
    q = torch.randn((B, H, D), generator=gen, device=dev).to(dt)
    tables = torch.as_tensor(np.random.default_rng(0).permutation(B * p)
                             .reshape(B, p).astype(np.int32)).to(dev)
    lens = torch.full((B,), p * BS, dtype=torch.int32, device=dev)
    lens[-1] = 0
    return dict(q=q, kp=kp, vp=vp, tables=tables, lens=lens,
                kq=R.quantize_block_ref(kp), vq=R.quantize_block_ref(vp))


def decode_caller(lib, c: dict, kind: str):
    """A closure launching ``kind`` (``b2`` or ``b9``) from ``lib`` on the
    inputs ``c`` through the entry ``ops`` would take (the split-context
    entry for bf16, where ``lib`` has it), and the output it writes."""
    import torch

    from chip_smoke import BS, HKV
    q, tables, lens = c["q"], c["tables"], c["lens"]
    b, h, d = q.shape
    p = tables.shape[1]
    out = torch.empty_like(q)
    name = "paged_attention" if kind == "b2" else "paged_attention_quant"
    pools = ([c["kp"].data_ptr(), c["vp"].data_ptr()] if kind == "b2" else
             [c["kq"][0].data_ptr(), c["vq"][0].data_ptr(),
              c["kq"][1].data_ptr(), c["vq"][1].data_ptr()])
    head = (q.data_ptr(), *pools, tables.data_ptr(), lens.data_ptr(),
            out.data_ptr())
    scale = 1.0 / math.sqrt(d)
    scratch = None
    if q.dtype == torch.bfloat16 and hasattr(lib, f"{name}_tc"):
        splits = _bind(lib, "paged_decode_splits")(b, p, BS, HKV, d,
                                                   int(kind == "b9"))
        if splits < 1:
            raise RuntimeError(f"paged_decode_splits: cudaError {-splits}")
        scratch = torch.empty(b * h * splits * (d + 2), dtype=torch.float32,
                              device=q.device)
        name += "_tc"
        args = (*head, scratch.data_ptr(), b, p, BS, HKV, h // HKV, d,
                splits, scale)
    else:
        args = (*head, b, p, BS, HKV, h // HKV, d, scale,
                1 if q.dtype == torch.bfloat16 else 0)
    call = _checked(_bind(lib, name), name, args)

    def run():
        call()
        return scratch                  # keeps the partials' scratch alive
    return run, out


def decode_want(c: dict, kind: str):
    """The plain version's output of ``kind`` (``b2`` or ``b9``) on ``c``."""
    from repro_torch.kernels import ref as R
    if kind == "b2":
        return R.paged_attention_ref(c["q"], c["kp"], c["vp"], c["tables"],
                                     c["lens"])
    (kq, ks), (vq, vs) = c["kq"], c["vq"]
    return R.paged_attention_quant_ref(c["q"], kq, vq, ks, vs, c["tables"],
                                       c["lens"])


def swa_case():
    """bf16 q, k, v of Hymba-1.5B's prefill after the head repeat, as the
    families phase of chip_smoke.py calls B15, and its window."""
    import torch

    from chip_smoke import FAM_B, FAM_S
    from repro_torch.configs.base import get_config
    cfg = get_config("hymba_1_5b")
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn((FAM_B, FAM_S, cfg.num_heads, cfg.head_dim),
                           generator=gen, device="cuda").bfloat16()
               for _ in "qkv")
    return q, k, v, cfg.sliding_window


def swa_caller(lib, q, k, v, window: int):
    """A closure launching B15 from ``lib`` on bf16 q, k, v, and the
    output it writes."""
    import torch
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    name = "swa_attention"
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
            h, d, min(window, s), 1.0 / math.sqrt(d), 1)
    return _checked(_bind(lib, name), name, args), out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", nargs="*", default=[],
                    help="directories holding another paged_prefill.cu and "
                         "swa_attention.cu")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("prefill_breakdown: needs a CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import P, graph_ms, smi
    from repro_torch.kernels import ref as R

    print(f"[device] {smi()}", flush=True)
    sources = {}
    for name, (cu, hdr) in variants(
            (CSRC / "paged_prefill.cu").read_text(),
            (CSRC / "mma.cuh").read_text()).items():
        (OUT / name).mkdir(parents=True, exist_ok=True)
        (OUT / name / "mma.cuh").write_text(hdr)
        sources[name] = OUT / name / "paged_prefill.cu"
        sources[name].write_text(cu)
    dec = (CSRC / "paged_attention.cu").read_text()
    for part in (_DC_WARPS, _DC_COMBINE):
        if part not in dec:
            raise SystemExit("prefill_breakdown: paged_attention.cu no "
                             "longer has the code a variant changes:\n"
                             + part)
    sources["dec_base"] = CSRC / "paged_attention.cu"
    for name, cu in (
            ("dec_warps2", dec.replace(_DC_WARPS,
                                       "constexpr int DC_WARPS = 2;")),
            ("dec_no_combine", dec.replace(_DC_COMBINE, ""))):
        (OUT / name).mkdir(parents=True, exist_ok=True)
        sources[name] = OUT / name / "paged_attention.cu"
        sources[name].write_text(cu)
    others = [f"other{i}" for i in range(len(args.against))]
    if others:
        sources["swa_base"] = CSRC / "swa_attention.cu"
    for name, d in zip(others, args.against):
        sources[name] = Path(d).resolve() / "paged_prefill.cu"
        sources[f"swa_{name}"] = Path(d).resolve() / "swa_attention.cu"
        sources[f"dec_{name}"] = Path(d).resolve() / "paged_attention.cu"
    libs = build_all(sources)

    bf16 = torch.bfloat16
    for b, p in ((8, P), (8, 16), (4, P)):
        c = case(b, p, bf16)
        want = R.paged_prefill_attention_ref(c["q"], c["kp"], c["vp"],
                                             c["tables"], c["qp"])
        for name in ("base", "no_lo", "no_load", "no_compute"):
            call, out = caller(libs[name], c, "b4")
            call()
            torch.cuda.synchronize()
            err = float((out.float() - want.float()).abs().max())
            ms = graph_ms(call)
            print(f"  B {b}, {p} pages, bf16 B4 {name:10s} {ms:.4f} ms"
                  + (f"  max abs err {err:.3g}" if name == "base" else ""),
                  flush=True)
    for p in (P, 16):
        c = decode_case(p, bf16)
        for kind in ("b2", "b9"):
            want = decode_want(c, kind)
            for name in ("dec_base", "dec_warps2", "dec_no_combine"):
                call, out = decode_caller(libs[name], c, kind)
                call()
                torch.cuda.synchronize()
                err = float((out.float() - want.float()).abs().max())
                print(f"  {p} pages, bf16 {kind.upper()} {name[4:]:10s} "
                      f"{graph_ms(call):.4f} ms"
                      + (f"  max abs err {err:.3g}"
                         if name != "dec_no_combine" else ""), flush=True)
    if others:
        sq, sk, sv, window = swa_case()
        swa_want = R.swa_attention_ref(sq, sk, sv, window)
    for other, d in zip(others, args.against):
        print(f"[against] {d}: turns {other}, base, base, {other}",
              flush=True)
        for dt, kind in ((bf16, "b4"), (torch.float32, "b4"),
                         (bf16, "b10"), (bf16, "b15"), (bf16, "b2"),
                         (torch.float32, "b2"), (bf16, "b9")):
            want = None
            if kind == "b15":
                lib = {other: libs[f"swa_{other}"], "base": libs["swa_base"]}
                calls = {n: swa_caller(lib[n], sq, sk, sv, window)
                         for n in (other, "base")}
                want = swa_want
            elif kind in ("b2", "b9"):
                c = decode_case(P, dt)
                lib = {other: libs[f"dec_{other}"], "base": libs["dec_base"]}
                calls = {n: decode_caller(lib[n], c, kind)
                         for n in (other, "base")}
                want = decode_want(c, kind)
            else:
                c = case(8, P, dt)
                calls = {n: caller(libs[n], c, kind)
                         for n in (other, "base")}
            times = [graph_ms(calls[n][0])
                     for n in (other, "base", "base", other)]
            label = f"{'bf16' if dt == bf16 else 'f32'} {kind.upper()}"
            line = (f"  {label}: {other} {times[0]:.4f} / {times[3]:.4f} ms, "
                    f"base {times[1]:.4f} / {times[2]:.4f} ms")
            if want is not None:
                torch.cuda.synchronize()
                errs = [float((calls[n][1].float() - want.float())
                              .abs().max()) for n in (other, "base")]
                line += (f"; max abs err {other} {errs[0]:.3g}, base "
                         f"{errs[1]:.3g}")
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
