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

The KV write kernels of ``kv_write.cu`` (B1, B3 and their RoPE-fused
entries; one token per block) are timed at ``chip_smoke.py``'s bf16
shapes with the block shape as it is (``base``: 16 head slots per block)
and with 8 and 32 (``heads8``, ``heads32``); all are correct, and the
fused entries' error against their plain versions is printed.

``--against DIR`` also builds ``DIR/paged_prefill.cu``,
``DIR/swa_attention.cu``, ``DIR/paged_attention.cu`` and
``DIR/kv_write.cu`` (for example the ``csrc`` of a parent commit unpacked
with ``git archive``) and times them and ``base`` in turns (other, base,
base, other): bf16 B4, f32 B4 and bf16 B10 (int8 pages) at the main
path's shape, bf16 B15 (sliding-window attention) at Hymba-1.5B's
prefill shape, q/k/v (4, 2048, 25, 64) with a 1024-token window, and bf16
B2, f32 B2 and bf16 B9 at the main path's decode shape, so two versions
compare inside one run on one card (a ``paged_attention.cu`` without the
split-context entries runs its scalar kernel on bf16). Then the KV writes
at ``chip_smoke.py``'s B1 / B3 shapes, bf16, in a CUDA graph and eagerly:
B1 and B3 alone, and each layer's RoPE + write, which is one fused launch
(``rope_kv_token_write`` / ``rope_kv_chunk_write``) where the build has
the fused entries and, where it has not, torch's RoPE of q and of k
followed by B1 / B3, as the decoder ran it before them (``kv_write.cu``'s
C signatures before the fused entries are kept here for that). Last, it
runs ``--steps`` on DIR's source tree (three levels above DIR) and on this
one, each in its own process. Each build prints the ptxas registers,
spills and static shared memory of its tensor-core kernels (D 128 for
paged prefill and decode, D 64 for sliding-window attention) and of its
bf16 KV write kernels.

``--steps SRC`` imports ``repro_torch`` from the source tree SRC, builds
Qwen2.5-14B at full width and depth (random bf16 weights from seed 0) with
the serve phase's pools, and prints as one JSON line the device kernels,
copies and memsets of one ``paged_decode_step`` and one
``paged_prefill_step`` at the serve's shape, and the host's launch calls
that put them on the card (``chip_smoke.step_device_kernels``): run
eagerly, and, where SRC has ``models.graphs``, replayed from the step's
CUDA graph, where the same device kernels take one graph launch and one
input copy. Exits 1 without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
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
                       r"swa_attention_tc_kernelILi64E|"
                       r"kv_(?:token|chunk)_write_kernelI13__nv_bfloat16Li8E)"
                       r"\w*)'")
# the decode kernel's warps per block, which the warps2 variant doubles,
# and its combine launch, which no_combine removes
_DC_WARPS = "constexpr int DC_WARPS = 1;"
_DC_COMBINE = """  paged_decode_combine_kernel<<<(unsigned)(batch * H), D, 0, s>>>(
      part_o, part_ml, (__nv_bfloat16*)out, splits, D, scale_log2);
"""
# kv_write.cu's C signatures before the fused RoPE entries (byte rows, no
# dtype), for a build that lacks them
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# the KV write kernels' head slots per block, which the kvw variants change
_KVW_HEADS = "constexpr int KVW_HEADS = 16;"
KVW_VARIANTS = {f"heads{n}": (_KVW_HEADS, f"constexpr int KVW_HEADS = {n};")
                for n in (8, 32)}
_KVW_BYTES = {"kv_token_write": [_P] * 5 + [_I64, _I64, _I64, _P],
              "kv_chunk_write": [_P] * 7 + [_I64, _I, _I, _I, _I64, _I64,
                                            _P]}


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


def _bind(lib, name: str, argtypes=None):
    from repro_torch.kernels import ops
    fn = getattr(lib, name)
    fn.argtypes = argtypes or ops._SIGNATURES[name][1]   # the stream too
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


def kvw_case():
    """bf16 inputs of the decode and prefill KV writes as ``chip_smoke.py``
    holds B1, B3 and their fused entries: B 8 rows over a (513, 16, 8, 128)
    pool, the last two decode rows padded into the scratch slot; 32-token
    windows starting at offset i of row i's first page, the last row
    padded; q (8, 40, 128) and (8, 32, 40, 128); positions up to 4096."""
    import numpy as np
    import torch

    from chip_smoke import B, BS, C, D, H, HKV, P
    from repro_torch.configs.base import get_config
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    def ints(x):
        return torch.as_tensor(np.asarray(x, np.int32)).to(dev)

    n = B * P + 1
    scratch = (n - 1) * BS
    slots = rng.choice(scratch, B, replace=False)
    slots[-2:] = scratch
    pp = (C - 1) // BS + 2
    wpages = np.full((B, pp), n - 1)
    wpages[:B - 1] = rng.permutation(B * P)[:(B - 1) * pp].reshape(B - 1, pp)
    posc = np.zeros((B, C))
    posc[:B - 1] = rng.integers(0, 4097 - C, B - 1)[:, None] + np.arange(C)
    return dict(
        kp=rand(n, BS, HKV, D), vp=rand(n, BS, HKV, D), q=rand(B, H, D),
        k=rand(B, HKV, D), v=rand(B, HKV, D), slots=ints(slots),
        pos=ints(rng.integers(0, 4097, B)), qc=rand(B, C, H, D),
        kc=rand(B, C, HKV, D), vc=rand(B, C, HKV, D), wp=ints(wpages),
        ws=ints(np.arange(B) % BS), wc=ints([C] * (B - 1) + [0]),
        posc=ints(posc), theta=get_config("qwen2_5_14b_serving").rope_theta)


def kvw_callers(lib, c: dict) -> dict:
    """``{what: closure}`` over ``lib``'s KV writes on the inputs ``c``:
    ``b1`` and ``b3`` alone, and the decode / prefill layer's RoPE + write
    (``rope_b1`` / ``rope_b3``: the fused entry where ``lib`` has it, else
    torch's RoPE of q and k, then ``lib``'s B1 / B3). The layer closures
    return the roped q."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as R
    kp, vp = c["kp"], c["vp"]
    n, bs, hkv, d = kp.shape
    b, h = c["q"].shape[:2]
    ch, pp = c["qc"].shape[1], c["wp"].shape[1]
    fused = hasattr(lib, "rope_kv_token_write")
    sig = None if fused else _KVW_BYTES
    tail1 = (hkv, d, 1) if fused else (hkv * d * 2,)
    tail3 = (n * bs, hkv, d, 1) if fused else (n, hkv * d * 2)
    b1 = _bind(lib, "kv_token_write", sig and sig["kv_token_write"])
    b3 = _bind(lib, "kv_chunk_write", sig and sig["kv_chunk_write"])

    def write1(k, v):
        _checked(b1, "kv_token_write", (
            kp.data_ptr(), vp.data_ptr(), k.data_ptr(), v.data_ptr(),
            c["slots"].data_ptr(), b, n * bs, *tail1))()

    def write3(k, v):
        _checked(b3, "kv_chunk_write", (
            kp.data_ptr(), vp.data_ptr(), k.data_ptr(), v.data_ptr(),
            c["wp"].data_ptr(), c["ws"].data_ptr(), c["wc"].data_ptr(), b,
            ch, pp, bs, *tail3))()

    out = {"b1": lambda: write1(c["k"], c["v"]),
           "b3": lambda: write3(c["kc"], c["vc"])}
    if fused:
        freqs = ops.rope_freqs(d, float(c["theta"]), kp.device)
        f1 = _bind(lib, "rope_kv_token_write")
        f3 = _bind(lib, "rope_kv_chunk_write")

        def rope_b1():
            q = torch.empty_like(c["q"])
            _checked(f1, "rope_kv_token_write", (
                c["q"].data_ptr(), q.data_ptr(), c["k"].data_ptr(),
                c["v"].data_ptr(), kp.data_ptr(), vp.data_ptr(),
                c["slots"].data_ptr(), c["pos"].data_ptr(), freqs.data_ptr(),
                b, n * bs, h, hkv, d, 1))()
            return q

        def rope_b3():
            q = torch.empty_like(c["qc"])
            _checked(f3, "rope_kv_chunk_write", (
                c["qc"].data_ptr(), q.data_ptr(), c["kc"].data_ptr(),
                c["vc"].data_ptr(), kp.data_ptr(), vp.data_ptr(),
                c["wp"].data_ptr(), c["ws"].data_ptr(), c["wc"].data_ptr(),
                c["posc"].data_ptr(), freqs.data_ptr(), b, ch, pp, bs,
                n * bs, h, hkv, d, 1))()
            return q
    else:
        def rope_b1():
            write1(R.apply_rope(c["k"], c["pos"], c["theta"]), c["v"])
            return R.apply_rope(c["q"], c["pos"], c["theta"])

        def rope_b3():
            write3(R.apply_rope(c["kc"], c["posc"], c["theta"]), c["vc"])
            return R.apply_rope(c["qc"], c["posc"], c["theta"])
    out.update(rope_b1=rope_b1, rope_b3=rope_b3)
    return out


def kvw_want(c: dict) -> dict:
    """The plain versions' roped q of the decode and prefill layer writes
    on ``c`` (on copies of its pools)."""
    from repro_torch.kernels import ref as R
    return {"rope_b1": R.rope_kv_token_write_ref(
                c["q"], c["k"], c["v"], c["kp"].clone(), c["vp"].clone(),
                c["slots"], c["pos"], c["theta"]),
            "rope_b3": R.rope_kv_chunk_write_ref(
                c["qc"], c["kc"], c["vc"], c["kp"].clone(), c["vp"].clone(),
                c["wp"], c["ws"], c["wc"], c["posc"], c["theta"])}


def kvw_shapes(libs: dict) -> None:
    """Each KV write of each block-shape variant ``libs`` in a CUDA graph;
    the fused entries' roped q against the plain version's."""
    import torch

    from chip_smoke import graph_ms
    c = kvw_case()
    want = kvw_want(c)
    for name, lib in libs.items():
        calls = kvw_callers(lib, c)
        times = {w: graph_ms(f) for w, f in calls.items()}
        errs = {w: float((calls[w]().float() - want[w].float()).abs().max())
                for w in want}
        torch.cuda.synchronize()
        print(f"  KV writes {name[4:]:8s} " + "  ".join(
            f"{w.upper()} {ms:.5f} ms" for w, ms in times.items())
              + f"; q max abs err {errs}", flush=True)


def kvw_turns(libs: dict, other: str) -> None:
    """The KV writes of ``libs[other]`` and ``libs["base"]`` in turns
    (other, base, base, other), in a CUDA graph and eagerly; the layer
    writes' roped q against the plain version's."""
    import torch

    from chip_smoke import cuda_ms, graph_ms
    c = kvw_case()
    calls = {n: kvw_callers(libs[n], c) for n in (other, "base")}
    want = kvw_want(c)
    for what in ("b1", "b3", "rope_b1", "rope_b3"):
        order = (other, "base", "base", other)
        graph = [graph_ms(calls[n][what]) for n in order]
        eager = [cuda_ms(calls[n][what]) for n in order]
        line = (f"  bf16 {what.upper()}: graph {other} {graph[0]:.5f} / "
                f"{graph[3]:.5f} ms, base {graph[1]:.5f} / {graph[2]:.5f}; "
                f"eager {other} {eager[0]:.5f} / {eager[3]:.5f}, base "
                f"{eager[1]:.5f} / {eager[2]:.5f}")
        if what in want:
            errs = [float((calls[n][what]().float() - want[what].float())
                          .abs().max()) for n in (other, "base")]
            torch.cuda.synchronize()
            line += (f"; q max abs err {other} {errs[0]:.3g}, base "
                     f"{errs[1]:.3g}")
        print(line, flush=True)


def steps(src: str) -> int:
    """``--steps``: the device kernels and host launch calls of one decode
    step and one prefill chunk of Qwen2.5-14B with ``repro_torch`` from
    ``src``, eager and (where ``src`` has them) replayed from CUDA
    graphs."""
    import torch

    from chip_smoke import BS, GPU_BLOCKS, step_device_kernels
    sys.path.insert(0, str(Path(src).resolve()))   # ahead of this tree's src
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    cfg = get_config("qwen2_5_14b_serving")
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    dt = params["embed"].dtype
    shape = (cfg.num_layers, GPU_BLOCKS + 1, BS, cfg.num_kv_heads,
             cfg.head_dim)
    k, v = (torch.zeros(shape, dtype=dt, device="cuda") for _ in "kv")
    print(json.dumps({"src": str(src),
                      **step_device_kernels(cfg, params, k, v)}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", nargs="*", default=[],
                    help="directories holding another paged_prefill.cu, "
                         "swa_attention.cu, paged_attention.cu and "
                         "kv_write.cu")
    ap.add_argument("--steps", default=None, metavar="SRC",
                    help="only count the device kernels of one decode step "
                         "and one prefill chunk with repro_torch from SRC")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("prefill_breakdown: needs a CUDA device", file=sys.stderr)
        return 1
    if args.steps:
        return steps(args.steps)
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
    kvw = (CSRC / "kv_write.cu").read_text()
    sources["kvw_base"] = CSRC / "kv_write.cu"
    for name, (old, new) in KVW_VARIANTS.items():
        if old not in kvw:
            raise SystemExit("prefill_breakdown: kv_write.cu no longer has "
                             "the code a variant changes:\n" + old)
        (OUT / f"kvw_{name}").mkdir(parents=True, exist_ok=True)
        sources[f"kvw_{name}"] = OUT / f"kvw_{name}" / "kv_write.cu"
        sources[f"kvw_{name}"].write_text(kvw.replace(old, new))
    others = [f"other{i}" for i in range(len(args.against))]
    if others:
        sources["swa_base"] = CSRC / "swa_attention.cu"
    for name, d in zip(others, args.against):
        sources[name] = Path(d).resolve() / "paged_prefill.cu"
        sources[f"swa_{name}"] = Path(d).resolve() / "swa_attention.cu"
        sources[f"dec_{name}"] = Path(d).resolve() / "paged_attention.cu"
        sources[f"kvw_{name}"] = Path(d).resolve() / "kv_write.cu"
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
    kvw_shapes({n: libs[n] for n in ("kvw_base", *(
        f"kvw_{v}" for v in KVW_VARIANTS))})
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
        kvw_turns({other: libs[f"kvw_{other}"], "base": libs["kvw_base"]},
                  other)
    for d in args.against:
        for src in (Path(d).resolve().parents[2], ROOT / "src"):
            print(f"[steps] {src}", flush=True)
            subprocess.run([sys.executable, __file__, "--steps", str(src)],
                           check=True, timeout=900)
    return 0


if __name__ == "__main__":
    sys.exit(main())
