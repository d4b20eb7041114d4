#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --only kernels   # phases 1-3, then the closing lines

Phases, each of which fails the run (non-zero exit) if anything is off:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; no CUDA device -> exit 1 before any result is printed;
2. build: every CUDA kernel of the serving path, from ``src/repro_torch/
   kernels/csrc`` with nvcc (all sources in parallel), and nvcc's ptxas
   register/spill report; the registers, spill bytes and static shared
   memory of the bf16 tensor-core kernels (B2, B4, B9 and B10 at D 128,
   B2 and B4 at D 112, B15 at D 64) and of the bf16 KV write kernels
   (plain and fused with RoPE) also go into the results;
3. kernels: each kernel at the serving path's shapes for Qwen2.5-14B
   (bf16, and float32 for correctness), held against its plain PyTorch
   version (exact for writes, copies and the int8 quantize / dequantize
   kernels, whose round trip must also land within scale/2; the decode and
   prefill writes fused with the RoPE of q and k bit for bit or one step
   of the dtype off, the count printed, the pool rows they do not write
   untouched; 2e-3 bf16 / 3e-5 f32 for the attention kernels; the block
   migrations on pools of the serve phase's size, whose byte offsets pass
   2**31) and timed with CUDA events: the kernel alone inside a CUDA
   graph, and, called eagerly, its wrapper, its plain version and one
   PyTorch library call computing the same function where there is one
   (for B1, B3, B5, B6, B13a and B13b also inside a CUDA graph, like for
   like with the kernel); beside them its bound (bytes over 3.35 TB/s or
   operations over the peak of their type). The single-layer copies B13a
   / B13b are also held and timed at one block (variant ``m1``, their
   launch floor) and at 1536 blocks (``m1536``, B5 / B6's bytes in one
   layer), each variant row with its own launches. The fused writes'
   plain version is the eager RoPE of q and k and the write that they
   replace. The int8-pool
   attention kernels take the float attention cases' queries, tables and
   lengths over those pools quantized on the card (bf16 B10 runs the int8
   instantiation of B4's tensor-core kernel), and their difference from
   the float kernels on the same inputs (the int8 error) is printed,
   ungated; bf16 B2 and B9 run the split-context tensor-core decode
   kernel, and their padded row must come out as exact zeros. B2, B4
   and the fused writes are held and timed again at each serve's own
   shape (``serve_shape_cases``: 256-token contexts through 16-page
   tables, a 32-token chunk), at Qwen2.5-14B's heads (variant ``ctx256``)
   and at Kimi-K2's (variant ``d112``: H 64, Hkv 8, D 112); B14
   must take its tensor-core route at both shapes (its route count), its
   y and final state are compared with its plain version (``TOL_SSD``)
   and, with the plain version's, against the plain version run in
   float64 on the card (max abs and the worst ratio |d| / (atol + rtol
   |ref|) printed; the kernel's max abs must be at most ``SSD_F64_MAX``),
   and the device time of each of its route's four launches (G, chunk
   states, state pass, y) is read from a profile of 20 calls, for f32 and
   bf16 x;
4. step check: one bf16 ``paged_decode_step`` and one
   ``paged_prefill_step`` (its last rows through ``head_logits``) at
   Qwen2.5-14B's widths with 2 layers (random weights and pools from seed
   0; B 8 rows of 256-token contexts through 16-page tables, a 32-token
   chunk), run eagerly through the kernels and through their plain
   versions, before any step is captured: the logits must agree within
   four bf16 steps of the largest one, and the argmax on every row whose
   top two logits are clearly apart (``STEP_REL``);
5. serve fp16: four deep_research apps through the tokencake engine with
   ``TorchBackend`` at Qwen2.5-14B's full width and depth (48 layers,
   random bf16 weights from seed 0), a 2048-block device pool and a
   1024-block pinned host pool; the backend runs each padded step shape
   as one CUDA graph (``models.graphs.StepGraphs``: a bucket's first call
   runs the step eagerly once and captures it, every call replays it);
   launch counts are zeroed just before and read just after, and every
   kernel of the path (B2, B4, B5, B6 and the RoPE + B1 / RoPE + B3
   writes) must have run, the fused writes once per layer of every
   replayed and every warm-up decode step and prefill chunk and B1 / B3
   alone never, with at least one offload and no truncated prompt; the
   graphs captured per kind, the capture seconds and the peak memory are
   printed; then the graph phase at the serve's shape on its weights and
   pools: the replayed decode step and prefill chunk equal the eager ones
   bit for bit (output and K/V), wall ms per step eager and replayed (20
   synchronised calls each), the device's idle share over 10 decode steps
   each way under ``torch.profiler``, and one step each way under the
   profiler (device kernels, copies, memsets, host launch calls); and the
   cache's offload and upload of 32 blocks are timed;
6. serve int8_host: the same apps on the same weights with
   ``TemporalConfig(kv_precision="int8_host")``: offloads quantize on the
   card into an int8 pinned host pool, uploads dequantize on the card;
   the fused writes, B2, B4, B7 and B8 must have run (the same launch
   checks), with at least one offload and one upload and wire bytes in
   whole int8 blocks; then the same timing;
6b. front door: phase 5's weights behind ``launch.http_server.HttpServer``
   (its pump on a background thread, 127.0.0.1, an ephemeral port) over
   an engine with continuous batching, sessions and the prefix cache, the
   same pools; this thread is a stdlib ``http.client`` client that
   touches no tensor while the server runs: four /generate calls of
   256-token prompts for 32 tokens (one async, collected through
   /v1/result; two sharing 136 prompt tokens, so one forks a block
   copy-on-write; one streamed and reassembled), the first again (a
   response-cache hit: no engine work), a tool adapter's app
   (/v1/register_graph, /v1/call_start, /v1/call_finish, /v1/states),
   then a session (open, one turn, read, close). Every response must be
   ok and every /generate's tokens the backend's own, the prefill logits
   finite, nothing truncated or outstanding, and the fused writes, B2,
   B4, B5 and B6 launched (B1 / B3 alone never); the client's wall ms per
   call and to the first streamed chunk, tokens per wall second, the
   server's steps and graphs and the serving report (virtual time) are
   printed. Then, without the socket, two turns of a session through
   ``FrontDoor.drive``: turn 2 after the forecast gap, after the turn-end
   offload and the predictive warm, prefills less than its prompt and
   decodes the tokens of the same turns with the KV pinned on the card;
7. serve kimi: Kimi-K2 (MoE: 384 experts, top 8, expert d_ff 2048) at
   full width (d_model 7168, 64 / 8 heads of D 112) and 2 of its 61
   layers, random bf16 weights from seed 0, through the engine as in
   phase 5 (fp16 host tier, the same pools and prompt cut) with two apps
   and decode segments cut to 16 tokens: the same launch checks (the
   fused writes, B2, B4, B5 and B6), at least one offload, no truncated
   prompt, finite logits; the experts' batched products of one decode
   step and one prefill chunk timed alone (CUDA events); then the graph
   phase at its shape (replay = eager bit for bit, wall ms, idle share,
   one step each way under the profiler, whose replayed steps' profiles
   give the products' kernels' share of their device time);
8. families: Mamba2-130M (SSM) and Hymba-1.5B (hybrid: sliding-window
   attention beside SSM heads) at full width and depth, random bf16
   weights from seed 0, through ``models.model.prefill`` of 4 prompts of
   2048 tokens and 32 greedy ``decode_step``s (eager); launch counts are
   zeroed just before and read just after, and the SSD scan (B14) must
   have run once per layer on its tensor-core route, and for Hymba
   sliding-window attention (B15) too; the logits must be finite; prefill
   and decode wall times, tokens per second and peak memory are printed,
   and the prefill profile's device ms of B14's and B15's kernels;
9. check: a small float32 dense model and a small float32 MoE model
   (whose experts drop entries past their capacity) served on the card
   (their steps replayed from CUDA graphs) give the same tokens and
   offloads as the same models on the CPU (eager, through the kernels'
   plain versions), with an fp16 and with an int8 host tier; and small
   float32 Mamba2, Hymba and Mixtral (MoE with a sliding window) models
   give the same prefill and decode logits and caches on the card as on
   the CPU (1e-4); and a front-door trace (``FrontDoor.drive`` over the
   small dense model: continuous batching, a shared prefix with a
   copy-on-write fork, a session's offload and warm, a response-cache
   hit) gives the same tokens and counters on the card as on the CPU.

B9-B13b (``paged_attention_quant``, ``paged_prefill_attention_quant``,
``kv_block_quant``, ``kv_block_dequant``, ``block_gather``,
``block_scatter``) run in the kernel phase only: no serving path of the
JAX package calls them, so their launches are those of phase 3. So do
B1 and B3 alone (``kv_token_write``, ``kv_chunk_write``): the serve
writes K/V through ``rope_kv_token_write`` and ``rope_kv_chunk_write``.
B14 and B15 are held and timed in phase 3 at the families phase's shapes
(B14 at Mamba2's and at Hymba's; bf16 B15 is its tensor-core kernel);
their launches are those of phase 8. The launches of the serving path's
kernels are the sum of the serve phases' (5, 6, 6b and 7); a ``d112``
variant carries the Kimi-K2 serve's own.

Prints one ``{"kernels": [...]}`` line, then the card's name and power
limit, then, last, ``{"ok": true, "device": {...}}``. With ``--only
kernels`` phases 4-9 are skipped and every launch count in that line is
the kernel phase's. ``--out PATH`` also writes the full results as JSON.
Engine latencies in the serve report are virtual time from the A100 cost
model, not card time.
"""
from __future__ import annotations

import argparse
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12                         # H100 SXM, data sheet
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}       # dense, no sparsity

# main-path shapes: Qwen2.5-14B attention, 16-token blocks, decode batch
# bucket 8, 32-token prefill chunks, a 64-page (1024-token) table, and
# an offload of 32 blocks (a 512-token request) across all 48 layers of
# the serve phase's 2048-block pool (plus its scratch block)
B, H, HKV, D, BS, C, P, M_BLOCKS, LAYERS = 8, 40, 8, 128, 16, 32, 64, 32, 48
GPU_BLOCKS, HOST_BLOCKS = 2048, 1024
# the serve phases cut prompts to this many tokens: the attention kernels
# and the fused writes are also held and timed at such contexts
# (``serve_shape_cases``)
CTX_SHORT = 256

# bf16: kernel and plain version both accumulate in f32 and round once, so
# they differ by at most one bf16 step of the output (measured <= 1.95e-3,
# one step of an output near 0.28, for B4 at 256-token contexts)
TOL = {"bf16": dict(atol=2e-3, rtol=2e-3), "f32": dict(atol=3e-5, rtol=3e-5)}

KERNEL_INFO = {   # name -> (CUDA source, the Pallas kernel it replaces)
    "kv_token_write": ("src/repro_torch/kernels/csrc/kv_write.cu",
                       "src/repro/kernels/kv_write.py:276"),
    "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:293"),
    "kv_chunk_write": ("src/repro_torch/kernels/csrc/kv_write.cu",
                       "src/repro/kernels/kv_write.py:221"),
    "rope_kv_token_write": ("src/repro_torch/kernels/csrc/kv_write.cu",
                            "src/repro/kernels/kv_write.py:276"),
    "rope_kv_chunk_write": ("src/repro_torch/kernels/csrc/kv_write.cu",
                            "src/repro/kernels/kv_write.py:221"),
    "paged_prefill_attention": (
        "src/repro_torch/kernels/csrc/paged_prefill.cu",
        "src/repro/kernels/paged_prefill.py:290"),
    "block_gather_layers": ("src/repro_torch/kernels/csrc/block_copy.cu",
                            "src/repro/kernels/block_copy.py:41"),
    "block_scatter_layers": ("src/repro_torch/kernels/csrc/block_copy.cu",
                             "src/repro/kernels/block_copy.py:63"),
    "block_gather_quant_layers": (
        "src/repro_torch/kernels/csrc/block_quant.cu",
        "src/repro/kernels/block_copy.py:93"),
    "block_scatter_dequant_layers": (
        "src/repro_torch/kernels/csrc/block_quant.cu",
        "src/repro/kernels/block_copy.py:134"),
    "kv_block_quant": ("src/repro_torch/kernels/csrc/block_quant.cu",
                       "src/repro/kernels/kv_write.py:154"),
    "kv_block_dequant": ("src/repro_torch/kernels/csrc/block_quant.cu",
                         "src/repro/kernels/kv_write.py:189"),
    "paged_attention_quant": (
        "src/repro_torch/kernels/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention.py:230"),
    "paged_prefill_attention_quant": (
        "src/repro_torch/kernels/csrc/paged_prefill.cu",
        "src/repro/kernels/paged_prefill.py:230"),
    "block_gather": ("src/repro_torch/kernels/csrc/block_copy.cu",
                     "src/repro/kernels/block_copy.py:22"),
    "block_scatter": ("src/repro_torch/kernels/csrc/block_copy.cu",
                      "src/repro/kernels/block_copy.py:175"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:64"),
    "swa_attention": ("src/repro_torch/kernels/csrc/swa_attention.cu",
                      "src/repro/kernels/swa_attention.py:66"),
}

# families phase: prompts, their length (twice Hymba's 1024-token window)
# and greedy decode steps; the kernels each model's prefill must launch
# once per layer
FAM_B, FAM_S, FAM_STEPS = 4, 2048, 32
FAMILY_KERNELS = {"mamba2_130m": ("ssd_scan",),
                  "hymba_1_5b": ("ssd_scan", "swa_attention")}
# the families phase's profile sums the device time of the kernels whose
# names hold these
FAMILY_GROUPS = {"B14": ("ssd_",), "B15": ("swa_attention",)}
# B14 against its token-sequential plain version: the tolerance of the JAX
# package's test_ssd_scan (the sums run in another order); B15 in bf16 may
# differ from its plain version by one bf16 step of the output (2**-7 of
# its size), and its early rows average few keys, so outputs reach ~4
TOL_SSD = dict(atol=2e-3, rtol=2e-3)
# B14's largest distance from its plain version run in float64 (outputs and
# final state) at each shape: between the tensor-core route's (3.3e-4 at
# Mamba2's, 2.3e-5 at Hymba's) and that of the route built with two bf16
# parts per float32 operand instead of three (2.2e-3 / 8.9e-4 with bf16 x;
# tools/ssd_breakdown.py on the H100), so a slide back to two parts fails
SSD_F64_MAX = {"mamba2": 1e-3, "hymba": 1.5e-4}
# the launches of B14's tensor-core route, in order, by the names of their
# kernels (device time of each from a profile of whole calls)
SSD_LAUNCHES = {"gram": ("ssd_gram_tc",), "chunk": ("ssd_chunk_tc",),
                "state": ("ssd_state_kernel",), "out": ("ssd_out_tc",)}
TOL_ONE_STEP = {"bf16": dict(atol=2e-3, rtol=8e-3),
                "f32": dict(atol=3e-5, rtol=3e-5)}

# the kernels each serve phase must launch; the fused RoPE + KV writes
# once per layer of every decode step and prefill chunk
SERVE_KERNELS = {
    "fp16": ("rope_kv_token_write", "paged_attention", "rope_kv_chunk_write",
             "paged_prefill_attention", "block_gather_layers",
             "block_scatter_layers"),
    "int8_host": ("rope_kv_token_write", "paged_attention",
                  "rope_kv_chunk_write", "paged_prefill_attention",
                  "block_gather_quant_layers",
                  "block_scatter_dequant_layers"),
}
# run in the kernel phase only (no serving path calls them; the serve's
# layers write K/V through the fused entries, never B1 / B3 alone)
KERNEL_PHASE_ONLY = ("kv_token_write", "kv_chunk_write", "kv_block_quant",
                     "kv_block_dequant", "paged_attention_quant",
                     "paged_prefill_attention_quant", "block_gather",
                     "block_scatter")
NO_LIBRARY = "none: no single PyTorch call computes this function"
# the tensor-core kernels whose ptxas resources the results keep: label ->
# (source, pattern of the mangled name)
TC_KERNELS = {
    "paged_prefill_tc_kernel<bf16, 128> (B4)": (
        "paged_prefill", r"paged_prefill_tc_kernelI13__nv_bfloat16Li128E"),
    "paged_prefill_tc_kernel<int8_t, 128> (B10)": (
        "paged_prefill", r"paged_prefill_tc_kernelIaLi128E"),
    "swa_attention_tc_kernel<64> (B15)": (
        "swa_attention", r"swa_attention_tc_kernelILi64E"),
    "paged_decode_tc_kernel<bf16, 128> (B2)": (
        "paged_attention", r"paged_decode_tc_kernelI13__nv_bfloat16Li128E"),
    "paged_decode_tc_kernel<int8_t, 128> (B9)": (
        "paged_attention", r"paged_decode_tc_kernelIaLi128E"),
    # Kimi-K2's head dim (7168 / 64)
    "paged_prefill_tc_kernel<bf16, 112> (B4)": (
        "paged_prefill", r"paged_prefill_tc_kernelI13__nv_bfloat16Li112E"),
    "paged_decode_tc_kernel<bf16, 112> (B2)": (
        "paged_attention", r"paged_decode_tc_kernelI13__nv_bfloat16Li112E"),
    # B14 at N 128 (NK 8: Mamba2-130M) and its y launch at N 16 (Hymba-1.5B)
    "ssd_gram_tc_kernel<8> (B14)": ("ssd_scan", r"ssd_gram_tc_kernelILi8E"),
    "ssd_chunk_tc_kernel<bf16, 8> (B14)": (
        "ssd_scan", r"ssd_chunk_tc_kernelI13__nv_bfloat16Li8E"),
    "ssd_chunk_tc_kernel<float, 8> (B14)": (
        "ssd_scan", r"ssd_chunk_tc_kernelIfLi8E"),
    "ssd_out_tc_kernel<bf16, 8> (B14)": (
        "ssd_scan", r"ssd_out_tc_kernelI13__nv_bfloat16Li8E"),
    "ssd_out_tc_kernel<float, 8> (B14)": (
        "ssd_scan", r"ssd_out_tc_kernelIfLi8E"),
    "ssd_out_tc_kernel<bf16, 1> (B14)": (
        "ssd_scan", r"ssd_out_tc_kernelI13__nv_bfloat16Li1E"),
}


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# the KV write kernels (bf16, 16-byte vectors) whose ptxas resources the
# results keep: the decode and chunk templates, plain and fused with RoPE
WRITE_KERNELS = {
    f"kv_{kind}_write_kernel<bf16, 8, {rope}> ({name})": (
        "kv_write", rf"kv_{kind}_write_kernelI13__nv_bfloat16Li8ELb{flag}E")
    for kind, rope, flag, name in (
        ("token", "false", 0, "B1"), ("token", "true", 1, "B1 + RoPE"),
        ("chunk", "false", 0, "B3"), ("chunk", "true", 1, "B3 + RoPE"))}


def tc_resources(report, kernels=TC_KERNELS) -> dict:
    """Registers, spill bytes and static shared memory of each kernel of
    ``kernels``, read from ``report(source)``, nvcc's ``-Xptxas -v``
    output; None for a kernel the report does not name."""
    out = {}
    for label, (source, pattern) in kernels.items():
        lines = report(source).splitlines()
        out[label] = None
        for i, line in enumerate(lines):
            if "Compiling entry" in line and re.search(pattern, line):
                props = " ".join(lines[i + 1:i + 4])
                nums = {k: re.search(rx, props) for k, rx in (
                    ("registers", r"Used (\d+) registers"),
                    ("spill_stores", r"(\d+) bytes spill stores"),
                    ("spill_loads", r"(\d+) bytes spill loads"),
                    ("static_smem", r"(\d+) bytes smem"))}
                out[label] = {k: int(m.group(1)) if m else None
                              for k, m in nums.items()}
                if nums["registers"] and out[label]["static_smem"] is None:
                    out[label]["static_smem"] = 0     # ptxas omits 0 bytes
                break
    return out


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Time per eager call of ``fn``, host launch cost included."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 50, reps: int = 5) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph and replayed ``reps`` times between two events, so the host's
    cost of each launch is not in it. The kernels' launches count once per
    replay (``ops.capture_launches``)."""
    import torch

    from repro_torch.kernels import ops
    g = torch.cuda.CUDAGraph()
    with ops.capture_launches() as counts, torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    ops.add_launches(counts, 1 + reps)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def bound_ms(nbytes: float, flops: float, dt: str):
    """The larger of bytes over the memory rate and operations over the
    peak rate of their type (``dt``)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dt] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version, timed
# ---------------------------------------------------------------------------

def sdpa(q, k, v, mask):
    """One scaled_dot_product_attention call with grouped K/V heads (the
    library yardstick of the attention kernels; never used by the port)."""
    import torch.nn.functional as F
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)


def kernel_cases(dt: str):
    """One dict per kernel at the main-path shapes for dtype ``dt``:
    closures for the kernel, its plain version and a library call on the
    same inputs, the tensors a write updates in place, and the bytes and
    flops this data needs."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as R

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    td = torch.bfloat16 if dt == "bf16" else torch.float32
    es = torch.finfo(td).bits // 8
    row = HKV * D * es
    rng = np.random.default_rng(0)
    theta = get_config("qwen2_5_14b_serving").rope_theta

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(td)

    def ints(x):
        return torch.as_tensor(np.asarray(x, np.int32)).to(dev)

    n = B * P + 1                        # pool pages + scratch page
    kp, vp = rand(n, BS, HKV, D), rand(n, BS, HKV, D)
    kf, vf = kp.view(n * BS, HKV, D), vp.view(n * BS, HKV, D)
    perm = rng.permutation(B * P).reshape(B, P)
    tables = ints(perm)
    cases = []

    # B1 kv_token_write: 8 rows, the last two padded into the scratch slot
    kn, vn = rand(B, HKV, D), rand(B, HKV, D)
    scratch = (n - 1) * BS
    slots = rng.choice(scratch, B, replace=False)
    slots[-2:] = scratch
    sl = ints(slots)
    sl64 = sl.long()
    cases.append(dict(
        name="kv_token_write", kind="write", targets=(kp, vp),
        kernel=lambda: ops.kv_token_write(kp, vp, kn, vn, sl),
        plain=lambda: R.kv_token_write_ref(kp, vp, kn, vn, sl),
        library=lambda: (kf.index_copy_(0, sl64, kn),
                         vf.index_copy_(0, sl64, vn)),
        library_call="index_copy_ on the K and on the V pool",
        library_graph=True, nbytes=4 * (B - 2) * row + 4 * B, flops=0.0))

    # B1 fused with the RoPE of q and k (the decode layer's write, one
    # launch): B1's rows and slots, new q (8, 40, 128) and K/V, positions
    # up to 4096 (from their own generator, so rng's later draws stay as
    # they were). Bytes: q read and written, the live rows' K/V, slots,
    # positions and the frequency table; operations: 6 f32 per roped pair
    rope_rng = np.random.default_rng(1)
    qd, kd1, vd1 = rand(B, H, D), rand(B, HKV, D), rand(B, HKV, D)
    posd = ints(rope_rng.integers(0, 4097, B))
    live_d = torch.zeros(n * BS, dtype=torch.bool, device=dev)
    live_d[sl64[:-2]] = True
    cases.append(dict(
        name="rope_kv_token_write", kind="rope_write", targets=(kp, vp),
        written=live_d,
        kernel=lambda: ops.rope_kv_token_write(qd, kd1, vd1, kp, vp, sl,
                                               posd, theta),
        plain=lambda: R.rope_kv_token_write_ref(qd, kd1, vd1, kp, vp, sl,
                                                posd, theta),
        library=None, library_call=NO_LIBRARY,
        nbytes=2 * B * H * D * es + 4 * (B - 2) * row + 8 * B + 2 * D,
        flops=3.0 * (B * H + (B - 2) * HKV) * D, ops_dt="f32"))

    # B2 paged_attention: a full 64-page table per row, one padded row
    q = rand(B, H, D)
    lens = np.full(B, P * BS)
    lens[-1] = 0
    cl = ints(lens)
    ctx = int(lens.sum())
    kd = kp[tables.long()].reshape(B, P * BS, HKV, D).transpose(1, 2) \
        .contiguous()
    vd = vp[tables.long()].reshape(B, P * BS, HKV, D).transpose(1, 2) \
        .contiguous()
    mask_d = (torch.arange(P * BS, device=dev)[None, :]
              < cl.long()[:, None])[:, None, None, :]
    def splits(p, quant):
        """The split count of the bf16 decode kernel for p-page tables."""
        return lambda: ops.decode_splits(torch.cuda.current_device(), B, p,
                                         BS, HKV, D, quant)

    cases.append(dict(
        name="paged_attention", kind="attn", targets=(), zero_rows=[B - 1],
        splits=splits(P, False),
        kernel=lambda: ops.paged_attention(q, kp, vp, tables, cl),
        plain=lambda: R.paged_attention_ref(q, kp, vp, tables, cl),
        library=sdpa(q[:, :, None], kd, vd, mask_d),
        library_call="scaled_dot_product_attention over pre-gathered K/V",
        nbytes=2 * B * H * D * es + 2 * ctx * row + 4 * (B * P + B),
        flops=4.0 * H * D * ctx))

    # B3 kv_chunk_write: row i's 32-token window starts at offset i of its
    # first page and spills into the next two; the last row is padding
    kc, vc = rand(B, C, HKV, D), rand(B, C, HKV, D)
    pp = (C - 1) // BS + 2
    wpages = np.full((B, pp), n - 1)
    wpages[:B - 1] = perm[:B - 1, :pp]
    starts = np.arange(B) % BS
    counts = np.array([C] * (B - 1) + [0])
    wp, ws, wc = ints(wpages), ints(starts), ints(counts)
    pos = starts[:B - 1, None] + np.arange(C)[None, :]
    cslots = np.concatenate([wpages[i, pos[i] // BS] * BS + pos[i] % BS
                             for i in range(B - 1)])
    cs64 = torch.as_tensor(cslots, dtype=torch.long, device=dev)
    kc_live = kc[:B - 1].reshape(-1, HKV, D)
    vc_live = vc[:B - 1].reshape(-1, HKV, D)
    cases.append(dict(
        name="kv_chunk_write", kind="write", targets=(kp, vp),
        kernel=lambda: ops.kv_chunk_write(kp, vp, kc, vc, wp, ws, wc),
        plain=lambda: R.kv_chunk_write_ref(kp, vp, kc, vc, wp, ws, wc),
        library=lambda: (kf.index_copy_(0, cs64, kc_live),
                         vf.index_copy_(0, cs64, vc_live)),
        library_call="index_copy_ on the K and on the V pool",
        library_graph=True,
        nbytes=4 * int(counts.sum()) * row + 4 * (B * pp + 2 * B),
        flops=0.0))

    # B3 fused with the RoPE of q and k (the prefill layer's write): B3's
    # windows, new q (8, 32, 40, 128) and K/V, q roped at every token (the
    # padded row at position 0, as the decoder clamps q_pos = -1),
    # positions up to 4096
    qw, kw, vw = rand(B, C, H, D), rand(B, C, HKV, D), rand(B, C, HKV, D)
    posw = np.zeros((B, C), np.int32)
    posw[:B - 1] = (rope_rng.integers(0, 4097 - C, B - 1)[:, None]
                    + np.arange(C))
    pw = ints(posw)
    live_c = torch.zeros(n * BS, dtype=torch.bool, device=dev)
    live_c[cs64] = True
    cases.append(dict(
        name="rope_kv_chunk_write", kind="rope_write", targets=(kp, vp),
        written=live_c,
        kernel=lambda: ops.rope_kv_chunk_write(qw, kw, vw, kp, vp, wp, ws, wc,
                                               pw, theta),
        plain=lambda: R.rope_kv_chunk_write_ref(qw, kw, vw, kp, vp, wp, ws,
                                                wc, pw, theta),
        library=None, library_call=NO_LIBRARY,
        nbytes=(2 * B * C * H * D * es + 4 * int(counts.sum()) * row
                + 4 * (B * pp + 2 * B) + 4 * B * C + 2 * D),
        flops=3.0 * (B * C * H + int(counts.sum()) * HKV) * D, ops_dt="f32"))

    # B4 paged_prefill_attention: the last 32-token chunk of a 1024-token
    # context per row; the last row is padding (q_pos = -1)
    qc = rand(B, C, H, D)
    qpos = np.full((B, C), -1)
    qpos[:B - 1] = P * BS - C + np.arange(C)
    qp = ints(qpos)
    live_q = qpos >= 0
    mask_p = (torch.arange(P * BS, device=dev)[None, None, :]
              <= qp.long()[:, :, None])[:, None]
    cases.append(dict(
        name="paged_prefill_attention", kind="attn", targets=(),
        kernel=lambda: ops.paged_prefill_attention(qc, kp, vp, tables, qp),
        plain=lambda: R.paged_prefill_attention_ref(qc, kp, vp, tables, qp),
        library=sdpa(qc.transpose(1, 2), kd, vd, mask_p),
        library_call="scaled_dot_product_attention over pre-gathered K/V",
        nbytes=(2 * int(live_q.sum()) * H * D * es
                + 2 * int((qpos.max(axis=1) + 1).sum()) * row
                + 4 * (B * C + B * P)),
        flops=4.0 * H * D * int((qpos[live_q] + 1).sum())))

    # B5/B6: 32 blocks of the serve phase's 48-layer pool, as one offload /
    # upload moves them; the ids include the last live block and the
    # scratch block, whose byte offsets on the last layers pass 2**31
    nb = GPU_BLOCKS + 1
    pools = rand(LAYERS, nb, BS, HKV, D)
    idx = ints(np.concatenate([[nb - 1, nb - 2],
                               rng.choice(nb - 2, M_BLOCKS - 2,
                                          replace=False)]))
    idx64 = idx.long()
    staging = rand(LAYERS, M_BLOCKS, BS, HKV, D)
    moved = 2 * LAYERS * M_BLOCKS * BS * row + 4 * M_BLOCKS
    cases.append(dict(
        name="block_gather_layers", kind="copy", targets=(),
        kernel=lambda: ops.block_gather_layers(pools, idx),
        plain=lambda: R.block_gather_layers_ref(pools, idx),
        library=lambda: pools.index_select(1, idx64),
        library_call="index_select", library_graph=True, nbytes=moved,
        flops=0.0))
    cases.append(dict(
        name="block_scatter_layers", kind="scatter", targets=(pools,),
        kernel=lambda: ops.block_scatter_layers(pools, idx, staging),
        plain=lambda: R.block_scatter_layers_ref(pools, idx, staging),
        library=lambda: pools.index_copy_(1, idx64, staging),
        library_call="index_copy_", library_graph=True, nbytes=moved,
        flops=0.0))

    # B7/B8: the same 32 blocks x 48 layers, quantized on offload and
    # dequantized on upload; B11/B12 on the same bytes as staged blocks
    # (1536, 16, 8, 128). Operations are float32 scalar work: |x| and max,
    # then divide, round and two clamps per element (quantize); convert and
    # multiply per element (dequantize).
    elems = LAYERS * M_BLOCKS * BS * HKV * D
    qbytes = elems * (es + 1) + 4 * LAYERS * M_BLOCKS * HKV
    sq, ss = R.quantize_block_ref(rand(LAYERS, M_BLOCKS, BS, HKV, D))
    cases.append(dict(
        name="block_gather_quant_layers", kind="quant", targets=(),
        kernel=lambda: ops.block_gather_quant_layers(pools, idx),
        plain=lambda: R.block_gather_quant_layers_ref(pools, idx),
        source=lambda: R.block_gather_layers_ref(pools, idx),
        library=None, library_call=NO_LIBRARY,
        nbytes=qbytes + 4 * M_BLOCKS, flops=6.0 * elems, ops_dt="f32"))
    cases.append(dict(
        name="block_scatter_dequant_layers", kind="scatter", targets=(pools,),
        kernel=lambda: ops.block_scatter_dequant_layers(pools, idx, sq, ss),
        plain=lambda: R.block_scatter_dequant_layers_ref(pools, idx, sq, ss),
        library=None, library_call=NO_LIBRARY,
        nbytes=qbytes + 4 * M_BLOCKS, flops=2.0 * elems, ops_dt="f32"))
    blocks = rand(LAYERS * M_BLOCKS, BS, HKV, D)
    bq, bsc = sq.reshape(blocks.shape), ss.reshape(-1, HKV)
    cases.append(dict(
        name="kv_block_quant", kind="quant", targets=(),
        kernel=lambda: ops.kv_block_quant(blocks),
        plain=lambda: R.quantize_block_ref(blocks),
        source=lambda: blocks, library=None, library_call=NO_LIBRARY,
        nbytes=qbytes, flops=6.0 * elems, ops_dt="f32"))
    cases.append(dict(
        name="kv_block_dequant", kind="copy", targets=(),
        kernel=lambda: ops.kv_block_dequant(bq, bsc, td),
        plain=lambda: R.dequantize_block_ref(bq, bsc, td),
        library=None, library_call=NO_LIBRARY,
        nbytes=qbytes, flops=2.0 * elems, ops_dt="f32"))

    # B9/B10: B2's and B4's queries, tables and lengths over their pools
    # quantized on the card by B11 (int8 pages, (N, Hkv) float32 scales),
    # quantized here, before any write case runs; "versus" is B2/B4 on the
    # pools as quantized, for the int8 error. Bytes: the live int8 K/V, one
    # scale per live (page, kv head) and tensor, q, out, tables and
    # lengths; operations as B2/B4 (the dequantizing multiplies, 2 per
    # K/V element, take under 0.001 ms at the float32 peak)
    kq, ksc = ops.kv_block_quant(kp)
    vq, vsc = ops.kv_block_quant(vp)
    k0, v0 = kp.clone(), vp.clone()
    kdq = R.dequantize_block_ref(kq, ksc, td)[tables.long()] \
        .reshape(B, P * BS, HKV, D).transpose(1, 2).contiguous()
    vdq = R.dequantize_block_ref(vq, vsc, td)[tables.long()] \
        .reshape(B, P * BS, HKV, D).transpose(1, 2).contiguous()
    irow, srow = HKV * D, HKV * 4        # int8 bytes per token, scale bytes
    n_pages = int(np.ceil(lens / BS).sum())
    cases.append(dict(
        name="paged_attention_quant", kind="attn", targets=(),
        zero_rows=[B - 1], splits=splits(P, True),
        kernel=lambda: ops.paged_attention_quant(q, kq, vq, ksc, vsc, tables,
                                                 cl),
        plain=lambda: R.paged_attention_quant_ref(q, kq, vq, ksc, vsc,
                                                  tables, cl),
        versus=lambda: ops.paged_attention(q, k0, v0, tables, cl),
        library=sdpa(q[:, :, None], kdq, vdq, mask_d),
        library_call="scaled_dot_product_attention over K/V gathered and "
                     "dequantized beforehand",
        nbytes=(2 * B * H * D * es + 2 * ctx * irow + 2 * n_pages * srow
                + 4 * (B * P + B)),
        flops=4.0 * H * D * ctx))
    kv_tok = qpos.max(axis=1) + 1
    n_pages = int(np.ceil(kv_tok / BS).sum())
    cases.append(dict(
        name="paged_prefill_attention_quant", kind="attn", targets=(),
        kernel=lambda: ops.paged_prefill_attention_quant(qc, kq, vq, ksc, vsc,
                                                         tables, qp),
        plain=lambda: R.paged_prefill_attention_quant_ref(qc, kq, vq, ksc,
                                                          vsc, tables, qp),
        versus=lambda: ops.paged_prefill_attention(qc, k0, v0, tables, qp),
        library=sdpa(qc.transpose(1, 2), kdq, vdq, mask_p),
        library_call="scaled_dot_product_attention over K/V gathered and "
                     "dequantized beforehand",
        nbytes=(2 * int(live_q.sum()) * H * D * es
                + 2 * int(kv_tok.sum()) * irow + 2 * n_pages * srow
                + 4 * (B * C + B * P)),
        flops=4.0 * H * D * int((qpos[live_q] + 1).sum())))

    # B13a/B13b: the same 32 block ids (the last live block and the scratch
    # block among them) in one layer of the serve pool, (2049, 16, 8, 128);
    # variant m1: the scratch block alone (the same kernel's launch floor);
    # variant m1536: 1536 distinct ids, B5/B6's bytes in one layer
    page1 = rand(nb, BS, HKV, D)
    for m, ids, variant in (
            (M_BLOCKS, idx, None), (1, ints([nb - 1]), "m1"),
            (M_BLOCKS * LAYERS, ints(np.concatenate(
                [[nb - 1, nb - 2], rng.choice(nb - 2, M_BLOCKS * LAYERS - 2,
                                              replace=False)])), "m1536")):
        cases += single_layer_copies(page1, ids, rand(m, BS, HKV, D),
                                     variant, 2 * m * BS * row + 4 * m)
    return cases


def single_layer_copies(page1, ids, staging1, variant, moved):
    """B13a / B13b cases: gather blocks ``ids`` of ``page1``, and scatter
    ``staging1`` into them, in place."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as R

    ids64 = ids.long()
    common = dict(variant=variant, library_graph=True, nbytes=moved,
                  flops=0.0)
    if variant:
        common["shape"] = (f"{ids.shape[0]} blocks of "
                           f"{tuple(page1.shape)}")
    return [
        dict(common, name="block_gather", kind="copy", targets=(),
             kernel=lambda: ops.block_gather(page1, ids),
             plain=lambda: R.block_gather_ref(page1, ids),
             library=lambda: page1.index_select(0, ids64),
             library_call="index_select"),
        dict(common, name="block_scatter", kind="scatter", targets=(page1,),
             kernel=lambda: ops.block_scatter(page1, ids, staging1),
             plain=lambda: R.block_scatter_ref(page1, ids, staging1),
             library=lambda: page1.index_copy_(0, ids64, staging1),
             library_call="index_copy_")]

    return cases


def serve_shape_cases(dt: str, arch: str, variant: str):
    """The decode and prefill kernels of a serve phase at its own shape:
    ``arch``'s attention heads (Qwen2.5-14B: H 40, Hkv 8, D 128, variant
    ``ctx256``; Kimi-K2: H 64, Hkv 8, D 112 = 7168 / 64, variant ``d112``)
    and the serves' batch and contexts: B 8 rows, the last padded, of
    256-token contexts through 16-page tables, a 32-token chunk. Variants
    of the fused RoPE + B1 / RoPE + B3 writes, B2 and B4, held and timed
    as their main-path cases are (bytes and operations counted the same
    way)."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as R

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    td = torch.bfloat16 if dt == "bf16" else torch.float32
    es = torch.finfo(td).bits // 8
    cfg = get_config(arch)
    h, hkv, d, theta = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                        cfg.rope_theta)
    row = hkv * d * es
    rng = np.random.default_rng(2)
    p16 = CTX_SHORT // BS

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(td)

    def ints(x):
        return torch.as_tensor(np.asarray(x, np.int32)).to(dev)

    n = B * p16 + 1                      # pool pages + scratch page
    kp, vp = rand(n, BS, hkv, d), rand(n, BS, hkv, d)
    perm = rng.permutation(B * p16).reshape(B, p16)
    tables = ints(perm)
    common = dict(variant=variant, targets=(kp, vp))
    cases = []

    # RoPE + B1: each live row writes its position-255 slot, the last two
    # rows are padded into the scratch slot
    slots = perm[:, -1] * BS + BS - 1
    slots[-2:] = (n - 1) * BS
    sl = ints(slots)
    live_d = torch.zeros(n * BS, dtype=torch.bool, device=dev)
    live_d[sl.long()[:-2]] = True
    qd, kd1, vd1 = rand(B, h, d), rand(B, hkv, d), rand(B, hkv, d)
    posd = ints([CTX_SHORT - 1] * B)
    cases.append(dict(
        common, name="rope_kv_token_write", kind="rope_write",
        written=live_d, shape=f"q ({B}, {h}, {d}), k/v ({B}, {hkv}, {d})",
        kernel=lambda: ops.rope_kv_token_write(qd, kd1, vd1, kp, vp, sl,
                                               posd, theta),
        plain=lambda: R.rope_kv_token_write_ref(qd, kd1, vd1, kp, vp, sl,
                                                posd, theta),
        library=None, library_call=NO_LIBRARY,
        nbytes=2 * B * h * d * es + 4 * (B - 2) * row + 8 * B + 2 * d,
        flops=3.0 * (B * h + (B - 2) * hkv) * d, ops_dt="f32"))

    # B2: 256-token contexts, the last row padded
    q = rand(B, h, d)
    lens = np.full(B, CTX_SHORT)
    lens[-1] = 0
    cl = ints(lens)
    ctx = int(lens.sum())
    kd, vd = (x[tables.long()].reshape(B, CTX_SHORT, hkv, d).transpose(1, 2)
              .contiguous() for x in (kp, vp))
    mask_d = (torch.arange(CTX_SHORT, device=dev)[None, :]
              < cl.long()[:, None])[:, None, None, :]
    cases.append(dict(
        common, name="paged_attention", kind="attn", targets=(),
        zero_rows=[B - 1],
        splits=lambda: ops.decode_splits(torch.cuda.current_device(), B, p16,
                                         BS, hkv, d, False),
        shape=f"q ({B}, {h}, {d}), {p16}-page tables, {CTX_SHORT}-token "
              f"contexts",
        kernel=lambda: ops.paged_attention(q, kp, vp, tables, cl),
        plain=lambda: R.paged_attention_ref(q, kp, vp, tables, cl),
        library=sdpa(q[:, :, None], kd, vd, mask_d),
        library_call="scaled_dot_product_attention over pre-gathered K/V",
        nbytes=2 * B * h * d * es + 2 * ctx * row + 4 * (B * p16 + B),
        flops=4.0 * h * d * ctx))

    # RoPE + B3: each live row writes the last 32 tokens of its context (its
    # last two pages), the last row is padding
    pp = (C - 1) // BS + 2
    wpages = np.full((B, pp), n - 1)
    wpages[:B - 1, :2] = perm[:B - 1, -2:]
    counts = np.array([C] * (B - 1) + [0])
    wp, ws, wc = ints(wpages), ints(np.zeros(B)), ints(counts)
    live_c = torch.zeros(n * BS, dtype=torch.bool, device=dev)
    live_c[torch.as_tensor(np.concatenate([
        wpages[i, :2, None] * BS + np.arange(BS) for i in range(B - 1)])
        .ravel(), device=dev)] = True
    qw, kw, vw = rand(B, C, h, d), rand(B, C, hkv, d), rand(B, C, hkv, d)
    qpos = np.full((B, C), -1)
    qpos[:B - 1] = CTX_SHORT - C + np.arange(C)
    pw = ints(np.maximum(qpos, 0))
    cases.append(dict(
        common, name="rope_kv_chunk_write", kind="rope_write",
        written=live_c,
        shape=f"q ({B}, {C}, {h}, {d}), k/v ({B}, {C}, {hkv}, {d})",
        kernel=lambda: ops.rope_kv_chunk_write(qw, kw, vw, kp, vp, wp, ws, wc,
                                               pw, theta),
        plain=lambda: R.rope_kv_chunk_write_ref(qw, kw, vw, kp, vp, wp, ws,
                                                wc, pw, theta),
        library=None, library_call=NO_LIBRARY,
        nbytes=(2 * B * C * h * d * es + 4 * int(counts.sum()) * row
                + 4 * (B * pp + 2 * B) + 4 * B * C + 2 * d),
        flops=3.0 * (B * C * h + int(counts.sum()) * hkv) * d, ops_dt="f32"))

    # B4: the same chunk's queries over the 256-token contexts
    qc = rand(B, C, h, d)
    qp = ints(qpos)
    live_q = qpos >= 0
    mask_p = (torch.arange(CTX_SHORT, device=dev)[None, None, :]
              <= qp.long()[:, :, None])[:, None]
    cases.append(dict(
        common, name="paged_prefill_attention", kind="attn", targets=(),
        shape=f"q ({B}, {C}, {h}, {d}), {p16}-page tables, {CTX_SHORT}-"
              f"token contexts",
        kernel=lambda: ops.paged_prefill_attention(qc, kp, vp, tables, qp),
        plain=lambda: R.paged_prefill_attention_ref(qc, kp, vp, tables, qp),
        library=sdpa(qc.transpose(1, 2), kd, vd, mask_p),
        library_call="scaled_dot_product_attention over pre-gathered K/V",
        nbytes=(2 * int(live_q.sum()) * h * d * es
                + 2 * int((qpos.max(axis=1) + 1).sum()) * row
                + 4 * (B * C + B * p16)),
        flops=4.0 * h * d * int((qpos[live_q] + 1).sum())))
    return cases


def family_kernel_cases(dt: str):
    """B14 at Mamba2-130M's and at Hymba-1.5B's prefill shapes and B15 at
    Hymba-1.5B's (heads repeated to MHA layout), as the families phase
    calls them, in the same form as ``kernel_cases``. B14's operations are
    those its data needs (``data_flops``): the lower triangle of c b^T
    once per (row, chunk), and per (row, head, chunk) the triangle of w x,
    the state update and, after the first chunk, c state^T; its
    tensor-core route does each on bf16 MMAs, six passes per product of
    two float32 operands and three where x is bf16, so ``flops`` counts
    the MMAs' flops, against the bf16 peak. B15's are 4 D per (query,
    visible key) pair, on dt data."""
    import functools

    import torch
    import torch.nn.functional as F

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as R

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    td = torch.bfloat16 if dt == "bf16" else torch.float32
    es = torch.finfo(td).bits // 8

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    cases = []
    for arch, variant in (("mamba2_130m", None), ("hymba_1_5b", "hymba")):
        cfg = get_config(arch)
        h, p, n, q = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                      cfg.ssm_chunk)
        x = randn(FAM_B, FAM_S, h, p).to(td)
        dts = F.softplus(randn(FAM_B, FAM_S, h))
        # A = -exp(A_log) as init_ssm sets it: -1 .. -H
        a = dts * -torch.arange(1, h + 1, device=dev, dtype=torch.float32)
        bm, cm = randn(FAM_B, FAM_S, n), randn(FAM_B, FAM_S, n)
        tri, nc = q * (q + 1) // 2, FAM_S // q
        gram = 2.0 * FAM_B * nc * tri * n
        intra = 2.0 * FAM_B * nc * h * tri * p
        inter = 2.0 * FAM_B * (nc - 1) * h * q * p * n
        update = 2.0 * FAM_B * nc * h * q * p * n
        px = 3 if dt == "bf16" else 6          # passes of products with x
        cases.append(dict(
            name="ssd_scan", variant=variant, kind="ssd", targets=(),
            shape=f"{arch}: x ({FAM_B}, {FAM_S}, {h}, {p}), N {n}, Q {q}",
            kernel=functools.partial(ops.ssd_scan, x, dts, a, bm, cm, q),
            plain=functools.partial(R.ssd_scan_ref, x, dts, a, bm, cm),
            plain64=functools.partial(R.ssd_scan_ref, x, dts, a, bm, cm,
                                      dtype=torch.float64),
            plain_iters=3, library=None, library_call=NO_LIBRARY,
            nbytes=(x.numel() * (es + 4) + 2 * dts.numel() * 4
                    + 2 * bm.numel() * 4 + FAM_B * h * p * n * 4),
            data_flops=gram + intra + inter + update,
            flops=6 * (gram + inter) + px * (intra + update), ops_dt="bf16"))

    cfg = get_config("hymba_1_5b")
    hq, d, w = cfg.num_heads, cfg.head_dim, cfg.sliding_window
    qs, ks, vs = (randn(FAM_B, FAM_S, hq, d).to(td) for _ in "qkv")
    i = torch.arange(FAM_S, device=dev)
    band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)
    pairs = FAM_B * hq * sum(min(t + 1, w) for t in range(FAM_S))
    cases.append(dict(
        name="swa_attention", kind="attn", targets=(), tol=TOL_ONE_STEP[dt],
        shape=f"hymba_1_5b: q/k/v ({FAM_B}, {FAM_S}, {hq}, {d}), window {w}",
        kernel=lambda: ops.swa_attention(qs, ks, vs, w),
        plain=lambda: R.swa_attention_ref(qs, ks, vs, w),
        library=sdpa(qs.transpose(1, 2), ks.transpose(1, 2),
                     vs.transpose(1, 2), band),
        library_call="scaled_dot_product_attention with a band mask",
        nbytes=4 * qs.numel() * es, flops=4.0 * d * pairs))
    return cases


def ssd_launch_ms(fn, calls: int = 20) -> dict:
    """The device ms of each launch of B14's tensor-core route
    (``SSD_LAUNCHES``), averaged over the launches that a profile of
    ``calls`` whole calls of ``fn`` under ``torch.profiler`` recorded, and
    their sum; raises if it recorded none of a launch, or more than one
    per call (the profiler may miss the first kernel it sees)."""
    prof = device_profile(lambda: [fn() for _ in range(calls)],
                          groups=SSD_LAUNCHES)
    out = {}
    for k, g in prof["groups"].items():
        assert 0 < g["calls"] <= calls, f"B14 {k}: {g['calls']} " \
            f"launches recorded in {calls} calls"
        out[k] = g["device_ms"] / g["calls"]
    out["sum"] = sum(out.values())
    return out


def ssd_errors(got, want) -> dict:
    """For B14's y and final state: the max abs difference from ``want``
    and the worst ratio |d| / (atol + rtol |want|) under ``TOL_SSD`` (1 at
    the tolerance's edge)."""
    out = {}
    for what, g, w in zip(("y", "state"), got, want):
        d = (g.double() - w.double()).abs()
        out[what] = dict(max_abs=float(d.max()), ratio=float(
            (d / (TOL_SSD["atol"] + TOL_SSD["rtol"] * w.double().abs()))
            .max()))
    return out


def one_step(got, want):
    """(count of differing elements, max abs difference) of ``got`` from
    ``want``; raises unless each differing element lies one step of their
    dtype (the gap to the next value away from 0) from ``want``."""
    import torch
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    bits = {torch.float32: 23, torch.bfloat16: 7}[got.dtype]

    def step(x):
        _, e = torch.frexp(x.abs())
        st = torch.ldexp(torch.ones_like(x), e - 1 - bits)
        return torch.where(x == 0, torch.full_like(
            x, torch.finfo(got.dtype).tiny * 2.0 ** -bits), st)

    bad = diff > torch.maximum(step(g), step(w))
    assert not bool(bad.any()), (f"{int(bad.sum())} elements more than one "
                                 f"step off, max abs {float(diff.max())}")
    return int((diff > 0).sum()), float(diff.max())


def check_case(case: dict, dt: str) -> float:
    """Kernel and plain version on the same inputs; returns the max abs
    difference and raises if it is outside the tolerance. In-place writes
    start from the same snapshot of their pools; decode-write pools are
    compared on every page but the scratch page. The fused RoPE + KV writes
    must give the plain version's roped q and pools bit for bit or one step
    of the dtype off (their count goes to ``case["mismatches"]``), and
    leave every pool row they do not write bit for bit. Quantizers must
    give the plain version's payload and scales exactly, and dequantizing
    their output must land within scale/2 of the source (plus the float32
    rounding of the quotient and the product, |x| * 2**-24 each)."""
    import torch
    from repro_torch.kernels import ref as R

    if case["kind"] == "rope_write":
        targets = case["targets"]
        snap = [t.clone() for t in targets]
        want_q = case["plain"]()
        want = [t.clone() for t in targets]
        for t, s in zip(targets, snap):
            t.copy_(s)
        got_q = case["kernel"]()
        torch.cuda.synchronize()
        n_diff, err = one_step(got_q, want_q)
        live = case["written"][:-BS]           # the scratch page left out
        for got, w, s in zip(targets, want, snap):
            got, w, s = (x[:-1].reshape(-1, *x.shape[2:])
                         for x in (got, w, s))
            assert torch.equal(got[~live], s[~live]), \
                f"{case['name']}: wrote outside its slots"
            assert not torch.equal(w[live], s[live]), \
                f"{case['name']}: wrote nothing"
            n, e = one_step(got, w)
            n_diff, err = n_diff + n, max(err, e)
        case["mismatches"] = n_diff
        return err
    if case["kind"] == "quant":
        (q, s), (want_q, want_s) = case["kernel"](), case["plain"]()
        torch.cuda.synchronize()
        assert torch.equal(q, want_q), f"{case['name']}: payload"
        assert torch.equal(s, want_s), f"{case['name']}: scales"
        x = case["source"]().float()
        err = (R.dequantize_block_ref(q, s) - x).abs()
        bound = s[..., None, :, None] / 2 + x.abs() * 2.0 ** -22 + 1e-7
        assert bool((err <= bound).all()), f"{case['name']}: round trip"
        return 0.0
    if case["kind"] == "ssd":
        from repro_torch.kernels import ops
        tc = ops.route_launches["ssd_scan:tc"]
        (y, st), (yr, sr) = case["kernel"](), case["plain"]()
        torch.cuda.synchronize()
        assert ops.route_launches["ssd_scan:tc"] == tc + 1, \
            f"{case['shape']}: B14 did not take its tensor-core route"
        torch.testing.assert_close(y, yr, **TOL_SSD)
        torch.testing.assert_close(st, sr, **TOL_SSD)
        case["ssd_check"] = ssd_errors((y, st), (yr, sr))
        return max(float((y - yr).abs().max()), float((st - sr).abs().max()))
    if case["kind"] in ("attn", "copy"):
        got, want = case["kernel"](), case["plain"]()
        torch.cuda.synchronize()
        if case["kind"] == "copy":
            assert torch.equal(got, want), case["name"]
        torch.testing.assert_close(got.float(), want.float(),
                                   **case.get("tol", TOL[dt]))
        for r in case.get("zero_rows", ()):
            assert not got[r].any(), f"{case['name']}: padded row {r}"
        return float((got.float() - want.float()).abs().max())
    targets = case["targets"]
    snap = [t.clone() for t in targets]
    case["plain"]()
    want = [t.clone() for t in targets]
    for t, s in zip(targets, snap):
        t.copy_(s)
    case["kernel"]()
    torch.cuda.synchronize()
    err = 0.0
    for got, w, s in zip(targets, want, snap):
        if case["kind"] == "write":
            got, w, s = got[:-1], w[:-1], s[:-1]
        assert not torch.equal(w, s), f"{case['name']}: wrote nothing"
        assert torch.equal(got, w), case["name"]
        err = max(err, float((got.float() - w.float()).abs().max()))
    return err


def f64_errors(case: dict) -> dict:
    """The distance (``ssd_errors``) of the kernel and of its float32 plain
    version from the plain version run in float64 on the same inputs,
    outputs and final states: which side carries their difference. Raises
    if the kernel's is above ``SSD_F64_MAX`` for its shape."""
    import torch
    ref = case["plain64"]()
    out = {side: ssd_errors(case[side](), ref) for side in ("kernel", "plain")}
    torch.cuda.synchronize()
    worst = max(e["max_abs"] for e in out["kernel"].values())
    gate = SSD_F64_MAX[case["variant"] or "mamba2"]
    assert worst <= gate, \
        f"{case['shape']}: B14 {worst:.3g} from float64 > {gate}"
    return out


def time_case(case: dict, row: dict, err: float) -> None:
    """Time a bf16 case (the kernel in a graph and eagerly, its plain
    version, the library call), put the times and the bound into its
    ``row`` and print them."""
    if "splits" in case:        # runs of the split-context kernel
        row["splits"] = case["splits"]()
    lib = case["library"]
    row.update(
        ms=graph_ms(case["kernel"]), eager_ms=cuda_ms(case["kernel"]),
        plain_ms=cuda_ms(case["plain"],
                         iters=case.get("plain_iters", 50),
                         warmup=min(5, case.get("plain_iters", 5))),
        library_ms=cuda_ms(lib) if lib is not None else None,
        library_call=case["library_call"], nbytes=case["nbytes"],
        flops=case["flops"])
    if "data_flops" in case:
        row["data_flops"] = case["data_flops"]
    if case.get("library_graph"):    # like for like with ``ms``
        row["library_graph_ms"] = graph_ms(lib)
    row["bound_ms"], row["bound_by"] = bound_ms(
        case["nbytes"], case["flops"], case.get("ops_dt", "bf16"))
    libs = f"{row['library_ms']:.4f}" if lib is not None else "-"
    label = case["name"] + (f" ({case['variant']})"
                            if case.get("variant") else "")
    print(f"  {label:28s} bf16 {row['ms']:.4f} ms  eager "
          f"{row['eager_ms']:.4f}  plain {row['plain_ms']:.4f}  "
          f"library {libs}"
          f"  bound {row['bound_ms']:.4f} ({row['bound_by']})  "
          f"err bf16 {err:.3g} f32 {row['max_abs_err_f32']:.3g}"
          + (f"  splits {row['splits']}" if "splits" in row else "")
          + (f"  library in a graph {row['library_graph_ms']:.5f}"
             if "library_graph_ms" in row else "")
          + (f"  one step off: bf16 {row['mismatches_bf16']}, f32 "
             f"{row['mismatches_f32']} elements"
             if "mismatches_bf16" in row else ""),
          flush=True)


def kernel_phase():
    from repro_torch.kernels import ops
    rows = {}
    for dt in ("f32", "bf16"):
        for case in (kernel_cases(dt)
                     + serve_shape_cases(dt, "qwen2_5_14b_serving", "ctx256")
                     + serve_shape_cases(dt, "kimi_k2_1t_a32b", "d112")
                     + family_kernel_cases(dt)):
            before = ops.launches[case["name"]]
            err = check_case(case, dt)
            row = rows.setdefault(case["name"], {"name": case["name"]})
            if case.get("variant"):      # a second shape of the same kernel
                row = row.setdefault(case["variant"], {})
            if "shape" in case:
                row["shape"] = case["shape"]
            row[f"max_abs_err_{dt}"] = err
            if "mismatches" in case:     # fused RoPE writes: one step off
                row[f"mismatches_{dt}"] = case["mismatches"]
            if case["kind"] == "ssd":
                row[f"vs_plain_{dt}"] = e = case["ssd_check"]
                row[f"vs_f64_{dt}"] = d = f64_errors(case)
                label = case["name"] + f" ({case['variant'] or 'mamba2'})"
                for what, against in (("plain version", e),
                                      ("float64 kernel", d["kernel"]),
                                      ("float64 plain", d["plain"])):
                    print(f"  {label:28s} {dt}: against the {what}: "
                          + ", ".join(f"{k} max abs {v['max_abs']:.3g} ratio "
                                      f"{v['ratio']:.3g}"
                                      for k, v in against.items())
                          + " (ratio = |d| / (2e-3 + 2e-3 |ref|))", flush=True)
                # each launch of the route
                row[f"launch_ms_{dt}"] = st = ssd_launch_ms(case["kernel"])
                print(f"  {label:28s} {dt}: device ms of each launch, "
                      "profiled over 20 calls: " + ", ".join(
                          f"{k} {v:.4f}" for k, v in st.items()),
                      flush=True)
            if "versus" in case:              # int8 error, information only
                diff = case["kernel"]().float() - case["versus"]().float()
                d = row[f"int8_vs_float_max_abs_err_{dt}"] = float(
                    diff.abs().max())
                print(f"  {case['name']:28s} {dt}: int8 pages vs the float "
                      f"kernel on the pages before quantization: max abs "
                      f"difference {d:.4g} (no gate)", flush=True)
            if dt == "bf16":
                time_case(case, row, err)
            if case.get("variant") and case["name"] in KERNEL_PHASE_ONLY:
                row["launches"] = (row.get("launches", 0)
                                   + ops.launches[case["name"]] - before)
    return rows


# ---------------------------------------------------------------------------
# phases 5 and 6: serve through the engine at Qwen2.5-14B's full size
# ---------------------------------------------------------------------------

def engine_cfg(EngineConfig, TemporalConfig, gpu_blocks, host_blocks,
               kv_precision):
    return EngineConfig.preset(
        "tokencake", gpu_blocks=gpu_blocks, host_blocks=host_blocks,
        max_running=8,
        temporal=TemporalConfig(score_threshold=-1.0, pressure_watermark=0.0,
                                kv_precision=kv_precision))


def submit(front, build_workload, n_apps, prompt_cap, decode_cap):
    for t, g in build_workload("deep_research", qps=2.0, n_apps=n_apps,
                               seed=0):
        for node in g.nodes.values():
            node.prompt_len = min(node.prompt_len, prompt_cap)
            node.decode_segments = [min(s, decode_cap)
                                    for s in node.decode_segments]
        front.register_graph(g, t)


def serve_phase(card: str, kv_precision: str, params=None, cfg=None,
                n_apps: int = 4, decode_cap: int = 32):
    """Serve ``n_apps`` apps (decode segments cut to ``decode_cap``) with a
    ``kv_precision`` host tier on ``cfg`` (default Qwen2.5-14B); ``params``
    reuses weights already on the card. Returns the phase's results, its
    launch counts and the backend."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core.backend import TorchBackend
    from repro_torch.core.costmodel import A100_PCIE
    from repro_torch.core.engine import Engine, EngineConfig
    from repro_torch.core.temporal import TemporalConfig
    from repro_torch.data.workloads import build_workload
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import MCPFrontend
    from repro_torch.models import graphs as G

    cfg = cfg or get_config("qwen2_5_14b_serving")
    ecfg = engine_cfg(EngineConfig, TemporalConfig, GPU_BLOCKS, HOST_BLOCKS,
                      kv_precision)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    backend = TorchBackend(cfg, ecfg, A100_PCIE, seed=0, device="cuda",
                           params=params)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cache = backend.cache
    n_params = sum(t.numel() for t in backend.params["layers"].values()) + \
        sum(backend.params[k].numel()
            for k in ("embed", "unembed", "final_norm"))
    print(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.2f} B params in bf16, pools "
          f"{tuple(cache.k.shape)} x2, host pool {cache.host_k.dtype} "
          f"pinned={cache.host_k.is_pinned()}; set-up {setup_s:.1f} s",
          flush=True)
    assert cache.host_k.is_pinned()
    if kv_precision == "int8_host":
        assert cache.host_k.dtype == torch.int8
        assert cache.host_scales_k.dtype == torch.float32
        assert cache.host_scales_k.is_pinned()
    eng = Engine(ecfg, A100_PCIE, backend=backend)
    front = MCPFrontend(eng)
    submit(front, build_workload, n_apps, prompt_cap=CTX_SHORT,
           decode_cap=decode_cap)

    # the backend's steps run as CUDA graphs: each bucket's first call
    # runs the step eagerly once and captures it, then every call replays
    sg = backend.steps
    ops.reset_launches()
    t0 = time.perf_counter()
    eng.run(max_time=1e5)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    rep = front.report()

    assert rep["apps_finished"] == n_apps, rep["apps_finished"]
    assert rep["decoded_tokens"] > 0
    assert rep["offloads"] >= 1, rep["offloads"]
    assert rep["truncated_prompt_tokens"] == 0
    assert backend.truncated_prompt_tokens == 0
    missing = [k for k in SERVE_KERNELS[kv_precision] if launches[k] <= 0]
    assert not missing, f"kernels never launched on the main path: {missing}"
    nl = cfg.num_layers
    steps = {k: sg.replays[k] for k in G.KINDS}
    runs = {k: sg.replays[k] + sg.captures[k] for k in G.KINDS}
    assert steps["decode"] > 0 and steps["prefill"] > 0, steps
    assert launches["rope_kv_token_write"] == runs["decode"] * nl, \
        (launches, runs)
    assert launches["rope_kv_chunk_write"] == runs["prefill"] * nl, \
        (launches, runs)
    assert launches["kv_token_write"] == launches["kv_chunk_write"] == 0, \
        "the serve wrote K/V through the standalone B1 / B3"
    bpb = A100_PCIE.block_bytes_for(kv_precision)
    if kv_precision == "int8_host":
        assert rep["uploads"] >= 1, rep["uploads"]
        for key in ("d2h_bytes", "h2d_bytes"):
            assert rep[key] > 0 and rep[key] % bpb == 0, (key, rep[key])
    for rid, toks in backend.generated.items():
        assert toks and all(0 <= t < cfg.vocab_size for t in toks), rid
    for rid, logits in backend.last_prefill_logits.items():
        assert logits.shape == (cfg.vocab_size,), rid
        assert bool(np.isfinite(logits).all()), rid
    generated = sum(len(t) for t in backend.generated.values())
    peak = torch.cuda.max_memory_allocated()
    out = dict(
        model=cfg.name, kv_precision=kv_precision, apps=n_apps,
        apps_finished=rep["apps_finished"],
        decoded_tokens=rep["decoded_tokens"], generated_tokens=generated,
        offloads=rep["offloads"], uploads=rep["uploads"],
        d2h_bytes=rep["d2h_bytes"], h2d_bytes=rep["h2d_bytes"],
        engine_block_bytes=bpb, wall_s=wall, setup_s=setup_s,
        generated_tokens_per_wall_s=generated / wall,
        decode_steps=steps["decode"], prefill_chunks=steps["prefill"],
        head_calls=steps["head"], graphs_captured=dict(sg.captures),
        capture_s=sg.capture_s,
        max_memory_allocated_bytes=peak, launches=launches,
        virtual_avg_latency_s=rep["avg_latency"],
        virtual_p90_latency_s=rep["p90_latency"])
    print(f"  [{card}] wall {wall:.2f} s for {generated} generated tokens "
          f"({generated / wall:.1f} tokens per wall second), peak device "
          f"memory {peak / 2**30:.2f} GiB", flush=True)
    print(f"  apps {rep['apps_finished']}/{n_apps}, engine decoded_tokens "
          f"{rep['decoded_tokens']}, offloads {rep['offloads']}, uploads "
          f"{rep['uploads']}, d2h_bytes {rep['d2h_bytes']}, h2d_bytes "
          f"{rep['h2d_bytes']} (engine's {kv_precision} block: {bpb} B); "
          f"engine latency (virtual time, A100 cost model, not card time) "
          f"avg {rep['avg_latency']:.1f} s", flush=True)
    print(f"  {steps['decode']} decode steps, {steps['prefill']} prefill "
          f"chunks and {steps['head']} head calls of {nl} layers, replayed "
          f"from CUDA graphs: {dict(sg.captures)} buckets captured in "
          f"{sg.capture_s:.2f} s (each capture runs its step once eagerly); "
          f"launches on the main path: {launches}", flush=True)
    return out, launches, backend


def step_inputs(cfg, nb: int):
    """The int32 inputs (numpy) of one decode step and one prefill chunk at
    the serve phases' shape: B 8 rows of 256-token contexts through 16-page
    tables of blocks < ``nb`` (block ``nb`` is the scratch block); decode at
    position 255, writing each row's last slot; a 32-token chunk at
    positions 224-255, writing each row's last two pages."""
    import numpy as np

    p16 = CTX_SHORT // BS
    rng = np.random.default_rng(0)
    tables = rng.permutation(nb)[:B * p16].reshape(B, p16).astype(np.int32)

    def i32(x):
        return np.asarray(x, np.int32)

    dec = (i32(rng.integers(0, cfg.vocab_size, B)), tables,
           i32([CTX_SHORT - 1] * B), i32([CTX_SHORT] * B),
           i32(tables[:, -1] * BS + BS - 1))
    wpages = np.full((B, (C - 1) // BS + 2), nb, np.int32)
    wpages[:, :2] = tables[:, -2:]
    pre = (i32(rng.integers(0, cfg.vocab_size, (B, C))), tables,
           i32(np.tile(CTX_SHORT - C + np.arange(C), (B, 1))), wpages,
           i32([0] * B), i32([C] * B))
    return dec, pre


# the CUDA runtime and driver calls that put work on the card: kernel and
# graph launches, copies and memsets (torch.profiler's host-side events)
HOST_LAUNCHES = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                 "cudaMemsetAsync"}


def step_device_kernels(cfg, params, k_pool, v_pool, groups=None) -> dict:
    """One ``paged_decode_step`` and one ``paged_prefill_step`` at the serve
    phases' shape (``step_inputs``), from numpy inputs as the backend calls
    them, under ``torch.profiler``: eagerly, and, where
    the source tree has ``models.graphs``, replayed from its CUDA graph
    (``..._replayed``), each once to warm up and once under
    ``device_profile`` (``groups`` as there). Writes K/V into the pools'
    slots of those pages."""
    import torch

    from repro_torch.models import model as M

    dev = k_pool.device
    dec, pre = step_inputs(cfg, k_pool.shape[1] - 1)

    def t(arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    runs = {"decode_step": lambda: M.paged_decode_step(
                cfg, params, k_pool, v_pool, *t(dec)),
            "prefill_chunk": lambda: M.paged_prefill_step(
                cfg, params, k_pool, v_pool, *t(pre))}
    try:
        from repro_torch.models import graphs as G
    except ImportError:               # a source tree from before the graphs
        G = None
    if G is not None:
        sg = G.StepGraphs(cfg, dev)
        runs["decode_step_replayed"] = lambda: sg.decode(
            params, k_pool, v_pool, *dec)
        runs["prefill_chunk_replayed"] = lambda: sg.prefill(
            params, k_pool, v_pool, *pre)
    out = {}
    for name, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        out[name] = device_profile(fn, top=0, groups=groups)
    return out


def wall_ms(fn, n: int = 20) -> dict:
    """Host wall ms of ``fn`` ending in a synchronise, after one warm-up
    call: median, mean, min and max of ``n`` calls, and all of them."""
    import numpy as np
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return dict(median=float(np.median(times)), mean=float(np.mean(times)),
                min=min(times), max=max(times), calls=n, all=times)


def graph_phase(card: str, cfg, params, k_pool, v_pool,
                groups=None) -> dict:
    """The compiled steps at the serve's shape, on the serve's weights and
    pools (``step_inputs``): the replayed decode step and prefill chunk
    give the eager step's output and K/V bit for bit (first call: warm-up,
    capture and replay; second call: replay alone); wall ms per step,
    eager against replayed, host time included; the device's idle share
    over 10 replayed decode steps, each read to the host as the serve reads
    its argmax, under ``torch.profiler``; and the device kernels and host
    launch calls of one step each way (``step_device_kernels``, its
    profiles grouping kernels by ``groups``)."""
    import torch

    from repro_torch.models import graphs as G

    dec, pre = step_inputs(cfg, k_pool.shape[1] - 1)
    eager, sg = G.EagerSteps(cfg), G.StepGraphs(cfg, k_pool.device)
    blocks = torch.as_tensor(dec[1].ravel().astype("int64"),
                             device=k_pool.device)

    def written():
        return [pool[:, blocks].clone() for pool in (k_pool, v_pool)]

    out = {}
    for name, kind, args in (("decode_step", "decode", dec),
                             ("prefill_chunk", "prefill", pre)):
        want = getattr(eager, kind)(params, k_pool, v_pool, *args).clone()
        want_kv = written()
        t0 = time.perf_counter()
        first = getattr(sg, kind)(params, k_pool, v_pool, *args).clone()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        first_kv = written()
        again = getattr(sg, kind)(params, k_pool, v_pool, *args)
        torch.cuda.synchronize()
        for what, got in (("first call", first), ("replay", again)):
            assert torch.equal(got, want), \
                (f"{name}: {what} differs from the eager step, max abs "
                 f"{float((got.float() - want.float()).abs().max())}")
        for g, w in zip(first_kv + written(), want_kv * 2):
            assert torch.equal(g, w), f"{name}: K/V differ from the eager step"
        out[name] = dict(
            bitwise_equal=True, first_call_s=first_s,
            eager_wall_ms=wall_ms(lambda: getattr(eager, kind)(
                params, k_pool, v_pool, *args)),
            replayed_wall_ms=wall_ms(lambda: getattr(sg, kind)(
                params, k_pool, v_pool, *args)))
        print(f"  [{card}] {name}: replay = eager step bit for bit (output "
              f"and K/V); first call (warm-up, capture, replay) "
              f"{first_s * 1e3:.1f} ms; wall per call eager "
              f"{out[name]['eager_wall_ms']['median']:.3f} ms, replayed "
              f"{out[name]['replayed_wall_ms']['median']:.3f} ms (median of "
              f"20, synchronised)", flush=True)

    def ten(steps):
        def run():
            for _ in range(10):
                lg = steps.decode(params, k_pool, v_pool, *dec)
                torch.argmax(lg, dim=-1).cpu()
        return run

    for label, steps in (("replayed", sg), ("eager", eager)):
        w = wall_ms(ten(steps), n=3)["median"]
        pr = device_profile(ten(steps))
        pr["unprofiled_wall_ms"] = w
        pr["device_idle_share"] = (None if pr["device_ms"] is None
                                   else 1.0 - pr["device_ms"] / w)
        out[f"ten_decode_steps_{label}"] = pr
        print(f"  [{card}] 10 {label} decode steps (argmax read each step):"
              f" device busy {pr['device_ms']} ms of {w:.2f} ms wall, idle "
              f"share {pr['device_idle_share']}", flush=True)
    out["per_step"] = per = step_device_kernels(cfg, params, k_pool, v_pool,
                                                groups)
    for what, r in per.items():
        print(f"  [{card}] one {what} under torch.profiler: {r['kernels']} "
              f"device kernels, {r['memcpy']} copies, {r['memset']} memsets, "
              f"device time {r['device_ms']} ms; host launch calls "
              f"{r['host_launches']}", flush=True)
    out["graphs"] = dict(captures=sg.captures, capture_s=sg.capture_s)
    return out


# ---------------------------------------------------------------------------
# phase 4: one bf16 step at Qwen2.5-14B's widths, kernels against plain
# ---------------------------------------------------------------------------

# the plain version of each kernel entry the paged steps call
STEP_PLAIN = {"rope_kv_token_write": "rope_kv_token_write_ref",
              "paged_attention": "paged_attention_ref",
              "rope_kv_chunk_write": "rope_kv_chunk_write_ref",
              "paged_prefill_attention": "paged_prefill_attention_ref"}
# a step through the kernels against the same step through their plain
# versions: the two differ only in the attention kernels, by at most one
# bf16 step of each output (TOL); two layers of bf16 products, norms and
# the head carry that into the hidden states and logits by a few steps,
# so each output must lie within four bf16 steps of the largest one
# (2**-5 of max |plain|); the argmax must agree on every row whose top
# two plain logits are further apart than twice that
STEP_LAYERS, STEP_REL = 2, 2.0 ** -5


def step_check(card: str) -> dict:
    """One bf16 ``paged_decode_step`` and one ``paged_prefill_step`` (its
    last rows through ``head_logits``) of Qwen2.5-14B at 2 layers, random
    weights from seed 0, random bf16 pools, at the serve's shape
    (``step_inputs``), eagerly through the kernels and through their plain
    versions (``STEP_PLAIN``, swapped into ``ops`` for this check only),
    each from the same pools."""
    import dataclasses

    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as R
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config("qwen2_5_14b_serving"),
                              num_layers=STEP_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = M.init_params(cfg, gen, "cuda")
    nb = B * (CTX_SHORT // BS)
    shape = (cfg.num_layers, nb + 1, BS, cfg.num_kv_heads, cfg.head_dim)
    pools = [torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in "kv"]
    dec, pre = step_inputs(cfg, nb)

    def t(arrays):
        return [torch.from_numpy(a).cuda() for a in arrays]

    steps = {
        "decode_step": lambda: M.paged_decode_step(cfg, params, *pools,
                                                   *t(dec)),
        "prefill_chunk": lambda: M.head_logits(
            cfg, params, M.paged_prefill_step(cfg, params, *pools,
                                              *t(pre))[:, -1])}
    out = {}
    for name, fn in steps.items():
        snap = [p.clone() for p in pools]
        got = fn().float()
        for p, s in zip(pools, snap):
            p.copy_(s)
        kernels = {k: getattr(ops, k) for k in STEP_PLAIN}
        try:
            for k, plain in STEP_PLAIN.items():
                setattr(ops, k, getattr(R, plain))
            want = fn().float()
        finally:
            for k, f in kernels.items():
                setattr(ops, k, f)
        for p, s in zip(pools, snap):
            p.copy_(s)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all()), name
        err = float((got - want).abs().max())
        tol = STEP_REL * float(want.abs().max())
        top2 = want.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * tol
        agree = got.argmax(-1) == want.argmax(-1)
        out[name] = dict(max_abs_err=err, tol=tol,
                         max_abs_logit=float(want.abs().max()),
                         argmax_agree_rows=int(agree.sum()),
                         rows=int(agree.numel()),
                         clear_rows=int(clear.sum()))
        print(f"  [{card}] bf16 {name}, {cfg.num_layers} layers at Qwen2.5-"
              f"14B's widths, kernels vs plain versions: logits max abs err "
              f"{err:.4g} (tolerance {tol:.4g}, max |logit| "
              f"{out[name]['max_abs_logit']:.4g}); argmax agrees on "
              f"{int(agree.sum())} of {agree.numel()} rows ({int(clear.sum())}"
              f" rows with a clear top logit)", flush=True)
        assert err <= tol, (name, err, tol)
        assert bool(agree[clear].all()), f"{name}: argmax differs"
    return out


def migration_times(card: str, cache, reps: int = 10) -> dict:
    """Wall time of ``cache.offload`` and ``cache.upload`` of M_BLOCKS
    blocks (the kernel phase's ids: the last live block, the scratch block
    and 30 others) to and from host blocks 0..M-1, after one warm-up call
    each, every call ending in a synchronise. Wire bytes are what crosses
    PCIe: the pools' bytes, or the int8 payload plus its scales."""
    import numpy as np

    nb = cache.num_blocks + 1
    ids = np.concatenate([[nb - 1, nb - 2], np.random.default_rng(0).choice(
        nb - 2, M_BLOCKS - 2, replace=False)]).tolist()
    host = list(range(M_BLOCKS))
    hosts = [cache.host_k, cache.host_v]
    if cache.host_scales_k is not None:
        hosts += [cache.host_scales_k, cache.host_scales_v]
    wire = sum(h[:, :M_BLOCKS].numel() * h.element_size() for h in hosts)
    out = {"blocks": M_BLOCKS, "wire_bytes": wire, "reps": reps}
    for op, fn in (("offload", lambda: cache.offload(ids, host)),
                   ("upload", lambda: cache.upload(host, ids))):
        w = wall_ms(fn, n=reps)
        ms = w["median"]
        out[op] = dict(ms_per_call=ms, ms_per_block=ms / M_BLOCKS,
                       wire_gb_per_s=wire / ms / 1e6, all_ms=w["all"])
        print(f"  [{card}] {cache.host_precision} {op} of {M_BLOCKS} "
              f"blocks: {ms:.3f} ms per call (median of {reps}; "
              f"{w['min']:.3f}-{w['max']:.3f}), {ms / M_BLOCKS:.4f} ms "
              f"per block, {wire} wire bytes at {wire / ms / 1e6:.2f} GB/s",
              flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 6b: the serving front door at Qwen2.5-14B's full size
# ---------------------------------------------------------------------------

# /generate prompts, the prefix two of them share (eight blocks and half a
# ninth: the second request pins the whole blocks and forks the half one
# copy-on-write) and the tokens each asks for
FD_PROMPT, FD_SHARED, FD_MAX_TOKENS = 256, 136, 32
# the tool adapter's app in ``graph_from_spec``'s wire form: a planner,
# then an actor whose tool call the client starts and finishes over HTTP
# while the actor decodes its first segment (long enough for the client
# to see it running first)
FD_GRAPH = {"name": "tool", "nodes": [
    {"name": "plan", "agent_type": "planner", "prompt_len": 64,
     "decode_len": 8},
    {"name": "act", "agent_type": "actor", "prompt_len": 64,
     "decode_segments": [96, 8], "deps": ["plan"],
     "func_calls": [{"name": "s", "tool": "search", "predict_time": 30.0}]},
]}
# the session round trip: turn 1's prompt, each turn's tokens, the new
# user tokens of turn 2, and turn 2's arrival after turn 1's end (past the
# forecast gap, so the predictive warm lands first)
FD_TURN1, FD_TURN_TOKENS, FD_USER2, FD_GAP_S = 200, 16, 16, 12.0


def frontdoor_engine(cfg, params, device, gpu_blocks, host_blocks,
                     policy="ttl"):
    """The front door's engine: continuous batching, sessions (turn-end
    ``policy``) and the prefix cache, over ``TorchBackend`` on ``device``."""
    from repro_torch.core.backend import TorchBackend
    from repro_torch.core.costmodel import A100_PCIE
    from repro_torch.core.engine import Engine, EngineConfig
    from repro_torch.core.temporal import TemporalConfig

    ecfg = EngineConfig.preset(
        "tokencake", gpu_blocks=gpu_blocks, host_blocks=host_blocks,
        continuous_batching=True, sessions=True, prefix_cache=True,
        temporal=TemporalConfig(session_policy=policy))
    backend = TorchBackend(cfg, ecfg, A100_PCIE, device=device,
                           params=params)
    return Engine(ecfg, A100_PCIE, backend=backend), backend


class HttpClient:
    """stdlib ``http.client`` calls to the server on 127.0.0.1:``port``;
    each returns (status, JSON body, wall ms)."""

    def __init__(self, port: int, timeout: float = 600.0):
        self.port, self.timeout = port, timeout

    def call(self, method: str, path: str, body=None):
        import http.client

        t0 = time.perf_counter()
        c = http.client.HTTPConnection("127.0.0.1", self.port,
                                       timeout=self.timeout)
        try:
            c.request(method, path,
                      json.dumps(body) if body is not None else None,
                      {"Content-Type": "application/json"})
            r = c.getresponse()
            out = json.loads(r.read())
            return r.status, out, (time.perf_counter() - t0) * 1e3
        finally:
            c.close()

    def stream(self, body):
        """POST /generate?stream=1: the chunks' tokens reassembled, the
        last chunk, and the wall ms to the first chunk and to the end."""
        import http.client

        t0 = time.perf_counter()
        c = http.client.HTTPConnection("127.0.0.1", self.port,
                                       timeout=self.timeout)
        try:
            c.request("POST", "/generate?stream=1", json.dumps(body),
                      {"Content-Type": "application/json"})
            r = c.getresponse()
            assert r.status == 200, r.status
            toks, first_ms, last = [], None, None
            for line in r:                  # http.client de-chunks
                if first_ms is None:
                    first_ms = (time.perf_counter() - t0) * 1e3
                last = json.loads(line)
                toks.extend(last["tokens"])
            return toks, last, first_ms, (time.perf_counter() - t0) * 1e3
        finally:
            c.close()

    def until(self, path, done, what, timeout=600.0, every=0.005):
        """GET ``path`` until ``done(body)``; returns the body."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            status, out, _ = self.call("GET", path)
            assert status == 200, (path, status, out)
            if done(out):
                return out
            time.sleep(every)
        raise AssertionError(f"timed out waiting for {what}")


def frontdoor_serve(cfg, params, device, gpu_blocks, host_blocks,
                    seed: int = 0) -> dict:
    """``HttpServer`` over the front door's engine, on a background thread
    at 127.0.0.1:0; this thread is its client and touches no tensor while
    it runs. (b) four /generate calls, the async one first, then two that
    share ``FD_SHARED`` prompt tokens, then a streamed one; (c) the first
    request again, served from the response cache; (a) a tool adapter
    registering ``FD_GRAPH`` and starting and finishing its tool call;
    (d) a session opened, one turn, read and closed. The order steps
    around two behaviours of the reference's engine and server
    (ROADMAP.md §3): a tool call started over HTTP leaves its agent twice
    in the engine's running list, and the finished copy keeps
    ``Engine.step`` busy, so (c) comes before (a); the live pump parks on
    a pending session timer even with runnable work, until the timer's
    wall deadline, so the session comes last. After the server
    stops: every response ok, every /generate's tokens the backend's own,
    the cache hit without engine work, no truncated prompt, nothing
    outstanding. Returns the client's wall times and the report."""
    import numpy as np

    from repro_torch.launch.http_server import HttpServer, synth_tokens
    from repro_torch.launch.response_cache import request_key

    eng, backend = frontdoor_engine(cfg, params, device, gpu_blocks,
                                    host_blocks)
    # prefill logits of finished requests (their invalidation drops them)
    kept = {}
    invalidate = backend.invalidate

    def keep_logits(rid):
        if rid in backend.last_prefill_logits:
            kept[rid] = backend.last_prefill_logits[rid]
        invalidate(rid)
    backend.invalidate = keep_logits

    rng = np.random.default_rng(seed)

    def toks(n):
        return [int(t) for t in rng.integers(0, cfg.vocab_size, n)]
    shared = toks(FD_SHARED)
    prompts = [shared + toks(FD_PROMPT - FD_SHARED),
               shared + toks(FD_PROMPT - FD_SHARED),
               toks(FD_PROMPT), toks(FD_PROMPT)]
    bodies = [{"prompt": p, "max_tokens": FD_MAX_TOKENS} for p in prompts]
    srv = HttpServer(engine=eng)
    port = srv.start_background()
    cl = HttpClient(port)
    gen, ms = {}, {}
    try:
        # (b) the burst
        t0 = time.perf_counter()
        status, out, _ = cl.call("POST", "/generate?async=1", bodies[3])
        assert status == 200 and out["ok"], (status, out)
        gid = out["id"]
        for i in (0, 1):
            status, gen[i], ms[i] = cl.call("POST", "/generate", bodies[i])
            assert status == 200, (status, gen[i])
        toks2, last, first_ms, ms[2] = cl.stream(bodies[2])
        gen[2] = dict(last, tokens=toks2, ok=True, stream_first_ms=first_ms)
        gen[3] = cl.until(f"/v1/result/{gid}",
                          lambda o: o.get("status") == "finished",
                          "the async generation")
        ms[3] = (time.perf_counter() - t0) * 1e3
        burst_s = time.perf_counter() - t0
        rids = {i: cl.call("GET", f"/v1/result/{gen[i]['id']}")[1]["rid"]
                for i in range(4)}
        # (c) the first request again, once the pump has parked
        cl.until("/v1/report", lambda o: o["serving"]["outstanding"] == 0,
                 "the burst to drain")
        while True:
            steps0 = srv.steps
            time.sleep(0.2)
            if srv.steps == steps0:
                break
        work0 = (eng.metrics["decoded_tokens"], len(eng.apps),
                 eng.metrics["prefill_tokens"])
        status, hit, ms_hit = cl.call("POST", "/generate", bodies[0])
        # the handler wakes the pump even for a hit: at most one iteration
        # that finds nothing to do, and no engine work
        time.sleep(0.2)
        hit_steps = srv.steps - steps0
        hit_work = (eng.metrics["decoded_tokens"], len(eng.apps),
                    eng.metrics["prefill_tokens"])
        assert status == 200 and hit["ok"] and hit["cached"] is True, hit
        # (a) the tool adapter
        status, reg, _ = cl.call("POST", "/v1/register_graph",
                                 {"graph": FD_GRAPH})
        assert status == 200 and reg["ok"], reg
        act = f"{reg['app_id']}/act"
        cl.until("/v1/states", lambda o: o.get(act) == "running",
                 "the actor to run")
        tool = [cl.call("POST", "/v1/call_start",
                        {"rid": act, "estimate": 30.0}),
                cl.call("POST", "/v1/call_finish", {"rid": act})]
        states = cl.until(
            "/v1/states", lambda o: o and all(
                s == "finished" for r, s in o.items()
                if r.startswith(reg["app_id"])), "the tool app to finish")
        # (d) a session: open, one turn, read, close
        session = [cl.call("POST", "/v1/session/open", {"sid": "chat1"})]
        session.append(cl.call("POST", "/generate", {
            "prompt": toks(FD_TURN1), "max_tokens": FD_TURN_TOKENS,
            "session_id": "chat1"}))
        session.append(cl.call("GET", "/v1/session/chat1"))
        session.append(cl.call("POST", "/v1/session/chat1/close"))
        rep_status, rep, _ = cl.call("GET", "/v1/report")
    finally:
        srv.stop()
    assert not srv._thread.is_alive(), "the server thread did not stop"
    for status, body, _ in session + tool:
        assert status == 200 and body["ok"], (status, body)
    assert session[2][1]["turns"] == 1, session[2][1]
    assert rep_status == 200 and rep["serving"]["outstanding"] == 0, \
        rep["serving"]
    for i, body in gen.items():
        assert body["ok"], body
        n = len(body["tokens"])
        assert n == FD_MAX_TOKENS, (i, n)
        # the backend's own tokens, never the placeholder the front door
        # falls back to when the backend has none for the rid
        assert rids[i] in backend.generated, (i, rids[i])
        assert body["tokens"] == backend.generated[rids[i]][:n], i
        assert body["tokens"] != synth_tokens(request_key(bodies[i]), n), i
    assert gen[2]["done"] and gen[2]["n_tokens"] == FD_MAX_TOKENS
    assert hit["tokens"] == gen[0]["tokens"]
    assert hit_work == work0, (work0, hit_work)
    assert hit_steps <= 1, hit_steps
    assert rep["serving"]["cache_hits"] == 1, rep["serving"]
    assert rep["cow_forks"] >= 1, rep["cow_forks"]
    assert rep["truncated_prompt_tokens"] == 0
    assert backend.truncated_prompt_tokens == 0
    assert kept, "no prefill logits"
    for rid, logits in kept.items():
        assert logits.shape == (cfg.vocab_size,), rid
        assert bool(np.isfinite(logits).all()), rid
    generated = sum(len(gen[i]["tokens"]) for i in range(4))
    sv = rep["serving"]
    out = dict(
        generate_wall_ms={i: ms[i] for i in range(4)},
        stream_first_chunk_ms=gen[2]["stream_first_ms"],
        cache_hit_wall_ms=ms_hit, cache_hit_server_steps=hit_steps,
        burst_wall_s=burst_s, burst_tokens=generated,
        tokens_per_wall_s=generated / burst_s, server_steps=srv.steps,
        graphs_captured=dict(getattr(backend.steps, "captures", {})),
        tool_app_states=states, serving=sv,
        engine=dict(cow_forks=rep["cow_forks"],
                    prefix_hits=rep["prefix_hits"],
                    offloads=rep["offloads"], uploads=rep["uploads"],
                    decoded_tokens=rep["decoded_tokens"],
                    session=session[2][1]))
    backend.cache = None
    return out


def session_turns(cfg, params, device, gpu_blocks, host_blocks,
                  policy: str, seed: int = 1) -> dict:
    """Two turns of one session through ``FrontDoor.drive`` (virtual
    time): turn 2 = turn 1's prompt and reply plus ``FD_USER2`` new
    tokens, arriving ``FD_GAP_S`` after turn 1 ends."""
    import numpy as np

    from repro_torch.launch.http_server import FrontDoor

    rng = np.random.default_rng(seed)
    p1 = [int(t) for t in rng.integers(0, cfg.vocab_size, FD_TURN1)]
    user2 = [int(t) for t in rng.integers(0, cfg.vocab_size, FD_USER2)]
    eng, backend = frontdoor_engine(cfg, params, device, gpu_blocks,
                                    host_blocks, policy)
    fd = FrontDoor(eng, cache=None)
    g1 = fd.submit({"prompt": p1, "max_tokens": FD_TURN_TOKENS,
                    "session_id": "s"})
    fd.drive()
    resp1 = list(backend.generated[g1.rid][:FD_TURN_TOKENS])
    p2 = p1 + resp1 + user2
    before = eng.metrics["prefill_tokens"]
    g2 = fd.submit({"prompt": p2, "max_tokens": FD_TURN_TOKENS,
                    "session_id": "s"}, arrival=g1.finish + FD_GAP_S)
    fd.drive()
    assert g1.status == g2.status == "finished", (g1.status, g2.status)
    out = dict(policy=policy, turn1=resp1,
               turn2=list(backend.generated[g2.rid][:FD_TURN_TOKENS]),
               turn2_prompt=len(p2),
               turn2_prefill=eng.metrics["prefill_tokens"] - before,
               sessions=dict(eng.session_metrics),
               d2h_bytes=eng.metrics["d2h_bytes"],
               h2d_bytes=eng.metrics["h2d_bytes"])
    backend.cache = None
    return out


def session_roundtrip(cfg, params, device, gpu_blocks, host_blocks) -> dict:
    """The session's turn-end offload and predictive warm (``ttl``) give
    the tokens of the same two turns with the KV pinned on the device
    (``pin``): the round trip moves the bytes exactly."""
    runs = {}
    for policy in ("ttl", "pin"):
        runs[policy] = session_turns(cfg, params, device, gpu_blocks,
                                     host_blocks, policy)
        gc.collect()
        if device == "cuda":
            import torch
            torch.cuda.empty_cache()
    ttl, pin = runs["ttl"], runs["pin"]
    assert ttl["sessions"]["session_offloads"] >= 1, ttl["sessions"]
    assert ttl["sessions"]["session_warms"] == 1, ttl["sessions"]
    assert pin["sessions"]["session_offloads"] == 0, pin["sessions"]
    assert ttl["turn2_prefill"] < ttl["turn2_prompt"], ttl
    assert (ttl["turn1"], ttl["turn2"]) == (pin["turn1"], pin["turn2"]), \
        "the offloaded and warmed session decodes other tokens than the " \
        "pinned one"
    return runs


def frontdoor_phase(card: str, params) -> tuple:
    """Phase 6b on phase 5's Qwen2.5-14B weights: ``frontdoor_serve`` over
    the 2048-block pool and the pinned 1024-block host pool, then
    ``session_roundtrip``; launch counts zeroed before and read after each
    (the serving path's kernels must all have run over the socket, B1 / B3
    alone never). Returns the phase's results and its launch counts."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops

    cfg = get_config("qwen2_5_14b_serving")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out = frontdoor_serve(cfg, params, "cuda", GPU_BLOCKS, HOST_BLOCKS)
    counts = dict(ops.launches)
    gc.collect()
    torch.cuda.empty_cache()
    missing = [k for k in SERVE_KERNELS["fp16"] if counts[k] <= 0]
    assert not missing, f"kernels never launched over the socket: {missing}"
    assert counts["kv_token_write"] == counts["kv_chunk_write"] == 0, \
        "the front door wrote K/V through the standalone B1 / B3"
    ms = out["generate_wall_ms"]
    sv = out["serving"]
    print(f"  [{card}] /generate wall ms (client, {FD_PROMPT}-token "
          f"prompts, {FD_MAX_TOKENS} tokens): async {ms[3]:.1f} (to its "
          f"result), plain {ms[0]:.1f} / {ms[1]:.1f} (shared prefix), "
          f"stream first chunk {out['stream_first_chunk_ms']:.1f} of "
          f"{ms[2]:.1f}; {out['burst_tokens']} tokens in "
          f"{out['burst_wall_s']:.2f} s ({out['tokens_per_wall_s']:.1f} "
          f"tokens per wall second); cache hit {out['cache_hit_wall_ms']:.1f}"
          f" ms, {out['cache_hit_server_steps']} server steps, no engine "
          f"work", flush=True)
    print(f"  server steps {out['server_steps']}, graphs captured "
          f"{out['graphs_captured']}; serving (virtual time, A100 cost "
          f"model, not card time): accepted {sv['accepted']}, completed "
          f"{sv['completed']}, cache hits {sv['cache_hits']}, rejected "
          f"{sv['rejected']}, ttft p50 {sv['ttft']['p50']:.3f} s, tpot p50 "
          f"{sv['tpot']['p50']:.4f} s; engine {out['engine']}; launches "
          f"{ {k: counts[k] for k in SERVE_KERNELS['fp16']} }", flush=True)
    ops.reset_launches()
    t0 = time.perf_counter()
    out["session_roundtrip"] = session_roundtrip(cfg, params, "cuda",
                                                 GPU_BLOCKS, HOST_BLOCKS)
    rt_counts = dict(ops.launches)
    ttl = out["session_roundtrip"]["ttl"]
    print(f"  [{card}] session round trip (FrontDoor.drive, virtual time): "
          f"turn 2 prefilled {ttl['turn2_prefill']} of {ttl['turn2_prompt']}"
          f" prompt tokens after {ttl['sessions']['session_offloads']} "
          f"offload(s) and {ttl['sessions']['session_warms']} warm; its "
          f"tokens equal the pinned run's; {time.perf_counter() - t0:.1f} s, "
          f"launches { {k: rt_counts[k] for k in SERVE_KERNELS['fp16']} }",
          flush=True)
    for k, n in rt_counts.items():
        counts[k] = counts.get(k, 0) + n
    out["launches"] = counts
    out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    return out, counts


# ---------------------------------------------------------------------------
# phase 7: Kimi-K2 at full width through the engine
# ---------------------------------------------------------------------------

# Kimi-K2 (``configs/kimi_k2_1t_a32b.py``) at 2 of its 61 layers: each
# layer's 384 experts are 16.9e9 parameters (33.8 GB in bf16), so 2 layers,
# the embeddings and the attention weights take 72.8 GB of the card's 80;
# two apps with decode segments cut to 16 tokens keep the phase near 30 s
KIMI_LAYERS, KIMI_APPS, KIMI_DECODE = 2, 2, 16


def kimi_phase(card: str) -> tuple:
    """The fp16 serve (``serve_phase``) of Kimi-K2 at full width and
    ``KIMI_LAYERS`` layers; the experts' products timed alone
    (``expert_products``); then the graph phase at its shape on its
    weights and pools, whose profile of each replayed step sums the device
    time of the products' kernels: their share of the step. Returns the
    results and the serve's launch counts; frees the weights and pools."""
    import dataclasses

    import torch

    from repro_torch.configs.base import get_config

    cfg = dataclasses.replace(get_config("kimi_k2_1t_a32b"),
                              num_layers=KIMI_LAYERS)
    out, counts, backend = serve_phase(card, "fp16", cfg=cfg,
                                       n_apps=KIMI_APPS,
                                       decode_cap=KIMI_DECODE)
    out["experts"] = ex = expert_products(card, cfg, backend.params)
    print("[graphs] Kimi-K2: the compiled steps at the serve's shape, on "
          "its weights and pools", flush=True)
    out["graphs"] = graph_phase(card, cfg, backend.params, backend.cache.k,
                                backend.cache.v,
                                groups={"experts": ex["kernels"]})
    for what in ("decode_step", "prefill_chunk"):
        step = out["graphs"]["per_step"][f"{what}_replayed"]
        grp = step["groups"]["experts"]
        share = (None if not step["device_ms"]
                 else grp["device_ms"] / step["device_ms"])
        ex[what]["share_of_replayed_step"] = share
        print(f"  [{card}] one {what}_replayed: the expert products' kernels"
              f" ({grp['calls']} launches) take {grp['device_ms']:.3f} of its"
              f" {step['device_ms']} device ms: share {share}", flush=True)
    backend.cache = None
    del backend
    gc.collect()
    torch.cuda.empty_cache()
    return out, counts


def expert_products(card: str, cfg, params) -> dict:
    """The three batched expert products of every layer (``moe_ffn``'s
    ``bmm`` calls on the serve's weights) at the capacity the decode
    step's and the prefill chunk's buckets give (B and B·C tokens): their
    device ms per step from CUDA events (5 calls after a warm-up) beside
    the bytes of expert weights they read, and the names of their kernels
    (from one profiled call), by which the step profiles group them (a
    profile may miss the first launches it sees, so it gives names, not
    times)."""
    import torch

    from repro_torch.models import moe as MOE

    lay = params["layers"]
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    nbytes = 3 * cfg.num_layers * e * d * f * lay["we1"].element_size()
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    gen = torch.Generator(device="cuda").manual_seed(3)
    out, names = {"expert_bytes": nbytes, "expert_bound_ms": bound}, set()
    for what, tokens in (("decode_step", B), ("prefill_chunk", B * C)):
        cap = MOE.capacity(tokens, cfg)
        xb = torch.randn((e, cap, d), generator=gen, device="cuda").to(
            lay["we1"].dtype)

        def products():
            for i in range(cfg.num_layers):
                h = torch.bmm(xb, lay["we1"][i])
                torch.bmm(xb, lay["we3"][i])
                torch.bmm(h, lay["we2"][i])

        ms = cuda_ms(products, iters=5, warmup=1)
        new = {t["name"] for t in device_profile(products, top=4)["top"]
               if not t["name"].startswith("Memset")}
        names |= new
        out[what] = dict(tokens=tokens, capacity=cap, ms=ms,
                         rate_tb_per_s=nbytes / ms / 1e9)
        print(f"  [{card}] {what} (capacity {cap} of {tokens} tokens): the "
              f"expert products of {cfg.num_layers} layers take {ms:.3f} ms "
              f"(CUDA events) for {nbytes / 1e9:.1f} GB of weights, "
              f"{nbytes / ms / 1e9:.2f} TB/s (bound {bound:.2f} ms at 3.35 "
              f"TB/s); kernels {sorted(new)}", flush=True)
    out["kernels"] = sorted(names)
    return out


# ---------------------------------------------------------------------------
# phase 8: Mamba2-130M and Hymba-1.5B prefill and decode at full size
# ---------------------------------------------------------------------------

def family_run(cfg, params, tokens, steps: int):
    """``prefill`` of ``tokens`` into a cache sized for ``steps`` more
    tokens, then ``steps`` greedy ``decode_step``s. Returns (prefill
    logits, decode logits per step, generated tokens, cache, prefill
    seconds, decode seconds), both times ending in a synchronise."""
    import torch

    from repro_torch.models import model as M

    s = tokens.shape[1]
    t0 = time.perf_counter()
    logits, cache = M.prefill(cfg, params, {"tokens": tokens}, s + steps)
    if tokens.is_cuda:
        torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    nxt = logits[:, 0].argmax(-1).to(torch.int32)
    toks, step_logits = [nxt], []
    t0 = time.perf_counter()
    for step in range(steps):
        lg, cache = M.decode_step(cfg, params, cache, nxt, s + step)
        nxt = lg.argmax(-1).to(torch.int32)
        step_logits.append(lg)
        toks.append(nxt)
    if tokens.is_cuda:
        torch.cuda.synchronize()
    return (logits, step_logits, torch.stack(toks, 1), cache, prefill_s,
            time.perf_counter() - t0)


def device_profile(fn, top: int = 8, groups=None) -> dict:
    """Run ``fn`` once under ``torch.profiler`` (CPU and CUDA activity)
    and return its wall ms (profiler overhead included), the summed device
    time of its device-side events (kernels, copies, memsets; one stream,
    so their busy time), their counts by kind, the host calls of
    ``HOST_LAUNCHES`` that put them on the card, the ``top`` of them by
    device time, and for each ``groups`` entry {label: kernel names} the
    device ms and calls of the kernels whose names hold one of the
    names. CPU-side operator rows, which also carry their kernels'
    device time, are not counted. A profiler that records no device event
    gives ``device_ms: None`` (not measured)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    counts = {"kernels": 0, "memcpy": 0, "memset": 0, "host_launches": 0}
    rows, seen = [], False
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            if e.key in HOST_LAUNCHES:
                counts["host_launches"] += e.count
            continue
        seen = True
        counts["memcpy" if e.key.startswith("Memcpy") else
               "memset" if e.key.startswith("Memset") else
               "kernels"] += e.count
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / 1e3, e.key, e.count))
    rows.sort(reverse=True)
    dev = sum(r[0] for r in rows)
    def of(names, k):
        return any(n in k for n in names)
    grouped = {label: dict(
        device_ms=sum(ms for ms, k, _ in rows if of(names, k)),
        calls=sum(n for _, k, n in rows if of(names, k)))
        for label, names in (groups or {}).items()}
    return dict(counts, profiled_wall_ms=wall,
                device_ms=dev if seen else None, groups=grouped,
                top=[dict(name=k[:80], device_ms=ms, calls=n)
                     for ms, k, n in rows[:top]])


def families_phase(card: str):
    """Each family model once at full width and depth; returns its results
    and the launch counts of its run."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    results, counts = {}, {}
    for arch, want in FAMILY_KERNELS.items():
        cfg = get_config(arch)
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device="cuda").manual_seed(0)
        t0 = time.perf_counter()
        params = M.init_params(cfg, gen, "cuda")
        tokens = torch.randint(0, cfg.vocab_size, (FAM_B, FAM_S),
                               generator=gen, device="cuda",
                               dtype=torch.int32)
        family_run(cfg, params, tokens[:, :256], 2)     # warm-up, not timed
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        n_params = sum(t.numel() for t in params["layers"].values()) + \
            sum(params[k].numel() for k in ("embed", "unembed", "final_norm"))

        ops.reset_launches()
        logits, steps, toks, cache, prefill_s, decode_s = family_run(
            cfg, params, tokens, FAM_STEPS)
        launches = dict(ops.launches)
        routes = dict(ops.route_launches)
        peak = torch.cuda.max_memory_allocated()

        assert logits.shape == (FAM_B, 1, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all()), arch
        assert all(bool(torch.isfinite(lg).all()) for lg in steps), arch
        assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size
        specs = M.cache_specs(cfg, FAM_B, FAM_S + FAM_STEPS)
        assert {k: (tuple(t.shape), t.dtype) for k, t in cache.items()} \
            == specs, arch
        assert bool(torch.isfinite(cache["state"]).all()), arch
        for k in want:
            assert launches[k] == cfg.num_layers, (arch, k, launches[k])
        bad = [k for k in ops.KERNELS if k not in want and launches[k]]
        assert not bad, f"{arch}: unexpected launches {bad}"
        # both models' scans have Q 64, P 64 and N 128 / 16
        assert routes == {"ssd_scan:tc": cfg.num_layers,
                          "ssd_scan:scalar": 0}, (arch, routes)
        counts[arch] = {k: launches[k] for k in want}
        # where the time goes: one prefill and one decode step (the last
        # position again) under the profiler; the idle share compares the
        # device time with the unprofiled wall time above
        prof = {
            "prefill": device_profile(lambda: M.prefill(
                cfg, params, {"tokens": tokens}, FAM_S + FAM_STEPS),
                groups=FAMILY_GROUPS),
            "decode_step": device_profile(lambda: M.decode_step(
                cfg, params, cache, toks[:, -2], FAM_S + FAM_STEPS - 1))}
        for what, wall_ms in (("prefill", prefill_s * 1e3),
                              ("decode_step", decode_s * 1e3 / FAM_STEPS)):
            pr = prof[what]
            pr["unprofiled_wall_ms"] = wall_ms
            pr["device_idle_share"] = (None if pr["device_ms"] is None
                                       else 1.0 - pr["device_ms"] / wall_ms)
            print(f"  [{card}] {cfg.name} {what}: device busy "
                  f"{pr['device_ms']} ms of {wall_ms:.2f} ms wall (idle "
                  f"share {pr['device_idle_share']}); "
                  + "".join(f"{k} {g['device_ms']:.3f} ms in {g['calls']} "
                            "kernels; " for k, g in pr["groups"].items())
                  + "top kernels "
                  + "; ".join(f"{t['name']} {t['device_ms']:.3f} ms x"
                              f"{t['calls']}" for t in pr["top"]),
                  flush=True)
        results[arch] = dict(
            model=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
            params=n_params, batch=FAM_B, prompt_tokens=FAM_S,
            decode_steps=FAM_STEPS, setup_s=setup_s,
            prefill_ms=prefill_s * 1e3,
            prefill_tokens_per_s=FAM_B * FAM_S / prefill_s,
            decode_ms_per_step=decode_s * 1e3 / FAM_STEPS,
            decode_tokens_per_s=FAM_B * FAM_STEPS / decode_s,
            max_memory_allocated_bytes=peak, launches=counts[arch],
            routes=routes, profile=prof)
        print(f"  [{card}] {cfg.name}: {cfg.num_layers} layers, d_model "
              f"{cfg.d_model}, {n_params / 1e9:.3f} B params in bf16; "
              f"prefill {FAM_B} x {FAM_S} tokens {prefill_s * 1e3:.2f} ms "
              f"({FAM_B * FAM_S / prefill_s:.0f} tokens/s), decode "
              f"{decode_s * 1e3 / FAM_STEPS:.2f} ms per step "
              f"({FAM_B * FAM_STEPS / decode_s:.1f} tokens/s), peak device "
              f"memory {peak / 2**30:.2f} GiB; launches {counts[arch]}",
              flush=True)
        del params, cache, logits, steps
        gc.collect()
        torch.cuda.empty_cache()
    return results, counts


# ---------------------------------------------------------------------------
# phase 9: small models on the card equal the same models on the CPU
# ---------------------------------------------------------------------------

def family_check():
    """Small float32 Mamba2, Hymba and Mixtral models: prefill of 150
    tokens (the SSD scan pads its last chunk; Hymba's and Mixtral's
    64-token window bites and the SWA kernel's sequence is padded; the
    Mixtral MoE routes through its experts' capacity) and 3 decode steps
    give the same logits and caches on the card as on the CPU, to 1e-4."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import model as M

    torch.backends.cuda.matmul.allow_tf32 = False    # as the CPU reference
    out = {}
    for arch in (*FAMILY_KERNELS, "mixtral_8x22b"):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        tokens = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 150)), dtype=torch.int32)
        runs = {}
        for dev in ("cpu", "cuda"):
            p = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                     if isinstance(v, dict) else v.to(dev))
                 for k, v in params.items()}
            lg, steps, toks, cache, _, _ = family_run(cfg, p,
                                                      tokens.to(dev), 3)
            runs[dev] = [t.cpu() for t in [lg, *steps]], \
                {k: v.cpu() for k, v in cache.items()}
        (lc, cc), (lg, cg) = runs["cpu"], runs["cuda"]
        err = 0.0
        for a, b in list(zip(lg, lc)) + [(cg[k], cc[k]) for k in cc]:
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
            err = max(err, float((a.float() - b.float()).abs().max()))
        print(f"  {cfg.name} f32: prefill and 3 decode steps on the card "
              f"match the CPU (logits and caches {sorted(cc)}, max abs "
              f"difference {err:.3g})", flush=True)
        out[arch] = dict(max_abs_err=err)
    return out


# the small float32 models served on the card and on the CPU: dense, and
# MoE at the default capacity factor (1.25), so that experts drop entries
CHECK_TINY = dict(name="tiny-f32", arch_type="dense", num_layers=2,
                  d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                  vocab_size=128, dtype="float32")
CHECK_MODELS = (CHECK_TINY, dict(CHECK_TINY, name="tiny-moe-f32",
                                 arch_type="moe", num_experts=4,
                                 experts_per_token=2))


def check_phase():
    import torch

    from repro_torch.configs.base import ModelConfig

    # full float32 products on the card, like the CPU reference
    torch.backends.cuda.matmul.allow_tf32 = False
    return {m["name"]: serve_check(ModelConfig(**m)) for m in CHECK_MODELS}


def serve_check(cfg) -> dict:
    """``cfg`` served on the card (steps replayed from CUDA graphs) and on
    the CPU (eager, through the kernels' plain versions) on the same
    weights, with an fp16 and with an int8 host tier: the same tokens per
    request, offloads and uploads."""
    import torch

    from repro_torch.core.backend import TorchBackend
    from repro_torch.core.costmodel import A100_PCIE
    from repro_torch.core.engine import Engine, EngineConfig
    from repro_torch.core.temporal import TemporalConfig
    from repro_torch.data.workloads import build_workload
    from repro_torch.launch.serve import MCPFrontend
    from repro_torch.models import model as M

    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    result = {}
    for prec in ("fp16", "int8_host"):
        runs = {}
        for dev in ("cpu", "cuda"):
            ecfg = engine_cfg(EngineConfig, TemporalConfig, 96, 128, prec)
            p = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                     if isinstance(v, dict) else v.to(dev))
                 for k, v in params.items()}
            backend = TorchBackend(cfg, ecfg, A100_PCIE, device=dev,
                                   params=p)
            eng = Engine(ecfg, A100_PCIE, backend=backend)
            submit(MCPFrontend(eng), build_workload, 2, prompt_cap=48,
                   decode_cap=8)
            rep = eng.run(max_time=5000)
            runs[dev] = (rep, backend.generated)
        # the card's steps were replays of CUDA graphs
        replays = backend.steps.replays
        assert replays["decode"] > 0 and replays["prefill"] > 0, replays
        (rc, gc), (rg, gg) = runs["cpu"], runs["cuda"]
        assert rg["offloads"] >= 1 and rg["offloads"] == rc["offloads"]
        assert rg["uploads"] == rc["uploads"]
        assert gg == gc, f"{prec}: tokens on the card differ from the CPU"
        n = sum(len(t) for t in gg.values())
        print(f"  {cfg.name} {prec}: {n} tokens of {len(gg)} requests "
              f"identical on the card (steps replayed from CUDA graphs: "
              f"{replays}; buckets {backend.steps.captures}) and on the CPU "
              f"(eager), offloads {rg['offloads']}, uploads {rg['uploads']}",
              flush=True)
        result[prec] = dict(requests=len(gg), tokens=n,
                            offloads=rg["offloads"], uploads=rg["uploads"],
                            replays=dict(replays))
    return result


def frontdoor_trace(cfg, params, device) -> dict:
    """A ``FrontDoor.drive`` trace (virtual time) on the front door's
    engine: two requests sharing 40 prompt tokens (two blocks and half a
    third: a prefix hit and a copy-on-write fork) under continuous
    batching, a session whose turn-end offload and predictive warm come
    before its second turn, and a repeat served from the response cache.
    Returns every response's tokens, the backend's tokens per request and
    the engine's, the sessions' and the front door's counters."""
    import numpy as np

    from repro_torch.launch.http_server import FrontDoor
    from repro_torch.launch.response_cache import ResponseCache

    rng = np.random.default_rng(3)

    def toks(n):
        return [int(t) for t in rng.integers(0, cfg.vocab_size, n)]
    eng, backend = frontdoor_engine(cfg, params, device, 96, 64)
    fd = FrontDoor(eng, cache=ResponseCache(ttl=None))
    shared, p1 = toks(40), toks(44)
    a = {"prompt": shared + toks(9), "max_tokens": 8}
    fd.submit(a, arrival=0.0)
    fd.submit({"prompt": shared + toks(12), "max_tokens": 8}, arrival=0.05)
    s1 = fd.submit({"prompt": p1, "max_tokens": 8, "session_id": "s"},
                   arrival=0.1)
    fd.drive()
    fd.submit(a)
    p2 = p1 + list(backend.generated[s1.rid][:8]) + toks(16)
    fd.submit({"prompt": p2, "max_tokens": 8, "session_id": "s"},
              arrival=s1.finish + FD_GAP_S)
    rep = fd.drive()
    out = dict(responses={g.gid: (g.status, g.result["tokens"])
                          for g in fd.gens.values()},
               generated={r: list(t) for r, t in backend.generated.items()},
               metrics=dict(eng.metrics), sessions=dict(eng.session_metrics),
               front={k: rep[k] for k in ("accepted", "completed",
                                          "cache_hits", "outstanding")})
    backend.cache = None
    return out


def frontdoor_check() -> dict:
    """``frontdoor_trace`` of the small float32 dense model on the card
    (steps replayed from CUDA graphs) and on the CPU (plain versions), on
    the same weights: the same tokens per request and the same counters;
    the trace forked, warmed its session and hit the response cache."""
    import torch

    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import model as M

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(**CHECK_TINY)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    runs = {}
    for dev in ("cpu", "cuda"):
        p = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                 if isinstance(v, dict) else v.to(dev))
             for k, v in params.items()}
        runs[dev] = frontdoor_trace(cfg, p, dev)
    cpu, card = runs["cpu"], runs["cuda"]
    assert card == cpu, "the front door's trace on the card differs from " \
        "the CPU's"
    m, sess, front = card["metrics"], card["sessions"], card["front"]
    assert m["cow_forks"] >= 1 and sess["session_warms"] == 1, (m, sess)
    assert front["cache_hits"] == 1 and front["outstanding"] == 0, front
    n = sum(len(t) for t in card["generated"].values())
    print(f"  {cfg.name} front door: {n} tokens of "
          f"{len(card['generated'])} requests and every counter identical "
          f"on the card and on the CPU (cow_forks {m['cow_forks']}, "
          f"session offloads {sess['session_offloads']} / warms "
          f"{sess['session_warms']}, cache hits {front['cache_hits']})",
          flush=True)
    return dict(requests=len(card["generated"]), tokens=n,
                cow_forks=m["cow_forks"], sessions=sess, front=front)


def serving_phases(card: str, launches: dict, phase_s: dict):
    """Phases 4-9: the bf16 step check, the two Qwen2.5-14B serve phases
    (the graph phase after the first), the front door on their weights,
    the Kimi-K2 serve, the families phase and the check phase. Adds their
    launch counts to ``launches`` (each serve's counts zeroed before it
    and read after it, then summed) and their wall times to ``phase_s``;
    returns (step check, serve, migration, families, check);
    ``serve["frontdoor"]`` and ``serve["kimi"]`` hold those phases."""
    import torch

    t0 = time.perf_counter()
    print(f"[step check] bf16, Qwen2.5-14B's widths, {STEP_LAYERS} layers: "
          f"each step through the kernels and through their plain versions",
          flush=True)
    checked = step_check(card)
    gc.collect()
    torch.cuda.empty_cache()
    phase_s["step_check"] = time.perf_counter() - t0

    serve, migration, params = {}, {}, None
    for prec in ("fp16", "int8_host"):
        t0 = time.perf_counter()
        print(f"[serve {prec}]", flush=True)
        serve[prec], counts, backend = serve_phase(card, prec, params)
        for k in SERVE_KERNELS[prec]:
            launches[k] = launches.get(k, 0) + counts[k]
        if prec == "fp16":
            print("[graphs] the compiled steps at the serve's shape, on its "
                  "weights and pools", flush=True)
            serve[prec]["graphs"] = graph_phase(
                card, backend.cfg, backend.params, backend.cache.k,
                backend.cache.v)
        migration[prec] = migration_times(card, backend.cache)
        params = backend.params
        backend.cache = None          # free the pools before the next phase
        del backend
        gc.collect()
        torch.cuda.empty_cache()
        phase_s[f"serve_{prec}"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    print(f"[front door] Qwen2.5-14B behind HttpServer on 127.0.0.1, "
          f"continuous batching, sessions, prefix and response caches; "
          f"client order (b) (c) (a) (d)", flush=True)
    serve["frontdoor"], counts = frontdoor_phase(card, params)
    for k in SERVE_KERNELS["fp16"]:
        launches[k] += counts[k]
    phase_s["frontdoor"] = time.perf_counter() - t0
    del params
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    print(f"[serve kimi] Kimi-K2 at full width, {KIMI_LAYERS} layers, "
          f"{KIMI_APPS} apps, decode segments cut to {KIMI_DECODE}",
          flush=True)
    serve["kimi"], counts = kimi_phase(card)
    serve["kimi"]["launches_of_path"] = {k: counts[k]
                                         for k in SERVE_KERNELS["fp16"]}
    for k in SERVE_KERNELS["fp16"]:
        launches[k] += counts[k]
    phase_s["serve_kimi"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    print(f"[families] {FAM_B} prompts of {FAM_S} tokens, then {FAM_STEPS} "
          f"greedy decode steps; wall times end in a synchronise", flush=True)
    families, counts = families_phase(card)
    for arch_counts in counts.values():
        for k, n in arch_counts.items():
            launches[k] = launches.get(k, 0) + n
    phase_s["families"] = time.perf_counter() - t0

    print("[check]", flush=True)
    check = check_phase()
    check["frontdoor"] = frontdoor_check()
    check["families"] = family_check()
    return checked, serve, migration, families, check


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the full results to this JSON file")
    ap.add_argument("--only", choices=("kernels",), default=None,
                    help="kernels: run only the device, build and kernel "
                         "phases (launch counts are then the kernel "
                         "phase's), then print the same closing lines")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import build, ops

    t_start = time.perf_counter()
    card = smi()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {card} | torch {torch.__version__} CUDA "
          f"{torch.version.cuda} | {kind} x{torch.cuda.device_count()}",
          flush=True)

    t0 = time.perf_counter()
    logs = build.build()
    build_s = time.perf_counter() - t0
    print(f"[build] {len(logs)} libraries built in {build_s:.1f} s "
          f"(nvcc {' '.join(build.NVCC_FLAGS)})", flush=True)
    for name in build.SOURCES:
        for line in build.ptxas_report(name).splitlines():
            if "Compiling entry" in line or "Used" in line \
                    or "spill" in line:
                print(f"  {name}: {line.strip()}")
    tc = tc_resources(build.ptxas_report)
    for label, res in tc.items():
        print(f"  tensor cores: {label}: {res}", flush=True)
    writes = tc_resources(build.ptxas_report, WRITE_KERNELS)
    for label, res in writes.items():
        print(f"  KV writes: {label}: {res}", flush=True)

    print("[kernels] main-path shapes, bf16 timings: ms is the kernel in a "
          "CUDA graph; eager, plain and library are eager calls on the same "
          "inputs", flush=True)
    ops.reset_launches()
    rows = kernel_phase()
    phase_s = {"kernels": time.perf_counter() - t_start}

    if args.only == "kernels":
        launches = dict(ops.launches)
        checked = serve = migration = families = check = None
    else:
        launches = {k: ops.launches[k] for k in KERNEL_PHASE_ONLY}
        checked, serve, migration, families, check = serving_phases(
            card, launches, phase_s)

    if serve is not None:            # the D 112 rows ran in the Kimi serve
        for name, n in serve["kimi"]["launches_of_path"].items():
            if "d112" in rows[name]:
                rows[name]["d112"]["launches"] = n
    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        r = rows[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=r["max_abs_err_bf16"],
            max_err=r["max_abs_err_bf16"],
            max_abs_err_f32=r["max_abs_err_f32"], ms=r["ms"],
            eager_ms=r["eager_ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"],
            library_call=r["library_call"]))
        for extra in ("shape", "ctx256", "d112", "m1", "m1536", "splits",
                      "vs_f64_f32", "vs_f64_bf16", "vs_plain_f32",
                      "vs_plain_bf16",
                      "launch_ms_f32", "launch_ms_bf16", "library_graph_ms",
                      "mismatches_bf16", "mismatches_f32"):
            if extra in r:
                kernels[-1][extra] = r[extra]
        if "hymba" in r:           # the line carries no counted flops
            kernels[-1]["hymba"] = {k: v for k, v in r["hymba"].items()
                                    if k != "data_flops"}
        if "int8_vs_float_max_abs_err_bf16" in r:
            kernels[-1].update(
                int8_vs_float_max_abs_err=r["int8_vs_float_max_abs_err_bf16"],
                int8_vs_float_max_abs_err_f32=r[
                    "int8_vs_float_max_abs_err_f32"])
    total_s = time.perf_counter() - t_start
    results = dict(card=card, device=kind, torch=torch.__version__,
                   cuda=torch.version.cuda, build_s=build_s,
                   total_s=total_s, phase_s=phase_s, ptxas_tc=tc,
                   ptxas_writes=writes,
                   kernels=kernels, step_check=checked,
                   ssd_data_flops={
                       v: rows["ssd_scan"].get(v, rows["ssd_scan"])[
                           "data_flops"] for v in ("mamba2", "hymba")},
                   serve=serve, migration=migration, families=families,
                   check=check)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(results, indent=1))
    print(f"[done] {total_s:.1f} s in all", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
