#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if anything is off:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; no CUDA device -> exit 1 before any result is printed;
2. build: every CUDA kernel of the serving path, from ``src/repro_torch/
   kernels/csrc`` with nvcc (all sources in parallel), and nvcc's ptxas
   register/spill report;
3. kernels: each kernel at the serving path's shapes for Qwen2.5-14B
   (bf16, and float32 for correctness), held against its plain PyTorch
   version (exact for writes and copies; 2e-3 bf16 / 3e-5 f32 for the
   attention kernels; the block copies on pools of the serve phase's size,
   whose byte offsets pass 2**31) and timed with CUDA events: the kernel
   alone inside a CUDA graph, and, called eagerly, its wrapper, its plain
   version and one PyTorch library call computing the same function;
   beside them its bound (bytes over 3.35 TB/s or flops over the peak of
   the type);
4. serve: four deep_research apps through the tokencake engine with
   ``TorchBackend`` at Qwen2.5-14B's full width and depth (48 layers,
   random bf16 weights from seed 0), a 2048-block device pool and a
   1024-block pinned host pool; launch counts are zeroed just before and
   read just after, and every kernel must have run, with at least one
   offload and no truncated prompt;
5. check: a small float32 model served on the card gives the same tokens
   as the same model on the CPU through the kernels' plain versions.

Prints one ``{"kernels": [...]}`` line, then the card's name and power
limit, then, last, ``{"ok": true, "device": {...}}``. ``--out PATH`` also
writes the full results as JSON. Engine latencies in the serve report are
virtual time from the A100 cost model, not card time.
"""
from __future__ import annotations

import argparse
import json
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

# bf16: kernel and plain version both accumulate in f32 and round once, so
# they differ by at most one bf16 step of the output (measured <= 4.9e-4)
TOL = {"bf16": dict(atol=2e-3, rtol=2e-3), "f32": dict(atol=3e-5, rtol=3e-5)}

KERNEL_INFO = {   # name -> (CUDA source, the Pallas kernel it replaces)
    "kv_token_write": ("src/repro_torch/kernels/csrc/kv_write.cu",
                       "src/repro/kernels/kv_write.py:276"),
    "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:293"),
    "kv_chunk_write": ("src/repro_torch/kernels/csrc/kv_write.cu",
                       "src/repro/kernels/kv_write.py:221"),
    "paged_prefill_attention": (
        "src/repro_torch/kernels/csrc/paged_prefill.cu",
        "src/repro/kernels/paged_prefill.py:290"),
    "block_gather_layers": ("src/repro_torch/kernels/csrc/block_copy.cu",
                            "src/repro/kernels/block_copy.py:41"),
    "block_scatter_layers": ("src/repro_torch/kernels/csrc/block_copy.cu",
                             "src/repro/kernels/block_copy.py:63"),
}


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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
    cost of each launch is not in it."""
    import torch
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
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
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as R

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    td = torch.bfloat16 if dt == "bf16" else torch.float32
    es = torch.finfo(td).bits // 8
    row = HKV * D * es
    rng = np.random.default_rng(0)

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
        nbytes=4 * (B - 2) * row + 4 * B, flops=0.0))

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
    cases.append(dict(
        name="paged_attention", kind="attn", targets=(),
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
        nbytes=4 * int(counts.sum()) * row + 4 * (B * pp + 2 * B),
        flops=0.0))

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
        library_call="index_select", nbytes=moved, flops=0.0))
    cases.append(dict(
        name="block_scatter_layers", kind="scatter", targets=(pools,),
        kernel=lambda: ops.block_scatter_layers(pools, idx, staging),
        plain=lambda: R.block_scatter_layers_ref(pools, idx, staging),
        library=lambda: pools.index_copy_(1, idx64, staging),
        library_call="index_copy_", nbytes=moved, flops=0.0))
    return cases


def check_case(case: dict, dt: str) -> float:
    """Kernel and plain version on the same inputs; returns the max abs
    difference and raises if it is outside the tolerance. In-place writes
    start from the same snapshot of their pools; decode-write pools are
    compared on every page but the scratch page."""
    import torch

    if case["kind"] in ("attn", "copy"):
        got, want = case["kernel"](), case["plain"]()
        torch.cuda.synchronize()
        if case["kind"] == "copy":
            assert torch.equal(got, want), case["name"]
        torch.testing.assert_close(got.float(), want.float(), **TOL[dt])
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


def kernel_phase():
    rows = {}
    for dt in ("f32", "bf16"):
        for case in kernel_cases(dt):
            err = check_case(case, dt)
            row = rows.setdefault(case["name"], {"name": case["name"]})
            row[f"max_abs_err_{dt}"] = err
            if dt != "bf16":
                continue
            row.update(
                ms=graph_ms(case["kernel"]), eager_ms=cuda_ms(case["kernel"]),
                plain_ms=cuda_ms(case["plain"]),
                library_ms=cuda_ms(case["library"]),
                library_call=case["library_call"], nbytes=case["nbytes"],
                flops=case["flops"])
            row["bound_ms"], row["bound_by"] = bound_ms(
                case["nbytes"], case["flops"], dt)
            print(f"  {case['name']:24s} bf16 {row['ms']:.4f} ms  eager "
                  f"{row['eager_ms']:.4f}  plain {row['plain_ms']:.4f}  "
                  f"library {row['library_ms']:.4f}"
                  f"  bound {row['bound_ms']:.4f} ({row['bound_by']})  "
                  f"err bf16 {err:.3g} f32 {row['max_abs_err_f32']:.3g}",
                  flush=True)
    return rows


# ---------------------------------------------------------------------------
# phase 4: serve through the engine at Qwen2.5-14B's full size
# ---------------------------------------------------------------------------

def engine_cfg(EngineConfig, TemporalConfig, gpu_blocks, host_blocks):
    return EngineConfig.preset(
        "tokencake", gpu_blocks=gpu_blocks, host_blocks=host_blocks,
        max_running=8,
        temporal=TemporalConfig(score_threshold=-1.0, pressure_watermark=0.0))


def submit(front, build_workload, n_apps, prompt_cap, decode_cap):
    for t, g in build_workload("deep_research", qps=2.0, n_apps=n_apps,
                               seed=0):
        for node in g.nodes.values():
            node.prompt_len = min(node.prompt_len, prompt_cap)
            node.decode_segments = [min(s, decode_cap)
                                    for s in node.decode_segments]
        front.register_graph(g, t)


def serve_phase(card: str):
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

    n_apps = 4
    cfg = get_config("qwen2_5_14b_serving")
    ecfg = engine_cfg(EngineConfig, TemporalConfig, GPU_BLOCKS, HOST_BLOCKS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    backend = TorchBackend(cfg, ecfg, A100_PCIE, seed=0, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in backend.params["layers"].values()) + \
        sum(backend.params[k].numel()
            for k in ("embed", "unembed", "final_norm"))
    print(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.2f} B params in bf16, pools "
          f"{tuple(backend.cache.k.shape)} x2, host pool pinned="
          f"{backend.cache.host_k.is_pinned()}; set-up {setup_s:.1f} s",
          flush=True)
    eng = Engine(ecfg, A100_PCIE, backend=backend)
    front = MCPFrontend(eng)
    submit(front, build_workload, n_apps, prompt_cap=256, decode_cap=32)

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
    missing = [k for k, v in launches.items() if v <= 0]
    assert not missing, f"kernels never launched on the main path: {missing}"
    for rid, toks in backend.generated.items():
        assert toks and all(0 <= t < cfg.vocab_size for t in toks), rid
    for rid, logits in backend.last_prefill_logits.items():
        assert logits.shape == (cfg.vocab_size,), rid
        assert bool(np.isfinite(logits).all()), rid
    generated = sum(len(t) for t in backend.generated.values())
    peak = torch.cuda.max_memory_allocated()
    out = dict(
        model=cfg.name, apps=n_apps, apps_finished=rep["apps_finished"],
        decoded_tokens=rep["decoded_tokens"], generated_tokens=generated,
        offloads=rep["offloads"], uploads=rep["uploads"],
        wall_s=wall, setup_s=setup_s,
        generated_tokens_per_wall_s=generated / wall,
        max_memory_allocated_bytes=peak, launches=launches,
        virtual_avg_latency_s=rep["avg_latency"],
        virtual_p90_latency_s=rep["p90_latency"])
    print(f"  [{card}] wall {wall:.2f} s for {generated} generated tokens "
          f"({generated / wall:.1f} tokens per wall second), peak device "
          f"memory {peak / 2**30:.2f} GiB", flush=True)
    print(f"  apps {rep['apps_finished']}/{n_apps}, engine decoded_tokens "
          f"{rep['decoded_tokens']}, offloads {rep['offloads']}, uploads "
          f"{rep['uploads']}; engine latency (virtual time, A100 cost "
          f"model, not card time) avg {rep['avg_latency']:.1f} s", flush=True)
    print(f"  launches on the main path: {launches}", flush=True)
    return out, launches


# ---------------------------------------------------------------------------
# phase 5: a small model on the card equals the same model on the CPU
# ---------------------------------------------------------------------------

def check_phase():
    import torch

    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.backend import TorchBackend
    from repro_torch.core.costmodel import A100_PCIE
    from repro_torch.core.engine import Engine, EngineConfig
    from repro_torch.core.temporal import TemporalConfig
    from repro_torch.data.workloads import build_workload
    from repro_torch.launch.serve import MCPFrontend
    from repro_torch.models import model as M

    # full float32 products on the card, like the CPU reference
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(name="tiny-f32", arch_type="dense", num_layers=2,
                      d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                      vocab_size=128, dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    runs = {}
    for dev in ("cpu", "cuda"):
        ecfg = engine_cfg(EngineConfig, TemporalConfig, 96, 128)
        p = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                 if isinstance(v, dict) else v.to(dev))
             for k, v in params.items()}
        backend = TorchBackend(cfg, ecfg, A100_PCIE, device=dev, params=p)
        eng = Engine(ecfg, A100_PCIE, backend=backend)
        submit(MCPFrontend(eng), build_workload, 2, prompt_cap=48,
               decode_cap=8)
        rep = eng.run(max_time=5000)
        runs[dev] = (rep, backend.generated)
    (rc, gc), (rg, gg) = runs["cpu"], runs["cuda"]
    assert rg["offloads"] >= 1 and rg["offloads"] == rc["offloads"]
    assert gg == gc, "tokens on the card differ from the CPU reference"
    n = sum(len(t) for t in gg.values())
    print(f"  tiny-f32: {n} tokens of {len(gg)} requests identical on the "
          f"card and on the CPU, offloads {rg['offloads']}", flush=True)
    return dict(requests=len(gg), tokens=n, offloads=rg["offloads"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the full results to this JSON file")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import build

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

    print("[kernels] main-path shapes, bf16 timings: ms is the kernel in a "
          "CUDA graph; eager, plain and library are eager calls on the same "
          "inputs", flush=True)
    rows = kernel_phase()

    print("[serve]", flush=True)
    serve, launches = serve_phase(card)

    print("[check]", flush=True)
    check = check_phase()

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
    total_s = time.perf_counter() - t_start
    results = dict(card=card, device=kind, torch=torch.__version__,
                   cuda=torch.version.cuda, build_s=build_s,
                   total_s=total_s, kernels=kernels, serve=serve,
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
