"""End-to-end serving with REAL compute, on the PyTorch port.

A small GQA model (the glm4_9b smoke config) serves batched multi-agent
requests through the full TokenCake stack: the paged KV cache in device
tensors, the hand-written CUDA kernels of the decode and prefill steps
(replayed from CUDA graphs), real host offload and upload through the
block-migration kernels, both schedulers live. On the card unless
``--device cpu``, where the kernels' plain PyTorch versions run; without a
card and without ``--device cpu`` it fails.

    python examples/torch_serve_multiagent.py [--apps 3]
    python examples/torch_serve_multiagent.py --device cpu --apps 2
    python examples/torch_serve_multiagent.py --device cpu --arch hymba_1_5b

Every arch serves as in the JAX package's example: windowed, hybrid,
VLM, SSM and audio archs prefill one request at a time through the
dense-cache prefill, and SSM and audio archs decode no token.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs.base import get_smoke_config
from repro_torch.core.backend import TorchBackend
from repro_torch.core.costmodel import A100_PCIE
from repro_torch.core.engine import Engine, EngineConfig
from repro_torch.core.temporal import TemporalConfig
from repro_torch.data.workloads import build_workload


def main(argv=None):
    """Parse ``argv`` (default: the command line), serve, print the report.
    Returns (engine report, backend)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--apps", type=int, default=3)
    ap.add_argument("--arch", default="glm4_9b",
                    help="any assigned arch id (reduced smoke variant)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    ecfg = EngineConfig.preset(
        "tokencake", gpu_blocks=128, host_blocks=256, max_running=8,
        temporal=TemporalConfig(score_threshold=-1.0, pressure_watermark=0.0))
    backend = TorchBackend(cfg, ecfg, A100_PCIE, device=args.device)
    eng = Engine(ecfg, A100_PCIE, backend=backend)

    print(f"serving {args.apps} deep-research apps on {cfg.name} "
          f"({cfg.num_layers}L d{cfg.d_model}) with real paged KV on "
          f"{args.device}...\n")
    for t, g in build_workload("deep_research", qps=2.0, n_apps=args.apps,
                               seed=0):
        for n in g.nodes.values():   # shrink for the 128-block pool
            n.prompt_len = min(n.prompt_len, 64)
            n.decode_segments = [min(s, 16) for s in n.decode_segments]
        eng.submit_app(g, t)

    t0 = time.perf_counter()
    rep = eng.run(max_time=5000)
    wall = time.perf_counter() - t0
    print(f"apps finished      {rep['apps_finished']}/{args.apps}")
    print(f"decoded tokens     {rep['decoded_tokens']}")
    print(f"offload cycles     {rep['offloads']} "
          f"(real D2H/H2D through the block-migration kernels)")
    print(f"virtual latency    avg {rep['avg_latency']:.1f}s")
    print(f"wall time          {wall:.1f}s ({args.device})")
    # prove generations exist
    for rid, toks in list(backend.generated.items())[:3]:
        print(f"  {rid}: generated {len(toks)} tokens, tail {toks[-5:]}")
    return rep, backend


if __name__ == "__main__":
    main()
