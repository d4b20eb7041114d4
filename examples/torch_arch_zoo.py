"""Architecture zoo on the PyTorch port: run any assigned architecture end
to end.

    python examples/torch_arch_zoo.py --arch mixtral-8x22b
    python examples/torch_arch_zoo.py --all
    python examples/torch_arch_zoo.py --device cpu --arch glm4_9b

Instantiates the reduced smoke variant with random weights, computes the
training loss of one batch, prefills it and decodes one token, and prints
the full config's size. On the card unless ``--device cpu`` (the
windowed and SSM prefills then run the sliding-window and SSD-scan
kernels); without a card and without ``--device cpu`` it fails.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs.base import (ARCH_ALIASES, ARCH_IDS, INPUT_SHAPES,
                                      get_config, get_smoke_config)
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import model as M

SEQ = 64


@torch.no_grad()
def run_arch(arch: str, device: torch.device):
    cfg = get_smoke_config(arch)
    full = get_config(arch)
    params = M.init_params(cfg, torch.Generator(device).manual_seed(0),
                           device)
    batch = {k: v.to(device) for k, v in
             TokenPipeline(cfg, 2, SEQ, seed=0).next_batch().items()}
    t0 = time.perf_counter()
    loss, _ = M.loss_fn(cfg, params, batch)
    # positions cached after the prefill: the patches ahead of the text
    cached = SEQ + (cfg.num_patch_tokens if cfg.arch_type == "vlm" else 0)
    prompt = {k: v for k, v in batch.items() if k != "targets"}
    logits, cache = M.prefill(cfg, params, prompt, cache_size=cached + 32)
    tok = logits[:, -1].argmax(-1).to(torch.int32)
    lg, _ = M.decode_step(cfg, params, cache, tok, cached)
    if not (torch.isfinite(loss) and torch.isfinite(lg.float()).all()):
        raise RuntimeError(f"{arch}: non-finite loss or decode logits")
    dt = time.perf_counter() - t0
    print(f"{full.name:24s} [{full.arch_type:6s}] "
          f"{full.num_layers}L d{full.d_model} "
          f"params={full.param_count()/1e9:7.1f}B "
          f"active={full.active_param_count()/1e9:6.1f}B | "
          f"smoke loss={float(loss):.2f} decode ok ({dt:.1f}s)", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_arch_zoo: no CUDA device; pass --device cpu "
                         "to run on the CPU")
    archs = ARCH_IDS if (args.all or not args.arch) else \
        [ARCH_ALIASES.get(args.arch, args.arch).replace("-", "_")]
    print(f"{len(archs)} architecture(s) on {args.device}; serving shapes: "
          f"{', '.join(INPUT_SHAPES)}\n")
    for a in archs:
        run_arch(a, device)


if __name__ == "__main__":
    main()
