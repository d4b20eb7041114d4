"""Training on the PyTorch port: pretrain a small model on the
synthetic pipeline.

Default is a mamba2-family smoke model widened to 4 layers (a few hundred
steps in minutes); ``--arch`` selects any assigned architecture's reduced
variant, ``--full-130m`` runs the real mamba2-130m config. On the card
unless ``--device cpu``; without a card and without ``--device cpu`` it
fails.

    python examples/torch_train_small.py --steps 200
    python examples/torch_train_small.py --device cpu --steps 3
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.train import optimizer as O
from repro_torch.train.train_loop import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2_130m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--schedule", default="wsd",
                    choices=["wsd", "cosine", "const"])
    ap.add_argument("--full-130m", action="store_true")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full_130m \
        else get_smoke_config(args.arch)
    # widen the smoke config slightly so the loss curve is interesting
    if not args.full_130m:
        cfg = dataclasses.replace(cfg, num_layers=4)

    opt = O.AdamWConfig(lr=args.lr, schedule=args.schedule,
                        warmup_steps=max(args.steps // 20, 5),
                        total_steps=args.steps,
                        state_dtype=cfg.optimizer_state_dtype)
    pipe = TokenPipeline(cfg, args.batch, args.seq, seed=0)
    print(f"training {cfg.name} ({cfg.num_layers}L d{cfg.d_model}, "
          f"{args.schedule} schedule) for {args.steps} steps on "
          f"{args.device}")
    params, _, hist = train(cfg, opt, iter(pipe), num_steps=args.steps,
                            device=args.device,
                            log_every=max(args.steps // 20, 1),
                            checkpoint_path=args.checkpoint,
                            checkpoint_every=100 if args.checkpoint else 0)
    first, last = hist[0]["loss"], hist[-1]["loss"]
    print(f"\nloss {first:.3f} -> {last:.3f} "
          f"({'improved' if last < first else 'no improvement'})")
    return hist


if __name__ == "__main__":
    main()
