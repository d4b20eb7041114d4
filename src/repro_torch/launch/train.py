"""Training launcher.

Trains the selected architecture at smoke or full scale on one device
(the card unless ``--device cpu``); one device needs no mesh. ``--scale
full`` turns activation rematerialisation on, as ``--remat`` does.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm_2b \\
        --steps 100 --batch 8 --seq 256
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 3
"""
from __future__ import annotations

import argparse

from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import decoder as DEC
from repro_torch.train import optimizer as O
from repro_torch.train.train_loop import train


def main(argv=None, on_step=None):
    """Parse ``argv`` (default: the command line) and train. ``on_step``
    goes to ``train``. Returns (params, opt_state, history)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm_2b")
    ap.add_argument("--scale", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--schedule", default="wsd")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.scale == "full" \
        else get_smoke_config(args.arch)
    DEC.set_remat(args.remat or args.scale == "full")

    opt = O.AdamWConfig(lr=args.lr, schedule=args.schedule,
                        warmup_steps=max(args.steps // 20, 5),
                        total_steps=args.steps,
                        state_dtype=cfg.optimizer_state_dtype)
    pipe = TokenPipeline(cfg, args.batch, args.seq, seed=0)
    print(f"training {cfg.name} for {args.steps} steps "
          f"(batch {args.batch} x seq {args.seq}, {args.schedule}) on "
          f"{args.device}")
    try:
        out = train(cfg, opt, iter(pipe), num_steps=args.steps,
                    device=args.device,
                    log_every=max(args.steps // 20, 1),
                    checkpoint_path=args.checkpoint,
                    checkpoint_every=100 if args.checkpoint else 0,
                    on_step=on_step)
    finally:
        DEC.set_remat(False)
    print(f"final loss {out[2][-1]['loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
