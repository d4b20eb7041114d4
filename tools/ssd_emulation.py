#!/usr/bin/env python3
"""How far the SSD scan's tensor-core arithmetic lands from float64, on the
CPU.

    PYTHONPATH=src python3 tools/ssd_emulation.py

Runs ``emulate_ssd_tc`` of ``tests/torch_ssd_emulation.py`` (the arithmetic
of ``csrc/ssd_scan.cu``'s tensor-core route in plain torch) with float32
operands split into three bf16 parts, as the kernel splits them, and into
two (three MMAs per product), beside the float32 chunked scan with the
decay exponents taken as differences of the in-chunk cumsum (the scalar
route's and the Pallas kernel's order) and the float32 token loop, on
``test_ssd_tc_emulation_at_model_widths``' inputs: B 1, S 256, P 64,
Q 64 at Mamba2-130M's widths (H 24, N 128, A down to -24) and
Hymba-1.5B's (H 50, N 16, A down to -50), f32 and bf16 x. Prints, for each,
the max abs distance of y and of the final state from the plain version
run in float64. About a minute. ``tools/ssd_breakdown.py`` reads the same
on the card at the families phase's full shapes.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))


def main() -> int:
    import numpy as np
    import torch

    import torch_ssd_emulation as E
    from repro_torch.kernels import ref as R

    for dt in ("f32", "bf16"):
        for arch, h, n, a_scale in (("mamba2_130m", 24, 128, 24),
                                    ("hymba_1_5b", 50, 16, 50)):
            x, *rest = (torch.from_numpy(t.astype(np.float32)) for t in
                        E.ssd_inputs(np.random.default_rng(22), 1, 256, h,
                                     64, n, a_scale))
            if dt == "bf16":
                x = x.bfloat16()
            want = R.ssd_scan_ref(x, *rest, dtype=torch.float64)
            runs = {
                "tensor cores, three-part": E.emulate_ssd_tc(x, *rest),
                "tensor cores, two-part": E.emulate_ssd_tc(x, *rest,
                                                           parts=2),
                "f32 cumsum order": E.emulate_ssd_cumsum_f32(x, *rest),
                "f32 token loop": R.ssd_scan_ref(x, *rest)}
            for label, got in runs.items():
                y, st = (float((g.double() - w).abs().max())
                         for g, w in zip(got, want))
                print(f"{arch} {dt} x  {label:26s} y {y:.3g}  state "
                      f"{st:.3g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
