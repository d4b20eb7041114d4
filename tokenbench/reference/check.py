"""The comparison that decides ``correct``.

For each judged request the reference runs once over the sequence the
served model decoded through, ``prompt + [prompt[-1]] + served[:-1]``
(the serving package feeds the last prompt token again at the first
decode position), and reads at every judged position the gap by which
the served token's logit lies below the reference's best. The widest gap
over all judged tokens is the number compared with the cell's limit.

The control reads, at the same positions of the same sequences, the gap
of the token that the reference computed in fp8 puts first.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from tokenbench.reference.decoder import Reference


def sequence(prompt: List[int], served: List[int], vocab: int) -> List[int]:
    toks = [t % vocab for t in prompt]
    return toks + [toks[-1]] + list(served[:-1])


def gaps(s: dict, params: dict, items, control: Optional[str] = None):
    """Per judged token, the reference's best logit minus its logit of the
    token read: the served token, or with ``control`` the argmax of the
    reference computed at that precision. ``items``: (prompt, served).
    Returns one tensor of gaps per item."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        ref = Reference(s, params)
        low = Reference(s, params, control) if control else None
        out = []
        with torch.no_grad():
            for prompt, served in items:
                seq = sequence(prompt, served, s["vocab"])
                rows = range(len(prompt), len(prompt) + len(served))
                lg = ref.logits(seq, rows)
                pick = (low.logits(seq, rows).argmax(-1) if low is not None
                        else torch.as_tensor(served, device=lg.device))
                out.append((lg.max(-1).values
                            - lg.gather(-1, pick[:, None])[:, 0]).cpu())
                del lg
        return out
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
         ) = flags
