"""The comparison that decides ``correct``.

For each judged request the reference runs once over the sequence the
served model decoded through, ``prompt + [prompt[-1]] + served[:-1]``
(the serving package feeds the last prompt token again at the first
decode position), and reads at every judged position the gap by which
the served token's logit lies below the reference's best. The widest gap
over all judged tokens is the number compared with the cell's limit.

The control reads, at the same positions of the same sequences, the gap
of the token that the reference computed in fp8 puts first; the witness
the gap of the token that the reference with split-K products puts
first. For a routed model each judged token also carries the
reference's smallest route margin over the layers at its position.
"""
from __future__ import annotations

import time
from typing import List

import torch

from tokenbench.reference.decoder import Reference


def sequence(prompt: List[int], served: List[int], vocab: int) -> List[int]:
    toks = [t % vocab for t in prompt]
    return toks + [toks[-1]] + list(served[:-1])


# the reference computed another way and read in the program's place:
# the fp8 control and the split-K witness
VARIANTS = {"fp8": {"quant": "fp8"}, "splitk": {"order": "splitk"}}


def gaps(s: dict, params: dict, items, sides=(None,)):
    """Per judged token, the reference's best logit minus its logit of the
    token read, for each side of ``sides``: the served token (None), or
    the argmax of the reference computed another way (a key of
    ``VARIANTS``). The reference runs once per item for every side.
    ``items``: (prompt, served). Returns per item a dict of gaps by side,
    the reference's route margins at the same positions (None for a dense
    model), and the seconds its one pass over the item took."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        ref = Reference(s, params)
        low = {side: Reference(s, params, **VARIANTS[side])
               for side in sides if side is not None}
        out = []
        with torch.no_grad():
            for prompt, served in items:
                seq = sequence(prompt, served, s["vocab"])
                rows = range(len(prompt), len(prompt) + len(served))
                t = time.perf_counter()
                lg, margin = ref.logits(seq, rows)
                best = lg.max(-1).values
                if best.is_cuda:
                    torch.cuda.synchronize(best.device)
                seconds = time.perf_counter() - t
                read = {}
                for side in sides:
                    pick = (low[side].logits(seq, rows)[0].argmax(-1)
                            if side is not None
                            else torch.as_tensor(served, device=lg.device))
                    read[side] = (best - lg.gather(-1, pick[:, None])[:, 0]
                                  ).cpu()
                out.append((read, None if margin is None else margin.cpu(),
                            seconds))
                del lg
        return out
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
         ) = flags
