"""Plain PyTorch reference of the served decoders: the dense GQA decoder
with optional q/k/v biases (Qwen2.5) and the same decoder with a top-k
routed expert FFN (Mixtral), over one whole sequence, layer by layer.

It imports nothing of the serving package and takes only the shapes
(``model.shapes``), the weights the benchmark made and token ids. It
computes in the configuration's precision, bfloat16, with the published
casts: RMSNorm (gain 1 + w, statistics in float32, eps 1e-6 as the
serving package has it), split-half RoPE in float32, attention scores,
softmax and the weighted sum in float32, SwiGLU's gate in float32, the
router in float32 (softmax, top-k, gates renormalised to sum 1, no entry
dropped), the k expert outputs summed with their gates in float32, and
the logits in float32. Attention runs over blocks of queries, so no
(S, S) score matrix exists.

At a routed layer the reference also reads each position's route
margin: the gap between the float32 router logits of the last expert it
chose (the k-th largest) and the first it left out (the k+1-th). The
softmax keeps their order, so the margin says how far the router's
input would have to move to swap them: a small margin is a near tie,
which another correct bf16 computation may route the other way.

``quant="fp8"`` is the control: every bfloat16 product (attention
projections, experts, dense FFN, head) takes fp8 e4m3 weights, scaled per
output channel, and fp8 e4m3 inputs, scaled per row, as an fp8 serving
path would.

``order="splitk"`` is the witness: a second bf16 computation with another
accumulation order. Every bfloat16 product is two products over the
halves of its inner dimension, each accumulated in float32, summed in
float32 and rounded to bfloat16 once.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

EPS = 1e-6
FP8_MAX = 448.0
Q_BLOCK = 256


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to fp8 e4m3 with one scale per slice along ``dim``,
    returned in x's dtype."""
    amax = x.float().abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / FP8_MAX
    q = (x.float() / scale).to(torch.float8_e4m3fn)
    return (q.float() * scale).to(x.dtype)


class Reference:
    def __init__(self, s: dict, params: dict, quant: Optional[str] = None,
                 order: Optional[str] = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown reference precision {quant!r}")
        if order not in (None, "splitk"):
            raise ValueError(f"unknown accumulation order {order!r}")
        self.s, self.p, self.quant, self.order = s, params, quant, order

    # -- pieces ---------------------------------------------------------------
    def mm(self, x, w):
        """x (..., k) @ w (k, n) in bfloat16 (fp8 operands under the
        control; two float32 half-k products under the witness)."""
        if self.quant == "fp8":
            x, w = _fp8(x, -1), _fp8(w, 0)
        if self.order == "splitk":
            h = x.shape[-1] // 2
            return (x[..., :h].float() @ w[:h].float()
                    + x[..., h:].float() @ w[h:].float()).to(x.dtype)
        return x @ w

    @staticmethod
    def norm(x, w):
        xf = x.float()
        out = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + EPS)
        return (out * (1.0 + w.float())).to(x.dtype)

    def rope(self, x, pos):
        """x (S, H, D), positions (S,)."""
        d = x.shape[-1]
        freqs = 1.0 / (self.s["rope_theta"] ** (
            torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
        ang = pos.float()[:, None] * freqs
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        x1, x2 = x.float().chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                         -1).to(x.dtype)

    def attention(self, q, k, v):
        """Causal GQA: q (S, H, D), k/v (S, Hkv, D) -> (S, H, D)."""
        S, H, D = q.shape
        g = H // k.shape[1]
        kf = k.float().repeat_interleave(g, dim=1).transpose(0, 1)  # H S D
        vf = v.float().repeat_interleave(g, dim=1).transpose(0, 1)
        out = torch.empty_like(q)
        keys = torch.arange(S, device=q.device)
        for i in range(0, S, Q_BLOCK):
            j = min(i + Q_BLOCK, S)
            qb = q[i:j].float().transpose(0, 1)                     # H s D
            sc = (qb @ kf[:, :j].transpose(1, 2)) / math.sqrt(D)
            mask = keys[None, :j] <= torch.arange(i, j, device=q.device)[:, None]
            sc = sc.masked_fill(~mask, float("-inf"))
            pr = torch.softmax(sc, dim=-1)
            out[i:j] = (pr @ vf[:, :j]).transpose(0, 1).to(q.dtype)
        return out

    def ffn(self, lp, x):
        """The layer's FFN output, and each position's route margin (None
        for a dense FFN)."""
        if "we1" not in lp:
            gate = F.silu(self.mm(x, lp["w1"]).float()).to(x.dtype)
            return self.mm(gate * self.mm(x, lp["w3"]), lp["w2"]), None
        k = self.s["top_k"]
        logits = x.float() @ lp["wr"]
        top = torch.topk(logits, k + 1, dim=-1).values
        margin = top[:, k - 1] - top[:, k]
        probs = torch.softmax(logits, dim=-1)
        gate, idx = torch.topk(probs, k, dim=-1)
        gate = gate / gate.sum(-1, keepdim=True)
        slots = torch.zeros((x.shape[0], k, x.shape[1]), dtype=torch.float32,
                            device=x.device)
        for e in range(lp["wr"].shape[1]):
            tok, slot = torch.nonzero(idx == e, as_tuple=True)
            if tok.numel() == 0:
                continue
            xe = x[tok]
            h = F.silu(self.mm(xe, lp["we1"][e]).float()).to(x.dtype)
            slots[tok, slot] = self.mm(h * self.mm(xe, lp["we3"][e]),
                                       lp["we2"][e]).float()
        return (slots * gate[..., None]).sum(1).to(x.dtype), margin

    # -- the whole sequence --------------------------------------------------
    def logits(self, tokens: Sequence[int], rows: Sequence[int]):
        """float32 logits (len(rows), V) at positions ``rows`` of the
        sequence ``tokens``, each predicting the token after it, and the
        smallest route margin over the layers at each of those positions
        (len(rows),), None for a dense model."""
        s, p = self.s, self.p
        dev = p["embed"].device
        tok = torch.as_tensor(list(tokens), dtype=torch.long, device=dev)
        pos = torch.arange(tok.numel(), device=dev)
        H, Hkv, D = s["heads"], s["kv_heads"], s["head_dim"]
        h = p["embed"][tok]
        margin = None
        for i in range(s["layers"]):
            lp = {name: t[i] for name, t in p["layers"].items()}
            xn = self.norm(h, lp["attn_norm"])
            q, k, v = (self.mm(xn, lp[w]) for w in ("wq", "wk", "wv"))
            if "bq" in lp:
                q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
            q = self.rope(q.view(-1, H, D), pos)
            k = self.rope(k.view(-1, Hkv, D), pos)
            o = self.attention(q, k, v.view(-1, Hkv, D))
            h = h + self.mm(o.reshape(o.shape[0], -1), lp["wo"])
            f, m = self.ffn(lp, self.norm(h, lp["mlp_norm"]))
            h = h + f
            if m is not None:
                margin = m if margin is None else torch.minimum(margin, m)
        rows = torch.as_tensor(list(rows), device=dev)
        hn = self.norm(h[rows], p["final_norm"])
        if margin is not None:
            margin = margin[rows]
        if self.quant == "fp8":
            return self.mm(hn, p["unembed"]).float(), margin
        return hn.float() @ p["unembed"].float(), margin
