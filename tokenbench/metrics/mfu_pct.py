"""The operations the traced slice's tokens need, over the slice's
seconds, as a share of the H100's bf16 peak (989 TFLOP/s).

Counted from the shapes, per token the step computed for a request:
2 x the parameters it multiplies by in each layer (the q, k, v and o
projections; the dense FFN's three matrices, or the router and the
experts_per_token experts a token is routed to, not the serving
package's dispatch over every expert), plus attention over the token's
context (4 x heads x head_dim x context a layer), plus the head (2 x d x
vocab) for every decode row and once per prefilled request. Padded rows
are not counted."""
from tokenbench.peaks import PEAK_FLOPS


def layer_flops(s) -> float:
    d, hd = s["d"], s["heads"] * s["head_dim"]
    kvd = s["kv_heads"] * s["head_dim"]
    attn = d * hd + 2 * d * kvd + hd * d
    if s["experts"]:
        ffn = s["top_k"] * 3 * d * s["ff"] + d * s["experts"]
    else:
        ffn = 3 * d * s["ff"]
    return 2.0 * s["layers"] * (attn + ffn)


def slice_flops(s, sl) -> float:
    per_ctx = 4.0 * s["layers"] * s["heads"] * s["head_dim"]
    head = 2.0 * s["d"] * s["vocab"]
    rows = sum(len(a) for a in sl["decode"])
    ctx = sum(int(a.sum()) for a in sl["decode"])
    toks = sum(n for chunk in sl["prefill"] for n, _, _ in chunk)
    pctx = sum(p for chunk in sl["prefill"] for _, _, p in chunk)
    return (layer_flops(s) * (rows + toks) + per_ctx * (ctx + pctx)
            + head * (rows + sl["prefill_reqs"]))


def read(ctx):
    if ctx.trace is None:
        return None
    return (100.0 * slice_flops(ctx.shapes, ctx.traced)
            / ctx.trace["window_s"] / PEAK_FLOPS["bf16"])
