"""B4 (``paged_prefill_attention``, ``csrc/paged_prefill.cu``): its
roofline bound over its device time in the traced slice.

The bound of one prefill chunk's launches: per layer and real row, the K
and V of the row's context (up to its last query position) read once and
its queries and outputs once (bf16), against 4 x heads x head_dim x
(position + 1) operations a query (causal); the larger of bytes over
3.35 TB/s and operations over 989 TFLOP/s, summed over the layers. The
rows come from each chunk's ``q_pos``. The device time is that of the
kernels below (the tensor-core tile loop, or the scalar kernel)."""
from tokenbench.peaks import bound_s
from tokenbench.profile import ops_matching

KERNELS = ("paged_prefill_tc_kernel", "paged_prefill_kernel")


def chunk_bound_s(s, rows) -> float:
    h, hkv, dh = s["heads"], s["kv_heads"], s["head_dim"]
    nbytes = sum(2 * (2 * hkv * dh * c + 2 * h * dh * n) for n, c, _ in rows)
    flops = sum(4.0 * h * dh * p for _, _, p in rows)
    return s["layers"] * bound_s(nbytes, flops)[0]


def read(ctx):
    if ctx.trace is None:
        return None
    dev, n = ops_matching(ctx.trace, KERNELS)
    if not n or not ctx.traced["prefill"]:
        return None
    bound = sum(chunk_bound_s(ctx.shapes, r) for r in ctx.traced["prefill"])
    return 100.0 * bound / dev
