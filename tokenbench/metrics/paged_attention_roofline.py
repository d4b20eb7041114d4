"""B2 (``paged_attention``, ``csrc/paged_attention.cu``): its roofline
bound over its device time in the traced slice.

The bound of one decode step's launches: per layer, the K and V of each
real row's context read once and its q and output once (bf16), against
4 x heads x head_dim x context operations a row; the larger of bytes
over 3.35 TB/s and operations over 989 TFLOP/s, summed over the
layers. The contexts are the ``attn_lens`` of each decode step the
slice ran. The device time is that of the kernels below (the
split-context tensor-core kernel and its combine, or the scalar
kernel)."""
from tokenbench.peaks import bound_s
from tokenbench.profile import ops_matching

KERNELS = ("paged_decode_tc_kernel", "paged_decode_combine_kernel",
           "paged_attention_kernel")


def step_bound_s(s, attn_lens) -> float:
    h, hkv, dh = s["heads"], s["kv_heads"], s["head_dim"]
    ctx = float(attn_lens.sum())
    nbytes = 2 * (2 * hkv * dh * ctx + 2 * h * dh * len(attn_lens))
    flops = 4.0 * h * dh * ctx
    return s["layers"] * bound_s(nbytes, flops)[0]


def read(ctx):
    if ctx.trace is None:
        return None
    dev, n = ops_matching(ctx.trace, KERNELS)
    if not n or not ctx.traced["decode"]:
        return None
    bound = sum(step_bound_s(ctx.shapes, a) for a in ctx.traced["decode"])
    return 100.0 * bound / dev
