"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates) and
the roofline bound of a piece of work: the larger of its bytes over the
memory rate and its operations over the peak rate of their type. A frozen
copy of ``chip_smoke.bound_ms`` (in seconds here)."""

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}


def bound_s(nbytes: float, flops: float, dt: str = "bf16"):
    """(least seconds, "bytes" or "operations", whichever bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dt]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
