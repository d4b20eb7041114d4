"""Wall ms of ``TorchBackend._prefill_batch`` per 1000 suffix tokens it
prefilled, over the calls that began in the window (each ends in the
head's logits' copy to the host)."""


def read(ctx):
    w0, w1 = ctx.window
    calls = [(b - a, n) for a, b, n, _ in ctx.rec.prefills if w0 <= a <= w1]
    toks = sum(n for _, n in calls)
    return 1e6 * sum(s for s, _ in calls) / toks if toks else None
