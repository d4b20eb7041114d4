"""Wall ms of ``TorchBackend._decode_batch`` per call (one decode step of
the running batch, ending in the argmax's copy to the host), over the
calls that began in the window."""


def read(ctx):
    w0, w1 = ctx.window
    d = [b - a for a, b, _ in ctx.rec.decodes if w0 <= a <= w1]
    return 1e3 * sum(d) / len(d) if d else None
