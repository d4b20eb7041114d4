"""Host ms of ``Engine.schedule_step`` per call, over the calls that
began in the window."""


def read(ctx):
    w0, w1 = ctx.window
    d = [b - a for a, b in ctx.rec.scheds if w0 <= a <= w1]
    return 1e3 * sum(d) / len(d) if d else None
