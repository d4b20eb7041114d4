"""Tokens served in the window over the window's seconds: every token
that ended a segment's decode inside the window, stamped on the wall
clock when ``_decode_batch`` returned (tokens the engine decodes past a
segment's end and does not serve are not counted)."""


def read(ctx):
    w0, w1 = ctx.window
    return sum(1 for t, *_ in ctx.rec.tokens if w0 <= t <= w1) / (w1 - w0)
