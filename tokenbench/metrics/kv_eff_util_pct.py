"""Share of the device pool's blocks held by running requests
(``Engine.util_samples``' third field, sampled after every step), each
sample weighted by the wall time until the next, over the window."""


def read(ctx):
    w0, w1 = ctx.window
    s = ctx.rec.util
    num = den = 0.0
    for i, (t, eff) in enumerate(s):
        end = s[i + 1][0] if i + 1 < len(s) else w1
        dt = min(end, w1) - max(t, w0)
        if dt > 0:
            num += eff * dt
            den += dt
    return 100.0 * num / den if den else None
