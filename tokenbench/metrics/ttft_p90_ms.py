"""90th percentile, over every agent spawned in the window, of the wall
ms from its spawn to its first served token. An agent with no
dependency is due at its app's arrival; a later one at its spawn
(``Request.arrival`` on the wall-mapped clock). An agent still waiting
when the window closes counts with the time it has waited so far."""
import numpy as np


def read(ctx):
    w0, w1 = ctx.window
    first = {}
    for t, rid, *_ in ctx.rec.tokens:
        first.setdefault(rid, t)
    vals = [(min(first.get(rid, w1), w1) - s) * 1e3
            for rid, s in ctx.spawns.items() if w0 <= s <= w1]
    return float(np.percentile(vals, 90)) if vals else None
