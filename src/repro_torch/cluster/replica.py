"""Replica handle: one engine inside the co-simulated cluster.

The router advances whichever replica is earliest in virtual time
(conservative co-simulation — cross-replica messages always land as
events at the sender's clock, so no replica ever observes an effect
from its own future). The handle tracks the one piece of state the
engine's ``step()`` cannot: a ``False`` return is not final here,
because router-injected events (external spawns, pull bookings,
DAG-progress notifications) revive a drained or starved replica.
"""
from __future__ import annotations

import math
from typing import List, Tuple


class ReplicaHandle:
    def __init__(self, index: int, engine):
        self.index = index
        self.engine = engine
        self.blocked = False   # last step() made no progress on its own

    def next_time(self) -> float:
        """Virtual time of this replica's next action (inf = none).

        A blocked replica only moves when an injected event arrives, so
        its next action is its earliest event; a replica with runnable
        work acts at its current clock."""
        e = self.engine
        if not self.blocked and (e.running or e.waiting or e.offloaded):
            return e.clock
        if e.events:
            return e.events[0][0]
        return math.inf

    def advance(self) -> bool:
        alive = self.engine.step()
        self.blocked = not alive
        return alive

    def load(self) -> int:
        """Queue-depth load signal for saturation spill decisions."""
        e = self.engine
        return (len(e.running) + len(e.waiting)
                + len(e.stalled) + len(e.offloaded))

    def drain_outbox(self) -> List[Tuple]:
        out, self.engine.outbox = self.engine.outbox, []
        return out
