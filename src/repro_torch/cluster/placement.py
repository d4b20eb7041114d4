"""Placement policies: where an agent node runs.

The baseline is a consistent-hash **home** per app (all of an app's
agents share its system prefix, so keeping an app together is the unit
of affinity). ``PrefixAffinity`` overrides the home when another
replica's gossiped summary advertises materially better coverage of the
node's actual prompt, and spills off a saturated replica to the least
loaded one — the two cases where the best prefix ends up away from the
chosen replica and a cross-replica pull becomes worth pricing.
``RoundRobin`` is the DAG-blind control: perfect load spread, zero
affinity.
"""
from __future__ import annotations

import zlib
from bisect import bisect_left
from dataclasses import dataclass
from typing import List, Optional


class HashRing:
    """Consistent-hash ring (crc32, virtual nodes) over replica indices."""

    def __init__(self, n: int, vnodes: int = 64):
        pts = sorted(
            ((zlib.crc32(f"replica{r}:{v}".encode()) & 0xFFFFFFFF, r)
             for r in range(n) for v in range(vnodes)))
        self._keys = [p[0] for p in pts]
        self._owners = [p[1] for p in pts]

    def lookup(self, key: str) -> int:
        h = zlib.crc32(key.encode()) & 0xFFFFFFFF
        i = bisect_left(self._keys, h)
        if i == len(self._keys):
            i = 0
        return self._owners[i]


@dataclass
class PlacementDecision:
    replica: int
    kind: str                        # "home" | "override" | "spill" | "rr"
    pull_src: Optional[int] = None   # replica advertising blocks worth pulling
    src_cov: int = 0                 # its advertised device-tier coverage


class RoundRobin:
    """DAG-blind control: each node placement takes the next replica."""

    name = "round_robin"

    def __init__(self, n: int, **_):
        self.n = n
        self._i = 0

    def place(self, home: int, chain: List[int], view) -> PlacementDecision:
        r = self._i % self.n
        self._i += 1
        return PlacementDecision(r, "rr")


@dataclass
class AffinityConfig:
    min_gain_blocks: int = 2      # advertised advantage needed to override home
    saturate_factor: float = 1.5  # load >= factor * cluster mean -> spill
    saturate_min: int = 4         # absolute load floor before spilling


class PrefixAffinity:
    """Consistent-hash home + summary override + saturation spill."""

    name = "affinity"

    def __init__(self, n: int, **kw):
        self.n = n
        self.cfg = AffinityConfig(**kw)

    def place(self, home: int, chain: List[int], view) -> PlacementDecision:
        covs = [view.coverage(i, chain) for i in range(self.n)]
        # any-tier coverage picks the replica (host blocks promote locally
        # for less than any wire moves them); ties prefer home, then the
        # lowest index — both deterministic
        best = max(range(self.n),
                   key=lambda i: (covs[i][1], i == home, -i))
        chosen, kind = home, "home"
        if (best != home
                and covs[best][1] >= covs[home][1] + self.cfg.min_gain_blocks):
            chosen, kind = best, "override"
        loads = view.loads()
        mean = sum(loads) / self.n
        if loads[chosen] >= max(self.cfg.saturate_min,
                                self.cfg.saturate_factor * mean):
            alt = min(range(self.n), key=lambda i: (loads[i], i))
            if alt != chosen:
                chosen, kind = alt, "spill"
        dec = PlacementDecision(chosen, kind)
        # pull candidate: someone advertises more *device-ready* blocks
        # than the replica that will run the node (spills and load-capped
        # homes are exactly where the best prefix lives elsewhere)
        devs = [c[0] for c in covs]
        src = max(range(self.n), key=lambda i: (devs[i], -i))
        if src != chosen and devs[src] > devs[chosen]:
            dec.pull_src, dec.src_cov = src, devs[src]
        return dec


POLICIES = {p.name: p for p in (RoundRobin, PrefixAffinity)}
