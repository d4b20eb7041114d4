"""Gossiped radix summaries — the router's view of replica KV coverage.

A replica never ships its radix tree. It publishes a *digest*: the set of
chain hashes of the block-aligned prefixes it holds (``token_chain`` in
``kvcache.radix_index``), each tagged with the tiers backing it (device /
host). Because the hash of block ``i`` folds in blocks ``0..i-1``, equal
hashes identify equal prefixes — the router walks a prompt's own chain
against the digest and the length of the leading run present *is* the
replica's advertised coverage, with no token data on the wire.

Summaries refresh on a gossip tick in **virtual time** (the co-simulated
cluster has no wall clock, which also keeps routing deterministic), so
the router's view is stale by up to ``GossipConfig.interval`` seconds.
Staleness is handled in two layers: summaries older than ``max_stale``
score zero (a silent replica stops attracting traffic), and every pull
decision re-validates against the live source tree before any blocks
move (the "pull RPC handshake" in the router) — a stale advertisement
costs a declined pull, never a wrong transfer.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from repro_torch.kvcache.prefix_store import TIER_DEVICE, TIER_HOST  # noqa: F401


@dataclass
class GossipConfig:
    interval: float = 5.0     # virtual seconds between digest refreshes
    max_stale: float = 30.0   # older summaries score zero coverage
    max_entries: int = 8192   # digest cap: deepest blocks dropped first


@dataclass
class ReplicaSummary:
    """One replica's advertised coverage at one gossip tick."""
    replica: int
    digest: Dict[int, int] = field(default_factory=dict)  # chain hash -> tiers
    refreshed_at: float = float("-inf")
    truncated: int = 0        # digest entries dropped by the size cap

    @classmethod
    def capture(cls, replica: int, store, now: float,
                max_entries: int) -> "ReplicaSummary":
        """Snapshot a prefix store's coverage digest.

        The cap drops the *deepest* blocks first: shallow blocks are the
        shared prefixes routing cares about, and a truncated deep run
        only under-advertises (the pull handshake still finds the full
        run on the live tree).
        """
        triples = store.coverage_digest()
        triples.sort(key=lambda t: (t[0], t[1]))
        trunc = max(len(triples) - max_entries, 0)
        if trunc:
            triples = triples[:max_entries]
        digest: Dict[int, int] = {}
        for _idx, h, bits in triples:
            digest[h] = digest.get(h, 0) | bits
        return cls(replica, digest, now, trunc)

    def coverage(self, chain: List[int]) -> Tuple[int, int]:
        """(device-tier run, any-tier run) of a prompt's chain hashes.

        Both runs stop at the first hash absent from the digest — a gap
        in the middle of a prefix makes everything past it unusable, so
        only the leading run counts. The device run additionally stops at
        the first host-only block (pullable blocks must be device-ready
        on the source)."""
        n_dev = n_any = 0
        dev_ok = True
        for h in chain:
            bits = self.digest.get(h, 0)
            if not bits:
                break
            n_any += 1
            if dev_ok and bits & TIER_DEVICE:
                n_dev += 1
            else:
                dev_ok = False
        return n_dev, n_any
