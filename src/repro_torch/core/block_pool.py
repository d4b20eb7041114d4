"""Paged KV block pools (paper §6.3 CPU Migration Infrastructure).

Two pools:
 * ``DevicePool`` — GPU/TPU KV blocks. Supports a *reserved* partition
   managed by the Spatial Scheduler (§5.1) on top of a shared free list.
 * ``HostPool``  — CPU offload destination with a lightweight free list that
   recycles fixed-size blocks without returning them to the OS allocator
   (the paper measures this cutting worst-case allocation latency from ~1 s
   to sub-millisecond).

The pool owns the GPU<->CPU block mapping, block hashes, and the prefix-cache
indices. Blocks issued to an in-flight transfer are marked *pending-free*:
they return to the free list only when the transfer-complete callback fires,
preventing reallocation of blocks still being read (§6.3).

This module tracks *identifiers and metadata only* — actual tensor movement
belongs to the execution backend, keeping the scheduling logic identical
between the simulator and the JAX engine.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple


class OutOfBlocks(Exception):
    pass


@dataclass
class BlockMeta:
    block_id: int
    owner: Optional[str] = None      # request id
    hash_key: Optional[Tuple] = None


class DevicePool:
    """Fixed-size device KV block pool with reserved-capacity accounting."""

    def __init__(self, num_blocks: int, device: int = 0):
        self.device = device
        self.num_blocks = num_blocks
        self.free_list: List[int] = list(range(num_blocks))
        self.meta: Dict[int, BlockMeta] = {
            i: BlockMeta(i) for i in range(num_blocks)}
        self.pending_free: Set[int] = set()
        # prefix cache: hash -> block id (valid cached content, owner freed)
        self.prefix_index: Dict[Tuple, int] = {}
        self.cached_blocks: Set[int] = set()
        # spatial reservations: agent_type -> guaranteed block floor.
        # Semantics (§5.1, floor interpretation): a type's reservation counts
        # blocks it ALREADY holds, so protected-but-busy types do not idle
        # capacity; only the unmet part of a floor is held back from the
        # shared pool.
        self.reserved_quota: Dict[str, int] = {}
        self.type_held: Dict[str, int] = {}    # live blocks per agent type
        # prefix-store hooks (kvcache.prefix_store): ``victim_cb(device)``
        # picks which cached block to reclaim (LRU); ``reclaim_cb(device,
        # block, hash_key)`` tells the store its entry is gone. Both None
        # when no store is attached (legacy arbitrary-set reclaim).
        self.victim_cb = None
        self.reclaim_cb = None

    # ---- accounting ---------------------------------------------------------
    @property
    def used(self) -> int:
        return (self.num_blocks - len(self.free_list)
                - len(self.pending_free) - len(self.cached_blocks))

    @property
    def free(self) -> int:
        """Blocks allocatable right now (cached blocks are reclaimable)."""
        return len(self.free_list) + len(self.cached_blocks)

    @property
    def usage(self) -> float:
        return 1.0 - self.free / max(self.num_blocks, 1)

    def reserved_total(self) -> int:
        return sum(self.reserved_quota.values())

    def reserved_free(self, agent_type: str) -> int:
        """Unmet part of this type's floor (usable only by this type)."""
        return max(0, self.reserved_quota.get(agent_type, 0)
                   - self.type_held.get(agent_type, 0))

    def shared_free(self) -> int:
        """Free blocks not spoken for by unmet reservation floors."""
        outstanding = sum(max(0, q - self.type_held.get(t, 0))
                          for t, q in self.reserved_quota.items())
        return max(0, self.free - outstanding)

    # ---- allocation ---------------------------------------------------------
    def _pop_free(self) -> int:
        if self.free_list:
            return self.free_list.pop()
        if self.cached_blocks:  # reclaim a prefix-cached block
            bid = None
            if self.victim_cb is not None:
                bid = self.victim_cb(self.device)     # store's LRU choice
            if bid is None or bid not in self.cached_blocks:
                bid = self.cached_blocks.pop()        # legacy arbitrary
            else:
                self.cached_blocks.remove(bid)
            m = self.meta[bid]
            key = m.hash_key
            if key is not None:
                self.prefix_index.pop(key, None)
                m.hash_key = None
            if self.reclaim_cb is not None:
                self.reclaim_cb(self.device, bid, key)
            return bid
        raise OutOfBlocks(f"device {self.device} pool exhausted")

    def allocate(self, n: int, owner: str,
                 agent_type: Optional[str] = None) -> List[int]:
        if n > self.free:
            raise OutOfBlocks(
                f"need {n}, free {self.free} (device {self.device})")
        blocks = []
        for _ in range(n):
            bid = self._pop_free()
            self.meta[bid].owner = owner
            blocks.append(bid)
        if agent_type is not None:
            self.type_held[agent_type] = \
                self.type_held.get(agent_type, 0) + n
        return blocks

    def release(self, blocks: Sequence[int], agent_type: Optional[str] = None,
                cache: bool = False) -> None:
        """Free blocks. ``cache=True`` keeps content in the prefix index.

        NOTE: production device-tier caching goes through the ref-counted
        ``kvcache.prefix_store`` (which manages cached_blocks/prefix_index
        directly); the ``cache=True`` branch here (with ``set_hashes``) is
        the pool-local primitive kept for the conservation property tests
        — don't add new production callers."""
        for bid in blocks:
            m = self.meta[bid]
            m.owner = None
            if cache and m.hash_key is not None:
                self.prefix_index[m.hash_key] = bid
                self.cached_blocks.add(bid)
            else:
                m.hash_key = None
                self.free_list.append(bid)
        if agent_type is not None and blocks:
            self.type_held[agent_type] = max(
                0, self.type_held.get(agent_type, 0) - len(blocks))

    # ---- pending-free (async transfer in flight) ----------------------------
    def mark_pending_free(self, blocks: Sequence[int],
                          agent_type: Optional[str] = None) -> None:
        for bid in blocks:
            self.meta[bid].owner = None
            self.pending_free.add(bid)
        if agent_type is not None and blocks:
            self.type_held[agent_type] = max(
                0, self.type_held.get(agent_type, 0) - len(blocks))

    def complete_pending_free(self, blocks: Sequence[int]) -> None:
        for bid in blocks:
            if bid in self.pending_free:
                self.pending_free.remove(bid)
                self.free_list.append(bid)

    # ---- prefix cache --------------------------------------------------------
    def set_hashes(self, blocks: Sequence[int], hashes: Sequence[Tuple]):
        for bid, h in zip(blocks, hashes):
            self.meta[bid].hash_key = h

    def lookup_prefix(self, hashes: Sequence[Tuple]) -> List[int]:
        """Longest-prefix hit: cached block ids for a leading run of hashes.

        Read-only. Claiming cached blocks for a request goes through the
        ref-counted ``kvcache.prefix_store`` (shared pins, not the
        exclusive-claim the seed used) so its refcount/LRU bookkeeping
        stays coherent with this pool's sets."""
        hit = []
        for h in hashes:
            bid = self.prefix_index.get(h)
            if bid is None or bid not in self.cached_blocks:
                break
            hit.append(bid)
        return hit


@dataclass
class CachedBlockMeta:
    """Capacity-policy state of one cached host block: when it last
    entered or was hit in the cached tier (recency) and how many times a
    promotion has hit it (frequency). The block's request group lives in
    ``HostPool.group_of`` / ``group_cached`` — the authoritative quota
    accounting — not here."""
    last_touch: float = 0.0
    hits: int = 1


class HostPool:
    """CPU offload pool: free-list recycling (§6.3) plus a content cache
    tier for the H2D promotion path.

    A host block's KV *content* stays addressable through the prefix
    store's radix tree (host ids attached to token-path nodes), so blocks
    can outlive their owning request: when an upload finishes, indexed
    prompt copies are ``retire``d into the ``cached`` tier instead of
    being freed — a later same-prefix request promotes them back to
    device blocks without paying a fresh D2H. Cached blocks are
    reclaimable (``free`` counts them); ``release_cb`` unhooks the radix
    index when a block is reclaimed or freed. ``promote()`` is the
    transfer handoff: it pins the source blocks of an in-flight H2D
    promotion so neither reclaim nor an owner release can recycle a block
    the copy stream is still reading.

    Capacity policy (frequency + TTL + per-group quota, replacing the
    pure-LRU reclaim): each cached block carries a hit-count-decayed
    hotness score ``hits * exp(-age / hit_decay)`` — reclaim evicts the
    coldest unpinned block, so a prefix that keeps getting promoted
    outlives an idle one regardless of retire order (with no hits and no
    clock the score degenerates to retire order, i.e. plain LRU). Blocks
    idle past ``cache_ttl`` since their last touch score as expired and
    are swept by ``expire()`` (the Temporal Scheduler runs the sweep each
    step, so offload capacity — the predictive-upload plans' host
    destination — is reclaimed from cold copies *before* an allocation
    has to). When ``group_quota_frac > 0``, a request group holding more
    than that fraction of the pool in cached copies is reclaimed from
    first (coldest within the over-quota group), so one chatty app cannot
    squeeze every other app's promotable inventory out of the host tier.
    Knobs are wired from ``TemporalConfig`` by the Temporal Scheduler."""

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks
        self.free_list: List[int] = list(range(num_blocks))
        self.owner: Dict[int, Optional[str]] = {}
        # cached content tier: owner released, KV still indexed by the
        # prefix store. Insertion order (dict-as-ordered-set) is the
        # tie-break order of the frequency score — equal-score reclaim is
        # oldest-retired-first, and ``touch`` refreshes recency.
        self.cached: Dict[int, None] = {}
        self.cached_meta: Dict[int, CachedBlockMeta] = {}
        self.group_of: Dict[int, str] = {}   # block -> request group
        # cached blocks per group, maintained incrementally so the quota
        # check in _reclaim_cached is O(1), not an O(cached) rebuild per
        # reclaimed block (allocate under pressure reclaims in a loop)
        self.group_cached: Dict[str, int] = {}
        self.pins: Dict[int, int] = {}     # in-flight H2D promotion reads
        # capacity-policy knobs (TemporalConfig via TemporalScheduler)
        self.clock = 0.0                   # virtual time, engine-ticked
        self.cache_ttl = math.inf          # idle seconds before expiry
        self.hit_decay = 600.0             # hotness-score decay constant
        self.group_quota_frac = 0.0        # cached fraction cap per group
        # prefix-store hook (kvcache.prefix_store): fires with the freed
        # block ids so the radix index can unhook its host-tier entries.
        # None when no store is attached.
        self.release_cb = None

    @property
    def free(self) -> int:
        """Blocks allocatable right now (unpinned cached are reclaimable).
        On the per-step hot path (snapshot, offload gate): O(pins) — the
        handful of in-flight promotion sources — never O(cached)."""
        return (len(self.free_list) + len(self.cached)
                - sum(1 for b in self.pins if b in self.cached))

    @property
    def used(self) -> int:
        return self.num_blocks - len(self.free_list) - len(self.cached)

    def allocate(self, n: int, owner: str,
                 group: Optional[str] = None) -> List[int]:
        if n > self.free:
            raise OutOfBlocks(f"host pool: need {n}, free {self.free}")
        blocks = []
        for _ in range(n):
            if self.free_list:
                b = self.free_list.pop()
            else:
                b = self._reclaim_cached()
            self.owner[b] = owner
            if group is not None:
                self.group_of[b] = group
            blocks.append(b)
        return blocks

    # ---- capacity policy (frequency + TTL + group quota) ---------------------
    def tick(self, now: float) -> None:
        """Advance the pool's virtual clock (ages the hotness scores)."""
        self.clock = max(self.clock, now)

    def _cache_score(self, b: int) -> float:
        """Hotness of a cached block: hit count decayed by idle time.
        Expired blocks (idle past ``cache_ttl``) score below everything
        live; blocks with no meta (legacy direct ``cached`` inserts)
        score 0.0 so they reclaim before any scored block."""
        m = self.cached_meta.get(b)
        if m is None:
            return 0.0
        age = max(self.clock - m.last_touch, 0.0)
        if age >= self.cache_ttl:
            return -1.0
        if self.hit_decay <= 0:
            return float(m.hits)
        return m.hits * math.exp(-age / self.hit_decay)

    def _note_cached(self, b: int) -> None:
        """Bookkeeping for a block ENTERING the cached tier (call before
        the ``cached`` insert when the block was not already cached)."""
        g = self.group_of.get(b)
        if g is not None:
            self.group_cached[g] = self.group_cached.get(g, 0) + 1

    def _drop_cached(self, b: int) -> None:
        del self.cached[b]
        self.cached_meta.pop(b, None)
        g = self.group_of.pop(b, None)
        if g is not None:
            left = self.group_cached.get(g, 0) - 1
            if left > 0:
                self.group_cached[g] = left
            else:
                self.group_cached.pop(g, None)

    def _reclaim_cached(self) -> int:
        """Evict the coldest unpinned cached block. Victim order: an
        over-quota group's blocks first (coldest within it), then
        globally by ascending hotness score with ties broken
        oldest-retired-first; the release callback unhooks the radix
        index before the block is recycled."""
        cands = [b for b in self.cached if not self.pins.get(b)]
        if not cands:
            raise OutOfBlocks("host pool: only pinned cached blocks left")
        if self.group_quota_frac > 0:
            quota = self.group_quota_frac * self.num_blocks
            over = [b for b in cands
                    if self.group_cached.get(self.group_of.get(b), 0)
                    > quota]
            if over:
                cands = over
        # min() keeps the first (oldest-inserted) block on score ties, so
        # the no-hits/no-clock degenerate case is exactly the old LRU
        victim = min(cands, key=self._cache_score)
        self._drop_cached(victim)
        if self.release_cb is not None:
            self.release_cb([victim])
        return victim

    def expire(self, now: Optional[float] = None) -> List[int]:
        """Free every unpinned cached block idle past ``cache_ttl`` (the
        Temporal Scheduler's per-step sweep): cold copies hand their
        capacity back to the offload path before allocation pressure has
        to reclaim them. Returns the freed block ids."""
        if now is not None:
            self.tick(now)
        if self.cache_ttl == math.inf or not self.cached:
            return []
        freed = []
        for b in list(self.cached):
            if self.pins.get(b):
                continue
            m = self.cached_meta.get(b)
            if m is None or self.clock - m.last_touch < self.cache_ttl:
                continue
            self._drop_cached(b)
            self.free_list.append(b)
            freed.append(b)
        if freed and self.release_cb is not None:
            self.release_cb(freed)
        return freed

    def release(self, blocks: Sequence[int]) -> None:
        freed = []
        for b in blocks:
            self.owner.pop(b, None)
            if self.pins.get(b):
                # an in-flight promotion still reads this block: park it in
                # the cached tier; reclaim skips it until the pin drops
                if b not in self.cached:
                    self._note_cached(b)
                else:
                    del self.cached[b]
                self.cached[b] = None
                self.cached_meta.setdefault(
                    b, CachedBlockMeta(last_touch=self.clock))
            else:
                if b in self.cached:
                    self._drop_cached(b)
                else:
                    self.group_of.pop(b, None)
                self.free_list.append(b)
                freed.append(b)
        if self.release_cb is not None and freed:
            self.release_cb(freed)

    # ---- content cache tier (H2D promotion sources) --------------------------
    def retire(self, blocks: Sequence[int]) -> None:
        """Upload finished but the content stays indexed: move the blocks
        to the cached tier instead of freeing them (no release_cb — the
        radix index keeps its host entries until reclaim/expiry). A
        re-retire refreshes recency but keeps the accumulated hit count."""
        for b in blocks:
            self.owner.pop(b, None)
            prev = self.cached_meta.get(b)
            if b not in self.cached:
                self._note_cached(b)
            else:
                del self.cached[b]       # re-retire refreshes recency
            self.cached[b] = None
            self.cached_meta[b] = CachedBlockMeta(
                last_touch=self.clock,
                hits=prev.hits if prev is not None else 1)

    def touch(self, blocks: Sequence[int]) -> None:
        """A promotion hit on cached blocks: refresh recency and bump the
        hit count — the frequency half of the reclaim score."""
        for b in blocks:
            if b in self.cached:
                del self.cached[b]
                self.cached[b] = None
                m = self.cached_meta.get(b)
                if m is None:
                    m = self.cached_meta[b] = CachedBlockMeta()
                m.hits += 1
                m.last_touch = self.clock

    def promote(self, blocks: Sequence[int]) -> None:
        """Handoff to an H2D promotion transfer: pin the source blocks
        for the duration of the copy (refcounted — concurrent promotions
        may read the same host copy)."""
        for b in blocks:
            self.pins[b] = self.pins.get(b, 0) + 1

    def promote_done(self, blocks: Sequence[int]) -> None:
        """Transfer complete (or cancelled): drop the promotion pins."""
        for b in blocks:
            left = self.pins.get(b, 0) - 1
            if left > 0:
                self.pins[b] = left
            else:
                self.pins.pop(b, None)


def block_hashes(token_ids: Sequence[int], block_tokens: int,
                 extra: Tuple = ()) -> List[Tuple]:
    """Chained content hashes per block (vLLM-style prefix keys)."""
    out, prev = [], hash(("root",) + tuple(extra))
    for i in range(0, len(token_ids) - len(token_ids) % block_tokens,
                   block_tokens):
        prev = hash((prev,) + tuple(token_ids[i:i + block_tokens]))
        out.append((prev,))
    return out
