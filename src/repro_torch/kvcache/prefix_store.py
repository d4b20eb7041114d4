"""Ref-counted copy-on-write shared-prefix KV store (control plane).

Tokencake's multi-agent workloads are dominated by agents that share a long
app-level system prefix (§7.1) and then diverge **mid-block**: the shared
preamble rarely ends on a block boundary, and per-agent role lines or tool
outputs fork the token stream inside a block. The PR 2 store indexed
chained whole-block hashes, so it could only share an *identical leading
block run* — everything past the first divergent token was recomputed.

This version is built on a token-sequence radix tree
(:mod:`repro_torch.kvcache.radix_index`), which matches at **arbitrary branch
points**:

 * **Radix index** — edges are token runs, nodes are branch points, and
   each node owns the per-device KV blocks whose content ends inside its
   token span. Insert/match/evict are O(depth).
 * **Mid-block divergence** — two prompts that share ``k`` full blocks
   plus part of the next block share the ``k`` full blocks *physically*
   (same device block ids in both tables, node-granular refcounts) and
   **COW-fork** the partial block: the sharer pins a source block below
   the branch point, the data plane clones it into the sharer's first
   private block, and the suffix prefill overwrites everything from the
   divergence offset on. The fork source's leading ``partial_len`` token
   positions are immutable prompt KV, so the clone is race-free even while
   the source's publisher keeps decoding into the same block.
 * **Ref-counted pinning** — ``acquire`` pins every node on the matched
   path (path pinning: a node's pins are a superset of its descendants'),
   so a pinned branch can never lose an ancestor. Pinned blocks are owned
   by the ``SHARED_OWNER`` sentinel and are unreclaimable.
 * **LRU over refcount-0 leaves** — when a node's last pin drops, its
   blocks become reclaimable (``cached_blocks``). Allocation pressure
   reclaims from the tree's *frontier* — unpinned nodes with no
   device-backed descendants — least-recently-released first, so reclaim
   eats branches deepest-first and ancestors stay matchable until every
   deeper branch is gone.
 * **Host tier** — the §6.3 CPU prefix index (mooncake mode) walks the
   *same tree*: ``host_publish`` attaches host block ids to the nodes
   covering the offloaded prompt blocks (at any depth, not just root-
   anchored runs) and ``host_match`` counts the leading host-backed run.
   Device and host hits are therefore deduplicated structurally — the
   engine reports a host hit only for blocks the device tier cannot serve.

Entries hold one block id *per device* (TP mirroring): a hit requires the
prefix to be resident on every device. The store is control-plane only;
block *content* moves through the backend (``copy_blocks`` for COW clones,
the chunked suffix prefill for everything past the match). Entries publish
*unready* at admission and flip ready only after the publisher's prefill
executed, so a sharer can never attend over unwritten KV.

Key invariants:

* **Pin-before-allocate** — a sharer acquires (pins) its matched path
  *before* the engine allocates its private blocks, so allocation
  pressure triggered by that very admission can never reclaim the
  prefix it is about to share.
* **Unready-entry discipline** — entries published at admission stay
  unready until the publisher's prefill has actually executed (and, for
  promotion-gated publishers, until the promotion delivered); matching
  skips unready entries, so no request ever attends over unwritten KV.
* **Path pinning** — a node's pin count is always >= the sum of its
  descendants'; reclaim only ever takes refcount-0 frontier nodes, so a
  pinned branch can never lose an ancestor.

The radix-tree / two-tier lifecycle (device entries, host publishes,
promotion gates) is diagrammed in docs/ARCHITECTURE.md.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.block_pool import DevicePool, HostPool
from repro_torch.kvcache.radix_index import BlockEntry, RadixNode, RadixTree

SHARED_OWNER = "<shared-prefix>"

# tier bitmask of the gossip coverage digest (see ``coverage_digest``)
TIER_DEVICE = 1
TIER_HOST = 2


@dataclass
class PrefixMatch:
    """Result of a longest-prefix lookup for one request.

    ``tokens`` (= ``n_full * bt + partial_len``) is the device-servable
    coverage; ``matched_tokens`` is the raw token-tree match, which can be
    longer when trailing blocks were reclaimed or are still unready.

    ``promo`` is the host-tier promotion run: the contiguous host-backed
    full blocks right past the device-servable run that an H2D upload
    could turn into device entries (filled only when the lookup ran with
    ``promote=True``). ``pending_promo`` flags that the first unservable
    block is *already* being promoted by another request's in-flight
    transfer — the caller should wait for ``upload_done`` rather than
    recompute or start a duplicate transfer.
    """
    n_full: int = 0                        # physically shareable full blocks
    partial_len: int = 0                   # matched tokens inside the next
    tokens: int = 0                        #   block (COW-forked, not shared)
    matched_tokens: int = 0                # raw radix match length
    full_entries: List[BlockEntry] = field(default_factory=list)
    pin_path: List[RadixNode] = field(default_factory=list)
    src_entry: Optional[BlockEntry] = None  # COW source for the partial
    src_path: List[RadixNode] = field(default_factory=list)  # descent to it
    cpu_hits: int = 0                      # host-only hits (no device blocks)
    promo: List[Tuple[int, int]] = field(default_factory=list)  # (idx, host)
    promo_path: List[RadixNode] = field(default_factory=list)   # pin targets
    pending_promo: bool = False            # in-flight promotion at boundary

    def __bool__(self) -> bool:
        return self.tokens > 0

    def trim_promo(self, k: int, block_tokens: int) -> None:
        """Cut the promotion run to its first ``k`` blocks.

        The run is *cuttable* by construction: every prefix of it is a
        valid promotion (contiguous host-backed full blocks starting at
        the device-coverage boundary), so the engine may trim at any
        marginal block — transfer-budget pressure and the cost model's
        upload-vs-recompute cutoff both use this. The pin scope
        (``promo_path``) shrinks with it so an admission hold never pins
        nodes past the trimmed run; ``k=0`` clears the run entirely (the
        recompute election)."""
        self.promo = self.promo[:k]
        if not self.promo:
            self.promo_path = []
            return
        last = (self.n_full + k) * block_tokens - 1
        self.promo_path = [nd for nd in self.promo_path
                           if nd.start <= last]


@dataclass
class _Promotion:
    """One in-flight host→device prefix promotion (transfer scheduled)."""
    rid: str                               # requesting publisher
    entries: List[BlockEntry]              # unready device entries
    host_blocks: List[int]                 # pinned H2D sources
    cancelled: bool = False                # requester released mid-transfer


class PrefixStore:
    def __init__(self, pools: Sequence[DevicePool],
                 host: Optional[HostPool], block_tokens: int,
                 host_precision: str = "fp16"):
        self.pools = {p.device: p for p in pools}
        self.host = host
        self.bt = block_tokens
        # precision of the host tier's stored payload: entries created by
        # promotions (and cross-replica pulls sourced from a same-config
        # peer) inherit this tag so the transfer plane can price the wire
        # bytes they move (``fp16`` | ``int8_host``)
        self.host_precision = host_precision
        self.tree = RadixTree(block_tokens, on_split=self._on_split)
        self.by_block: Dict[Tuple[int, int], BlockEntry] = {}
        # rid -> pinned nodes, appended shallow-to-deep (release walks the
        # list reversed so refs drop bottom-up and path pinning never
        # breaks mid-release)
        self.pins: Dict[str, List[RadixNode]] = {}
        # rid -> leading run of shared block ids per device, in table order
        # (acquired full blocks, then published/adopted blocks). This is
        # what ``pinned_count`` reports and what ``release`` strips from
        # the request's tables.
        self.pin_blocks: Dict[str, Dict[int, List[int]]] = {}
        self.unready: Dict[str, List[BlockEntry]] = {}   # publisher -> new
        self.host_nodes: Dict[int, RadixNode] = {}       # host bid -> node
        # reclaim victim queue: one frontier sweep feeds a whole burst of
        # reclaims instead of an O(tree) walk per freed block. Entries are
        # validated at pop time (node unpinned, entry live, block still
        # cached), so stale items are skipped and no invalidation hooks
        # are needed; a drained/stale queue triggers one fresh sweep.
        self._victims: List[Tuple[RadixNode, int]] = []
        # H2D promotion lifecycle: pin-before-allocate holds (rid -> host
        # sources pinned while the engine allocates destinations), then
        # in-flight transfer records keyed by promotion id. ``release``
        # cancels a requester's live promotions (entries dropped, record
        # kept so the completion event still unpins exactly once).
        self._promo_seq = 0
        self._promo_holds: Dict[str, List[int]] = {}
        self._promos: Dict[int, _Promotion] = {}
        self._promos_by_rid: Dict[str, set] = {}
        # store-internal lifecycle counters only; hit/COW accounting lives
        # in the engine's metrics (counted once, at admission commit)
        self.stats = {"published": 0, "reclaimed": 0, "promoted": 0,
                      "prefetch_wasted": 0, "pull_wasted": 0}
        for p in pools:
            p.reclaim_cb = self._on_reclaim
            p.victim_cb = self._lru_victim
        if host is not None:
            host.release_cb = self._on_host_release

    # ---- lookup --------------------------------------------------------------
    def match(self, prompt_tokens: Sequence[int],
              promote: bool = False) -> PrefixMatch:
        """Longest device-servable shared prefix for a prompt.

        Walks the radix tree token-by-token, then scans block indices from
        0 for the contiguous run of *ready, full, device-resident* entries
        along the matched path. If the token match runs past the full-block
        run into the next block (mid-block divergence) a COW source entry
        is located in the subtree below the branch point — every block
        there holds identical KV for the matched positions.

        A match ending mid-edge SPLITS the node at the boundary (SGLang
        style) so the returned pin path covers exactly the matched tokens:
        without the split, pinning the partially matched node would drag
        every entry of its divergent remainder into the unreclaimable
        shared state for the sharer's whole lifetime.

        With ``promote=True`` the lookup also fills the host-tier
        promotion run (``m.promo``): the contiguous host-backed full
        blocks right past the device-servable run, ready to be uploaded
        into fresh device blocks and attached to the *same* nodes their
        host copies sit on. A promo run and a mid-block COW fork are
        mutually exclusive (the fork needs the match to end inside the
        first unservable block; promotion needs it fully matched)."""
        path, matched = self.tree.walk(prompt_tokens)
        if path and matched < path[-1].end:
            # walk guarantees >= 1 matched edge token on the trailing node
            path[-1] = self.tree._split(path[-1], matched - path[-1].start)
        avail: Dict[int, BlockEntry] = {}
        for node in path:
            avail.update(node.entries)
        full: List[BlockEntry] = []
        n = 0
        while True:
            e = avail.get(n)
            if (e is None or not e.ready or e.tokens < self.bt
                    or (n + 1) * self.bt > matched
                    or any(d not in e.blocks for d in self.pools)):
                break
            full.append(e)
            n += 1
        # pin only what the request will reference: nodes covering the
        # full-block run. Deeper token-matched nodes (beyond a gap, or the
        # partial region) are pinned via src_path — and only while a COW
        # source needs protecting — so a short match never drags another
        # prompt's suffix blocks into the unreclaimable shared state.
        cut = path.index(full[-1].node) + 1 if full else 0
        partial_len, src_entry, src_path = 0, None, []
        rem = matched - n * self.bt
        if path and 0 < rem < self.bt and n == matched // self.bt:
            src_entry, descent = self._find_cow_src(path[-1], n, rem)
            if src_entry is not None:
                partial_len = rem
                src_path = path[cut:] + descent
        m = PrefixMatch(n, partial_len, n * self.bt + partial_len,
                        matched, full, path[:cut], src_entry, src_path)
        if promote:
            self._scan_promotable(m, path, matched)
        return m

    def _scan_promotable(self, m: PrefixMatch, path: List[RadixNode],
                         matched: int) -> None:
        """Fill ``m.promo``: the contiguous run of host-backed full blocks
        starting right where the device-servable run ends. The run is
        returned *cuttable* — every prefix of it is independently
        promotable (see :meth:`PrefixMatch.trim_promo`), so admission can
        stop at the marginal block where the cost model says upload stops
        beating recompute instead of taking it all-or-nothing. An index
        that already carries a device entry is never promotable — if that
        entry is an in-flight promotion (another request's transfer), flag
        ``pending_promo`` so the caller waits for ``upload_done`` instead
        of recomputing or starting a duplicate transfer."""
        hosts: Dict[int, int] = {}
        avail: Dict[int, BlockEntry] = {}
        for node in path:
            hosts.update(node.host)
            avail.update(node.entries)
        idx = m.n_full
        promo: List[Tuple[int, int]] = []
        while (idx + 1) * self.bt <= matched:
            e = avail.get(idx)
            if e is not None:
                if not e.ready \
                        and e.source in ("promo", "prefetch", "remote") \
                        and not promo:
                    m.pending_promo = True
                break                    # device entry exists: not ours
            if idx not in hosts:
                break
            promo.append((idx, hosts[idx]))
            idx += 1
        if not promo:
            return
        m.promo = promo
        last = idx * self.bt - 1         # last promoted token position
        m.promo_path = [nd for nd in path if nd.start <= last]
        # a promotion run and a mid-block COW fork are mutually exclusive
        # by construction: the fork needs the match to END inside block
        # n_full (matched < (n_full+1)*bt) while the first promotable
        # index needs that block fully matched ((n_full+1)*bt <= matched).
        # So trimming the promo run later (transfer-budget pressure) never
        # costs the request fork coverage it would otherwise have had.
        assert not m.partial_len, "COW fork coexists with a promo run"

    def _find_cow_src(self, branch: RadixNode, idx: int, rem: int):
        """A ready device block for index ``idx`` at/below ``branch``.

        Every node in the branch subtree extends the matched prefix, so any
        such block holds valid KV for the first ``rem`` matched positions
        of the block — the publisher's own divergent tokens sit at offsets
        >= ``rem`` and are overwritten by the sharer's suffix prefill.
        Breadth-first so the shallowest (cheapest-to-pin) source wins."""
        queue = deque([(branch, [])])
        while queue:
            node, descent = queue.popleft()
            e = node.entries.get(idx)
            if (e is not None and e.ready and e.tokens >= rem
                    and all(d in e.blocks for d in self.pools)):
                return e, descent
            for c in node.children.values():
                queue.append((c, descent + [c]))
        return None, []

    # ---- pin / fork ----------------------------------------------------------
    def acquire(self, rid: str, m: PrefixMatch) -> Dict[int, List[int]]:
        """Pin the matched path (plus the descent to the COW source) for
        ``rid``; returns the per-device ids of the shared full blocks in
        prefix order. Pin-before-allocate: once pinned, the allocation for
        the request's private blocks cannot reclaim these."""
        for node in m.pin_path:
            self._pin(rid, node)
        for node in m.src_path:
            self._pin(rid, node)
        pb = self.pin_blocks.setdefault(
            rid, {d: [] for d in self.pools})
        out: Dict[int, List[int]] = {d: [] for d in self.pools}
        for e in m.full_entries:
            for d, bid in e.blocks.items():
                out[d].append(bid)
                pb[d].append(bid)
        return out

    def cow_fork(self, rid: str, m: PrefixMatch) -> Dict[int, int]:
        """Copy-on-write commit: ``rid`` will write inside the partially
        matched block, so it takes a private clone instead of a pin. Drops
        the pins that existed only to protect the source (the descent below
        the branch point) and returns the per-device *source* block ids for
        the data-plane copy."""
        for node in reversed(m.src_path):
            self._unpin(rid, node)
        return dict(m.src_entry.blocks)

    # ---- host → device promotion ---------------------------------------------
    def promote_hold(self, rid: str, m: PrefixMatch) -> None:
        """Pin-before-allocate for a promotion (PR 3 discipline): pin the
        token path covering the promoted run and the source host blocks
        BEFORE the engine allocates destination blocks, so neither device
        reclaim (triggered by that very allocation) nor host reclaim can
        invalidate the hit mid-admission. Rolled back by ``release``."""
        for node in m.promo_path:
            self._pin(rid, node)
        hbs = [hb for _, hb in m.promo]
        self.host.promote(hbs)
        self._promo_holds[rid] = hbs

    def promote(self, rid: str, m: PrefixMatch,
                blocks_by_device: Dict[int, List[int]],
                source: str = "promo") -> int:
        """Admission committed: attach *unready* device entries for the
        promoted blocks at the SAME radix nodes their host copies sit on
        (device and host tier share one tree), owned by the store and
        pinned by ``rid``. The entries flip ready only at ``upload_done``
        (``promotion_done``), so sharers never read in-flight KV; the
        host pins move from the admission hold to the transfer record.
        Returns the promotion id for the engine's completion event.

        ``source="prefetch"`` marks a speculative ownerless promotion
        (``rid`` is then the engine's synthetic prefetch tag, released
        at delivery via :meth:`prefetch_done`)."""
        hbs = self._promo_holds.pop(rid)
        pb = self.pin_blocks.setdefault(rid, {d: [] for d in self.pools})
        entries: List[BlockEntry] = []
        for j, (idx, _hb) in enumerate(m.promo):
            last = (idx + 1) * self.bt - 1
            node = next(nd for nd in m.promo_path
                        if nd.start <= last < nd.end)
            e = BlockEntry(idx, {d: blocks_by_device[d][j]
                                 for d in self.pools}, self.bt,
                           node=node, source=source,
                           precision=self.host_precision)
            node.entries[idx] = e
            for d, bid in e.blocks.items():
                self.by_block[(d, bid)] = e
                self.pools[d].meta[bid].owner = SHARED_OWNER
                pb[d].append(bid)
            entries.append(e)
        pid = self._promo_seq = self._promo_seq + 1
        self._promos[pid] = _Promotion(rid, entries, hbs)
        self._promos_by_rid.setdefault(rid, set()).add(pid)
        self.stats["promoted"] += len(entries)
        return pid

    def promotion_done(self, pid: int) -> bool:
        """Transfer-complete event: flip the promoted entries ready
        (sharers may now pin and read them) and hand the host sources
        back via the shared H2D handoff. Exactly-once: a cancelled
        promotion (requester released mid-transfer) already dropped its
        entries — only the host pins drop, and False is returned."""
        promo = self._promos.pop(pid, None)
        if promo is None:
            return False
        by_rid = self._promos_by_rid.get(promo.rid)
        if by_rid is not None:
            by_rid.discard(pid)
            if not by_rid:
                del self._promos_by_rid[promo.rid]
        self.host_handoff(promo.host_blocks, pinned=True)
        if promo.cancelled:
            return False
        for e in promo.entries:
            e.ready = True
        return True

    def prefetch_done(self, pid: int, now: float) -> bool:
        """Delivery of a speculative (ownerless) promotion: flip the
        entries ready exactly like :meth:`promotion_done`, stamp their
        delivery time for hit/waste accounting, then release the
        synthetic prefetch tag — the entries drop to the refcount-0
        cached tier, matchable by the consumer the prefetch anticipated
        (and reclaimable under pressure like any cached prefix, so a
        misprediction leaks nothing). A prefetch cancelled mid-flight
        only drops its host pins, same as a cancelled promotion."""
        promo = self._promos.get(pid)
        rid = promo.rid if promo is not None else None
        entries = list(promo.entries) if promo is not None else []
        ok = self.promotion_done(pid)
        if ok:
            for e in entries:
                e.prefetched_at = now
        if rid is not None:
            self.release(rid)
        return ok

    def host_handoff(self, blocks: Sequence[int], pinned: bool = False)\
            -> None:
        """Block-adoption handoff shared by the two H2D completion paths
        (request upload in ``engine._finish_upload`` and promotion in
        ``promotion_done``): the transfer stops reading the host copies.
        Upload sources (owned) retire — copies still indexed in the tree
        stay cached so a future hit promotes without a fresh D2H, the
        rest free. Promotion sources (pinned) drop the transfer pin and
        get an LRU touch: a hot host copy keeps surviving reclaim."""
        if self.host is None:
            return
        if pinned:
            self.host.promote_done(blocks)
            self.host.touch([b for b in blocks if b in self.host_nodes])
            return
        kept = [b for b in blocks if b in self.host_nodes]
        if kept:
            self.host.retire(kept)
        rest = [b for b in blocks if b not in self.host_nodes]
        if rest:
            self.host.release(rest)

    # ---- publish -------------------------------------------------------------
    def publish(self, rid: str, prompt_tokens: Sequence[int],
                blocks_by_device: Dict[int, List[int]],
                start: int = 0, agent_type: Optional[str] = None) -> int:
        """Register ``rid``'s prompt blocks from block index ``start`` (its
        already-acquired shared run) as shared entries along its token
        path, splitting the tree at the branch point.

        Adoption stops at the first index another publisher already backs:
        a request's shared blocks are always a contiguous leading run of
        its table (the invariant offload/eviction stripping relies on).
        New entries are *unready* until ``mark_ready`` — their prefill has
        not executed yet. Adoption moves ownership to the store (the
        publisher's agent type no longer holds the block against its
        reservation floor)."""
        T = len(prompt_tokens)
        if T == 0:
            return 0
        path = self.tree.insert(prompt_tokens)
        # deepest entry wins per index (a stored prompt's partial tail can
        # be shadowed by a longer prompt's full block further down the path)
        avail: Dict[int, BlockEntry] = {}
        for node in path:
            avail.update(node.entries)
        pb = self.pin_blocks.setdefault(
            rid, {d: [] for d in self.pools})
        made: List[BlockEntry] = []
        for idx in range(start, -(-T // self.bt)):
            valid = min((idx + 1) * self.bt, T) - idx * self.bt
            prev = avail.get(idx)
            if prev is not None and prev.tokens >= valid:
                break           # foreign coverage: stop, keep run contiguous
            if any(idx >= len(blocks_by_device.get(d, []))
                   for d in self.pools):
                break           # table under-sized (defensive; engine bug)
            last = idx * self.bt + valid - 1
            node = next(nd for nd in path if nd.start <= last < nd.end)
            e = BlockEntry(idx, {d: blocks_by_device[d][idx]
                                 for d in self.pools}, valid, node=node)
            node.entries[idx] = e
            for nd in path:     # pin the path down to the adopting node
                self._pin(rid, nd)
                if nd is node:
                    break
            for d, bid in e.blocks.items():
                self.by_block[(d, bid)] = e
                p = self.pools[d]
                p.meta[bid].owner = SHARED_OWNER
                if agent_type is not None:
                    p.type_held[agent_type] = max(
                        0, p.type_held.get(agent_type, 0) - 1)
                pb[d].append(bid)
            made.append(e)
        if made:
            self.unready.setdefault(rid, []).extend(made)
            self.stats["published"] += len(made)
        # adoption that broke early (foreign coverage) can leave the
        # freshly inserted leaf hollow — drop it rather than leak a
        # token-only node per unique suffix
        self.tree.maybe_remove(path[-1])
        return len(made)

    def mark_ready(self, rid: str) -> None:
        """The publisher's prefill has executed: its entries hold real KV."""
        for e in self.unready.pop(rid, []):
            e.ready = True

    # ---- multi-turn sessions -------------------------------------------------
    def session_publish(self, tag: str, context_tokens: Sequence[int],
                        blocks_by_device: Dict[int, List[int]],
                        agent_type: Optional[str] = None
                        ) -> Dict[int, List[int]]:
        """Keep a finished turn's KV alive under a session pin.

        Walks/inserts the context token path and, per full block index
        from 0: an index already backed by a ready device entry is
        *pinned* for ``tag`` (the prefix a later turn extends — turn-1
        blocks, or a warmed promotion); an uncovered index *adopts* the
        finishing request's block as a new entry, ready immediately (the
        KV was just computed — unlike :meth:`publish` there is no
        prefill still pending). Returns the per-device block ids adopted
        so the caller can strip them from the request's tables — the
        finish path then frees only what stayed private (the partial
        trailing block). Idempotent across turns: re-pinning a covered
        node is a no-op and block ids are never double-recorded."""
        T = len(context_tokens) - len(context_tokens) % self.bt
        out: Dict[int, List[int]] = {d: [] for d in self.pools}
        if T == 0:
            return out
        path = self.tree.insert(context_tokens[:T])
        avail: Dict[int, BlockEntry] = {}
        for node in path:
            avail.update(node.entries)
        pb = self.pin_blocks.setdefault(tag, {d: [] for d in self.pools})
        seen = {d: set(ids) for d, ids in pb.items()}
        adopted = 0
        for idx in range(T // self.bt):
            prev = avail.get(idx)
            if prev is not None:
                if (not prev.ready or prev.tokens < self.bt
                        or any(d not in prev.blocks for d in self.pools)):
                    break       # unready/partial foreign coverage: stop
                for nd in path:
                    self._pin(tag, nd)
                    if nd is prev.node:
                        break
                for d, bid in prev.blocks.items():
                    if bid not in seen[d]:
                        pb[d].append(bid)
                        seen[d].add(bid)
                continue
            if any(idx >= len(blocks_by_device.get(d, []))
                   for d in self.pools):
                break           # table under-sized (defensive; engine bug)
            last = (idx + 1) * self.bt - 1
            node = next(nd for nd in path if nd.start <= last < nd.end)
            e = BlockEntry(idx, {d: blocks_by_device[d][idx]
                                 for d in self.pools}, self.bt,
                           ready=True, node=node)
            node.entries[idx] = e
            for nd in path:     # pin the path down to the adopting node
                self._pin(tag, nd)
                if nd is node:
                    break
            for d, bid in e.blocks.items():
                self.by_block[(d, bid)] = e
                p = self.pools[d]
                p.meta[bid].owner = SHARED_OWNER
                if agent_type is not None:
                    p.type_held[agent_type] = max(
                        0, p.type_held.get(agent_type, 0) - 1)
                pb[d].append(bid)
                seen[d].add(bid)
                out[d].append(bid)
            adopted += 1
        if adopted:
            self.stats["published"] += adopted
        self.tree.maybe_remove(path[-1])
        return out

    def session_blocks(self, tag: str, device: int = 0) -> List[int]:
        """Session-pinned block ids on ``device``, in context order."""
        pb = self.pin_blocks.get(tag)
        return list(pb[device]) if pb else []

    def drop_cached_path(self, context_tokens: Sequence[int]) -> int:
        """Actively free the refcount-0 cached entries along a token path
        (session drop, and device-side eviction after a session offload
        lands): unlike pressure-driven reclaim this targets exactly the
        released session's blocks, so its device memory comes back
        immediately instead of waiting for allocation pressure to sweep
        the LRU frontier. Entries on nodes still pinned by anyone else
        are left alone. Returns the number of entries freed."""
        path, _ = self.tree.walk(context_tokens)
        n = 0
        for node in reversed(path):     # deepest-first: hollow leaves drop
            if node.refs:
                continue
            for e in list(node.entries.values()):
                if e.ready:
                    self._drop_entry(e)
                    n += 1
        self.stats["reclaimed"] += n
        return n

    # ---- release / refcounts -------------------------------------------------
    def release(self, rid: str, req=None) -> None:
        """Drop every pin held by ``rid`` (finish / eviction / rollback).

        Entries the publisher never filled are deleted and their blocks
        freed outright; nodes whose last pin drops move their (ready)
        entries to the reclaimable LRU. Refs are dropped deepest-first so
        path pinning holds at every intermediate state. When ``req`` is
        given, the shared block ids are stripped from its per-device
        tables so the caller can free the remaining private blocks."""
        for e in self.unready.pop(rid, []):
            if not e.ready:
                self._drop_entry(e)
        # cancel the requester's in-flight promotions: unfilled entries
        # drop (their device blocks free), but the transfer record stays
        # so the pending ``promotion_done`` event still releases the host
        # pins exactly once (never a double-release). An admission hold
        # that never became a transfer rolls its host pins back here.
        hbs = self._promo_holds.pop(rid, None)
        if hbs is not None:
            self.host.promote_done(hbs)
        for pid in self._promos_by_rid.pop(rid, set()):
            promo = self._promos[pid]
            promo.cancelled = True
            for e in promo.entries:
                if not e.ready:
                    self._drop_entry(e)
            promo.entries = []
        for node in reversed(self.pins.pop(rid, [])):
            node.refs.discard(rid)
            if not node.refs:
                self._node_released(node)
        pb = self.pin_blocks.pop(rid, None)
        if req is not None and pb:
            for d, ids in pb.items():
                lst = req.gpu_blocks_by_device.get(d)
                if lst:
                    for bid in ids:
                        if bid in lst:
                            lst.remove(bid)

    def pinned_count(self, rid: str) -> int:
        """Leading shared blocks in ``rid``'s device-0 table."""
        pb = self.pin_blocks.get(rid)
        return len(pb[0]) if pb else 0

    def refcount(self, prompt_tokens: Sequence[int]) -> int:
        """Pins on the node ending exactly at ``len(prompt_tokens)``."""
        node = self.tree.node_at(prompt_tokens)
        return len(node.refs) if node is not None else 0

    @property
    def lru(self) -> List[BlockEntry]:
        """Reclaimable (ready, refcount-0) entries — test/introspection."""
        return [e for e in set(self.by_block.values())
                if e.ready and not e.node.refs]

    # ---- host tier (§6.3 CPU prefix index, mooncake mode) --------------------
    def host_publish(self, prompt_tokens: Sequence[int],
                     host_blocks: Sequence[int], start: int = 0) -> None:
        """Attach host block ids to the tree nodes covering block indices
        ``[start, start + len(host_blocks))`` of this prompt. Unlike the
        PR 2 hash chain, attachment works at any depth — a suffix offload
        behind a device-resident shared prefix is still matchable because
        device and host walk the same tree."""
        if self.host is None or not host_blocks:
            return
        cover = min(len(prompt_tokens),
                    (start + len(host_blocks)) * self.bt)
        path = self.tree.insert(prompt_tokens[:cover])
        for j, hb in enumerate(host_blocks):
            idx = start + j
            last = (idx + 1) * self.bt - 1
            if last >= cover:
                break           # only whole prompt blocks are addressable
            node = next(nd for nd in path if nd.start <= last < nd.end)
            node.host[idx] = hb
            self.host_nodes[hb] = node
        self.tree.maybe_remove(path[-1])    # drop a leaf left hollow

    def host_match(self, prompt_tokens: Sequence[int]) -> int:
        """Leading full-block run servable by *either* tier along the
        matched path (host-resident, or ready on device).

        Counting device-backed indices too is what makes the two tiers
        compose: a host copy of block ``k`` sitting behind ``k`` device-
        resident blocks extends the run to ``k+1`` — the H2D promotion
        path could fill exactly that gap. The engine dedups by
        subtracting its device-tier ``n_full``, so ``cpu_prefix_hits``
        counts only blocks the device tier cannot serve by itself."""
        if self.host is None:
            return 0
        path, matched = self.tree.walk(prompt_tokens)
        hosts: Dict[int, int] = {}
        avail: Dict[int, BlockEntry] = {}
        for node in path:
            hosts.update(node.host)
            avail.update(node.entries)
        n = 0
        while (n + 1) * self.bt <= matched:
            e = avail.get(n)
            if n not in hosts and not (
                    e is not None and e.ready and e.tokens >= self.bt):
                break
            n += 1
        return n

    # ---- cluster plane: coverage digest + remote-sourced publish -------------
    def coverage_digest(self) -> List[Tuple[int, int, int]]:
        """Compact gossip summary of this replica's radix coverage.

        Returns ``(idx, chain_hash, bits)`` triples — one per servable
        block-aligned prefix, never the tree itself: ``bits`` is
        ``TIER_DEVICE`` for a ready full block resident on every device
        and/or ``TIER_HOST`` for a host-backed index. Read-only (a gossip
        tick must not perturb the store), and deliberately lossy: the
        router walking a prompt's :func:`token_chain` against the hash
        set stops at the first absent block, so non-contiguous coverage
        truncates to the leading servable run exactly like a real match
        would."""
        def classify(node: RadixNode, idx: int) -> int:
            bits = 0
            e = node.entries.get(idx)
            if (e is not None and e.ready and e.tokens >= self.bt
                    and all(d in e.blocks for d in self.pools)):
                bits |= TIER_DEVICE
            if idx in node.host:
                bits |= TIER_HOST
            return bits
        return self.tree.block_digest(classify)

    def remote_import(self, rid: str, prompt_tokens: Sequence[int],
                      start: int, blocks_by_device: Dict[int, List[int]],
                      ) -> Tuple[Optional[int], int]:
        """Publish a cross-replica pull in flight: *unready* entries with
        ``source="remote"`` for block indices ``start..start+k`` along the
        prompt's token path, pinned by the synthetic pull tag ``rid``.

        The PR 4 promotion discipline applies unchanged — sharers that
        match into the run wait on the pending-promotion gate instead of
        recomputing or starting a duplicate pull, and the entries flip
        ready only at :meth:`remote_done`. Adoption stops at the first
        index that already carries any device entry (ready, or another
        transfer in flight: never double-transfer) — the caller frees the
        unused destination blocks. Returns ``(promotion id, blocks
        adopted)``; ``(None, 0)`` when local coverage won the race
        entirely."""
        k = min(len(v) for v in blocks_by_device.values())
        cover = min(len(prompt_tokens), (start + k) * self.bt)
        path = self.tree.insert(prompt_tokens[:cover])
        avail: Dict[int, BlockEntry] = {}
        for node in path:
            avail.update(node.entries)
        pb = self.pin_blocks.setdefault(rid, {d: [] for d in self.pools})
        entries: List[BlockEntry] = []
        for j, idx in enumerate(range(start, start + k)):
            if (idx + 1) * self.bt > cover:
                break            # partial tail: not block-aligned pullable
            if avail.get(idx) is not None:
                break            # foreign coverage: never double-transfer
            last = (idx + 1) * self.bt - 1
            node = next(nd for nd in path if nd.start <= last < nd.end)
            e = BlockEntry(idx, {d: blocks_by_device[d][j]
                                 for d in self.pools}, self.bt,
                           node=node, source="remote",
                           precision=self.host_precision)
            node.entries[idx] = e
            for nd in path:      # pin the path down to the adopting node
                self._pin(rid, nd)
                if nd is node:
                    break
            for d, bid in e.blocks.items():
                self.by_block[(d, bid)] = e
                self.pools[d].meta[bid].owner = SHARED_OWNER
                pb[d].append(bid)
            entries.append(e)
        self.tree.maybe_remove(path[-1])
        if not entries:
            self.release(rid)    # drop the empty pin-block record
            return None, 0
        pid = self._promo_seq = self._promo_seq + 1
        self._promos[pid] = _Promotion(rid, entries, [])
        self._promos_by_rid.setdefault(rid, set()).add(pid)
        self.stats["promoted"] += len(entries)
        return pid, len(entries)

    def remote_done(self, pid: int, now: float) -> bool:
        """Delivery of a cross-replica pull: identical lifecycle to an
        ownerless prefetch (flip ready, stamp delivery time, release the
        synthetic tag so the blocks drop to the cached tier) — the
        ``source="remote"`` marker splits the hit/waste counters."""
        return self.prefetch_done(pid, now)

    def _on_host_release(self, blocks: Sequence[int]) -> None:
        """Host pool freed blocks (upload finished): unindex them."""
        for hb in blocks:
            node = self.host_nodes.pop(hb, None)
            if node is None:
                continue
            for idx, b in list(node.host.items()):
                if b == hb:
                    del node.host[idx]
            self.tree.maybe_remove(node)

    # ---- internals -----------------------------------------------------------
    def _pin(self, rid: str, node: RadixNode) -> None:
        if rid in node.refs:
            return
        if not node.refs:
            self._node_to_shared(node)
        node.refs.add(rid)
        self.pins.setdefault(rid, []).append(node)

    def _unpin(self, rid: str, node: RadixNode) -> None:
        if rid not in node.refs:
            return
        node.refs.discard(rid)
        pins = self.pins.get(rid)
        if pins and node in pins:
            pins.remove(node)
        if not node.refs:
            self._node_released(node)

    def _node_to_shared(self, node: RadixNode) -> None:
        """First pin landed: LRU (reclaimable) -> pinned shared-held."""
        for e in node.entries.values():
            for d, bid in e.blocks.items():
                p = self.pools[d]
                p.cached_blocks.discard(bid)
                p.meta[bid].owner = SHARED_OWNER

    def _node_released(self, node: RadixNode) -> None:
        """Last pin dropped: entries stay cached, blocks reclaimable."""
        self.tree.tick += 1
        node.tick = self.tree.tick
        for e in node.entries.values():
            assert e.ready, "unready entry outlived its publisher's pins"
            for d, bid in e.blocks.items():
                p = self.pools[d]
                p.meta[bid].owner = None
                p.cached_blocks.add(bid)
        self.tree.maybe_remove(node)

    def _drop_entry(self, e: BlockEntry) -> None:
        """Delete an entry and free its blocks (content never valid)."""
        node = e.node
        node.entries.pop(e.index, None)
        for d, bid in e.blocks.items():
            self.by_block.pop((d, bid), None)
            p = self.pools[d]
            p.cached_blocks.discard(bid)
            p.meta[bid].owner = None
            p.meta[bid].hash_key = None
            p.free_list.append(bid)
        self.tree.maybe_remove(node)

    def _on_split(self, upper: RadixNode, lower: RadixNode) -> None:
        """Tree split under live pins: the upper half inherits the pins,
        so every pin list holding ``lower`` must also hold ``upper``
        (shallower, inserted just before it). Host back-pointers for the
        indices that moved up follow."""
        for rid in upper.refs:
            pins = self.pins.get(rid)
            if pins is not None and lower in pins and upper not in pins:
                pins.insert(pins.index(lower), upper)
        for hb in upper.host.values():
            self.host_nodes[hb] = upper

    # ---- pool hooks ----------------------------------------------------------
    def _lru_victim(self, device: int) -> Optional[int]:
        """Reclaim choice for ``DevicePool._pop_free``: the last block of
        the least-recently-released *frontier* node — deepest-first, so a
        chain is consumed from its tail and the leading run stays
        matchable. Amortized via ``_victims`` (popped from the end:
        oldest node first, deepest entry of each node first)."""
        for _ in range(2):
            while self._victims:
                node, idx = self._victims.pop()
                e = node.entries.get(idx)
                if e is None or node.refs:
                    continue            # stale: entry reclaimed / node pinned
                if (idx != max(node.entries)
                        or self.tree.has_backed_descendant(node)):
                    continue            # stale: no longer the deepest —
                                        # reclaiming it would strand deeper
                                        # cached blocks (republished chain)
                bid = e.blocks.get(device)
                if bid is not None and bid in self.pools[device].cached_blocks:
                    return bid
            frontier = self.tree.frontier()
            if not frontier:
                return None
            frontier.sort(key=lambda n: n.tick, reverse=True)
            self._victims = [(n, i) for n in frontier
                             for i in sorted(n.entries)]
        return None

    def _on_reclaim(self, device: int, bid: int, key) -> None:
        """A pool reclaimed a cached block: prune the entry and free its
        mirror copies on the other devices (a partial mirror is useless)."""
        e = self.by_block.pop((device, bid), None)
        if e is None:
            return
        e.node.entries.pop(e.index, None)
        self.stats["reclaimed"] += 1
        if e.prefetched_at is not None:
            # delivered speculatively, reclaimed before any consumer
            # pinned it: the transfer bought nothing (misprediction —
            # cross-replica pulls account separately from prefetches)
            self.stats["pull_wasted" if e.source == "remote"
                       else "prefetch_wasted"] += 1
            e.prefetched_at = None
        for d, b in e.blocks.items():
            if d == device:
                continue
            self.by_block.pop((d, b), None)
            p = self.pools[d]
            if b in p.cached_blocks:
                p.cached_blocks.remove(b)
                p.meta[b].owner = None
                p.free_list.append(b)
        self.tree.maybe_remove(e.node)

    # ---- invariants (property-test surface) ----------------------------------
    def check_invariants(self) -> None:
        """Assert the full store + tree + pool invariant set. Called by
        the property/fuzz suite after every operation."""
        self.tree.check_structure()
        total_refs = sum(len(n.refs) for n in self.tree.nodes())
        total_pins = sum(len(v) for v in self.pins.values())
        assert total_refs == total_pins, "refcounts out of sync with pins"
        for rid, nodes in self.pins.items():
            assert len(set(map(id, nodes))) == len(nodes)
            for n in nodes:
                assert rid in n.refs, f"{rid} pin list holds unpinned node"
        reachable = set(map(id, self.tree.nodes()))
        entries = set(self.by_block.values())
        for e in entries:
            assert id(e.node) in reachable, "orphan node holds live entry"
            assert e.node.entries.get(e.index) is e
        for d, p in self.pools.items():
            free, cached = set(p.free_list), set(p.cached_blocks)
            assert not free & cached
            for bid in cached:
                e = self.by_block.get((d, bid))
                assert e is not None and e.ready and not e.node.refs, \
                    f"cached block {bid} not a refcount-0 ready entry"
            for (dd, bid), e in self.by_block.items():
                if dd != d:
                    continue
                assert bid not in free, f"entry block {bid} on free list"
                if e.node.refs:
                    assert p.meta[bid].owner == SHARED_OWNER
                    assert bid not in cached
                else:
                    assert e.ready and bid in cached
        for promo in self._promos.values():
            for e in promo.entries:
                assert not e.ready, "in-flight promotion entry became ready"
                assert promo.rid in e.node.refs, \
                    "promotion entry on a node its requester doesn't pin"
            for hb in promo.host_blocks:
                assert self.host.pins.get(hb, 0) > 0, \
                    f"in-flight promotion source {hb} unpinned"
        if self.host is not None:
            hfree, hcached = set(self.host.free_list), set(self.host.cached)
            assert not hfree & hcached, "host block both free and cached"
            for hb in self.host.pins:
                assert hb not in hfree, f"pinned host block {hb} on free list"
            counts: Dict[str, int] = {}
            for hb in self.host.cached:
                g = self.host.group_of.get(hb)
                if g is not None:
                    counts[g] = counts.get(g, 0) + 1
            assert counts == self.host.group_cached, \
                "host group_cached out of sync with cached tier"
