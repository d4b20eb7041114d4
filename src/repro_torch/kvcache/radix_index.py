"""Token-sequence radix tree for KV prefix indexing (SGLang-style).

The tree is the *structural* half of the prefix subsystem: edges are runs
of prompt tokens, nodes mark the branch points where stored prompts
diverge, and each node carries the KV block ids whose content ends inside
its token span. ``kvcache.prefix_store.PrefixStore`` layers the policy on
top (refcount pinning, LRU reclaim, pool bookkeeping, host tier); this
module knows nothing about pools or requests.

Why a radix tree: the PR 2 store keyed entries by chained block hashes, so
a lookup could only extend a run of *whole identical leading blocks*. But
multi-agent prompts diverge mid-block (per-agent role lines right after a
shared app preamble), and a hash-chained index scores those as a full miss
past the last aligned block. The tree matches token-by-token: two prompts
sharing 3 full blocks plus half a fourth meet at a branch point inside the
fourth block, share the 3 full blocks physically, and copy-on-write fork
the partial one. Insert/match/evict are O(depth).

Block ownership rule: KV is paged in fixed ``block_tokens`` blocks, while
edges split at arbitrary token offsets, so blocks can straddle node
boundaries. A :class:`BlockEntry` for block index ``i`` (covering token
positions ``[i*bt, (i+1)*bt)``) lives on the node containing its *last
valid token*. Straddlers therefore sit below the branch point — each
branch owns its own physical copy of the block it diverged inside, and the
shared ancestors own only blocks whose tokens are common to every
descendant.

Nodes may be *hollow* (no device entries): they appear when a publisher is
evicted before its prefill ran (entries dropped, token path kept) or when
the host tier indexes a prefix that has no device copy. Hollow nodes keep
the token structure intact — a later publisher re-adopts blocks into them.
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple


def token_chain(tokens: Sequence[int], bt: int) -> List[int]:
    """Chained per-block hashes of every full ``bt``-token leading block.

    ``chain[i]`` digests blocks ``0..i`` — position-dependent, so equal
    chain values identify equal *block-aligned prefixes*, not merely equal
    block contents. This is the compact coverage key the cluster layer
    gossips: a replica summary is the set of chain values it can serve
    (:meth:`RadixTree.block_digest`), and a router scores a prompt against
    it without ever seeing the tree. Deliberately coarser than the radix
    match (mid-block divergence scores as a miss past the last aligned
    block) — that precision loss is the price of a digest that ships in a
    heartbeat.
    """
    out: List[int] = []
    h = 0
    for i in range(len(tokens) // bt):
        blk = tokens[i * bt:(i + 1) * bt]
        h = zlib.crc32(struct.pack(f"<{bt}q", *blk), h)
        out.append(h)
    return out


@dataclass(eq=False)
class BlockEntry:
    """One shared physical KV block (mirrored on every device).

    ``tokens`` is the number of *valid* leading token positions: ``bt`` for
    a full block, fewer for the partial last block of a stored prompt (the
    remaining slots hold the publisher's decode writes — past every stored
    token path, never matchable, so sharers COW-fork before writing).

    ``source`` distinguishes why an entry is unready: ``"prefill"``
    entries flip ready within the publisher's admission quantum, while
    ``"promo"`` / ``"prefetch"`` entries are H2D promotions in flight on
    the transfer stream for a *multi-step* window — the store tells
    sharers to wait for those instead of recomputing (or
    double-transferring) the blocks, and ``"remote"`` entries are
    cross-replica pulls in flight on the same stream, gated identically.
    A prefetch is an ownerless
    promotion issued speculatively ahead of its consumer's arrival;
    ``prefetched_at`` stamps its delivery time and stays set until the
    first consumer pins the entry (hit) or reclaim takes it (waste), so
    the engine can account prefetch hits/earliness exactly once.
    """
    index: int                       # block index = position // block_tokens
    blocks: Dict[int, int]           # device -> physical block id
    tokens: int                      # valid leading tokens in the block
    ready: bool = False              # prefill/upload has written the KV
    node: "RadixNode" = None         # owning node (kept in sync on splits)
    source: str = "prefill"   # "prefill" | "promo" | "prefetch" | "remote"
    prefetched_at: Optional[float] = None   # delivery time, unhit prefetch
    # precision of the tier copy this entry was filled FROM: device entries
    # are always full precision once ready (upload dequantizes in-kernel),
    # but a promotion/pull in flight from an int8 host tier is tagged so
    # match/pin knows the wire payload it is waiting on — the transfer
    # plane prices it via ``PlatformModel.block_bytes_for(precision)``
    precision: str = "fp16"


def _entry_last_token(e: "BlockEntry", bt: int) -> int:
    """Index of the entry's last valid token position."""
    return e.index * bt + e.tokens - 1


class RadixNode:
    __slots__ = ("parent", "edge", "start", "children", "entries", "host",
                 "refs", "tick")

    def __init__(self, parent: Optional["RadixNode"], edge: Tuple[int, ...],
                 start: int):
        self.parent = parent
        self.edge = edge                  # tokens from parent to this node
        self.start = start                # token depth at the edge start
        self.children: Dict[int, RadixNode] = {}   # edge[0] -> child
        self.entries: Dict[int, BlockEntry] = {}   # block index -> entry
        self.host: Dict[int, int] = {}             # block index -> host bid
        self.refs: Set[str] = set()       # rids pinning this node
        self.tick = 0                     # LRU stamp of the last unpin

    @property
    def end(self) -> int:
        return self.start + len(self.edge)

    def is_hollow(self) -> bool:
        return not self.entries and not self.host

    def __repr__(self):  # debugging aid
        return (f"RadixNode([{self.start},{self.end}) edge={len(self.edge)}t "
                f"entries={sorted(self.entries)} host={sorted(self.host)} "
                f"refs={len(self.refs)})")


class RadixTree:
    """Structure-only radix tree over token sequences.

    ``on_split(upper, lower)`` fires after a node split so the owner can
    patch any external references (the store's per-rid pin lists and its
    host-block back-pointers): ``lower`` is the original node object with a
    shortened edge, ``upper`` is freshly created and inherits the pins.
    """

    def __init__(self, block_tokens: int,
                 on_split: Optional[Callable] = None):
        self.bt = block_tokens
        self.root = RadixNode(None, (), 0)
        self.on_split = on_split
        self.tick = 0

    # ---- lookup --------------------------------------------------------------
    def walk(self, tokens: Sequence[int]
             ) -> Tuple[List[RadixNode], int]:
        """Follow ``tokens`` from the root without mutating the tree.

        Returns ``(path, L)``: the matched non-root nodes in root-to-leaf
        order and the match length in tokens. When the match ends inside
        the last node's edge, that node is still included (partially
        matched) — its leading ``L - node.start`` edge tokens are common.
        """
        node, path, matched = self.root, [], 0
        i = 0
        while i < len(tokens):
            child = node.children.get(tokens[i])
            if child is None:
                break
            e = child.edge
            lim = min(len(e), len(tokens) - i)
            j = 0
            while j < lim and e[j] == tokens[i + j]:
                j += 1
            path.append(child)
            matched += j
            i += j
            if j < len(e):
                break
            node = child
        return path, matched

    # ---- insert --------------------------------------------------------------
    def insert(self, tokens: Sequence[int]) -> List[RadixNode]:
        """Materialize the full path for ``tokens``; returns it in order.

        Splits a partially matched node at the divergence offset and hangs
        a new leaf for the uncovered remainder. Existing entries move to
        whichever half contains their last valid token (straddlers go to
        the lower half — their content belongs to the old branch).
        """
        path, matched = self.walk(tokens)
        if path and matched < path[-1].end:
            # split the partially matched trailing node at ``matched``
            path[-1] = self._split(path[-1], matched - path[-1].start)
        if matched < len(tokens):
            parent = path[-1] if path else self.root
            leaf = RadixNode(parent, tuple(tokens[matched:]), matched)
            parent.children[leaf.edge[0]] = leaf
            path.append(leaf)
        return path

    def _split(self, node: RadixNode, offset: int) -> RadixNode:
        """Split ``node`` after ``offset`` edge tokens; returns the upper
        half. ``node`` itself becomes the lower half (its identity is kept
        so deep references — children, entry back-pointers below the cut —
        stay valid)."""
        assert 0 < offset < len(node.edge)
        upper = RadixNode(node.parent, node.edge[:offset], node.start)
        upper.refs = set(node.refs)       # path pinning: pins cover ancestors
        upper.tick = node.tick
        node.parent.children[upper.edge[0]] = upper
        node.parent = upper
        node.edge = node.edge[offset:]
        node.start = upper.end
        upper.children[node.edge[0]] = node
        # entries/host blocks whose last valid token falls in the upper half
        for idx in [i for i, e in node.entries.items()
                    if _entry_last_token(e, self.bt) < upper.end]:
            e = node.entries.pop(idx)
            e.node = upper
            upper.entries[idx] = e
        for idx in [i for i in node.host
                    if (i + 1) * self.bt <= upper.end]:
            upper.host[idx] = node.host.pop(idx)
        if self.on_split is not None:
            self.on_split(upper, node)
        return upper

    # ---- maintenance ---------------------------------------------------------
    def maybe_remove(self, node: RadixNode) -> None:
        """Detach ``node`` (and newly barren ancestors) if it carries
        nothing: no entries, no host blocks, no children, no pins."""
        while (node is not None and node is not self.root
               and node.is_hollow() and not node.children and not node.refs):
            parent = node.parent
            parent.children.pop(node.edge[0], None)
            node.parent = None
            node = parent

    # ---- eviction frontier ---------------------------------------------------
    @staticmethod
    def has_backed_descendant(node: RadixNode) -> bool:
        """Any device-backed entry strictly below ``node``? (Frontier
        membership check for amortized victim queues: a queued node that
        has since gained cached descendants must not be reclaimed first —
        freeing an ancestor strands every deeper cached block.)"""
        stack = list(node.children.values())
        while stack:
            n = stack.pop()
            if n.entries:
                return True
            stack.extend(n.children.values())
        return False

    def frontier(self) -> List[RadixNode]:
        """Unpinned nodes with device entries and no device-backed
        descendants — the only legal reclaim victims. Taking frontier
        nodes first is what makes reclaim deepest-first: ancestors stay
        matchable until every deeper branch is gone.

        Iterative post-order (explicit stack): extension-prompt chains
        grow one node per prompt, so a recursive walk would overflow the
        interpreter stack right when allocation pressure needs a victim."""
        out: List[RadixNode] = []
        backed: Dict[int, bool] = {}              # id(node) -> subtree has
        stack: List[Tuple[RadixNode, bool]] = [(self.root, False)]
        while stack:
            node, visited = stack.pop()
            if not visited:
                stack.append((node, True))
                stack.extend((c, False) for c in node.children.values())
                continue
            below = any(backed[id(c)] for c in node.children.values())
            has = bool(node.entries)
            if has and not below and not node.refs and node is not self.root:
                out.append(node)
            backed[id(node)] = has or below
        return out

    # ---- coverage digest -----------------------------------------------------
    def block_digest(self, classify: Callable[[RadixNode, int], int]
                     ) -> List[Tuple[int, int, int]]:
        """Chain-hash digest of every servable block-aligned prefix.

        Read-only DFS (never splits — safe to call from a gossip tick
        without perturbing the tree). For each block index ``idx`` owned
        by a node, ``classify(node, idx)`` returns a tier bitmask (0 =
        not servable); servable blocks are emitted as ``(idx, chain_hash,
        bits)`` where ``chain_hash`` is the :func:`token_chain` value of
        the path's first ``idx + 1`` blocks. A block is only emitted when
        the path covers its full token span — partial tail blocks can't
        anchor a block-aligned prefix.
        """
        out: List[Tuple[int, int, int]] = []
        # stack carries (node, tokens-so-far, chain-so-far); token tuples
        # are shared between siblings via the parent reference
        stack: List[Tuple[RadixNode, Tuple[int, ...], List[int]]] = [
            (self.root, (), [])]
        while stack:
            node, ptoks, pchain = stack.pop()
            toks = ptoks + tuple(node.edge)
            chain = list(pchain)
            h = chain[-1] if chain else 0
            for i in range(len(chain), len(toks) // self.bt):
                blk = toks[i * self.bt:(i + 1) * self.bt]
                h = zlib.crc32(struct.pack(f"<{self.bt}q", *blk), h)
                chain.append(h)
            for idx in sorted(set(node.entries) | set(node.host)):
                if idx < len(chain):
                    bits = classify(node, idx)
                    if bits:
                        out.append((idx, chain[idx], bits))
            stack.extend((c, toks, chain)
                         for c in node.children.values())
        return out

    # ---- introspection / invariants ------------------------------------------
    def nodes(self) -> List[RadixNode]:
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            out.append(n)
            stack.extend(n.children.values())
        return out

    def node_at(self, tokens: Sequence[int]) -> Optional[RadixNode]:
        """The node whose span ends exactly at ``len(tokens)`` along the
        token path, or None (test/debug helper)."""
        path, matched = self.walk(tokens)
        if path and matched == len(tokens) and path[-1].end == matched:
            return path[-1]
        return None

    def check_structure(self) -> None:
        """Assert structural invariants (used by the property tests):

        * child links keyed by the first edge token; starts are contiguous;
        * every entry sits on the node containing its last valid token;
        * path pinning — a node's pins are a subset of its parent's, so an
          unpinned node can never have a pinned descendant (the reclaim
          frontier can't free an ancestor out from under a pin);
        * no physical (device, block) appears in two entries.
        """
        seen: Dict[Tuple[int, int], Tuple] = {}
        for n in self.nodes():
            if n is self.root:
                assert n.start == 0 and n.edge == ()
            else:
                assert len(n.edge) >= 1
                assert n.parent.children.get(n.edge[0]) is n
                assert n.start == n.parent.end
                assert n.refs <= n.parent.refs or n.parent is self.root, \
                    f"pin not path-contiguous at {n!r}"
            for idx, e in n.entries.items():
                assert e.index == idx and e.node is n
                assert 0 < e.tokens <= self.bt
                last = _entry_last_token(e, self.bt)
                assert n.start <= last < n.end, \
                    f"entry {idx} last token {last} outside {n!r}"
                for d, bid in e.blocks.items():
                    key = (d, bid)
                    assert key not in seen, f"block {key} owned twice"
                    seen[key] = (n, idx)
            for idx in n.host:
                last = (idx + 1) * self.bt - 1
                assert n.start <= last < n.end
