"""Unified transfer plane: the single copy stream as a priority queue.

The engine used to carry three near-duplicate transfer state machines
(offload, upload, promotion), each serializing itself through a bare
``stream_free_at`` scalar with its own ad-hoc metrics and rollback path.
The :class:`TransferManager` replaces that with per-transfer *lifecycle
records* (pending → in-flight → done/cancelled, exactly-once cancel) and
a priority-ordered queue over the shared stream:

    owed stall-resumes (uploads) > demand promotions > remote pulls
    > prefetches > offloads

Timing model (virtual time): transfers are booked into a serialized
timeline the moment they are submitted — ``start = max(now, prev_end)``,
exactly the PR 5 scalar-stream semantics — but slots that have not
*started* yet can still be displaced by a later, higher-priority submit
(or move earlier when a pending slot ahead of them is cancelled). Every
re-book bumps the slot's generation, pushes a fresh completion event and
invalidates the stale one, and notifies the submitter through its
``on_reschedule`` hook (the engine keeps ``promo_ready_at`` gates in sync
this way). With FIFO-only traffic — every legacy mode — no slot is ever
displaced and the completion times are bit-identical to the old scalar.

Accounting is unified here: per-kind counts / blocks / queue-wait plus
the engine's ``swap_blocks`` / ``h2d_bytes`` / ``d2h_bytes`` /
``stream_wait_s`` metrics, so the promote-vs-recompute crossover and the
figure rows read one consistent ledger no matter which state machine
issued the copy.

Key invariants:

* **Exactly-once cancel** — ``cancel`` on a pending slot unbooks it and
  drops it from the queue; on an in-flight slot it marks the record and
  lets the stream run it out (the completion event still fires, but the
  per-kind finisher sees ``cancelled`` and releases only what the
  transfer still holds). A second cancel of either is a no-op.
* **Generation-checked completions** — every re-book bumps the slot's
  generation; a completion event carrying a stale generation is ignored,
  so displacement can never double-complete a transfer.
* **Priority is strict, not aging** — upload > promotion > remote >
  prefetch > offload, ties FIFO; only *pending* (not started) slots are
  displaced, so booked start times never move backward.

The priority table and its rationale live in docs/ARCHITECTURE.md; the
serving frontend surfaces ``describe()`` via ``GET /v1/report``
(docs/SERVING_API.md).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.costmodel import PlatformModel

# stream arbitration order (lower value wins a free slot first): an owed
# stall-resume must never queue behind speculative work, and speculative
# prefetches must never delay a demand promotion some admission is gated
# on. Cross-replica pulls ("remote") sit between the two: an admission may
# be gated on the pulled blocks (demand), but the local host tier's own
# promotions answer the same demand with a faster link, so they go first.
PRIORITY = {"upload": 0, "promotion": 1, "remote": 2, "prefetch": 3,
            "offload": 4}

PENDING = "pending"
IN_FLIGHT = "in_flight"
DONE = "done"
CANCELLED = "cancelled"


@dataclass
class Transfer:
    """Lifecycle record of one block copy on the shared stream."""
    tid: int
    kind: str                    # one of the PRIORITY keys
    direction: str               # "h2d" | "d2h" | "remote"
    n_blocks: int
    payload: object              # rid (offload/upload) or promotion id
    owner: Optional[str]         # cancelling scope (rid / prefetch tag)
    priority: int
    submit_t: float
    duration: float
    start: float = 0.0
    end: float = 0.0
    state: str = PENDING
    gen: int = 0                 # booking generation (stale-event filter)
    waited: float = 0.0          # queue wait currently booked (start - submit)
    done_t: Optional[float] = None
    on_reschedule: Optional[Callable[[float], None]] = None


class TransferManager:
    def __init__(self, platform: PlatformModel, clock: Callable[[], float],
                 push: Callable[[float, str, object], None],
                 metrics: Optional[dict] = None):
        self.platform = platform
        self._clock = clock
        self._push = push
        self.metrics = metrics if metrics is not None else {}
        self._seq = itertools.count(1)
        # booked slots in stream order; a prefix of started (immovable)
        # slots followed by pending (re-orderable) ones — starts are
        # strictly increasing, so the split point is well defined
        self._timeline: List[Transfer] = []
        self.by_id: Dict[int, Transfer] = {}
        self.log: List[Transfer] = []          # terminal lifecycle records
        self.free_at = 0.0                     # end of the last booked slot
        self.count = {k: 0 for k in PRIORITY}
        self.wait_s = {k: 0.0 for k in PRIORITY}
        self.blocks = {k: 0 for k in PRIORITY}
        self.bytes = {"h2d": 0, "d2h": 0, "remote": 0}

    # ------------------------------------------------------------- accounting
    def _acct(self, key: str, delta) -> None:
        self.metrics[key] = self.metrics.get(key, 0) + delta

    def backlog(self) -> float:
        """Seconds until the stream's earliest free slot — the wait a
        transfer submitted *now* would pay before its first byte moves
        (the ``stream_backlog`` input of the cost model's crossover)."""
        return max(self.free_at - self._clock(), 0.0)

    def live_blocks(self, kind: str) -> int:
        """Blocks of ``kind`` still booked on the stream (pending or in
        flight) — the prefetch phase caps its budget with this."""
        return sum(t.n_blocks for t in self._timeline if t.kind == kind)

    # -------------------------------------------------------------- lifecycle
    def _advance(self, now: float) -> None:
        """Pending slots whose start time arrived are committed to the
        copy engine: immovable from here on."""
        for t in self._timeline:
            if t.start > now:
                break
            if t.state == PENDING:
                t.state = IN_FLIGHT

    def _repack(self, i: int, now: float) -> None:
        """Re-book slots from index ``i`` on (after an insert or a
        pending-cancel): starts snap to ``max(now, prev_end)``, moved
        slots get a fresh generation + completion event, and their
        submitters are notified via ``on_reschedule``."""
        for j in range(i, len(self._timeline)):
            t = self._timeline[j]
            prev_end = self._timeline[j - 1].end if j > 0 else now
            s = max(now, prev_end)
            if t.gen > 0 and s == t.start:
                continue
            rebooked = t.gen > 0
            t.start, t.end = s, s + t.duration
            t.gen += 1
            waited = s - t.submit_t
            self.wait_s[t.kind] += waited - t.waited
            self._acct("stream_wait_s", waited - t.waited)
            t.waited = waited
            self._push(t.end, "transfer_done", (t.tid, t.gen))
            if rebooked and t.on_reschedule is not None:
                t.on_reschedule(t.end)
        if self._timeline:
            self.free_at = self._timeline[-1].end

    def submit(self, kind: str, n_blocks: int, payload,
               owner: Optional[str] = None,
               on_reschedule: Optional[Callable[[float], None]] = None,
               duration: Optional[float] = None,
               bytes_per_block: Optional[int] = None) -> Transfer:
        """Book a copy on the stream. ``duration`` overrides the local
        platform's timing — cross-replica pulls are priced by the caller
        through a per-link :class:`PlatformModel` (the inter-replica
        fabric is not this replica's PCIe/DMA engine) but still serialize
        on this stream because the landing blocks do ride it.
        ``bytes_per_block`` overrides the platform's fixed fp16 block size
        in the h2d/d2h/remote ledgers — a quantized block moves fewer
        bytes on the wire than the pool slot it fills, and the ledgers
        report *wire* traffic (``platform.block_bytes_for(precision)``),
        not slot capacity."""
        if kind == "remote":
            direction = "remote"
        else:
            direction = "d2h" if kind == "offload" else "h2d"
        if duration is not None:
            dur = duration
        else:
            dur = (self.platform.offload_time(n_blocks)
                   if direction == "d2h"
                   else self.platform.upload_time(n_blocks))
        now = self._clock()
        tr = Transfer(next(self._seq), kind, direction, n_blocks, payload,
                      owner, PRIORITY[kind], now, dur,
                      on_reschedule=on_reschedule)
        self._advance(now)
        # insertion point: behind every started slot and every pending
        # slot of equal-or-higher priority (stable FIFO within a class)
        i = len(self._timeline)
        while i > 0:
            prev = self._timeline[i - 1]
            if prev.state != PENDING or prev.priority <= tr.priority:
                break
            i -= 1
        self._timeline.insert(i, tr)
        self.by_id[tr.tid] = tr
        self._repack(i, now)
        self.count[kind] += 1
        self.blocks[kind] += n_blocks
        bpb = (bytes_per_block if bytes_per_block is not None
               else self.platform.block_bytes)
        self.bytes[direction] += n_blocks * bpb
        self._acct("swap_blocks", n_blocks)
        self._acct(f"{direction}_bytes", n_blocks * bpb)
        return tr

    def on_event(self, payload: Tuple[int, int]) -> Optional[Transfer]:
        """Resolve a ``transfer_done`` event. Returns the completed record
        (state ``done``, or ``cancelled`` for an in-flight cancel whose
        slot still ran), or None for a stale booking generation."""
        tid, gen = payload
        tr = self.by_id.get(tid)
        if tr is None or tr.gen != gen:
            return None
        self._advance(self._clock())
        self._timeline.remove(tr)
        del self.by_id[tid]
        if tr.state != CANCELLED:
            tr.state = DONE
        tr.done_t = tr.end
        self.log.append(tr)
        if not self._timeline:
            self.free_at = max(self.free_at, tr.end)
        return tr

    def cancel(self, tid: int) -> bool:
        """Exactly-once cancel. A pending slot is removed from the stream
        outright (its event goes stale, followers move earlier); an
        in-flight slot cannot be un-copied — it is only marked, and its
        completion event still fires with state ``cancelled``. Returns
        False on a repeat cancel or an already-terminal transfer."""
        tr = self.by_id.get(tid)
        if tr is None or tr.state in (DONE, CANCELLED):
            return False
        now = self._clock()
        self._advance(now)
        if tr.state != PENDING:
            tr.state = CANCELLED
            return True
        i = self._timeline.index(tr)
        self._timeline.pop(i)
        del self.by_id[tid]
        tr.state = CANCELLED
        tr.gen += 1                       # orphan the pushed event
        self.wait_s[tr.kind] -= tr.waited  # it never actually waited a slot
        self._acct("stream_wait_s", -tr.waited)
        tr.waited = 0.0
        self.log.append(tr)
        self._repack(i, now)
        if not self._timeline:
            self.free_at = now
        return True

    def cancel_owner(self, owner: str) -> List[Transfer]:
        """Cancel every live transfer owned by ``owner``. Returns the
        records whose completion event will never fire (removed while
        pending) — the caller must run their completion handling itself
        so per-transfer teardown (e.g. dropping a cancelled promotion's
        host pins) still happens exactly once."""
        removed = []
        for tr in [t for t in self._timeline if t.owner == owner]:
            if self.cancel(tr.tid) and tr.done_t is None \
                    and tr.tid not in self.by_id:
                removed.append(tr)
        return removed

    # ----------------------------------------------------------- introspection
    def live(self) -> List[Transfer]:
        return list(self._timeline)

    def describe(self) -> dict:
        """Unified ledger for reports / the serving frontend."""
        return {
            "kinds": {k: {"count": self.count[k], "blocks": self.blocks[k],
                          "wait_s": round(self.wait_s[k], 6)}
                      for k in PRIORITY},
            "bytes": dict(self.bytes),
            "live": len(self._timeline),
            "backlog_s": round(self.backlog(), 6),
        }
