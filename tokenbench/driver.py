"""The wall-paced driver, and the records the harness keeps of one run.

The engine's clock is virtual: a step advances it by the A100 cost
model's estimate, and a tool call returns at ``clock + duration``. Here
the card paces the run instead. After a step in which the backend ran
(a prefill, a decode or a migration) the clock is set to the wall
seconds since the run began, never below its value at that step's start;
after a step that only moved the clock to a future event (an arrival, a
tool return, a modelled transfer end) the driver sleeps until the wall
reaches it. A tool call's clock is also brought up to the wall when it
starts, so a tool whose drawn duration is d returns no earlier than d
wall seconds later. This mapping stands in for a wall clock the engine
would own itself.

``Recorder`` wraps methods of one engine and its backend (on the
instances, never on their classes) and records what the metrics read:
each served token, as the engine counts it in ``_post_decode``, with its
time on the wall clock after ``_decode_batch`` returned it (that call
waits for the argmax on the host), each tool call's due time, the host
time of ``schedule_step``, ``_decode_batch``, ``_prefill_batch`` and the
migrations, the pool's utilisation after each step, and, inside the
traced slice, the shapes of each decode step and prefill chunk.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional


class Recorder:
    def __init__(self, eng, backend, sync: Optional[Callable] = None):
        self.eng, self.backend, self.sync = eng, backend, sync
        self.t0 = time.perf_counter()
        self.work = 0            # backend calls: prefills, decodes, moves
        self.tokens: List[tuple] = []        # (t, rid, segment, index)
        self.calls: List[tuple] = []  # (rid, segment, wall, clock, due)
        self.scheds: List[tuple] = []        # (t0, t1)
        self.decodes: List[tuple] = []       # (t0, t1, rows)
        self.prefills: List[tuple] = []      # (t0, t1, suffix tokens, reqs)
        self.moves: List[tuple] = []         # (t0, t1, blocks, kind)
        self.util: List[tuple] = []          # (t, share held by running)
        self.queue: List[tuple] = []         # (t, waiting agents)
        self.served: Dict[str, List[int]] = {}  # rid -> served token ids
        self.upload_at: Dict[str, int] = {}  # rid -> served at first upload
        # rid -> (t, token) of each decode since the engine last counted
        self._pending: Dict[str, List[tuple]] = {}
        self.slice: Optional[dict] = None    # shapes inside the traced slice
        self.ranges = False                  # host ranges for the profiler
        self._wrap()

    def now(self) -> float:
        return time.perf_counter() - self.t0

    @contextlib.contextmanager
    def range(self, name: str):
        if not self.ranges:
            yield
            return
        from torch.profiler import record_function
        with record_function(name):
            yield

    # -- the wrappers ---------------------------------------------------------
    def _wrap(self):
        eng, be = self.eng, self.backend
        sched, post_decode, call_start = (eng.schedule_step, eng._post_decode,
                                          eng.call_start)
        decode_batch, prefill_batch = be._decode_batch, be._prefill_batch
        copy_out, copy_in = be.copy_out, be.copy_in
        step_decode, step_prefill = be.steps.decode, be.steps.prefill

        def schedule_step():
            t = self.now()
            with self.range("tb.schedule"):
                out = sched()
            self.scheds.append((t, self.now()))
            return out

        def decode_batch_hook(reqs):
            t = self.now()
            with self.range("tb.decode"):
                decode_batch(reqs)
            t1 = self.now()
            self.work += 1
            self.decodes.append((t, t1, len(reqs)))
            for r in reqs:
                gen = be.generated.get(r.rid)
                if gen:
                    self._pending.setdefault(r.rid, []).append((t1, gen[-1]))

        def post_decode_hook(batch, q_step=1, grown=False):
            # the engine counts a request's served tokens here: the first
            # ``generated_total``'s rise of the decodes since it last
            # counted; the rest ran past the segment's end, unserved
            before = [(r, r.segment, r.generated_in_segment,
                       r.generated_total) for r in batch]
            post_decode(batch, q_step, grown)
            for r, seg, g, total in before:
                pend = self._pending.pop(r.rid, [])
                for j, (t, tok) in enumerate(pend[:r.generated_total - total]):
                    self.tokens.append((t, r.rid, seg, g + j))
                    self.served.setdefault(r.rid, []).append(tok)

        def prefill_batch_hook(reqs):
            t = self.now()
            with self.range("tb.prefill"):
                prefill_batch(reqs)
            self.work += 1
            suffix = sum(be.cache_len[r.rid]
                         - min(r.prefix_cached_tokens, be.cache_len[r.rid])
                         for r in reqs)
            self.prefills.append((t, self.now(), suffix, len(reqs)))

        def move(kind, fn):
            def hook(req):
                blocks = len(req.host_blocks)
                if kind == "upload":
                    self.upload_at.setdefault(
                        req.rid, len(self.served.get(req.rid, [])))
                if self.sync:
                    self.sync()
                t = self.now()
                with self.range(f"tb.{kind}"):
                    fn(req)
                    if self.sync:
                        self.sync()
                self.work += 1
                self.moves.append((t, self.now(), blocks, kind))
            return hook

        def call_start_hook(req):
            wall = self.now()
            eng.clock = max(eng.clock, wall)
            call_start(req)
            due = max(t for t, _, kind, rid in eng.events
                      if kind == "call_finish" and rid == req.rid)
            self.calls.append((req.rid, req.segment, wall, eng.clock, due))

        def step_decode_hook(params, k, v, tokens, tables, positions,
                             attn_lens, slots):
            if self.slice is not None:
                self.slice["decode"].append(attn_lens[attn_lens > 0].copy())
            return step_decode(params, k, v, tokens, tables, positions,
                               attn_lens, slots)

        def step_prefill_hook(params, k, v, tokens, tables, q_pos, wpages,
                              wstart, wcount):
            if self.slice is not None:
                rows = [r[r >= 0] for r in q_pos if (r >= 0).any()]
                self.slice["prefill"].append(
                    [(len(r), int(r.max()) + 1, int((r + 1).sum()))
                     for r in rows])
            return step_prefill(params, k, v, tokens, tables, q_pos, wpages,
                                wstart, wcount)

        eng.schedule_step = schedule_step
        eng._post_decode = post_decode_hook
        eng.call_start = call_start_hook
        be._decode_batch = decode_batch_hook
        be._prefill_batch = prefill_batch_hook
        be.copy_out = move("offload", copy_out)
        be.copy_in = move("upload", copy_in)
        be.steps.decode = step_decode_hook
        be.steps.prefill = step_prefill_hook

    def queue_at(self, t: float) -> int:
        """Agents waiting for admission after the last step before t."""
        return next((n for u, n in reversed(self.queue) if u <= t), 0)

    def begin_slice(self):
        self.slice = {"decode": [], "prefill": [], "t0": self.now()}
        self.ranges = True

    def end_slice(self) -> dict:
        """Stop recording shapes; returns the slice's records, with the
        requests its prefills served."""
        sl, self.slice, self.ranges = self.slice, None, False
        sl["t1"] = self.now()
        sl["prefill_reqs"] = sum(n for t, _, _, n in self.prefills
                                 if t >= sl["t0"])
        return sl


def drive(eng, rec: Recorder, t_end: float,
          marks=(), on_mark: Optional[Callable] = None) -> None:
    """Step ``eng`` on the wall clock until ``rec.now()`` reaches
    ``t_end``. ``on_mark(t)`` is called between steps, once the wall has
    passed each time in ``marks``, one mark per step; it may return a
    further mark."""
    marks = sorted(marks)
    n_util = len(eng.util_samples)
    while True:
        now = rec.now()
        if marks and now >= marks[0]:
            nxt = on_mark(marks.pop(0))
            if nxt is not None:
                marks = sorted(marks + [nxt])
        if now >= t_end:
            return
        if eng.clock > now:
            # the clock moved to a future event: wait for the wall to
            # reach it (never past the end or the next mark)
            with rec.range("tb.sleep"):
                time.sleep(max(0.0, min([eng.clock, t_end] + marks[:1])
                               - now))
            continue
        c0, w0 = eng.clock, rec.work
        with rec.range("tb.step"):
            progressed = eng.step()
        rec.queue.append((rec.now(), len(eng.waiting)))
        if len(eng.util_samples) > n_util:
            n_util = len(eng.util_samples)
            rec.util.append((rec.now(), eng.util_samples[-1][2]))
        now = rec.now()
        if rec.work != w0:
            eng.clock = max(c0, now)
        elif not progressed:
            # drained, or starved until an event the clock does not know
            eng.clock = max(eng.clock, now)
            with rec.range("tb.sleep"):
                time.sleep(max(0.0, min([t_end, now + 0.05] + marks[:1])
                               - now))
        elif eng.clock < now:
            eng.clock = now
