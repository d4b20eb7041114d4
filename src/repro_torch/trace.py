"""The port's own tracer: host spans and per-request stamps, taken where
the serving work happens (``core/backend.py``, ``models/graphs.py``,
``kvcache/paged.py``).

Off by default, and switched only by ``enable`` / ``disable``. Off,
``span`` returns one shared no-op context manager after a single flag
check, and ``stamp`` returns at once. On, a span records
``(name, t0_ns, t1_ns, fields)`` on ``time.perf_counter_ns()`` in
``spans``, and ``stamp(rid, event)`` appends ``(rid, event, t_ns)`` on
the same clock to ``stamps``. ``reset`` clears both.

With ``ranges=True`` each span also opens a
``torch.profiler.record_function`` range of its name, so that it stands
in a profiler's timeline beside the device's events. The profiler stamps
host ranges on the Unix clock; ``enable`` reads ``perf_counter_ns`` and
``time_ns`` back to back into ``clock``, and ``unix_ns`` maps a span's
stamp onto the profiler's clock through that pair.

Span names start with ``tc.``; fields are small ints (rows, bucket,
tokens, chunks).
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

PREFIX = "tc."

spans: List[tuple] = []          # (name, t0_ns, t1_ns, fields)
stamps: List[tuple] = []         # (rid, event, t_ns)
# (perf_counter_ns, time_ns) read back to back at the last enable()
clock: Optional[Tuple[int, int]] = None

_on = False           # spans and stamps are kept
_ranges = False       # spans also open profiler ranges
_record_function = None


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **fields):
        pass


NOOP = _Noop()


class _Span:
    __slots__ = ("name", "fields", "t0", "range")

    def __init__(self, name, fields):
        self.name, self.fields, self.range = name, fields, None

    # the span holds its range: the profiler stamps a range's start early
    # in its entry, whose first call in a process takes milliseconds
    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        if _ranges:
            self.range = _record_function(self.name)
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        spans.append((self.name, self.t0, time.perf_counter_ns(),
                      self.fields))
        return False

    def set(self, **fields):
        """Add fields known only inside the span."""
        self.fields.update(fields)


def span(name: str, **fields):
    if not _on:
        return NOOP
    return _Span(name, fields)


def stamp(rid: str, event: str) -> None:
    if _on:
        stamps.append((rid, event, time.perf_counter_ns()))


def enable(ranges: bool = False) -> None:
    """Switch the tracer on; with ``ranges`` each span also opens a
    profiler range. Reads the clock pair."""
    global _on, _ranges, _record_function, clock
    if ranges and _record_function is None:
        from torch.profiler import record_function
        _record_function = record_function
    _on, _ranges = True, bool(ranges)
    clock = (time.perf_counter_ns(), time.time_ns())


def disable() -> None:
    global _on, _ranges
    _on = _ranges = False


def reset() -> None:
    spans.clear()
    stamps.clear()


def unix_ns(t_ns: int) -> int:
    """A ``perf_counter_ns`` stamp on the Unix clock of the profiler's
    host ranges, through the pair the last ``enable`` read."""
    return t_ns - clock[0] + clock[1]
