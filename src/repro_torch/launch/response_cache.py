"""Exact-match response cache: the tier in FRONT of the engine.

CacheWise (PAPERS.md) measures how often coding-agent tool calls are
byte-identical repeats of earlier calls — same prompt, same sampling
parameters, same expected output. That traffic never needs the KV tier
at all: an exact-match cache keyed on a content hash of the *request*
absorbs it before admission, so a repeat costs zero engine steps, zero
blocks, zero stream time.

Semantics (documented for clients in docs/SERVING_API.md):

* **Key derivation** — ``request_key(payload)`` canonicalizes the
  request dict (sorted keys, separators pinned, lists kept in order)
  and hashes it with sha256. Any byte of semantic difference — one
  prompt token, a different ``max_tokens`` — is a different key; there
  is no fuzzy matching in this tier.
* **TTL** — entries expire ``ttl`` seconds after *insertion* on the
  injected clock (the serving stack passes the engine's virtual clock,
  so simulation runs age the cache deterministically; a wall-clock
  deployment passes ``time.monotonic``). Expiry is lazy (checked on
  ``get``) plus bulk via ``sweep()``.
* **Capacity** — at most ``max_entries`` live entries, evicted LRU on
  insert overflow. An expired or evicted entry is a plain miss; the
  engine recomputes and the completion re-inserts.
* **Invalidation** — ``flush()`` drops everything (exposed as
  ``POST /v1/cache/flush``); there is no per-key invalidation because
  keys are content hashes — a changed request IS a new key.

Metrics surface through ``report()`` next to the engine's ledger:
hits / misses / inserts / expirations / evictions plus byte counters
(``hit_bytes`` = response bytes served without inference).
"""
from __future__ import annotations

import hashlib
import json
from collections import OrderedDict
from typing import Any, Callable, Optional


def request_key(payload: dict) -> str:
    """Content hash of a request: canonical JSON (sorted keys, pinned
    separators) -> sha256 hex. Exact-match only — equality of meaning is
    equality of bytes after canonicalization."""
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"),
                      ensure_ascii=True)
    return hashlib.sha256(blob.encode()).hexdigest()


class ResponseCache:
    """LRU + TTL exact-match store of finished responses.

    ``clock`` is injected so the cache ages on the caller's timeline
    (engine virtual time in simulation / tests, monotonic wall time in a
    real deployment). ``ttl=None`` disables expiry; ``max_entries``
    bounds residency with LRU eviction.
    """

    def __init__(self, ttl: Optional[float] = 600.0,
                 max_entries: int = 4096,
                 clock: Callable[[], float] = None):
        if ttl is not None and clock is None:
            # a constant clock never advances, so `clock() - inserted_at`
            # is forever 0 and expiry silently never fires — refuse the
            # footgun instead of caching stale responses indefinitely
            raise ValueError(
                "ResponseCache(ttl=...) requires a clock: entries age on "
                "the injected timeline (engine virtual clock or "
                "time.monotonic). Pass clock=..., or ttl=None to disable "
                "expiry.")
        self.ttl = ttl
        self.max_entries = max_entries
        self.clock = clock or (lambda: 0.0)
        # key -> (inserted_at, nbytes, value); OrderedDict gives LRU order
        self._store: "OrderedDict[str, tuple]" = OrderedDict()
        self.metrics = {
            "hits": 0, "misses": 0, "inserts": 0,
            "expirations": 0, "evictions": 0,
            "hit_bytes": 0, "cached_bytes": 0,
        }

    def __len__(self) -> int:
        return len(self._store)

    def _expired(self, inserted_at: float) -> bool:
        return (self.ttl is not None
                and self.clock() - inserted_at > self.ttl)

    def get(self, key: str) -> Optional[Any]:
        """Return the cached response or None. A TTL-expired entry is
        dropped here (lazy expiry) and counted as a miss."""
        ent = self._store.get(key)
        if ent is None:
            self.metrics["misses"] += 1
            return None
        inserted_at, nbytes, value = ent
        if self._expired(inserted_at):
            del self._store[key]
            self.metrics["cached_bytes"] -= nbytes
            self.metrics["expirations"] += 1
            self.metrics["misses"] += 1
            return None
        self._store.move_to_end(key)
        self.metrics["hits"] += 1
        self.metrics["hit_bytes"] += nbytes
        return value

    def put(self, key: str, value: Any, nbytes: Optional[int] = None) -> None:
        """Insert (or refresh) a finished response. ``nbytes`` defaults
        to the JSON size of the value — the byte ledger mirrors what a
        hit would have served over the wire."""
        if nbytes is None:
            nbytes = len(json.dumps(value, default=str).encode())
        old = self._store.pop(key, None)
        if old is not None:
            self.metrics["cached_bytes"] -= old[1]
        self._store[key] = (self.clock(), nbytes, value)
        self.metrics["inserts"] += 1
        self.metrics["cached_bytes"] += nbytes
        while len(self._store) > self.max_entries:
            _, (_, ev_bytes, _) = self._store.popitem(last=False)
            self.metrics["evictions"] += 1
            self.metrics["cached_bytes"] -= ev_bytes

    def sweep(self) -> int:
        """Bulk-expire everything past TTL; returns the count dropped."""
        if self.ttl is None:
            return 0
        dead = [k for k, (t, _, _) in self._store.items()
                if self._expired(t)]
        for k in dead:
            _, nbytes, _ = self._store.pop(k)
            self.metrics["cached_bytes"] -= nbytes
            self.metrics["expirations"] += 1
        return len(dead)

    def flush(self) -> int:
        """Drop every entry (``POST /v1/cache/flush``)."""
        n = len(self._store)
        self._store.clear()
        self.metrics["cached_bytes"] = 0
        return n

    def report(self) -> dict:
        m = dict(self.metrics)
        total = m["hits"] + m["misses"]
        m["entries"] = len(self._store)
        m["hit_rate"] = m["hits"] / total if total else 0.0
        m["ttl"] = self.ttl
        return m
