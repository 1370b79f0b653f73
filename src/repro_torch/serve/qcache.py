"""Sketch-keyed query-result cache with generation invalidation (DESIGN.md
Sec. 7).

The CNB-LSH insight — shift cost off the query path into state refreshed
out-of-band — extends one level above the bucket cache: two queries whose
L-table sketch-code tuples are equal probe *identical bucket sets*
(`core.plan` derives the probe plan from the codes alone), so their
results can be shared.  The cache key is therefore the sketch tuple plus
the exclusion id; by default a digest of the raw query bytes is appended
so a cached entry is only ever served for a *bit-identical* query (exact
mode — result ids provably match a direct `engine.search`).  With
`sketch_only=True` the digest is dropped and any same-sketch query shares
the entry — the paper-spirit approximate mode, trading exactness for hit
rate (the served ids are still a valid CNB probe-set result for the
sketch, just scored against the first query that populated the entry).

Invalidation is generation-based, wired to churn: every store mutation
(`insert_masked` / `expire` / payload sync) bumps `BucketStore.generation`;
entries carry the generation they were computed at and are evicted on
lookup when it no longer matches — a stale-generation entry is NEVER
served (tested under live churn in tests/test_torch_serve.py).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np


def query_digest(q: np.ndarray) -> bytes:
    """Raw query bytes (exact-mode key component).

    The bytes themselves, not a hash: a digest collision would silently
    serve another query's results, and the memory cost of keeping the
    bytes is comparable to the stored entry — so exactness is actual,
    not probabilistic."""
    return np.ascontiguousarray(q).tobytes()


@dataclasses.dataclass
class CacheEntry:
    ids: np.ndarray      # int32 [m]
    scores: np.ndarray   # f32   [m]
    generation: int      # backend generation the result was computed at


class QueryCache:
    """Bounded LRU of search results keyed on (sketch codes, exclude[, digest])."""

    def __init__(self, capacity: int = 4096, sketch_only: bool = False):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.sketch_only = sketch_only
        self._entries: OrderedDict[tuple, CacheEntry] = OrderedDict()
        # counters (the frontend's telemetry aggregates across components;
        # these are the cache's own ground truth)
        self.hits = 0
        self.misses = 0
        self.stale_evictions = 0
        self.lru_evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def key(self, codes, exclude: int, q: np.ndarray | None = None,
            m: int | None = None) -> tuple:
        """Build the lookup key for one query.

        codes: the L-table sketch-code tuple/array of the query;
        exclude: the self-exclusion id (-2 when unused) — part of the key
        because it changes the result set; q: raw query vector, digested
        in exact mode and ignored in sketch_only mode; m: the requested
        top-m — also part of the key (an entry computed at a smaller m is
        a TRUNCATED result and must never serve a larger-m request).
        """
        code_t = tuple(int(c) for c in np.asarray(codes).reshape(-1))
        m_t = -1 if m is None else int(m)
        if self.sketch_only or q is None:
            return (code_t, int(exclude), m_t)
        return (code_t, int(exclude), m_t, query_digest(q))

    def get(self, key: tuple, generation: int) -> CacheEntry | None:
        """Entry for `key` iff it was computed at `generation`; a stale
        entry is evicted (and counted) instead of served."""
        e = self._entries.get(key)
        if e is None:
            self.misses += 1
            return None
        if e.generation != generation:
            del self._entries[key]
            self.stale_evictions += 1
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return e

    def put(
        self, key: tuple, ids: np.ndarray, scores: np.ndarray, generation: int
    ) -> None:
        if key in self._entries:
            self._entries.move_to_end(key)
        self._entries[key] = CacheEntry(
            np.asarray(ids), np.asarray(scores), int(generation)
        )
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.lru_evictions += 1

    def clear(self) -> None:
        self._entries.clear()
