"""Device-resident LSH bucket store with soft-state maintenance.

Paper Sec. 4.1 "Bucket Maintenance": users periodically re-hash and
re-announce their vectors; entries not refreshed within a TTL are
garbage-collected.  Buckets are fixed-capacity rings.

Two payload modes:
  * id-only  — buckets store (id, timestamp); scoring gathers vectors
    from a corpus at search time (the engine);
  * embedded — buckets also store a payload per slot: f32 vectors
    [C, D], or packed sketch words int32 [C, W] for hamming scoring.

The public functions are functional, as the JAX reference is: each
returns a new store and leaves its input as it was.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.routing import run_ranks

EMPTY = -1


@dataclasses.dataclass
class BucketStore:
    """Bucket state, one hash table per l in [0, L).

    Shapes (T = L tables, NB = buckets per table, C = capacity):
      ids:        int32 [T, NB, C]   (-1 = empty slot)
      timestamps: int32 [T, NB, C]
      write_ptr:  int32 [T, NB]      (ring pointer)
      payload:    f32 [T, NB, C, D], int32 words [T, NB, C, W], or None
      generation: int32 0-dim tensor (mutation counter)

    `generation` counts mutations: every `insert_masked` bumps it, and
    `expire` bumps it when it collects something.  Readers that cache
    derived results treat a bump as invalidation.
    """

    ids: torch.Tensor
    timestamps: torch.Tensor
    write_ptr: torch.Tensor
    payload: torch.Tensor | None
    generation: torch.Tensor | None = None

    def __post_init__(self):
        if self.generation is None:
            self.generation = torch.zeros((), dtype=torch.int32,
                                          device=self.ids.device)

    @property
    def num_tables(self) -> int:
        return self.ids.shape[0]

    @property
    def num_buckets(self) -> int:
        return self.ids.shape[1]

    @property
    def capacity(self) -> int:
        return self.ids.shape[2]

    def occupancy(self) -> torch.Tensor:
        """Live entries per (table, bucket)."""
        return (self.ids >= 0).sum(dim=-1)

    def clone(self) -> "BucketStore":
        return BucketStore(
            self.ids.clone(), self.timestamps.clone(), self.write_ptr.clone(),
            None if self.payload is None else self.payload.clone(),
            self.generation.clone(),
        )


def make_store(
    num_tables: int,
    num_buckets: int,
    capacity: int,
    payload_dim: int | None = None,
    dtype=torch.float32,
    *,
    device=None,
) -> BucketStore:
    dev = resolve_device(device)
    shape = (num_tables, num_buckets, capacity)
    payload = (
        None if payload_dim is None
        else torch.zeros(shape + (payload_dim,), dtype=dtype, device=dev)
    )
    return BucketStore(
        ids=torch.full(shape, EMPTY, dtype=torch.int32, device=dev),
        timestamps=torch.zeros(shape, dtype=torch.int32, device=dev),
        write_ptr=torch.zeros(shape[:2], dtype=torch.int32, device=dev),
        payload=payload,
    )


def _insert_masked_(
    store: BucketStore,
    table: int,
    ids: torch.Tensor,        # int32 [n]; entries with id < 0 are skipped
    buckets: torch.Tensor,    # int [n] local bucket index per entry
    timestamp,                # int or int32 0-dim tensor
    payload: torch.Tensor | None = None,  # [n, D] or [n, W]
) -> None:
    """`insert_masked`, writing into `store` in place."""
    l = table
    nb, cap = store.num_buckets, store.capacity
    dev = ids.device
    ids = ids.to(torch.int32)
    valid = ids >= 0
    n = ids.shape[0]
    if n > 1:
        # in-batch dedupe, keep-last: stable-sort by id, keep the final row
        # of each equal-id run
        order_d = torch.argsort(ids, stable=True)
        s = ids[order_d]
        last = torch.ones(n, dtype=torch.bool, device=dev)
        last[:-1] = s[:-1] != s[1:]
        keep = torch.empty(n, dtype=torch.bool, device=dev)
        keep[order_d] = last
        valid &= keep
    bucket = torch.where(valid, buckets.to(torch.int64) % nb, nb)  # nb = none
    bucket_c = torch.clamp(bucket, max=nb - 1)

    # -- split: refresh-in-place (id already present) vs ring-append ------
    match = store.ids[l, bucket_c] == ids[:, None]          # [n, C]
    found = match.any(dim=-1) & valid
    exist_slot = torch.argmax(match.to(torch.int8), dim=-1)  # first match

    # -- ring-append the new ids ------------------------------------------
    app_bucket = torch.where(found, nb, bucket)
    order = torch.argsort(app_bucket, stable=True)
    b_sorted = app_bucket[order]
    ranks = run_ranks(b_sorted).to(torch.int64)
    counts = torch.bincount(b_sorted, minlength=nb + 1)[:nb]
    base = store.write_ptr[l, torch.clamp(b_sorted, max=nb - 1)].to(torch.int64)
    slot = (base + ranks) % cap
    # JAX's scatter drops out-of-range rows (mode="drop") and lets the last
    # of several writes to one slot win; torch has neither, so drop the
    # rows first and keep only each bucket's last `cap` appends (the ring
    # writers that survive), which makes every written slot unique.
    n_in_bucket = torch.cat([counts, counts.new_zeros(1)])[b_sorted]
    app = (b_sorted < nb) & (ranks >= n_in_bucket - cap)
    upd = found

    ts = torch.as_tensor(timestamp, dtype=torch.int32, device=dev)
    # refresh first, append second: an append that wraps onto a slot being
    # refreshed wins wholesale (a consistent ring eviction)
    store.timestamps[l, bucket_c[upd], exist_slot[upd]] = ts
    store.ids[l, b_sorted[app], slot[app]] = ids[order][app]
    store.timestamps[l, b_sorted[app], slot[app]] = ts
    store.write_ptr[l] = (store.write_ptr[l] + counts.to(torch.int32)) % cap
    if store.payload is not None:
        if payload is None:
            raise ValueError("store has payload; insert must provide vectors")
        payload = payload.to(store.payload.dtype)
        store.payload[l, bucket_c[upd], exist_slot[upd]] = payload[upd]
        store.payload[l, b_sorted[app], slot[app]] = payload[order][app]
    store.generation = store.generation + 1


def insert_masked(store: BucketStore, table: int, ids, buckets, timestamp,
                  payload=None) -> BucketStore:
    """Soft-state insert/refresh into one table (Sec. 4.1 semantics).

    An id already in its target bucket is refreshed in place (timestamp
    and payload updated, slot kept); new ids ring-append, overwriting the
    oldest slots on overflow.  Entries with id < 0 are skipped.
    Duplicate ids within one batch keep the last copy.  Returns a new
    store.
    """
    new = store.clone()
    _insert_masked_(new, table, ids, buckets, timestamp, payload)
    return new


def insert_batch(
    store: BucketStore,
    ids: torch.Tensor,        # int32 [n]
    codes: torch.Tensor,      # int32 [n, T] — bucket id per table
    timestamp,
    payload: torch.Tensor | None = None,  # [n, D] unit-norm vectors
) -> BucketStore:
    """Insert/refresh a batch of vectors into every table; returns a new
    store (one copy of the input, then written in place)."""
    new = store.clone()
    for l in range(new.num_tables):
        _insert_masked_(new, l, ids, codes[:, l], timestamp, payload)
    return new


def expire(store: BucketStore, now, ttl: int) -> BucketStore:
    """Garbage-collect entries not refreshed within `ttl` ticks.

    `generation` bumps only when something was collected; empty slots
    (timestamp 0) never count as collected."""
    stale = (now - store.timestamps) > ttl
    collected = stale & (store.ids != EMPTY)
    return dataclasses.replace(
        store,
        ids=torch.where(collected, EMPTY, store.ids),
        generation=store.generation + collected.any().to(torch.int32),
    )


def build_store_host(
    codes,                      # int [n, T] (numpy or tensor)
    num_buckets: int,
    capacity: int,
    payload=None,               # [n, D] (numpy or tensor), row i = id i
    timestamp: int = 0,
    *,
    device=None,
) -> BucketStore:
    """Bulk build for large corpora (preprocessing).

    Slot assignment runs on the host with numpy and keeps the *last*
    `capacity` entries per bucket, matching `insert_batch`.  Ids are
    positional (`arange(n)`), so the payload of slot (l, b, c) is row
    `ids[l, b, c]` of `payload`: the device payload is filled by one
    gather, with no host copy of the [T, NB, C, D] array.
    """
    dev = resolve_device(device)
    codes = np.asarray(codes.cpu() if torch.is_tensor(codes) else codes)
    n, T = codes.shape
    ids_arr = np.full((T, num_buckets, capacity), -1, dtype=np.int32)
    ptr = np.zeros((T, num_buckets), dtype=np.int32)
    all_ids = np.arange(n, dtype=np.int32)
    for l in range(T):
        bucket = (codes[:, l].astype(np.int64) & 0xFFFFFFFF) % num_buckets
        order = np.argsort(bucket, kind="stable")
        b_sorted = bucket[order]
        is_start = np.ones(n, bool)
        is_start[1:] = b_sorted[1:] != b_sorted[:-1]
        run_start = np.maximum.accumulate(np.where(is_start, np.arange(n), 0))
        ranks = np.arange(n) - run_start
        counts = np.bincount(b_sorted, minlength=num_buckets)
        # later duplicates in a slot overwrite earlier ones == keep last
        ids_arr[l, b_sorted, ranks % capacity] = all_ids[order]
        ptr[l] = counts % capacity
    ids = torch.from_numpy(ids_arr).to(dev)
    ts = torch.where(ids >= 0, timestamp, 0).to(torch.int32)
    pay = None
    if payload is not None:
        src = torch.as_tensor(payload).to(dev)
        pay = src[ids.clamp(min=0)]
        pay.masked_fill_((ids < 0)[..., None], 0)
    return BucketStore(ids=ids, timestamps=ts,
                       write_ptr=torch.from_numpy(ptr).to(dev), payload=pay)
