"""fused_query / fused_contains: gather -> score -> dedup -> top-m of the
probed buckets of each (query, table) row.

`fused_query_cuda` and `fused_contains_cuda` launch `csrc/fused_query.cu`
(the CUDA port of the TPU kernels `repro/kernels/fused_query.py::
fused_query_pallas` and `::fused_contains_pallas`); the `_plain`
functions are the same in plain PyTorch: the staged pipeline of
`kernels.ref`, whose top-m runs through `core.scoring.dedupe_topk`.

Row layout: `fb[r, p]` is the flat bucket row ([T*NB, C] view of the
store) of probe p; `meta[r] = (probe-validity word, exclude or target
id)`, where bit p of the word marks probe p valid.

On the card, dot runs in three steps: grouping kernels (a counting sort;
`group_pairs` is their plain version) group the valid (row, probe)
pairs by bucket row into work items of at most `ITEM_ROWS` pairs; a
score kernel reads each item's bucket row once and scores it against
all the item's query rows into a [pairs, C] buffer; select kernels (a warp a row for rows with one valid probe, a block a
row for the rest) keep the m best first occurrences of each row's ids.
Hamming runs the select kernels alone and scores the packed words in
place.  The kernels read the counts of the grouping from the card, so
the host runs ahead: the score buffer holds r*P pairs, unless that
exceeds `SCORE_BUFFER_BYTES`; then the host waits once for the count of
valid pairs and sizes the buffer by it (`score_buffer_rows`).

fused_contains takes a warp a row, `contains_grid` rows a block (at most
the card's tuned `max_rows`, `kernels.autotune` op "fused_contains";
CONTAINS_MAX_ROWS is the default): the first valid probe alone,
stopping at a hit, then the others two at a time.  fused_query has no
tuned parameter: its work items are `ITEM_ROWS` pairs, a constant of
the CUDA source.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, autotune, ref

MAX_PROBES = 31  # the validity word is an int32 with bit 31 clear
ITEM_ROWS = 16   # pairs of one score work item (FQ_ITEM_ROWS in the source)
FAST_M = 32      # largest m of the warp-list selection (FQ_FAST_M)
# largest score buffer sized for every (row, probe) pair, without a
# read-back of the valid pairs' count
SCORE_BUFFER_BYTES = 1 << 28
CONTAINS_MAX_ROWS = 16  # most rows (a warp each) of a contains block


class PairGroups(NamedTuple):
    """Valid (row, probe) pairs, numbered row-major and grouped by bucket.

    Pair j of row r is `row_ptr[r]` plus the rank of its probe among the
    row's valid probes.  The `by_*` arrays list the r*P (row, probe)
    entries sorted by bucket row, valid pairs first (the first
    `n_pairs`); work item i spans positions `item_start[i]` up to the
    next item's start (or `n_pairs`): one bucket row, at most `ITEM_ROWS`
    pairs, so a bucket named by many rows splits into several items.
    `row_order` lists the `n_small` rows with at most one valid pair
    first (when asked for), then the others, each in row order."""
    row_ptr: torch.Tensor     # int32 [r + 1]
    row_order: torch.Tensor   # int32 [r]
    by_row: torch.Tensor      # int32 [r*P] query row of each entry
    by_pair: torch.Tensor     # int32 [r*P] pair index of each entry
    by_bucket: torch.Tensor   # int32 [r*P] clamped bucket row (n_rows: invalid)
    item_start: torch.Tensor  # int32 [r*P + 1] (the first n_items hold)
    n_items: torch.Tensor     # int32 [1], on the inputs' device
    sizes: torch.Tensor       # [2] (n_pairs, n_small), on the host
    ready: object             # CUDA event after which `sizes` holds, or None


def group_pairs(fb: torch.Tensor, meta: torch.Tensor, n_rows: int, *,
                split_small: bool = True,
                item_rows: int = ITEM_ROWS) -> PairGroups:
    """Group the valid (row, probe) pairs of `fb` / `meta` by bucket row
    (clamped to [0, n_rows)) in torch ops: the plain version of the
    grouping kernels (`group_pairs_cuda`), stable in every order."""
    r, n_probes = fb.shape
    dev = fb.device
    shifts = torch.arange(n_probes, dtype=torch.int32, device=dev)
    valid = ((meta[:, :1] >> shifts) & 1) > 0                 # [r, P]
    count = valid.sum(1)
    row_ptr = torch.zeros(r + 1, dtype=torch.int32, device=dev)
    row_ptr[1:] = torch.cumsum(count, 0)
    small = count <= 1 if split_small else torch.zeros_like(valid[:, 0])
    n_small = small.sum()
    sizes = torch.stack([row_ptr[-1].long(), n_small]).cpu()
    rank = torch.where(small, torch.cumsum(small, 0),
                       n_small + torch.cumsum(~small, 0)) - 1
    row_order = torch.empty(r, dtype=torch.int32, device=dev)
    row_order.scatter_(0, rank, torch.arange(r, dtype=torch.int32,
                                             device=dev))
    bucket = torch.where(valid, fb.clamp(0, n_rows - 1), n_rows).reshape(-1)
    by_bucket, order = torch.sort(bucket.to(torch.int32), stable=True)
    pair_of = torch.cumsum(valid.reshape(-1), 0, dtype=torch.int32) - 1
    by_pair = pair_of[order]
    by_row = torch.div(order, n_probes, rounding_mode="floor").to(torch.int32)
    # an item starts every item_rows pairs from the first of its bucket
    pos = torch.arange(r * n_probes, device=dev)
    first = torch.searchsorted(by_bucket, by_bucket)
    start = ((pos - first) % item_rows == 0) & (by_bucket < n_rows)
    idx = torch.cumsum(start, 0) - 1
    item_start = torch.zeros(r * n_probes + 1, dtype=torch.int32, device=dev)
    item_start.scatter_(0, torch.where(start, idx, r * n_probes),
                        pos.to(torch.int32))
    n_items = start.sum(dtype=torch.int32).reshape(1)
    return PairGroups(row_ptr, row_order, by_row, by_pair, by_bucket,
                      item_start, n_items, sizes, None)


def fused_query_plain(ids_flat, pay_flat, q, fb, meta, *, m: int,
                      score: str = "dot"):
    """(ids int32 [r, m], scores f32 [r, m])."""
    return ref.fused_query_ref(ids_flat, pay_flat, q, fb, meta, m=m,
                               score=score)


def fused_contains_plain(ids_flat, fb, meta) -> torch.Tensor:
    """bool [r]: is the target id in any valid probed bucket row?"""
    return ref.fused_contains_ref(ids_flat, fb, meta)[:, 0] > 0


# int32 workspace of the grouping kernels, in the order of `fq_ws` in the
# source: name -> length
def ws_layout(r: int, n_probes: int, n_rows: int) -> dict:
    rp = r * n_probes
    return {"row_cnt": r, "row_ptr": r + 1, "row_order": r, "by_row": rp,
            "by_pair": rp, "by_bucket": rp, "item_start": rp,
            "bucket_cnt": n_rows, "bucket_off": n_rows + 1,
            "item_off": n_rows + 1, "tot": 8}


def score_buffer_rows(r: int, n_probes: int, c: int):
    """Rows of the dot path's [pairs, C] f32 score buffer when the host
    sizes it for every (row, probe) pair, or None when that buffer would
    exceed `SCORE_BUFFER_BYTES` and the count of valid pairs is read back."""
    rows = r * n_probes
    return rows if rows * c * 4 <= SCORE_BUFFER_BYTES else None


_sizes_out: dict = {}  # device index -> (pinned int32 [2], CUDA event)


def _group(fb, meta, n_rows: int, split_small: bool, read_back: bool):
    """Launch the grouping kernels on contiguous CUDA tensors: (int32
    workspace laid out by `ws_layout`, pinned (n_pairs, n_small) and the
    event after which they hold, or (None, None) unless `read_back`).
    The pinned buffer and the event are the device's own, reused by the
    next call."""
    r, n_probes = fb.shape
    host = ready = None
    if read_back:
        dev = fb.device.index
        if dev not in _sizes_out:
            _sizes_out[dev] = (torch.empty(2, dtype=torch.int32,
                                           pin_memory=True),
                               torch.cuda.Event())
        host, ready = _sizes_out[dev]
    ws = torch.empty(sum(ws_layout(r, n_probes, n_rows).values()),
                     dtype=torch.int32, device=fb.device)
    stream = _build.stream_of(fb)
    count = _build.entry("fused_query", "fused_query_group_count",
                         [_build.P] * 4 + [_build.I] * 4 + [_build.P])
    place = _build.entry("fused_query", "fused_query_group_place",
                         [_build.P] * 3 + [_build.I] * 4 + [_build.P])
    args = (fb.data_ptr(), meta.data_ptr(), ws.data_ptr())
    _build.check(count(*args, None if host is None else host.data_ptr(), r,
                       n_rows, n_probes, int(split_small), stream),
                 "fused_query grouping")
    if ready is not None:
        ready.record()  # (n_pairs, n_small) reach `host`; placement follows
    _build.check(place(*args, r, n_rows, n_probes, int(split_small), stream),
                 "fused_query grouping")
    return ws, host, ready


def group_pairs_cuda(fb, meta, n_rows: int, *,
                     split_small: bool = True) -> PairGroups:
    """`group_pairs` by the grouping kernels (a counting sort), on
    contiguous CUDA tensors.  Order within a bucket row, and within each
    class of `row_order`, is the atomics' order; entries past n_pairs
    (n_items) are not written; `sizes` holds until the next call."""
    r, n_probes = fb.shape
    ws, host, ready = _group(fb, meta, n_rows, split_small, True)
    views, off = {}, 0
    for name, n in ws_layout(r, n_probes, n_rows).items():
        views[name] = ws[off:off + n]
        off += n
    return PairGroups(views["row_ptr"], views["row_order"], views["by_row"],
                      views["by_pair"], views["by_bucket"],
                      views["item_start"], views["tot"][2:3], host, ready)


def fused_query_cuda(ids_flat, pay_flat, q, fb, meta, *, m: int,
                     score: str = "dot"):
    """The kernels on contiguous CUDA tensors (see `ops.fused_query`).

    Dot groups the pairs by bucket and scores each bucket's payload once
    into a [pairs, C] buffer (sized by `score_buffer_rows`, or by the
    count of valid pairs read back when that gives None); hamming scores
    the 8-byte words in place in the select kernels, with no grouping
    and no read-back."""
    n_rows, c = ids_flat.shape
    r, n_probes = fb.shape
    dw = pay_flat.shape[-1]
    ids = torch.empty((r, m), dtype=torch.int32, device=q.device)
    scores = torch.empty((r, m), dtype=torch.float32, device=q.device)
    launch = _build.entry("fused_query", "fused_query_launch",
                          [_build.P] * 9 + [_build.I] * 10 + [_build.P])
    head = (ids_flat.data_ptr(), pay_flat.data_ptr(), q.data_ptr(),
            fb.data_ptr(), meta.data_ptr())
    tail = (ids.data_ptr(), scores.data_ptr(), r, n_rows, c, dw, n_probes, m,
            int(score == "hamming"))
    stream = _build.stream_of(q)
    what = f"fused_query (P*C = {n_probes}*{c} candidates)"
    if score == "hamming":
        _build.check(launch(*head, None, None, *tail, 0, 0, 0, stream), what)
        return ids, scores
    fast = m <= FAST_M
    pairs = score_buffer_rows(r, n_probes, c)
    ws, host, ready = _group(fb, meta, n_rows, fast, pairs is None)
    if pairs is None:
        ready.synchronize()
        pairs, n_small = host.tolist()  # pairs sizes the score buffer
        small_lo = small_hi = n_small
    else:  # the kernels read n_small from the card
        small_lo, small_hi = 0, (r if fast else 0)
    buf = torch.empty((pairs, c), dtype=torch.float32, device=q.device)
    _build.check(launch(*head, ws.data_ptr(), buf.data_ptr(), *tail, pairs,
                        small_lo, small_hi, stream), what)
    return ids, scores


@dataclasses.dataclass(frozen=True)
class ContainsGrid:
    """`rows` rows a block, a warp each."""
    rows: int
    blocks: int


@functools.lru_cache(maxsize=256)
def contains_grid(r: int, sms: int,
                  max_rows: int = CONTAINS_MAX_ROWS) -> ContainsGrid:
    """The contains kernel's blocks for r rows on a card of `sms` SMs: the
    most rows a block (a power of two, up to `max_rows`) that still
    leaves a block for every SM, so that a small batch spreads over the
    card."""
    if max_rows < 1 or max_rows & (max_rows - 1) or max_rows > 32:
        raise ValueError(f"fused_contains: max_rows must be a power of two "
                         f"up to 32 (a warp a row), got {max_rows}")
    rows = max_rows
    while rows > 1 and -(-r // rows) < sms:
        rows //= 2
    return ContainsGrid(rows, -(-r // rows))


def fused_contains_cuda(ids_flat, fb, meta,
                        tuned: dict | None = None) -> torch.Tensor:
    """The kernel on contiguous CUDA tensors (see `ops.fused_contains`),
    on the blocks `contains_grid` picks with the card's tuned `max_rows`
    (or `tuned`'s)."""
    n_rows, c = ids_flat.shape
    r, n_probes = fb.shape
    hit = torch.empty((r,), dtype=torch.bool, device=fb.device)
    p = autotune.get("fused_contains", autotune.device_kind(fb.device)) \
        if tuned is None else tuned
    g = contains_grid(r, _build.sm_count(fb.device), int(p["max_rows"]))
    launch = _build.entry("fused_query", "fused_contains_launch",
                          [_build.P] * 4 + [_build.I] * 5 + [_build.P])
    _build.check(launch(ids_flat.data_ptr(), fb.data_ptr(), meta.data_ptr(),
                        hit.data_ptr(), r, n_rows, c, n_probes, g.rows,
                        _build.stream_of(fb)),
                 "fused_contains")
    return hit
