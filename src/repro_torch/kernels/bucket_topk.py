"""bucket_topk: candidate scoring + top-m selection.

`bucket_topk_cuda` launches `csrc/bucket_topk.cu` (the CUDA port of the
TPU kernel `repro/kernels/bucket_topk.py::bucket_topk_pallas`) on the
grid that `grid` picks, with the card's tuned `parts_per_sm`
(`kernels.autotune`, op "bucket_topk"; PARTS_PER_SM is the default); `bucket_topk_plain` is the same function in
plain PyTorch, and `two_phase_plain` the kernels' own two phases (top m
of each part of a row, then of their union) in plain PyTorch.  All take
validity as bitfield words int32 [b, ceil(kc/32)]: bit i of word w is
lane w*32 + i.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core.hashing import to_int32_bits
from repro_torch.kernels import _build, autotune, ref


def pack_valid(valid: torch.Tensor) -> torch.Tensor:
    """bool [b, kc] -> bitfield words int32 [b, ceil(kc/32)]."""
    b, kc = valid.shape
    nw = -(-kc // 32)
    bits = torch.zeros((b, nw * 32), dtype=torch.int64, device=valid.device)
    bits[:, :kc] = valid
    shifts = torch.arange(32, dtype=torch.int64, device=valid.device)
    return to_int32_bits((bits.reshape(b, nw, 32) << shifts).sum(dim=-1))


def unpack_valid(vwords: torch.Tensor, kc: int) -> torch.Tensor:
    """Inverse of `pack_valid`."""
    shifts = torch.arange(32, dtype=torch.int32, device=vwords.device)
    bits = (vwords[:, :, None] >> shifts) & 1
    return bits.reshape(vwords.shape[0], 32 * vwords.shape[1])[:, :kc] > 0


FAST_M = 32          # largest m of the kernels' warp-list selection
MERGE_KEYS = 4096    # most part entries a row's m > 32 merge sorts
PARTS_PER_SM = 4     # (row, part) blocks an SM the grid aims for
SMEM_BLOCK = 232_448  # dynamic shared memory a block may opt into


@dataclasses.dataclass(frozen=True)
class BucketTopkGrid:
    """`parts` parts a row, part p holding validity words (32 lanes a
    word) p, p + parts, ..., at most `words_per_part` of them; one block
    a (row, part)."""
    parts: int
    words_per_part: int
    blocks: int


def _parts(b: int, nw: int, parts: int) -> BucketTopkGrid:
    return BucketTopkGrid(parts, -(-nw // parts), b * parts)


@functools.lru_cache(maxsize=256)
def grid(b: int, kc: int, m: int, sms: int,
         parts_per_sm: int = PARTS_PER_SM) -> BucketTopkGrid:
    """Deal each row's ceil(kc/32) validity words to parts, enough of
    them that b * parts blocks fill the card's `sms` SMs `parts_per_sm`
    times over (at most a part a word).  For m > 32 a row's parts hold
    at most MERGE_KEYS entries together, which its merge sorts in shared
    memory, and, as far as that allows, enough parts that each part's
    sort keys fit a block's SMEM_BLOCK bytes (beyond, the launch
    raises)."""
    nw = -(-kc // 32)
    want = -(-parts_per_sm * sms // b) if b else 1
    if m > FAST_M:
        most = min(nw, max(1, MERGE_KEYS // m))
        want = min(want, most)
        while want < most and \
                sort_smem_bytes(_parts(b, nw, want), m)[0] > SMEM_BLOCK:
            want += 1
    return _parts(b, nw, max(1, min(want, nw)))


def sort_smem_bytes(g: BucketTopkGrid, m: int) -> tuple[int, int]:
    """Shared memory of the m > 32 kernels' blocks, part and merge, as
    `csrc/bucket_topk.cu::bucket_topk_launch` sizes them: sort keys over
    the next power of two, and the part's four warps' lane lists."""
    p2 = lambda n: 1 << max(0, (n - 1).bit_length())
    return 8 * p2(32 * g.words_per_part) + 4 * 16 * 32 * 4, 8 * p2(g.parts * m)


def two_phase_plain(q, cand, vwords, m: int, g: BucketTopkGrid):
    """The kernels' two phases in plain PyTorch: the m best (score desc,
    lane asc) of each part of a row's lanes (part p: the lanes of words
    p, p + parts, ...), then the m best of the parts' entries.  Equals
    `bucket_topk_plain`."""
    b, kc, _ = cand.shape
    scores = torch.einsum("bd,bkd->bk", q.float(), cand.float())
    scores = scores.masked_fill(~unpack_valid(vwords, kc), float("-inf"))
    lane = torch.arange(kc, device=cand.device)
    part_s, part_i = [], []
    for p in range(g.parts):
        mine = lane[(lane // 32) % g.parts == p]
        s, i = _top(scores[:, mine], mine.expand(b, -1), m)
        part_s.append(s)
        part_i.append(i)
    return _top(torch.cat(part_s, 1), torch.cat(part_i, 1), m)


def _top(s, i, m: int):
    """The m best (s desc, i asc) of each row; -inf / -1 past the live
    entries."""
    order = torch.argsort(i, dim=1, stable=True)
    s, i = s.gather(1, order), i.gather(1, order)
    order = torch.argsort(s, dim=1, descending=True, stable=True)[:, :m]
    s, i = s.gather(1, order), i.gather(1, order)
    live = torch.isfinite(s)
    pad = m - s.shape[1]
    s = torch.nn.functional.pad(torch.where(live, s, float("-inf")), (0, pad),
                                value=float("-inf"))
    i = torch.nn.functional.pad(torch.where(live, i, -1), (0, pad), value=-1)
    return s, i.to(torch.int32)


def bucket_topk_plain(q, cand, vwords, m: int):
    """(scores f32 [b, m], idx int32 [b, m]); ties -> lowest index."""
    return ref.bucket_topk_ref(q, cand, unpack_valid(vwords, cand.shape[1]), m)


def bucket_topk_cuda(q, cand, vwords, m: int, tuned: dict | None = None):
    """The kernels on contiguous CUDA tensors: q f32 [b, d], cand f32
    [b, kc, d], vwords int32 [b, ceil(kc/32)]; on the grid of the card's
    tuned parameters (or of `tuned`)."""
    b, kc, d = cand.shape
    scores = torch.empty((b, m), dtype=torch.float32, device=q.device)
    idx = torch.empty((b, m), dtype=torch.int32, device=q.device)
    p = autotune.get("bucket_topk", autotune.device_kind(q.device)) \
        if tuned is None else tuned
    g = grid(b, kc, m, _build.sm_count(q.device), int(p["parts_per_sm"]))
    n_part = b * g.parts if g.parts > 1 or m > FAST_M else 0
    part_s = torch.empty((n_part, m), dtype=torch.float32, device=q.device)
    part_i = torch.empty((n_part, m), dtype=torch.int32, device=q.device)
    launch = _build.entry("bucket_topk", "bucket_topk_launch",
                          [_build.P] * 7 + [_build.I] * 6 + [_build.P])
    _build.check(launch(q.data_ptr(), cand.data_ptr(), vwords.data_ptr(),
                        part_s.data_ptr(), part_i.data_ptr(),
                        scores.data_ptr(), idx.data_ptr(),
                        b, kc, d, vwords.shape[1], m, g.parts,
                        _build.stream_of(q)),
                 f"bucket_topk (kc={kc}, d={d}, m={m})")
    return scores, idx
