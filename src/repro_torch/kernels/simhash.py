"""simhash: fused sign-random-projection sketching.

`simhash_cuda` launches `csrc/simhash.cu` (the CUDA port of the TPU
kernel `repro/kernels/simhash.py::simhash_pallas`) on the grid that
`grid` picks, with the card's tuned `warp_rows_per_sm` and
`stream_groups` (`kernels.autotune`, op "simhash"; the module constants
are the defaults); `simhash_plain` is the same function in plain
PyTorch, which serves CPU tensors and is what the kernel is held
against.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core.packed import num_words, pack_codes
from repro_torch.kernels import _build, autotune, ref

GROUP = 12                 # hyperplanes a stream lane holds sums for
MAX_WARPS = 8              # warps a stream block, at most
WARP_BLOCK = 4             # warps a block of the warp kernel
SMEM_BLOCK = 232_448       # dynamic shared memory a block may opt into
STREAM_COLS = 32           # columns of a stage of a stream warp's ring
STREAM_STAGES = 2
WARP_ROWS_PER_SM = 96      # fewer rows an SM take the warp kernel
STREAM_GROUPS = 4          # groups of 12 hyperplanes a stream block holds
STREAM_GROUP_CHOICES = (2, 4)  # the stream kernel's compiled variants


@dataclasses.dataclass(frozen=True)
class SimhashGrid:
    """The launch shape of `csrc/simhash.cu`.

    `stream`: the stream kernel (`grid_rows` x `col_splits` blocks of
    `warps` warps, each warp on `chunk_rows`-row chunks of x against the
    hyperplanes of `elems_per_block` output elements, at most `groups`
    groups of 12, staged in `smem` bytes) or the warp kernel (a warp on 4
    rows of a code or 2 rows of a packed word, `warps` a block,
    `grid_rows` blocks)."""
    stream: bool
    warps: int
    chunk_rows: int
    elems_per_block: int
    col_splits: int
    grid_rows: int
    smem: int
    groups: int = STREAM_GROUPS

    @property
    def blocks(self) -> int:
        return self.grid_rows * self.col_splits


def element_spans(k: int, L: int, packed: bool) -> list[tuple[int, int]]:
    """Global hyperplane range [lo, hi) of each output element."""
    lk = L * k
    if packed:
        return [(32 * w, min(32 * w + 32, lk)) for w in range(num_words(k, L))]
    return [(l * k, l * k + k) for l in range(L)]


def _groups(spans, epb: int) -> int:
    """The most groups of 12 hyperplanes one block of `epb` elements
    holds."""
    return max(-(-(spans[min(i + epb, len(spans)) - 1][1] - spans[i][0])
                 // GROUP) for i in range(0, len(spans), epb))


def stream_smem_bytes(d: int, warps: int, rows: int,
                      groups: int = STREAM_GROUPS) -> int:
    """Shared memory of a stream block (`csrc/simhash.cu::stream_smem`):
    its 12 * `groups` hyperplanes, transposed, and each warp's ring."""
    return 4 * (((d + 3) & ~3) * GROUP * groups
                + warps * STREAM_STAGES * rows * STREAM_COLS)


@functools.lru_cache(maxsize=256)
def grid(n: int, d: int, k: int, L: int, packed: bool, sms: int,
         warp_rows_per_sm: int = WARP_ROWS_PER_SM,
         stream_groups: int = STREAM_GROUPS) -> SimhashGrid:
    """The launch shape for x [n, d] against L*k hyperplanes on a card of
    `sms` SMs.

    Below `warp_rows_per_sm` rows an SM (a search batch) the warp
    kernel: a warp on 4 rows of a code (k <= 16) or 2 rows of a word,
    one round of loads.  Above, the stream kernel: a block an SM with up
    to 8 warps, every output element in one block where their
    hyperplanes fit in `stream_groups` groups of 12 (x is read once),
    else the fewest blocks along the elements; 64-row chunks once there
    are 4 an SM, else 32-row chunks, so that more warps share the rows.
    Where one element's hyperplanes exceed the groups, or the staged
    hyperplanes exceed SMEM_BLOCK, the warp kernel runs at any n.
    (The defaults were measured on an H100 SXM, 132 SMs; `kernels.
    autotune --sweep` times the alternatives on a card.)"""
    if stream_groups not in STREAM_GROUP_CHOICES:
        raise ValueError(f"simhash: stream_groups must be one of "
                         f"{STREAM_GROUP_CHOICES}, got {stream_groups}")
    spans = element_spans(k, L, packed)
    if n >= warp_rows_per_sm * sms:
        epb = len(spans)
        while epb and _groups(spans, epb) > stream_groups:
            epb -= 1
        rows = 64 if -(-n // 64) >= 4 * sms else 32
        chunks = -(-n // rows)
        warps = min(MAX_WARPS, -(-chunks // sms))
        smem = stream_smem_bytes(d, warps, rows, stream_groups)
        if epb and smem <= SMEM_BLOCK:
            return SimhashGrid(True, warps, rows, epb,
                               -(-len(spans) // epb),
                               min(sms, -(-chunks // warps)), smem,
                               stream_groups)
    rows = 4 if max(hi - lo for lo, hi in spans) <= 16 else 2
    return SimhashGrid(False, WARP_BLOCK, rows, 1, 1,
                       -(-(-(-n // rows) * len(spans)) // WARP_BLOCK), 0,
                       stream_groups)


def simhash_plain(x: torch.Tensor, hyperplanes: torch.Tensor, *,
                  packed: bool = False) -> torch.Tensor:
    """int32 codes [n, L], or packed words [n, W] with packed=True."""
    codes = ref.simhash_ref(x, hyperplanes)
    return pack_codes(codes, hyperplanes.shape[1]) if packed else codes


def simhash_cuda(x: torch.Tensor, hyperplanes: torch.Tensor, *,
                 packed: bool = False, tuned: dict | None = None
                 ) -> torch.Tensor:
    """The kernel on contiguous f32 CUDA tensors x [n, d], H [L, k, d],
    on the grid of the card's tuned parameters (or of `tuned`)."""
    n, d = x.shape
    L, k, _ = hyperplanes.shape
    width = num_words(k, L) if packed else L
    out = torch.empty((n, width), dtype=torch.int32, device=x.device)
    p = autotune.get("simhash", autotune.device_kind(x.device)) \
        if tuned is None else tuned
    g = grid(n, d, k, L, packed, _build.sm_count(x.device),
             int(p["warp_rows_per_sm"]), int(p["stream_groups"]))
    launch = _build.entry("simhash", "simhash_launch", [_build.P] * 3 + [
        _build.I] * 11 + [_build.P])
    _build.check(launch(x.data_ptr(), hyperplanes.data_ptr(), out.data_ptr(),
                        n, d, k, L, int(packed), int(g.stream), g.warps,
                        g.chunk_rows, g.elems_per_block, g.groups,
                        g.grid_rows, _build.stream_of(x)),
                 f"simhash (d={d}, L*k={L * k})")
    return out
