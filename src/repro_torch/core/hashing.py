"""Cosine LSH via sign random projections (Charikar, STOC'02).

A bucket function concatenates k sign bits of random projections into a
k-bit sketch; L independent functions map each vector into L buckets.
Sketch codes are int32 tensors holding k <= 30 live bits, so they are
non-negative and behave the same as the JAX package's uint32 codes.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device

MAX_K = 30  # codes keep bit 31 clear, so int32 arithmetic on them is safe
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class LshParams:
    """Static configuration of the LSH scheme (paper Sec. 3.1)."""

    d: int  # input dimensionality
    k: int  # bits per sketch (hash functions per g)
    L: int  # number of hash tables / buckets per vector
    seed: int = 0

    def __post_init__(self):
        if not (1 <= self.k <= MAX_K):
            raise ValueError(f"k must be in [1, {MAX_K}], got {self.k}")
        if self.L < 1:
            raise ValueError(f"L must be >= 1, got {self.L}")

    @property
    def num_buckets(self) -> int:
        return 1 << self.k


def make_hyperplanes(
    params: LshParams,
    generator: torch.Generator | None = None,
    *,
    device=None,
    dtype=torch.float32,
) -> torch.Tensor:
    """Sample the L*k Gaussian hyperplanes, shape [L, k, d].

    Drawn on the CPU from `generator` (default: seeded with
    `params.seed`) and moved to `device`, so a seed gives the same
    hyperplanes on every device.  They are not the JAX package's
    hyperplanes: its PRNG cannot be reproduced here, and tests carry
    those across through `repro_torch.convert`.
    """
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(params.seed)
    h = torch.randn((params.L, params.k, params.d), generator=generator,
                    dtype=dtype)
    return h.to(dev)


def normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12):
    """L2-normalize so that cosine similarity == dot product."""
    n = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(n, min=eps)


def _projections(x: torch.Tensor, hyperplanes: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...d,lkd->...lk", x.float(), hyperplanes.float())


def sketch_bits(x: torch.Tensor, hyperplanes: torch.Tensor) -> torch.Tensor:
    """bool [..., L, k]; bit j of table l is (x . h_{l,j} >= 0)."""
    return _projections(x, hyperplanes) >= 0


def projection_margins(x: torch.Tensor, hyperplanes: torch.Tensor):
    """|x . h| per bit, [..., L, k] — the multi-probe ranking signal."""
    return _projections(x, hyperplanes).abs()


def to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same low 32 bits."""
    x = x & _U32
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack [..., k] boolean bits into int32 codes (bit 0 = index 0)."""
    k = bits.shape[-1]
    w = torch.arange(k, device=bits.device, dtype=torch.int64)
    return to_int32_bits(torch.sum(bits.to(torch.int64) << w, dim=-1))


def unpack_bits(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of `pack_bits`: int32 [...] -> bool [..., k]."""
    shifts = torch.arange(k, device=codes.device, dtype=torch.int64)
    return ((codes.to(torch.int64)[..., None] & _U32) >> shifts) & 1 > 0


def sketch_codes(x: torch.Tensor, hyperplanes: torch.Tensor) -> torch.Tensor:
    """x [..., d] -> int32 codes [..., L]: the L bucket ids of each vector."""
    return pack_bits(sketch_bits(x, hyperplanes))


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """32-bit popcount (SWAR) of int32 bit patterns -> int32.

    Runs in int64 on the low 32 bits, so a word with bit 31 set counts
    that bit once and no step can overflow."""
    x = x.to(torch.int64) & _U32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) >> 24) & 0xFF).to(torch.int32)


def sketch_codes_batched(x, hyperplanes: torch.Tensor,
                         batch: int = 65536) -> torch.Tensor:
    """Chunked sketching of a large corpus (the preprocessing path).

    `x` is a dense [n, d] tensor, or a corpus with `densify` (a
    `SparseCorpus`), whose rows are densified `batch` at a time on its
    device.  Each chunk goes through `ops.simhash`: the CUDA kernel on
    CUDA tensors, its plain version on CPU ones.  Returns int32 codes
    [n, L] on the hyperplanes' device, as `build_store_host` takes them.
    """
    from repro_torch.kernels import ops

    sparse = hasattr(x, "densify")
    n = x.n if sparse else x.shape[0]
    h = hyperplanes.float().contiguous()
    out = torch.empty((n, h.shape[0]), dtype=torch.int32, device=h.device)
    for s in range(0, n, batch):
        e = min(s + batch, n)
        if sparse:
            chunk = x.densify(torch.arange(s, e, device=x.nnz_ids.device))
        else:
            chunk = x[s:e]
        out[s:e] = ops.simhash(chunk.to(h.device, torch.float32).contiguous(),
                               h)
    return out


def hamming_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Popcount Hamming distance between packed codes (int32 bit
    patterns) -> int32."""
    return popcount32(torch.bitwise_xor(a.to(torch.int32), b.to(torch.int32)))


def collision_probability(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Analytical Pr[h(u)=h(v)] = angular similarity (Eq. 2/3 of the
    paper)."""
    un, vn = normalize(u), normalize(v)
    cos = torch.clamp(torch.sum(un * vn, dim=-1), -1.0, 1.0)
    return 1.0 - torch.arccos(cos) / torch.pi
