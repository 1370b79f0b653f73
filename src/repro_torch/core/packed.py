"""Bit-packed sketch-code layout of the hamming scoring mode.

A vector's L k-bit sketch codes fold into W = ceil(L*k / 32) dense words
[..., W]: global bit g = l*k + j lands in word g // 32 at position g % 32
(little-endian within and across words).  Words are int32 bit patterns;
`.numpy().view(np.uint32)` gives the JAX package's uint32 words.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.hashing import (
    MAX_K, _U32, popcount32, sketch_codes, to_int32_bits,
)


def _check_k(k: int) -> None:
    """k-bit codes with 1 <= k <= MAX_K only: a larger k would break the
    `unpack(pack(c)) == c` round-trip without an error."""
    if not (1 <= k <= MAX_K):
        raise ValueError(
            f"packed layout supports k in [1, {MAX_K}] bits per code, "
            f"got k={k}"
        )


def num_words(k: int, L: int) -> int:
    """32-bit words needed to hold L k-bit codes."""
    _check_k(k)
    return max(1, -(-(k * L) // 32))


def pack_codes(codes: torch.Tensor, k: int) -> torch.Tensor:
    """int32 codes [..., L] (k live bits each) -> packed words [..., W].

    Bits >= k of each input code are ignored."""
    _check_k(k)
    L = codes.shape[-1]
    W = num_words(k, L)
    dev = codes.device
    j = torch.arange(k, device=dev, dtype=torch.int64)
    bits = (codes.to(torch.int64)[..., None] >> j) & 1      # [..., L, k]
    flat = bits.reshape(codes.shape[:-1] + (L * k,))
    g = torch.arange(L * k, device=dev, dtype=torch.int64)
    shifted = flat << (g % 32)
    words = [shifted[..., w * 32:(w + 1) * 32].sum(dim=-1) for w in range(W)]
    return to_int32_bits(torch.stack(words, dim=-1))


def unpack_codes(words: torch.Tensor, k: int, L: int) -> torch.Tensor:
    """Inverse of `pack_codes`: words [..., W] -> int32 codes [..., L]."""
    _check_k(k)
    dev = words.device
    g = torch.arange(L * k, device=dev, dtype=torch.int64)
    w64 = words.to(torch.int64) & _U32
    bit = (w64[..., g // 32] >> (g % 32)) & 1                # [..., L*k]
    bit = bit.reshape(words.shape[:-1] + (L, k))
    j = torch.arange(k, device=dev, dtype=torch.int64)
    return torch.sum(bit << j, dim=-1).to(torch.int32)


def hamming_words(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int32 [...]: popcount Hamming distance over the last (word) axis;
    `a` and `b` broadcast against each other."""
    return popcount32(torch.bitwise_xor(a, b)).sum(dim=-1, dtype=torch.int32)


def pack_store_payload(store, hyperplanes: torch.Tensor):
    """Embedded f32 payloads -> packed sketch-code words.

    Re-sketches every slot's payload vector with `hyperplanes` [L, k, d]
    and stores the packed words as the new payload (int32 [T, NB, C, W]);
    empty slots become all-zero words.  Equal to the store an insert from
    scratch under `score="hamming"` builds from the same vectors.
    Sketches one table's slots at a time to bound the intermediates.
    """
    if store.payload is None:
        raise ValueError("pack_store_payload needs an embedded-payload store")
    t, nb, c, d = store.payload.shape
    if hyperplanes.dim() != 3 or hyperplanes.shape[0] != t \
            or hyperplanes.shape[2] != d:
        raise ValueError(
            f"hyperplanes must be [L, k, d] = [{t}, k, {d}] to match this "
            f"store's payload {tuple(store.payload.shape)}; got "
            f"{tuple(hyperplanes.shape)}"
        )
    k = hyperplanes.shape[1]
    words = torch.stack([
        pack_codes(sketch_codes(store.payload[l].reshape(-1, d), hyperplanes),
                   k).reshape(nb, c, -1)
        for l in range(t)
    ])
    words = torch.where((store.ids >= 0)[..., None], words, 0)
    return dataclasses.replace(store, payload=words)
