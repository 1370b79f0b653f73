"""`ops.hamming` (the `hamming_words` and `hamming` kernels' wrapper) on the
CPU, where it runs the kernels' plain versions, against the JAX package:
its oracles (`repro.kernels.ref.hamming_words_ref`, `hamming_ref`) and
its Pallas kernels in interpret mode (`repro.kernels.ops.hamming`).

Inputs are uint32 words made with numpy from a seed, about half with bit
31 set, crossing as int32 bit patterns.  Distances are integers, so every
comparison is exact.  The CUDA kernels are held against the same plain
versions on the card (`tests/test_torch_cuda.py`).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scoring as jscoring
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import scoring as tscoring
from repro_torch.kernels import hamming as thm
from repro_torch.kernels import ops as tops


def words(rng, *shape) -> np.ndarray:
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("w", [1, 2, 3])
@pytest.mark.parametrize("n,kc", [(1, 1), (7, 33), (40, 300)])
def test_hamming_words_matches_jax(n, kc, w):
    rng = np.random.default_rng(100 * n + 10 * kc + w)
    codes, cand = words(rng, n, w), words(rng, n, kc, w)
    cand[-1, -1] = ~codes[-1]                  # distance 32 * W
    cand[0, 0] = codes[0]                      # distance 0
    want = np.asarray(jref.hamming_words_ref(jnp.asarray(codes),
                                             jnp.asarray(cand)))
    got = tops.hamming(t(codes), t(cand))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        thm.hamming_words_plain(t(codes), t(cand)).numpy(), want)
    assert want[0, 0] == 0 and (n * kc == 1 or want[-1, -1] == 32 * w)
    # the JAX package's own kernel, interpreted, agrees too
    np.testing.assert_array_equal(
        np.asarray(jops.hamming(jnp.asarray(codes), jnp.asarray(cand),
                                interpret=True)), want)


@pytest.mark.parametrize("n,kc", [(1, 1), (9, 130), (64, 17)])
def test_hamming_single_word_matches_jax(n, kc):
    rng = np.random.default_rng(n * kc)
    codes, cand = words(rng, n), words(rng, n, kc)
    cand[0, 0] = codes[0] ^ np.uint32(1 << 31)  # only bit 31 differs
    want = np.asarray(jref.hamming_ref(jnp.asarray(codes), jnp.asarray(cand)))
    got = tops.hamming(t(codes), t(cand))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(thm.hamming_plain(t(codes), t(cand)).numpy(),
                                  want)
    assert want[0, 0] == 1
    np.testing.assert_array_equal(
        np.asarray(jops.hamming(jnp.asarray(codes), jnp.asarray(cand),
                                interpret=True)), want)


def test_hamming_rejects_mismatched_shapes():
    with pytest.raises(ValueError, match="hamming_words"):
        tops.hamming(torch.zeros((3, 2), dtype=torch.int32),
                     torch.zeros((3, 5, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="hamming"):
        tops.hamming(torch.zeros((4,), dtype=torch.int32),
                     torch.zeros((3, 5), dtype=torch.int32))


@pytest.mark.parametrize("w", [1, 2, 3])
def test_score_topk_hamming_kernel_path_matches_jax(w):
    """The staged hamming scorer with `use_kernels` (through `ops.hamming`)
    equals JAX's kernel path exactly: ids and integer scores."""
    rng = np.random.default_rng(w)
    b, kk = 12, 40
    q, cand = words(rng, b, w), words(rng, b, kk, w)
    ids = rng.integers(-1, 25, size=(b, kk)).astype(np.int32)
    wi, ws = jscoring.score_topk(jnp.asarray(q), jnp.asarray(ids),
                                 jnp.asarray(cand), 6, use_kernels=True,
                                 interpret=True, score="hamming")
    gi, gs = tscoring.score_topk(t(q), torch.from_numpy(ids), t(cand), 6,
                                 use_kernels=True, score="hamming")
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
