"""Rules for holding one result of the port against another (the JAX
package's, or the port's on another device).

Sign bits: `flips_outside_band` counts the sketch bits where two codes
of the same vectors differ although the projection lies outside the
near-zero band 1e-5 * |x| * |h|; inside it, the summation order decides
the sign, and a flip is allowed.

Top-m results: the near-tie rule of `topk_swaps`.

Equal scores are common on the OSN corpora (near-duplicate users give
exactly equal cosines), and two packages, or two devices, sum a score in
their own order, so scores that are equal in exact arithmetic may
differ by an ulp.  `topk_swaps` holds `got` against `ref`:

  * scores agree to `tol` at every rank (missing results: -inf on both);
  * the ranks of a row split into tie groups: runs of ranks whose `ref`
    scores lie within `tol` of the previous rank's.  Every group that
    does not reach the last rank holds the same ids in both results, in
    any order; the group that reaches the last rank may hold other ids,
    since its tie partners may lie past rank m.

It returns the number of ranks whose ids differ: the swaps.  Not
collected by pytest; the test files import it.
"""

from __future__ import annotations

import numpy as np
import torch


def topk_swaps(ref_s, ref_i, got_s, got_i, tol: float = 1e-6) -> int:
    ref_s, got_s = np.asarray(ref_s, np.float64), np.asarray(got_s, np.float64)
    ref_i, got_i = np.asarray(ref_i), np.asarray(got_i)
    assert ref_s.shape == got_s.shape == ref_i.shape == got_i.shape
    live = np.isfinite(ref_s)
    np.testing.assert_array_equal(live, np.isfinite(got_s))
    err = np.abs(ref_s[live] - got_s[live]).max(initial=0.0)
    assert err <= tol, f"score error {err} > {tol}"
    m = ref_s.shape[1]
    for r in range(ref_s.shape[0]):
        start = 0
        for c in range(1, m + 1):
            if c < m and live[r, c] and abs(ref_s[r, c] - ref_s[r, c - 1]) <= tol:
                continue
            if c < m:  # the group [start, c) ends before the last rank
                want = set(ref_i[r, start:c].tolist())
                have = set(got_i[r, start:c].tolist())
                assert want == have, (
                    f"row {r} ranks {start}..{c - 1}: ids {sorted(have)} != "
                    f"{sorted(want)} (scores {ref_s[r, start:c]})")
            start = c
    return int((ref_i != got_i).sum())


def flips_outside_band(x, h, got, want, packed_out=False) -> int:
    """Sign bits where codes (or, with packed_out, packed words) `got` and
    `want` of x [n, d] under hyperplanes h [L, k, d] differ although the
    projection lies outside the band 1e-5 * |x| * |h|."""
    from repro_torch.core import packed

    L, k, _ = h.shape
    flips = torch.bitwise_xor(got, want)
    if packed_out:
        flips = packed.unpack_codes(flips, k, L)
    if not bool(flips.any()):
        return 0
    proj = torch.einsum("nd,lkd->nlk", x.double(), h.double())
    bits = (flips.long()[..., None] >> torch.arange(k, device=x.device)) \
        & 1 > 0
    band = 1e-5 * x.double().norm(dim=1)[:, None, None] \
        * h.double().norm(dim=2)[None]
    return int((bits & (proj.abs() > band)).sum())
