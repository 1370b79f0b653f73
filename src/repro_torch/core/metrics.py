"""Search-quality metrics (paper Sec. 6.1): recall@m and NCS@m."""

from __future__ import annotations

import numpy as np


def recall_at_m(approx_ids: np.ndarray, ideal_ids: np.ndarray) -> float:
    """Definition 6.1/6.2: |A_m ∩ I_m| / |I_m| averaged over queries.

    ids arrays are [nq, m] with -1 padding for missing results.
    """
    nq = approx_ids.shape[0]
    vals = np.empty(nq, np.float64)
    for i in range(nq):
        ideal = set(int(x) for x in ideal_ids[i] if x >= 0)
        if not ideal:
            vals[i] = 1.0
            continue
        approx = set(int(x) for x in approx_ids[i] if x >= 0)
        vals[i] = len(approx & ideal) / len(ideal)
    return float(vals.mean())


def ncs_at_m(approx_scores: np.ndarray, ideal_scores: np.ndarray) -> float:
    """Definition 6.3: normalized cumulative similarity (precision proxy).

    scores arrays are [nq, m]; missing results contribute 0 (paper: CumSim
    of the approximate set can only fall short of the ideal's).
    """
    a = np.where(np.isfinite(approx_scores), np.maximum(approx_scores, 0.0), 0.0)
    i = np.where(np.isfinite(ideal_scores), np.maximum(ideal_scores, 0.0), 0.0)
    num = a.sum(axis=1)
    den = np.maximum(i.sum(axis=1), 1e-12)
    return float(np.mean(num / den))


def success_probability_by_interval(
    found: np.ndarray, similarities: np.ndarray, num_bins: int = 10
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Paper Sec. 6.3 / Fig. 4: fraction of (x, y) pairs found, binned by
    cosine similarity interval [i/10, (i+1)/10).

    Returns (bin_centers, success_fraction, bin_counts); empty bins are NaN.
    """
    edges = np.linspace(0.0, 1.0, num_bins + 1)
    centers = 0.5 * (edges[:-1] + edges[1:])
    frac = np.full(num_bins, np.nan)
    counts = np.zeros(num_bins, np.int64)
    which = np.clip(np.digitize(similarities, edges) - 1, 0, num_bins - 1)
    for b in range(num_bins):
        sel = which == b
        counts[b] = sel.sum()
        if counts[b]:
            frac[b] = float(np.mean(found[sel]))
    return centers, frac, counts
