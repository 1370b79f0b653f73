"""Closed-form success-probability analysis (paper Sec. 5).

All formulas are over the *angular* similarity s in [0.5, 1] (non-negative
vectors); `angular_from_cosine` converts from cosine similarity t in [0, 1]
(Eq. 4).  SP(A, s) = probability that algorithm A searches a bucket
containing a vector whose similarity to the query is s.
"""

from __future__ import annotations

import numpy as np


def angular_from_cosine(t):
    """Eq. 4: s = 1 - arccos(t)/pi."""
    t = np.clip(np.asarray(t, dtype=np.float64), -1.0, 1.0)
    return 1.0 - np.arccos(t) / np.pi


def cosine_from_angular(s):
    """Inverse of Eq. 4: t = cos(pi (1 - s))."""
    s = np.asarray(s, dtype=np.float64)
    return np.cos(np.pi * (1.0 - s))


def sp_exact_bucket(s, k):
    """Eq. 6: SP(LSH(k,1), s) = s^k."""
    return np.asarray(s, dtype=np.float64) ** k


def sp_b_near_bucket(s, k, b):
    """Eq. 8: success probability of a single b-near bucket."""
    s = np.asarray(s, dtype=np.float64)
    return s ** (k - b) * (1.0 - s) ** b


def sp_lsh(s, k, L):
    """Proposition 1: SP(LSH(k,L), s) = 1 - (1 - s^k)^L."""
    s = np.asarray(s, dtype=np.float64)
    return 1.0 - (1.0 - s**k) ** L


def sp_layered(s, k, L):
    """Sec. 5.2: for cosine similarity Layered-LSH == LSH(k, L)."""
    return sp_lsh(s, k, L)


def sp_nearbucket(s, k, L, num_probes=None):
    """Proposition 4 (generalized to p <= k probed near buckets):

    SP = 1 - (1 - (s^k + p s^(k-1) (1-s)))^L,   p = num_probes or k.

    Exact and 1-near buckets are disjoint events for one g, so the inner
    term is a plain sum.
    """
    s = np.asarray(s, dtype=np.float64)
    p = k if num_probes is None else num_probes
    single = s**k + p * s ** (k - 1) * (1.0 - s)
    return 1.0 - (1.0 - single) ** L


def sp_nearbucket_b2(s, k, L):
    """Ablation (beyond the paper's search set, within its formalism):
    probing exact + all 1-near + all 2-near buckets.
    """
    s = np.asarray(s, dtype=np.float64)
    single = (
        s**k
        + k * s ** (k - 1) * (1.0 - s)
        + (k * (k - 1) / 2.0) * s ** (k - 2) * (1.0 - s) ** 2
    )
    return 1.0 - (1.0 - single) ** L


def sp_curve(algorithm: str, k: int, L: int, num_points: int = 101):
    """(cosine_similarity, SP) curve for plotting Figs. 1-3.

    Returns (t, sp) with t the cosine similarity grid in [0, 1].
    """
    t = np.linspace(0.0, 1.0, num_points)
    s = angular_from_cosine(t)
    if algorithm in ("lsh", "layered"):
        return t, sp_lsh(s, k, L)
    if algorithm in ("nb", "cnb", "nearbucket"):
        return t, sp_nearbucket(s, k, L)
    raise ValueError(f"unknown algorithm {algorithm!r}")


# -- Proposition 2/3 checks (used by property tests) -------------------------

def near_dominates(s, k, b1, b2):
    """Prop. 3: SP(b1-near) >= SP(b2-near) for b1 < b2, s in [0.5, 1]."""
    return sp_b_near_bucket(s, k, b1) >= sp_b_near_bucket(s, k, b2)
