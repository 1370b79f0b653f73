"""Synthetic OSN interest-vector datasets (stand-ins for DBLP / LiveJournal /
Friendster, which are not available offline).

Generative model chosen to match the statistics the paper relies on:
  * users hold sparse non-negative interest vectors (tens of interests out of
    thousands..millions, paper Sec. 2.1);
  * interest popularity is power-law (OSN group sizes are heavy-tailed);
  * users belong to overlapping communities; interests are drawn from their
    communities' interest pools — this creates genuinely similar user pairs
    across the whole cosine range, which Figs. 4-5 need;
  * interests are weighted by inverse user frequency,
    w(I) = ln(N_u / (N_I + 1)) + 1   (paper Sec. 6.2).

Scaled-down sizes keep CPU runtimes sane while preserving the paper's
avg bucket size regime (N / 2^k ≈ tens..hundreds, Sec. 6.2).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.corpus import SparseCorpus, sparse_from_lists


@dataclasses.dataclass(frozen=True)
class OsnSpec:
    name: str
    num_users: int
    num_interests: int
    num_communities: int
    interests_per_user: int   # mean; actual ~ Poisson, clipped to [2, nnz_max]
    communities_per_user: int
    nnz_max: int
    k: int                    # paper's sketch size for this dataset
    seed: int = 0
    # fraction of users that are near-duplicates of another user (OSNs have
    # them: co-authors with identical venues, members of the same niche
    # groups); populates the high-similarity bins of Fig. 4
    twin_fraction: float = 0.08


# Paper Sec. 6.2: k=10 (DBLP, 260k users), k=12 (LJ, 1.1M), k=15 (FR, 7.9M);
# avg bucket ≈ 250.  Scaled ~1/8 with k chosen to keep N/2^k ≈ 57 (same
# across datasets, mirroring the paper's constant-B design).
DBLP_S = OsnSpec("dblp_s", 58_000, 8_192, 600, 12, 2, 24, k=10, seed=1)
LIVEJOURNAL_S = OsnSpec("livejournal_s", 117_000, 24_576, 1500, 16, 3, 32, k=11, seed=2)
FRIENDSTER_S = OsnSpec("friendster_s", 234_000, 49_152, 3000, 16, 3, 32, k=12, seed=3)

DATASETS = {s.name: s for s in (DBLP_S, LIVEJOURNAL_S, FRIENDSTER_S)}


def tiny_spec(seed: int = 0) -> OsnSpec:
    """Small spec for unit tests."""
    return OsnSpec("tiny", 2_000, 512, 40, 8, 2, 12, k=6, seed=seed)


def generate(spec: OsnSpec, *, device=None) -> SparseCorpus:
    """Sample the corpus on the host with numpy, then place it on
    `device`.  Deterministic in `spec.seed`: the rng stream is the JAX
    package's, so the corpus equals its corpus bit for bit."""
    rng = np.random.default_rng(spec.seed)

    # communities get power-law-ish sizes via Zipfian popularity
    comm_pop = 1.0 / np.arange(1, spec.num_communities + 1) ** 0.8
    comm_pop /= comm_pop.sum()

    # each community owns a pool of interests, pool sizes ~ community size
    pool_size = np.maximum(
        (comm_pop * spec.num_interests * 3).astype(int), 8
    )
    pools = [
        rng.choice(spec.num_interests, size=min(ps, spec.num_interests), replace=False)
        for ps in pool_size
    ]

    interest_ids: list[np.ndarray] = []
    n_per_user = np.clip(
        rng.poisson(spec.interests_per_user, size=spec.num_users), 2, spec.nnz_max
    )
    user_comms = rng.choice(
        spec.num_communities,
        size=(spec.num_users, spec.communities_per_user),
        p=comm_pop,
    )
    for u in range(spec.num_users):
        pool = np.concatenate([pools[c] for c in user_comms[u]])
        n = min(n_per_user[u], len(pool))
        ids = np.unique(rng.choice(pool, size=n, replace=True))
        # sprinkle of global interests for realism (cross-community overlap)
        if rng.random() < 0.3:
            ids = np.union1d(ids, rng.integers(0, spec.num_interests, size=1))
        interest_ids.append(ids.astype(np.int32))

    # near-duplicate users: copy a base user's interests, drop/add a couple
    n_twins = int(spec.twin_fraction * spec.num_users)
    if n_twins:
        twin_idx = rng.choice(spec.num_users, size=n_twins, replace=False)
        base_idx = rng.integers(0, spec.num_users, size=n_twins)
        for t, b in zip(twin_idx, base_idx):
            if t == b:
                continue
            ids = interest_ids[b].copy()
            if len(ids) > 3 and rng.random() < 0.7:
                ids = np.delete(ids, rng.integers(len(ids)))
            if rng.random() < 0.5:
                ids = np.union1d(
                    ids, rng.integers(0, spec.num_interests, size=1)
                ).astype(np.int32)
            interest_ids[t] = ids

    # inverse-user-frequency weights (paper Sec. 6.2)
    freq = np.zeros(spec.num_interests, np.int64)
    for ids in interest_ids:
        freq[ids] += 1
    w = np.log(spec.num_users / (freq + 1.0)) + 1.0

    interest_vals = [w[ids].astype(np.float32) for ids in interest_ids]
    return sparse_from_lists(
        interest_ids, interest_vals, d=spec.num_interests,
        nnz_max=spec.nnz_max, device=device,
    )
