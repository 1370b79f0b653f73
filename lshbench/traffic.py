"""The one traffic generator: every mix is a file of parameters in
`traffic/`, read here, and driven through the window by the driver that
its `kind` names (`drivers/<kind>.py`).

Every query is a user of the corpus searching for users like itself:
its vector is the user's row and its own id is excluded from the
answer.  Which users ask, in which order, is the mix's `order`:

  * `permutation`: a permutation of the corpus made from the seed, in
    turn (it starts over when a pass ends), so that every seed sends the
    same set of users;
  * `uniform`: users drawn uniformly, with repeats;
  * `zipf`: users drawn from a pool of `pool` users (a seeded sample of
    the corpus), the i-th most popular with weight i ** -`zipf_s`.
"""

from __future__ import annotations

import numpy as np

ORDERS = ("permutation", "uniform", "zipf")


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**63, stream])


def users(mix: dict, seed: int, n_users: int, count: int) -> np.ndarray:
    """int64 [count]: the query users of `mix`, in the order they ask."""
    order = mix.get("order", "permutation")
    r = rng(seed, 1)
    if order == "permutation":
        return np.resize(r.permutation(n_users), count)
    if order == "uniform":
        return r.integers(0, n_users, size=count)
    if order == "zipf":
        pool = r.choice(n_users, size=int(mix["pool"]), replace=False)
        w = np.arange(1, pool.size + 1, dtype=np.float64) ** -float(
            mix["zipf_s"])
        return pool[r.choice(pool.size, size=count, p=w / w.sum())]
    raise ValueError(f"traffic order must be one of {ORDERS}: {mix}")


class BatchOrder:
    """The users of a closed loop, `batch` at a time: one pass of the
    mix's order over the corpus with its first `batch` users repeated at
    the end, so that every batch is one contiguous slice."""

    def __init__(self, mix: dict, seed: int, n_users: int):
        self.batch = int(mix["batch"])
        self.users = users(mix, seed, n_users, n_users + self.batch)
        self.n = n_users
        self.pos = 0

    def next(self) -> slice:
        s = self.pos
        self.pos = (s + self.batch) % self.n
        return slice(s, s + self.batch)
