"""The comparison that decides `correct`.

Answers are judged one by one against the reference, with ties in mind:
two users with equal scores may come out in either order, so an answer
is right when every id it returns is a candidate of the query with the
score it claims, and its scores, in order, are the reference's best
scores.  The numbers compared:

  * `bad_answers`: answers with a wrong number of results, fill before
    a result, a repeated id, the user's own id (where the answer leaves
    it out), or an id that is not a candidate (not in a probed bucket,
    or evicted from it);
  * `score_gap`: the widest gap between an answer's i-th score and the
    reference's i-th best score;
  * `id_score_gap`: the widest gap between the score an answer gives an
    id and that id's score in the reference;
  * `dropped_probes`: probes the router dropped over the window (the
    configuration guarantees none);
  * `failed`: requests that got no answer.

Each has a limit in the configuration's file (`limits`); PERF.md gives
the readings each was set from.
"""

from __future__ import annotations

import torch

from lshbench.reference.lsh import Reference

NAMES = ("bad_answers", "score_gap", "id_score_gap", "dropped_probes",
         "failed")


def judge(ref: Reference, users: torch.Tensor, ids: torch.Tensor,
          scores: torch.Tensor, m: int, with_self: bool = False) -> dict:
    """The numbers compared for the answers (ids, scores) [S, m] that
    the query users `users` [S] got; with `with_self` the user's own id
    is one of its candidates."""
    dev = ref.device
    users = users.to(dev).long()
    ids = ids.to(dev).long()
    sc = scores.to(dev).double()
    _, ref_sc, n_cand = ref.top(users, m, with_self=with_self)
    want = n_cand.clamp(max=m)
    valid = ids >= 0
    first = torch.arange(m, device=dev)[None, :] < want[:, None]
    srt = torch.sort(torch.where(valid, ids, -1 - torch.arange(
        m, device=dev)[None, :]), dim=1).values
    dup = (srt[:, 1:] == srt[:, :-1]).any(1)
    cand = ref.is_candidate(users, ids, with_self=with_self)
    bad = (valid != first).any(1) | (valid & ~cand).any(1) | dup
    true = ref.pair_scores(users, ids)
    gap = (sc - true).abs()
    id_gap = gap[valid].max() if bool(valid.any()) else gap.new_zeros(())
    got = torch.sort(torch.where(valid, sc, float("-inf")), dim=1,
                     descending=True).values
    both = torch.isfinite(got) & torch.isfinite(ref_sc)
    rank_gap = (got - ref_sc).abs()[both]
    rank_gap = rank_gap.max() if rank_gap.numel() else gap.new_zeros(())
    return dict(bad_answers=int(bad.sum()), score_gap=float(rank_gap),
                id_score_gap=float(id_gap))


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over every number with a
    limit; a number without one, or not finite, fails."""
    out, ok = {}, True
    for name in NAMES:
        value, limit = numbers.get(name), limits.get(name)
        good = (value is not None and limit is not None
                and value == value and value <= limit)
        ok &= good
        out[name] = {"value": value, "limit": limit}
    return ok, out
