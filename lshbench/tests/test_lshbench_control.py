"""The checks fail what they must: the control (the reference in the
precision below the configuration's, or with a guarantee broken) and a
run whose timed path is broken underneath: an answer altered where it
is produced, and, on the mesh, the exchange between nodes left out."""

import pytest
import torch

from lshbench import calibrate, check
from tiny import run, tiny_cell

CELLS = ["lj1m-can16-hamming.device8192", "lj1m-1node-sparse.batch1024"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    cell = tiny_cell(name)
    numbers = calibrate.control_numbers(cell, 2_147_483_777, "cpu", 1024)
    numbers.update(dropped_probes=0, failed=0)
    ok, checks = check.verdict(numbers, cell.config["limits"])
    assert not ok, checks


@pytest.mark.parametrize("name", CELLS)
def test_an_answer_altered_where_it_is_produced_is_caught(name, monkeypatch):
    from repro_torch.core import runtime

    real = runtime.dedupe_topk

    def altered(ids, scores, m):
        ids, scores = real(ids, scores, m)
        ids = ids.clone()
        ids[..., 0, 0] = (ids[..., 0, 0] + 1) % 20_000
        return ids, scores

    monkeypatch.setattr(runtime, "dedupe_topk", altered)
    out = run(tiny_cell(name))
    assert not out["correct"]
    assert out["checks"]["bad_answers"]["value"] > 0 or \
        out["checks"]["id_score_gap"]["value"] > 0


def test_a_missing_number_fails():
    ok, checks = check.verdict({"bad_answers": 0}, {"bad_answers": 0})
    assert not ok and checks["score_gap"]["value"] is None
    ok, _ = check.verdict(dict.fromkeys(check.NAMES, 0),
                          dict.fromkeys(check.NAMES, 0))
    assert ok
    ok, _ = check.verdict(dict(dict.fromkeys(check.NAMES, 0),
                               score_gap=float("nan")),
                          dict.fromkeys(check.NAMES, 1))
    assert not ok


def test_the_exchange_between_nodes_left_out_is_caught(monkeypatch):
    from repro_torch.core import runtime

    monkeypatch.setattr(runtime.MeshCollectives, "all_to_all",
                        lambda self, x: x)
    out = run(tiny_cell("lj1m-can16-hamming.device8192"))
    assert not out["correct"], out["checks"]


def test_judge_takes_ties_in_either_order():
    from lshbench.reference.lsh import Reference

    # rows (1, 0), (0.6, 0.8), (0.6, -0.8), (0, 1) over two columns
    ids = torch.tensor([[0, -1], [0, 1], [0, 1], [1, -1]])
    vals = torch.tensor([[1.0, 0.0], [0.6, 0.8], [0.6, -0.8], [1.0, 0.0]])
    ref = Reference(ids, vals, 2, torch.tensor([[[1.0, 0.0]]]), capacity=4,
                    nodes=1, score="dot")
    users = torch.tensor([0, 0])
    # users 1 and 2 tie for user 0; with k = 1 every bucket is probed
    got_ids = torch.tensor([[1, 2, 3], [2, 1, 3]])
    scores = torch.tensor([[0.6, 0.6, 0.0], [0.6, 0.6, 0.0]])
    got = check.judge(ref, users, got_ids, scores, 3)
    assert got["bad_answers"] == 0 and got["score_gap"] < 1e-7
    got = check.judge(ref, users, torch.tensor([[1, 1, 3], [0, 2, 3]]),
                      scores, 3)
    assert got["bad_answers"] == 2
