"""The reference against the program's CPU path (its kernels' plain
versions) on a tiny world, and the reference's own rules on hand-made
cases."""

import pytest
import torch

from lshbench.reference.lsh import Reference, popcount_table, round_bf16
from tiny import run, tiny_cell

CELLS = ["lj1m-can16-hamming.device8192", "lj1m-1node-sparse.batch1024"]
E2E = {"lj1m-can16-hamming.device8192": "search_qps.can16",
       "lj1m-1node-sparse.batch1024": "search_qps.1node"}


@pytest.mark.parametrize("name", CELLS)
def test_reference_equals_the_programs_cpu_path(name):
    out = run(tiny_cell(name))
    assert out["correct"], out["checks"]
    assert out["checks"]["bad_answers"]["value"] == 0
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {E2E[name], "setup_s"}


def one_hot_rows(x):
    """Sparse rows (ids, vals) of a dense [N, d] tensor."""
    d = x.shape[1]
    ids = torch.arange(d).expand_as(x).clone()
    return ids.masked_fill(x == 0, -1), x


def test_eviction_keeps_the_last_ids_of_a_bucket():
    # five users, one hyperplane each table: ids 0, 2, 4 point one way
    x = torch.tensor([[1.0, 0.1], [-1.0, 0.2], [1.0, 0.3], [-1.0, 0.4],
                      [1.0, 0.5]])
    x = x / x.norm(dim=1, keepdim=True)
    ids, vals = one_hot_rows(x)
    ref = Reference(ids, vals, 2, torch.tensor([[[1.0, 0.0]]]), capacity=2,
                    nodes=1, score="dot")
    assert ref.codes[:, 0].tolist() == [1, 0, 1, 0, 1]
    assert ref.kept[:, 0].tolist() == [False, True, True, True, True]
    assert ref.load.tolist() == [[2, 3]]


def test_sparse_scores_and_dense_rows():
    # d = 4; user 0 = (0.6 at 3, 0.8 at 0), user 1 = (1 at 3)
    ids = torch.tensor([[3, 0, -1], [3, -1, -1]])
    vals = torch.tensor([[0.6, 0.8, 0.0], [1.0, 0.0, 0.0]])
    h = torch.tensor([[[1.0, 0.0, 0.0, -1.0]]])
    ref = Reference(ids, vals, 4, h, capacity=4, nodes=1, score="dot")
    assert ref.dense(torch.tensor([0, 1]), torch.float32).tolist() == [
        [vals[0, 1], 0.0, 0.0, vals[0, 0]], [0.0, 0.0, 0.0, 1.0]]
    assert ref.codes[:, 0].tolist() == [1, 0]
    got = ref.pair_scores(torch.tensor([0]), torch.tensor([[1]]))
    assert abs(float(got[0, 0]) - 0.6) < 1e-7


def test_candidates_are_the_probed_buckets_and_cache_rows():
    # k = 3 bits, 2 nodes: bit 2 is the node bit
    ref = Reference.__new__(Reference)
    ref.L, ref.k, ref.local_bits = 1, 3, 2
    ref.codes = torch.tensor([[0b000], [0b001], [0b011], [0b100], [0b101]],
                             dtype=torch.int32)
    ref.kept = torch.ones((5, 1), dtype=torch.bool)
    ref.pop = popcount_table(3, "cpu")
    users = torch.tensor([0])
    ids = torch.tensor([[0, 1, 2, 3, 4, -1]])
    got = ref.is_candidate(users, ids)
    assert got.tolist() == [[False, True, False, True, False, False]]
    got = ref.is_candidate(users, ids, node_probes=False)
    assert got.tolist() == [[False, True, False, False, False, False]]
    got = ref.is_candidate(users, ids, with_self=True)
    assert got.tolist() == [[True, True, False, True, False, False]]


def test_bf16_rounding_keeps_seven_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -7, 1.0 + 2.0 ** -8, 1.0 + 2.0 ** -9,
                      -(1.0 + 3 * 2.0 ** -8)])
    assert round_bf16(x).tolist() == [1.0 + 2.0 ** -7, 1.0, 1.0,
                                      -(1.0 + 2.0 ** -6)]
