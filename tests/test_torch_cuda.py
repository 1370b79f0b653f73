"""The CUDA kernels against their plain PyTorch versions, on the card,
the paper's sparse workload on the card against the CPU, and the serving
layer's use of the card: the pipelined dispatch's CUDA events, a stage
with no host sync, the churn writer's stream handoff, a batch in
flight across an update; the LM serving path: the SMOKE models of every
architecture on the card against the CPU, the mamba, mLSTM / sLSTM and
MoE layers on the card against the CPU, decode loops with no host
sync, one training step of every SMOKE arch against the CPU and a
resumed training run against a straight one, and the
index kernels at gemma2-2b's width (D = 2304); every grid the autotune
sweep may pick against the plain versions; and the process mesh
over NCCL at the one card's world size of 1: its collectives, a search,
and replicated reads, `kill_node` and a reshard round trip.

Marked `cuda`: they need an NVIDIA GPU and nvcc, and skip with a reason
where `torch.cuda.is_available()` is false.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import pytest
import torch

from repro_torch.core import hashing, scoring
from repro_torch.core.corpus import exact_topk_sparse
from repro_torch.core.engine import EngineConfig, LshEngine
from repro_torch.core.store import build_store_host
from repro_torch.data import osn
from repro_torch.kernels import autotune
from repro_torch.kernels import bucket_topk as bt
from repro_torch.kernels import fused_query as fq
from repro_torch.kernels import hamming as hm
from repro_torch.kernels import ops
from repro_torch.kernels import simhash as sh
from torch_fused_cases import CONTAINS_CASES, contains_case, edge_case_rows
from torch_parity_rules import flips_outside_band, topk_swaps

pytestmark = pytest.mark.cuda
# the resume test runs under torch.use_deterministic_algorithms, which
# needs cuBLAS's workspace fixed before the test run's first product
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _store(dev, seed, rows=40, c=96, dw=128, score="dot"):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(-1, 300, (rows, c), generator=g, dtype=torch.int32)
    ids[3] = -1
    ids[1, 0] = ids[2, 5] = 7  # a duplicate id across bucket rows
    if score == "dot":  # unit rows, as the index stores them
        pay = torch.nn.functional.normalize(
            torch.randn((rows, c, dw), generator=g), dim=-1)
    else:
        pay = torch.randint(-2**31, 2**31, (rows, c, dw), generator=g,
                            dtype=torch.int64).to(torch.int32)
    return ids.to(dev), pay.to(dev), g


# the stream kernel with blocks of 8 warps, each warp on 3 chunks or more
# and a ragged last chunk (3 x 8 warps x 132 SMs x 64 rows + 37), and with
# blocks of 2 warps (16384 + 37 rows); fewer rows take the warp kernel
STREAM_ROWS = 3 * 8 * 132 * 64 + 37
RING_ROWS = 16384 + 37


@pytest.mark.parametrize("packed_out", [False, True])
@pytest.mark.parametrize("n,d,k,L,offset", [
    (1, 128, 12, 4, 0), (7, 128, 12, 4, 0),  # fewer rows than a tile
    (1000, 128, 12, 4, 0), (1024, 128, 12, 4, 0), (77, 40, 30, 3, 0),
    (300, 37, 7, 2, 0),   # d % 4 != 0: scalar staging, padded columns
    (300, 128, 12, 4, 1),  # x not 16-byte aligned: scalar staging
    (2000, 128, 5, 5, 0),  # L*k = 25: neither 12 nor 32 divides it
    (RING_ROWS, 128, 12, 4, 0),
    (STREAM_ROWS, 128, 12, 4, 0), (STREAM_ROWS, 37, 7, 2, 0),
    (STREAM_ROWS, 128, 12, 4, 1),  # ... through the scalar staging
    (STREAM_ROWS, 64, 30, 9, 0),  # one block along each 30-bit table
])
def test_simhash_kernel_matches_plain(dev, n, d, k, L, offset, packed_out):
    g = torch.Generator().manual_seed(n)
    flat = torch.randn((n * d + offset,), generator=g).to(dev)
    x = flat[offset:].view(n, d)
    h = torch.randn((L, k, d), generator=g).to(dev)
    got = ops.simhash(x, h, packed=packed_out)
    want = sh.simhash_plain(x, h, packed=packed_out)
    assert flips_outside_band(x, h, got, want, packed_out) == 0


@pytest.mark.parametrize("score", ["dot", "hamming"])
@pytest.mark.parametrize("m", [1, 10, 700])
def test_fused_query_kernel_matches_plain(dev, score, m):
    ids, pay, g = _store(dev, m, dw=128 if score == "dot" else 2, score=score)
    r, p = 64, 13
    fb = torch.randint(0, ids.shape[0], (r, p), generator=g,
                       dtype=torch.int32).to(dev)
    pw = torch.randint(0, 1 << p, (r,), generator=g, dtype=torch.int32)
    pw[0] = 0
    excl = torch.where(torch.arange(r) % 2 == 0, -1, 7).to(torch.int32)
    meta = torch.stack([pw, excl], dim=1).to(dev)
    q = pay[fb[:, 0].long(), 0].contiguous()
    gi, gs = ops.fused_query(ids, pay, q, fb, meta, m=m, score=score)
    wi, ws = fq.fused_query_plain(ids, pay, q, fb, meta, m=m, score=score)
    if score == "hamming":
        assert torch.equal(gi, wi) and torch.equal(gs, ws)
    else:
        assert torch.equal(gi, wi)
        torch.testing.assert_close(gs, ws, atol=1e-5, rtol=0)


@pytest.mark.parametrize("score", ["dot", "hamming"])
@pytest.mark.parametrize("m", [1, 10, 32, 33, 700])
def test_fused_query_kernel_matches_plain_on_edge_cases(dev, score, m):
    """A later copy of an id scoring higher (once, and 32 times over so
    that the selection falls back to its hash), a row with no valid
    probe, a bucket probed twice, an exclude id present, exact ties, m
    above the live count, and 40 rows on one bucket (eight work items);
    m = 32 and 33 straddle the warp-list selection's limit."""
    args = edge_case_rows(score, device=dev)
    gi, gs = ops.fused_query(*args, m=m, score=score)
    wi, ws = fq.fused_query_plain(*args, m=m, score=score)
    assert torch.equal(gi, wi)
    if score == "hamming":
        assert torch.equal(gs, ws)
    else:
        torch.testing.assert_close(gs, ws, atol=1e-5, rtol=0)


@pytest.mark.parametrize("m", [1, 10, 700])
def test_fused_query_kernel_read_back_path(dev, monkeypatch, m):
    """Dot with the score buffer sized by the count of valid pairs read
    back from the card (the path of batches whose r*P-pair buffer would
    be too large), on the edge cases, against the plain version."""
    monkeypatch.setattr(fq, "SCORE_BUFFER_BYTES", 0)
    args = edge_case_rows("dot", device=dev)
    gi, gs = ops.fused_query(*args, m=m)
    wi, ws = fq.fused_query_plain(*args, m=m)
    assert torch.equal(gi, wi)
    torch.testing.assert_close(gs, ws, atol=1e-5, rtol=0)


@pytest.mark.parametrize("score,dw,m", [
    ("dot", 128, 10), ("dot", 37, 40), ("hamming", 2, 10), ("hamming", 3, 33),
])
def test_fused_query_kernel_full_buckets(dev, score, dw, m):
    """Every slot live and ids repeated across buckets: the first-occurrence
    hash at its highest load (P*C = 6656 ids in 8192 slots), the scalar
    dot path (dw = 37), and the sorted path of m > 32."""
    g = torch.Generator().manual_seed(dw + m)
    rows, c, r, p = 24, 512, 40, 13
    ids = torch.randint(0, 20000, (rows, c), generator=g, dtype=torch.int32)
    if score == "dot":
        pay = torch.nn.functional.normalize(
            torch.randn((rows, c, dw), generator=g), dim=-1)
        q = torch.nn.functional.normalize(torch.randn((r, dw), generator=g),
                                          dim=-1)
    else:
        pay = torch.randint(-2**31, 2**31, (rows, c, dw), generator=g,
                            dtype=torch.int64).to(torch.int32)
        q = torch.randint(-2**31, 2**31, (r, dw), generator=g,
                          dtype=torch.int64).to(torch.int32)
    fb = torch.stack([torch.randperm(rows, generator=g)[:p]
                      for _ in range(r)]).to(torch.int32)
    meta = torch.stack([torch.full((r,), (1 << p) - 1, dtype=torch.int32),
                        ids[fb[:, 0].long(), 0]], dim=1)
    args = [t.to(dev) for t in (ids, pay, q, fb, meta)]
    gi, gs = ops.fused_query(*args, m=m, score=score)
    wi, ws = fq.fused_query_plain(*args, m=m, score=score)
    assert torch.equal(gi, wi)
    torch.testing.assert_close(gs, ws, atol=1e-5, rtol=0)


@pytest.mark.parametrize("r,n_probes,n_rows,hot,split", [
    (1, 1, 1, 0, True), (300, 13, 40, 0, True), (4096, 13, 16384, 0, True),
    (2000, 9, 64, 1500, True), (700, 31, 9, 100, False), (5, 3, 2, 0, True),
])
def test_grouping_kernels_match_plain(dev, r, n_probes, n_rows, hot, split):
    """The counting sort of fused_query against `group_pairs`, up to the
    order of pairs within a bucket row and of rows within each class."""
    g = torch.Generator().manual_seed(r + n_probes)
    fb = torch.randint(-2, n_rows + 2, (r, n_probes), generator=g,
                       dtype=torch.int32)
    pw = torch.randint(0, 1 << n_probes, (r,), generator=g, dtype=torch.int64)
    pw[::7] = 0
    pw[1::5] = 1 << (n_probes - 1)
    fb[:hot] = 1
    pw[:hot] = (1 << n_probes) - 1
    meta = torch.stack([pw.to(torch.int32),
                        torch.full((r,), -1, dtype=torch.int32)], dim=1)
    got = fq.group_pairs_cuda(fb.to(dev), meta.to(dev), n_rows,
                              split_small=split)
    torch.cuda.synchronize()
    want = fq.group_pairs(fb, meta, n_rows, split_small=split)
    n_pairs, n_small = want.sizes.tolist()
    assert got.sizes.tolist() == [n_pairs, n_small]
    assert torch.equal(got.row_ptr.cpu(), want.row_ptr)
    order = got.row_order.cpu()
    for part in (slice(0, n_small), slice(n_small, r)):
        assert torch.equal(order[part].sort().values, want.row_order[part])
    assert torch.equal(got.by_bucket[:n_pairs].cpu(), want.by_bucket[:n_pairs])
    key = lambda x: sorted(zip(x.by_bucket[:n_pairs].tolist(),
                               x.by_row[:n_pairs].tolist(),
                               x.by_pair[:n_pairs].tolist()))
    assert key(got) == key(want)
    n_items = int(want.n_items)
    assert int(got.n_items) == n_items
    assert torch.equal(got.item_start[:n_items].cpu(),
                       want.item_start[:n_items])


def test_fused_contains_kernel_matches_plain(dev):
    ids, _, g = _store(dev, 3)
    fb = torch.randint(0, ids.shape[0], (300, 5), generator=g,
                       dtype=torch.int32).to(dev)
    pw = torch.randint(0, 32, (300,), generator=g, dtype=torch.int32)
    tgt = torch.randint(-1, 300, (300,), generator=g, dtype=torch.int32)
    meta = torch.stack([pw, tgt], dim=1).to(dev)
    assert torch.equal(ops.fused_contains(ids, fb, meta),
                       fq.fused_contains_plain(ids, fb, meta))


@pytest.mark.parametrize("case", list(CONTAINS_CASES))
def test_fused_contains_kernel_on_cases(dev, case):
    """Equal to the plain version under hit and miss traffic at the main
    path's shape (4096 rows, 13 probes, 512 ids) and on each edge case of
    `contains_case`; one launch a call, none for no rows."""
    ids, fb, meta = contains_case(case, device=dev)
    ops.reset_launches()
    got = ops.fused_contains(ids, fb, meta)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_contains"] == (1 if fb.shape[0] else 0)
    assert got.dtype == torch.bool and got.shape == (fb.shape[0],)
    assert torch.equal(got, fq.fused_contains_plain(ids, fb, meta))


@pytest.mark.parametrize("b,kc,m", [
    (16, 33, 50), (16, 6656, 10), (16, 1, 1), (16, 1, 10), (16, 1000, 1),
    (1, 6656, 10), (1, 6656, 50), (3, 6656, 33), (128, 6656, 10),
    (4096, 1024, 10), (7, 1000 + 5, 50),  # kc not a multiple of 32
])
def test_bucket_topk_kernel_matches_plain(dev, b, kc, m):
    """Ids equal to the plain version's, scores within 1e-5: exactly equal
    scores (every third lane copies lane 0; every 97th copies the row's
    best, across part boundaries: the lowest lane first), a row with no
    valid lane, a row whose first half is invalid (whole parts), a row
    with one valid lane (fewer than m)."""
    g = torch.Generator(device=dev).manual_seed(b * kc + m)
    q = torch.nn.functional.normalize(
        torch.randn((b, 128), generator=g, device=dev), dim=-1)
    cand = torch.nn.functional.normalize(
        torch.randn((b, kc, 128), generator=g, device=dev), dim=-1)
    cand[:, 1::3] = cand[:, :1]  # exactly equal scores: lowest index first
    if kc > 97:
        cand[:, 0] = q
        cand[:, ::97] = cand[:, :1]
    valid = torch.rand((b, kc), generator=g, device=dev) < 0.6
    if b > 1:
        valid[0] = False
    if b > 2:
        valid[1, : kc // 2] = False
        valid[2] = False
        valid[2, kc - 1] = True
    ops.reset_launches()
    gs, gi = ops.bucket_topk(q, cand, valid, m)
    assert ops.LAUNCHES["bucket_topk"] == 1
    ws, wi = bt.bucket_topk_plain(q, cand, bt.pack_valid(valid), m)
    assert torch.equal(gi, wi)
    torch.testing.assert_close(gs, ws, atol=1e-5, rtol=0)
    assert (gi[0] == -1).all() == (b > 1)


def test_bucket_topk_kernel_splits_rows_whose_sort_overflows(dev):
    """m > 32 with more rows than 4 blocks an SM and 16 416 lanes: one part
    a row would sort more keys than a block holds, so the grid splits each
    row in two; ids equal to the plain version's, scores within 1e-5."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    b, kc, d, m = 4 * sms + 1, 16416, 32, 50
    assert bt.grid(b, kc, m, sms).parts > 1
    g = torch.Generator(device=dev).manual_seed(kc)
    q = torch.nn.functional.normalize(
        torch.randn((b, d), generator=g, device=dev), dim=-1)
    cand = torch.nn.functional.normalize(
        torch.randn((b, kc, d), generator=g, device=dev), dim=-1)
    cand[:, 0] = q
    cand[:, ::97] = cand[:, :1]  # the row's best, tied across both parts
    valid = torch.rand((b, kc), generator=g, device=dev) < 0.6
    valid[0] = False
    gs, gi = ops.bucket_topk(q, cand, valid, m)
    ws, wi = bt.bucket_topk_plain(q, cand, bt.pack_valid(valid), m)
    assert torch.equal(gi, wi)
    torch.testing.assert_close(gs, ws, atol=1e-5, rtol=0)


def test_bucket_topk_kernel_takes_no_rows(dev):
    """b = 0: empty outputs, nothing launched."""
    ops.reset_launches()
    gs, gi = ops.bucket_topk(torch.zeros((0, 128), device=dev),
                             torch.zeros((0, 64, 128), device=dev),
                             torch.zeros((0, 64), dtype=torch.bool,
                                         device=dev), 10)
    assert gs.shape == gi.shape == (0, 10)
    assert ops.LAUNCHES["bucket_topk"] == 0


@pytest.mark.parametrize("op", ["fused_query", "bucket_topk"])
def test_shapes_beyond_shared_memory_raise(dev, op):
    """A block holds every candidate of its row in shared memory (its
    id and position in fused_query's hash; in bucket_topk at m > 32, its
    sort key in the part's block, which at m = 5000 takes the whole row);
    shapes that would overflow it raise ValueError, and the next launch
    still works."""
    if op == "fused_query":
        ids = torch.zeros((2, 2048), dtype=torch.int32, device=dev)
        words = torch.zeros((2, 2048, 1), dtype=torch.int32, device=dev)
        fb = torch.zeros((1, 31), dtype=torch.int32, device=dev)
        meta = torch.zeros((1, 2), dtype=torch.int32, device=dev)
        with pytest.raises(ValueError, match="shared memory"):
            ops.fused_query(ids, words, words[0, :1, :], fb, meta, m=1,
                            score="hamming")
        got = ops.fused_query(ids[:, :8].contiguous(),
                              words[:, :8].contiguous(), words[0, :1, :],
                              fb, meta, m=1, score="hamming")
        assert got[0].shape == (1, 1)
    else:
        q = torch.zeros((1, 128), device=dev)
        cand = torch.zeros((1, 60000, 128), device=dev)
        valid = torch.ones((1, 60000), dtype=torch.bool, device=dev)
        with pytest.raises(ValueError, match="shared memory"):
            ops.bucket_topk(q, cand, valid, 5000)
        got = ops.bucket_topk(q, cand[:, :64].contiguous(), valid[:, :64], 1)
        assert got[1].tolist() == [[0]]


def test_wrappers_count_launches_and_staged_hamming_runs(dev):
    ops.reset_launches()
    x = torch.randn((8, 16), device=dev)
    ops.simhash(x, torch.randn((2, 3, 16), device=dev))
    assert ops.LAUNCHES["simhash"] == 1
    w = torch.zeros((2, 4, 1), dtype=torch.int32, device=dev)
    ids, _ = scoring.score_topk(w[:, 0], torch.zeros((2, 4), dtype=torch.int32,
                                                     device=dev), w, 2,
                                use_kernels=True, score="hamming")
    assert ops.LAUNCHES["hamming_words"] == 1 and ids.tolist() == [[0, -1]] * 2
    with pytest.raises(ValueError, match="contiguous"):
        ops.simhash(x.T.contiguous().T, torch.randn((2, 3, 16), device=dev))
    with pytest.raises(TypeError, match="int32"):
        ops.hamming(w[:, 0].long(), w.long())


@pytest.mark.parametrize("w", [1, 2, 3, 5])
@pytest.mark.parametrize("n,kc", [(1, 1), (37, 300), (4096, 2048)])
def test_hamming_words_kernel_matches_plain(dev, n, kc, w):
    g = torch.Generator().manual_seed(n + kc + w)
    codes = torch.randint(-2**31, 2**31, (n, w), generator=g,
                          dtype=torch.int64).to(torch.int32).to(dev)
    cand = torch.randint(-2**31, 2**31, (n, kc, w), generator=g,
                         dtype=torch.int64).to(torch.int32).to(dev)
    cand[0, 0] = codes[0]
    got = ops.hamming(codes, cand)
    torch.cuda.synchronize()
    assert torch.equal(got, hm.hamming_words_plain(codes, cand))
    assert int(got[0, 0]) == 0


@pytest.mark.parametrize("n,kc", [(1, 1), (4096, 6656), (3, 0)])
def test_hamming_kernel_matches_plain(dev, n, kc):
    g = torch.Generator().manual_seed(n + kc)
    codes = torch.randint(-2**31, 2**31, (n,), generator=g,
                          dtype=torch.int64).to(torch.int32).to(dev)
    cand = torch.randint(-2**31, 2**31, (n, kc), generator=g,
                         dtype=torch.int64).to(torch.int32).to(dev)
    got = ops.hamming(codes, cand)
    torch.cuda.synchronize()
    assert got.shape == (n, kc)
    assert torch.equal(got, hm.hamming_plain(codes, cand))


@pytest.mark.parametrize("op", list(autotune.SWEEP))
def test_every_autotune_candidate_equals_plain(dev, op):
    """Each grid the sweep may pick, at the sweep's shapes, gives the
    plain version's output (simhash: flips only within the 1e-5 band)."""
    op_cases = autotune.cases(op, dev)
    for case in op_cases:
        want = case.plain()
        for params in autotune.candidates(op):
            case.check(case.run(params), want)



# -- the paper's sparse OSN workload ---------------------------------------


@pytest.mark.parametrize("packed_out", [False, True])
@pytest.mark.parametrize("spec", [osn.DBLP_S, osn.LIVEJOURNAL_S,
                                  osn.FRIENDSTER_S], ids=lambda s: s.name)
def test_simhash_kernel_matches_plain_at_osn_widths(dev, spec, packed_out):
    """The corpus sketch's inputs: densified interest vectors of d = 8192,
    24 576 and 49 152 (a 2 048-user cut of each dataset), k of the
    dataset, L = 4."""
    corpus = osn.generate(dataclasses.replace(spec, num_users=2048),
                          device=dev)
    x = corpus.densify(torch.arange(corpus.n, device=dev))
    h = hashing.make_hyperplanes(
        hashing.LshParams(d=spec.num_interests, k=spec.k, L=4, seed=13),
        device=dev)
    got = ops.simhash(x, h, packed=packed_out)
    want = sh.simhash_plain(x, h, packed=packed_out)
    assert flips_outside_band(x, h, got, want, packed_out) == 0


def test_sparse_densify_on_card_equals_cpu(dev):
    cpu = osn.generate(osn.tiny_spec(), device="cpu")
    card = osn.generate(osn.tiny_spec(), device=dev)
    idx = torch.tensor([[0, -1, 5], [1999, 5, 17]])
    assert torch.equal(card.densify(idx.to(dev)).cpu(), cpu.densify(idx))
    q = cpu.densify(torch.arange(8))
    q = q / q.norm(dim=1, keepdim=True)
    cand = torch.randint(-1, cpu.n, (8, 300),
                         generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(
        card.scores_against_dense(q.to(dev), cand.to(dev)).cpu(),
        cpu.scores_against_dense(q, cand), atol=1e-6, rtol=0)


def test_sparse_engine_on_card_matches_cpu(dev):
    """tiny_osn on both devices: the corpus codes (simhash kernel against
    the CPU's plain sketch) and the query codes first, then, on one
    store, ids under the near-tie rule, contains (fused_contains on the
    card) exactly, and the oracle."""
    spec = osn.tiny_spec()
    cpu = osn.generate(spec, device="cpu")
    card = osn.generate(spec, device=dev)
    params = hashing.LshParams(d=spec.num_interests, k=spec.k, L=4, seed=7)
    h = hashing.make_hyperplanes(params, device="cpu")
    codes = hashing.sketch_codes_batched(cpu, h)
    codes_c = hashing.sketch_codes_batched(card, h.to(dev), batch=512)
    dense = cpu.densify(torch.arange(cpu.n))
    assert flips_outside_band(dense, h, codes_c.cpu(), codes) == 0
    store = build_store_host(codes, params.num_buckets, 128, device="cpu")
    store_c = build_store_host(codes, params.num_buckets, 128, device=dev)
    qidx = np.arange(64)
    q = dense[qidx] / dense[qidx].norm(dim=1, keepdim=True)
    qc = hashing.sketch_codes(q, h)
    qc_c = hashing.sketch_codes(q.to(dev), h.to(dev)).cpu()
    assert flips_outside_band(q, h, qc_c, qc) == 0
    same = (qc_c == qc).all(dim=1).numpy()  # queries whose codes agree
    for variant in ("lsh", "nb", "cnb"):
        e_cpu = LshEngine(params, h, store, cpu, None,
                          EngineConfig(variant=variant), device="cpu")
        e_card = LshEngine(params, h.to(dev), store_c, card, None,
                           EngineConfig(variant=variant), device=dev)
        a = e_cpu.search(q.numpy(), m=10, exclude=qidx)
        b = e_card.search(q.numpy(), m=10, exclude=qidx)
        topk_swaps(a.scores[same], a.ids[same], b.scores[same], b.ids[same])
        y = a.ids[:, 0]
        np.testing.assert_array_equal(e_card.contains(q.numpy(), y)[same],
                                      e_cpu.contains(q.numpy(), y)[same])
    s_cpu, i_cpu = exact_topk_sparse(cpu, q, 11)
    s_card, i_card = exact_topk_sparse(card, q.to(dev), 11)
    topk_swaps(s_cpu.numpy(), i_cpu.numpy(), s_card.cpu().numpy(),
               i_card.cpu().numpy())


def _replicated_calls(dev, monkeypatch, R, mode):
    """The fused_query and fused_contains calls of one replicated search
    and contains on a 4-node mesh on the card, node 1 killed: [(args,
    kwargs)] each, recorded as the runtime makes them."""
    from repro_torch.core.runtime import IndexRuntime, RuntimeConfig, \
        kill_node
    from repro_torch.launch.mesh import make_zone_mesh

    n_users, d, k, L, c, nq = 6000, 64, 8, 3, 128, 256
    g = torch.Generator().manual_seed(R)
    x = torch.nn.functional.normalize(torch.randn((n_users, d), generator=g),
                                      dim=-1)
    params = hashing.LshParams(d=d, k=k, L=L, seed=R)
    h = hashing.make_hyperplanes(params, device="cpu")
    store = build_store_host(hashing.sketch_codes(x, h), params.num_buckets,
                             c, payload=x, device=dev)
    rt = IndexRuntime(RuntimeConfig(params=params, n_nodes=4, m=11,
                                    cap_factor=4.0, replication=R,
                                    read_mode=mode),
                      mesh=make_zone_mesh(4, device=dev))
    reps = rt.replicate_store(store)
    cache = rt.refresh_cache(store)
    store, reps = kill_node(rt, store, reps, 1)
    calls = {"fused_query": [], "fused_contains": []}
    for name in calls:
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _n=name, _f=real, **kw: (
            calls[_n].append((a, kw)), _f(*a, **kw))[1])
    q = x[:nq].to(dev)
    live = [1, 0, 1, 1]
    rt.search(h.to(dev), store, q, cache=cache, replicas=reps, live=live)
    rt.contains(h.to(dev), store, q, torch.arange(nq), cache=cache,
                replicas=reps, live=live)
    monkeypatch.undo()
    assert len(calls["fused_query"]) == len(calls["fused_contains"]) == 1
    ids_flat = calls["fused_query"][0][0][0]
    assert ids_flat.shape == (L * R * params.num_buckets, c)
    return calls["fused_query"][0], calls["fused_contains"][0][0]


@pytest.mark.parametrize("R,mode", [(2, "first"), (2, "quorum"),
                                    (3, "first"), (3, "quorum")])
def test_fused_kernels_on_the_replica_view(dev, monkeypatch, R, mode):
    """fused_query and fused_contains on the [T*R*NB, C] primary +
    replica view a replicated read gives them (quorum: R x the routed
    rows), against their plain versions.  The R = 3 quorum shape also
    runs with the score buffer sized by the pair count read back."""
    (a, kw), ca = _replicated_calls(dev, monkeypatch, R, mode)
    gi, gs = ops.fused_query(*a, **kw)
    wi, ws = fq.fused_query_plain(*a, **kw)
    topk_swaps(ws.cpu().numpy(), wi.cpu().numpy(), gs.cpu().numpy(),
               gi.cpu().numpy(), tol=1e-5)
    assert torch.equal(ops.fused_contains(*ca), fq.fused_contains_plain(*ca))
    if (R, mode) == (3, "quorum"):
        r, n_probes = a[3].shape
        monkeypatch.setattr(fq, "SCORE_BUFFER_BYTES",
                            r * n_probes * a[0].shape[1] * 4 - 1)
        assert fq.score_buffer_rows(r, n_probes, a[0].shape[1]) is None
        bi, bs = ops.fused_query(*a, **kw)
        topk_swaps(ws.cpu().numpy(), wi.cpu().numpy(), bs.cpu().numpy(),
                   bi.cpu().numpy(), tol=1e-5)


# -- serving: pipelined dispatch on CUDA events, the writer's stream --------


def _serve_world(dev, n=20000, d=64, k=8, L=4, seed=0):
    """(backend over `LshEngine(use_kernels=True)` on the card, queries,
    hyperplanes, host corpus, params); the test holds no other reference
    to the engine's store or corpus."""
    from repro_torch.core import LshParams, make_hyperplanes
    from repro_torch.core.corpus import DenseCorpus
    from repro_torch.serve import RuntimeBackend

    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    params = LshParams(d=d, k=k, L=L, seed=seed + 1)
    h = make_hyperplanes(params, device=dev)
    vecs = torch.from_numpy(emb).to(dev)
    store = build_store_host(hashing.sketch_codes_batched(vecs, h),
                             params.num_buckets, capacity=128, device=dev)
    engine = LshEngine(params, h, store, DenseCorpus(vecs), None,
                       EngineConfig(use_kernels=True), device=dev)
    return RuntimeBackend(engine), emb[:64].copy(), h, emb, params


def _drifted(h, emb, params, seed, now=1):
    """A churn epoch on the card: drifted vectors, the store rebuilt and
    re-stamped; returns the update kwargs."""
    from repro_torch.core.corpus import DenseCorpus
    from repro_torch.core.store import insert_batch

    rng = np.random.default_rng(seed)
    moved = emb + 0.3 * rng.standard_normal(emb.shape).astype(np.float32)
    moved /= np.linalg.norm(moved, axis=1, keepdims=True)
    vecs = torch.from_numpy(moved).to(h.device)
    codes = hashing.sketch_codes_batched(vecs, h)
    store = build_store_host(codes, params.num_buckets, capacity=128,
                             device=h.device)
    store = insert_batch(store, torch.arange(emb.shape[0], dtype=torch.int32,
                                             device=h.device), codes, now)
    return dict(store=store, corpus=DenseCorpus(vecs))


def test_pending_dispatch_ready_after_the_event(dev):
    """`ready()` is False while the batch queues behind a sleep kernel and
    True once its copies have landed; `wait()` gives the sync ids."""
    backend, q, *_ = _serve_world(dev)
    ex = np.arange(q.shape[0], dtype=np.int32)
    want_i, want_s, _ = backend.dispatch(q, ex, 10)
    torch.cuda._sleep(200_000_000)  # ~100 ms ahead of the batch
    p = backend.dispatch_async(q, ex, 10)
    assert not p.ready()
    got_i, got_s, stats = p.wait()
    assert p.ready() and int(stats) == 0
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_s, want_s)


def test_engine_backend_stage_makes_no_host_sync(dev):
    backend, q, *_ = _serve_world(dev)
    ex = np.full(q.shape[0], -2, np.int32)
    want = backend.dispatch(q, ex, 10)[0]  # warm: kernels, pinned blocks
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        p = backend.dispatch_async(q, ex, 10)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    np.testing.assert_array_equal(p.wait()[0], want)


def test_writer_stream_install_then_depth4_batch_serves_the_new_store(dev):
    from repro_torch.serve import (
        ChurnWriter, FrontendConfig, RetrievalFrontend, RuntimeBackend)

    backend, q, h, emb, params = _serve_world(dev)
    # no cache: a cached result would answer the submits at intake, at
    # the generation before the install
    fe = RetrievalFrontend(backend, FrontendConfig(
        m=10, max_batch=16, queue_capacity=128, cache=False,
        pipeline_depth=4))
    old, _ = fe.search(q)
    with ChurnWriter(fe) as wr:
        def prep():  # the new store is built on the writer's stream
            torch.cuda._sleep(50_000_000)
            return _drifted(h, emb, params, seed=3)
        wr.submit(prep)
        deadline = time.perf_counter() + 60
        while wr.prepared < 1 and time.perf_counter() < deadline:
            time.sleep(0.001)
        assert wr.prepared == 1
        tickets = [fe.submit(r) for r in q[:16]]
        fe.step()  # the stage boundary installs, then stages at once
        assert wr.installed == 1 and fe.inflight == 1
        got = np.stack([fe.wait(t)[0] for t in tickets])
    fresh = RuntimeBackend(LshEngine(
        params, h, backend._store, backend._corpus, None,
        EngineConfig(use_kernels=True), device=dev))
    want = fresh.dispatch(q[:16], np.full(16, -2, np.int32), 10)[0]
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, old[:16])


def test_update_while_in_flight_serves_the_old_store(dev):
    """A batch staged before an update reads the store it was staged
    with, even once the backend has dropped that store and the caching
    allocator has handed out memory of its size again."""
    backend, q, h, emb, params = _serve_world(dev)
    ex = np.arange(q.shape[0], dtype=np.int32)
    want = backend.dispatch(q, ex, 10)[0]
    nbytes = backend._corpus.vectors.numel()
    torch.cuda._sleep(200_000_000)
    p = backend.dispatch_async(q, ex, 10)
    backend.update(**_drifted(h, emb, params, seed=5))
    junk = [torch.full((nbytes,), -7.0, device=dev) for _ in range(4)]
    got = p.wait()[0]
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(backend.dispatch(q, ex, 10)[0], want)
    del junk


# -- the LM serving path: the models on the card, the index at D = 2304 -----


@pytest.fixture
def no_tf32():
    """f32 products in full fp32 (TF32 alone exceeds 1e-4)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved[0]
    torch.set_float32_matmul_precision(saved[1])


@pytest.mark.parametrize("arch", [
    "gemma2-2b", "starcoder2-7b", "codeqwen1.5-7b", "phi3-medium-14b",
    "seamless-m4t-medium", "phi-3-vision-4.2b", "xlstm-1.3b",
    "jamba-v0.1-52b", "deepseek-moe-16b", "llama4-maverick-400b-a17b"])
def test_smoke_model_on_card_equals_cpu(dev, no_tf32, arch):
    """Forward logits, prefill and 4 teacher-forced decode steps of the
    SMOKE config in f32, on the card against the CPU on the same
    weights, within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_batch
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    cpu = M.init_model(cfg, 0, device="cpu")
    card = M.Model(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    outs = []
    for model, d in ((cpu, "cpu"), (card, dev)):
        b = make_batch(cfg, 2, 16, 0, d)
        got = [M.logits_from_hidden(model, M.forward(model, b))]
        last, st = M.prefill(model, dict(b, tokens=b["tokens"][:, :12]), 24)
        got.append(last)
        off = cfg.num_prefix_embeds if "prefix_embeds" in b else 0
        for t in range(4):
            lg, st = M.decode_step(model, b["tokens"][:, 12 + t], st,
                                   off + 12 + t)
            got.append(lg)
        outs.append([x.cpu() for x in got])
    for want, got in zip(*outs):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def test_lm_decode_loop_makes_no_host_sync(dev):
    """`generate` (prefill and every decode step) runs under sync-debug
    "error"; its tokens equal a run outside it."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate, make_batch
    from repro_torch.models import model as M

    cfg = get_config("gemma2-2b", smoke=True)
    model = M.init_model(cfg, 0, device=dev)
    batch = make_batch(cfg, 2, 16, 0, dev)
    want = generate(model, batch, steps=8, max_len=32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = generate(model, batch, steps=8, max_len=32)
        sampled = generate(model, batch, steps=8, max_len=32, greedy=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got, want)
    assert bool(((sampled >= 0) & (sampled < cfg.vocab_size)).all())


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "jamba-v0.1-52b",
                                  "deepseek-moe-16b"])
def test_recurrent_and_moe_decode_loop_makes_no_host_sync(dev, arch):
    """`generate` through mLSTM / sLSTM, mamba and MoE layers runs under
    sync-debug "error"; its tokens equal a run outside it."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate, make_batch
    from repro_torch.models import model as M

    cfg = get_config(arch, smoke=True)
    model = M.init_model(cfg, 0, device=dev)
    batch = make_batch(cfg, 2, 16, 0, dev)
    want = generate(model, batch, steps=8, max_len=32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = generate(model, batch, steps=8, max_len=32)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got, want)


def _layer_on_both(dev, module, arch):
    """A module of the SMOKE config in f32 drawn on the CPU, and a copy
    on the card."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    cpu = module(cfg)
    g = torch.Generator().manual_seed(0)
    for sub in cpu.modules():  # an MoE's shared MLP resets itself
        sub.reset_parameters(g)
    card = module(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    return cfg, cpu, card


@pytest.mark.parametrize("s,chunk", [(32, 8), (512, 256)])
def test_mamba_on_card_equals_cpu(dev, no_tf32, s, chunk):
    """The chunked scan (chunks carrying the state; the serving chunk of
    256) and 3 decode steps, on the card against the CPU, within 1e-4."""
    from repro_torch.models import ssm

    cfg, cpu, card = _layer_on_both(dev, ssm.Mamba, "jamba-v0.1-52b")
    x = torch.randn((2, s + 3, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)) * 0.5
    outs = []
    for m, d in ((cpu, "cpu"), (card, dev)):
        xd = x.to(d)
        y, st = ssm.mamba_with_state(m, xd[:, :s], chunk=chunk)
        got = [y, st[0]]
        for t in range(s, s + 3):
            o, st = ssm.mamba_decode(m, xd[:, t:t + 1], st)
            got += [o, st[0]]
        outs.append([g.cpu() for g in got])
    for want, got in zip(*outs):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_on_card_equals_cpu(dev, no_tf32, kind):
    """mLSTM over 2 chunks of 256 then a decode step; sLSTM's time loop
    over 64 steps then a decode step: the card against the CPU, 1e-4."""
    from repro_torch.models import xlstm

    module = xlstm.MLstm if kind == "mlstm" else xlstm.SLstm
    fwd = (xlstm.mlstm_with_state if kind == "mlstm"
           else xlstm.slstm_with_state)
    step = xlstm.mlstm_decode if kind == "mlstm" else xlstm.slstm_decode
    cfg, cpu, card = _layer_on_both(dev, module, "xlstm-1.3b")
    s = 512 if kind == "mlstm" else 64
    x = torch.randn((2, s + 1, cfg.d_model),
                    generator=torch.Generator().manual_seed(2)) * 0.5
    outs = []
    for m, d in ((cpu, "cpu"), (card, dev)):
        xd = x.to(d)
        y, st = fwd(m, xd[:, :s])
        o, st2 = step(m, xd[:, s:], st)
        outs.append([t.cpu() for t in (y, o) + tuple(st2)])
    for want, got in zip(*outs):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("cf", [0.5, 16.0])
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "jamba-v0.1-52b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_layer_on_card_equals_cpu(dev, no_tf32, arch, cf):
    """The MoE layer on the card against the CPU: the same expert ids and
    dispatch table, the output and the aux within 1e-4, and the output
    the same on a second run (the combine is a gather, no atomics); at
    cf 0.5 pairs are dropped."""
    from repro_torch.models import moe

    cfg, cpu, card = _layer_on_both(dev, moe.Moe, arch)
    cfg = dataclasses.replace(cfg, moe_capacity_factor=cf)
    cpu.cfg = card.cfg = cfg
    x = torch.randn((4, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(3)) * 0.3
    outs = []
    for m, d in ((cpu, "cpu"), (card, dev)):
        xd = x.to(d)
        _, _, w, idx = moe.route(m, xd)
        cap = moe.capacity(cfg, 64)
        disp, _, _ = moe.dispatch(idx, w, cfg.moe_num_experts, cap,
                                  torch.float32)
        y, aux = moe.moe(m, xd)
        assert torch.equal(moe.moe(m, xd)[0], y)
        outs.append([t.cpu() for t in (idx, disp, y, aux.load_balance_loss,
                                       aux.router_z_loss,
                                       aux.dropped_fraction)])
    (idx0, disp0, *rest0), (idx1, disp1, *rest1) = outs
    assert torch.equal(idx0, idx1) and torch.equal(disp0, disp1)
    for want, got in zip(rest0, rest1):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    assert (float(rest1[-1]) > 0) == (cf == 0.5)


ALL_ARCHS = ("gemma2-2b", "starcoder2-7b", "codeqwen1.5-7b",
             "phi3-medium-14b", "seamless-m4t-medium", "phi-3-vision-4.2b",
             "xlstm-1.3b", "jamba-v0.1-52b", "deepseek-moe-16b",
             "llama4-maverick-400b-a17b")


def _rel_err(got, want) -> float:
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max()
                 / max(float(want.abs().max()), 1e-30))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_train_step_on_card_equals_cpu(dev, no_tf32, arch):
    """One training step of the SMOKE config in f32 (MoE layers
    dropless), on the card against the CPU from the same weights and
    batch: the loss within 1e-4 relative, each gradient leaf within 1e-3
    of its largest magnitude (chip_smoke.py's train_check gates); then
    `apply_updates` given the CPU's gradients on both devices:
    parameters and moments within 1e-6 relative."""
    from repro_torch.configs import get_config
    from repro_torch.data import tokens as tok
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    if cfg.moe_num_experts:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=float(
            cfg.moe_num_experts) / cfg.moe_top_k)
    cpu = M.init_model(cfg, 0, device="cpu")
    card = M.Model(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    ocfg = opt.OptConfig(peak_lr=1e-3, warmup_steps=0, decay_steps=10)
    hp = ts.TrainHParams(loss_chunk=16)
    out = {}
    for model, d in ((cpu, "cpu"), (card, dev)):
        batch = tok.make_batch(cfg, tok.DataConfig(), 0, 2, 32, device=d)
        p = ts.parameters(model)
        loss, _ = ts.make_loss_fn(cfg, hp)(model, batch)
        out[d] = (float(loss.detach()), ts.grads_of(loss, p), p)
    (l_cpu, g_cpu, p_cpu), (l_card, g_card, p_card) = out["cpu"], out[dev]
    assert abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu)
    for name, g in g_cpu.items():
        assert _rel_err(g_card[name], g) <= 1e-3, name
    states = {}
    for p, d in ((p_cpu, "cpu"), (p_card, dev)):
        grads = {n: g.to(d) for n, g in g_cpu.items()}
        _, states[d], _ = opt.apply_updates(p, grads,
                                            opt.init_opt_state(p, ocfg), ocfg)
    for name in p_cpu:
        assert _rel_err(p_card[name], p_cpu[name]) <= 1e-6, name
        for k in ("m", "v"):
            assert _rel_err(states[dev]["mu"][name][k],
                            states["cpu"]["mu"][name][k]) <= 1e-6, (name, k)


def test_train_resume_on_card_equals_straight_run(dev, tmp_path):
    """On the card, under deterministic algorithms: 4 steps with a
    checkpoint, then `--resume` to 6, leave the same parameters as 6
    straight steps, bit for bit (starcoder2 smoke, bf16)."""
    from repro_torch.launch import train as train_mod

    args = ["--arch", "starcoder2-7b", "--smoke", "--device", "cuda",
            "--batch", "2", "--seq", "32", "--ckpt-every", "2"]
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        ck = str(tmp_path / "ck")
        train_mod.run(train_mod.parse_args(
            args + ["--steps", "4", "--ckpt-dir", ck]), log=lambda s: None)
        resumed, _ = train_mod.run(train_mod.parse_args(
            args + ["--steps", "6", "--ckpt-dir", ck, "--resume"]),
            log=lambda s: None)
        straight, _ = train_mod.run(train_mod.parse_args(
            args + ["--steps", "6"]), log=lambda s: None)
    finally:
        torch.use_deterministic_algorithms(was)
    for (name, a), (_, b) in zip(resumed.state_dict().items(),
                                 straight.state_dict().items()):
        assert torch.equal(a, b), name


def _wide_index(dev, n=4096, d=2304, k=10, L=4, c=64, seed=0):
    """Unit vectors at gemma2-2b's width in 64 tight clusters, their
    store at capacity c (payload kept), the hyperplanes and params."""
    g = torch.Generator(device=dev).manual_seed(seed)
    centres = torch.randn((64, d), generator=g, device=dev)
    emb = centres[torch.arange(n, device=dev) % 64] \
        + 0.3 * torch.randn((n, d), generator=g, device=dev)
    emb = torch.nn.functional.normalize(emb, dim=-1)
    params = hashing.LshParams(d=d, k=k, L=L, seed=seed)
    h = hashing.make_hyperplanes(params, device=dev)
    store = build_store_host(hashing.sketch_codes_batched(emb, h),
                             params.num_buckets, c, payload=emb, device=dev)
    return emb, params, h, store


def test_bucket_topk_kernel_at_model_width(dev):
    """The engine chunk's shape at D = 2304: 128 rows x 11 probes x 64
    lanes; ids equal plain up to near ties, scores within 1e-5."""
    g = torch.Generator(device=dev).manual_seed(2304)
    q = torch.nn.functional.normalize(
        torch.randn((128, 2304), generator=g, device=dev), dim=-1)
    cand = torch.nn.functional.normalize(
        q[:, None] + torch.randn((128, 704, 2304), generator=g, device=dev),
        dim=-1)
    valid = torch.rand((128, 704), generator=g, device=dev) < 0.6
    gs, gi = ops.bucket_topk(q, cand, valid, 10)
    ws, wi = bt.bucket_topk_plain(q, cand, bt.pack_valid(valid), 10)
    topk_swaps(ws.cpu().numpy(), wi.cpu().numpy(), gs.cpu().numpy(),
               gi.cpu().numpy(), tol=1e-5)


def test_fused_kernels_at_model_width(dev):
    """IndexRuntime(use_kernels=True) dot search (fused_query) and
    contains (fused_contains) over a D = 2304 store equal the plain
    staged path; the engine's bucket_topk path equals its plain path."""
    from repro_torch.core.corpus import DenseCorpus
    from repro_torch.core.runtime import IndexRuntime, RuntimeConfig
    from repro_torch.core.store import BucketStore

    emb, params, h, store = _wide_index(dev)
    q, ex = emb[:512], torch.arange(512, device=dev, dtype=torch.int32)
    ops.reset_launches()
    fused = IndexRuntime(RuntimeConfig(params=params, variant="cnb", m=10,
                                       use_kernels=True), device=dev)
    gi, gs, _ = fused.search(h, store, q, exclude=ex)
    hits, _ = fused.contains(h, store, q, ex)
    assert ops.LAUNCHES["fused_query"] >= 1
    assert ops.LAUNCHES["fused_contains"] >= 1
    plain = IndexRuntime(RuntimeConfig(params=params, variant="cnb", m=10),
                         device=dev)
    wi, ws, _ = plain.search(h, store, q, exclude=ex)
    topk_swaps(ws.cpu().numpy(), wi.cpu().numpy(), gs.cpu().numpy(),
               gi.cpu().numpy(), tol=1e-5)
    assert torch.equal(hits, plain.contains(h, store, q, ex)[0])
    ids_only = BucketStore(store.ids, store.timestamps, store.write_ptr, None)
    engines = [LshEngine(params, h, ids_only, DenseCorpus(emb), None,
                         EngineConfig(use_kernels=kern), device=dev)
               for kern in (True, False)]
    (r_k, r_p) = [e.search(q, m=10, exclude=ex.cpu().numpy())
                  for e in engines]
    assert ops.LAUNCHES["bucket_topk"] >= 1
    topk_swaps(r_p.scores, r_p.ids, r_k.scores, r_k.ids, tol=1e-5)


# -- the process mesh over NCCL, at the one card's world of 1 -----------------


@pytest.fixture
def nccl_world(dev):
    """A one-rank NCCL process group, destroyed after the test."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    from torch_dist_worker import free_port

    mesh_mod.init_process_mesh(dev, init_method=f"tcp://127.0.0.1:"
                               f"{free_port()}", rank=0, world_size=1)
    try:
        yield mesh_mod
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("n", [1, 4])
def test_block_collectives_over_nccl_equal_mesh_collectives(dev, nccl_world,
                                                            n):
    """Every BlockCollectives method through NCCL at world 1 (the whole
    exchange passes the group's collective) equals MeshCollectives."""
    from repro_torch.core.runtime import BlockCollectives, MeshCollectives
    from torch_dist_worker import collective_inputs, perms_of

    mesh = nccl_world.make_zone_mesh(n, device=dev)
    assert mesh.world == 1 and mesh.n_loc == n
    bc = BlockCollectives(n=n, n_loc=n, block=0, device=mesh.device)
    mc = MeshCollectives(n=n, device=mesh.device)
    x = {k: v.to(mesh.device) for k, v in collective_inputs(n, n).items()}
    assert torch.equal(bc.axis_index(), mc.axis_index())
    assert torch.equal(bc.local_index(), mc.local_index())
    for key in ("a2a", "a2a_f"):
        assert torch.equal(bc.all_to_all(x[key]), mc.all_to_all(x[key]))
    assert torch.equal(bc.all_gather(x["gather"]), mc.all_gather(x["gather"]))
    assert torch.equal(bc.all_gather_batch(x["gather"]),
                       mc.all_gather_batch(x["gather"]))
    assert torch.equal(bc.psum(x["psum"]), mc.psum(x["psum"]))
    assert torch.equal(bc.alive(x["live"]), mc.alive(x["live"]))
    perms = perms_of(n) if n > 1 else {"self": [(0, 0)], "none": []}
    for perm in perms.values():
        for key, axis in (("perm", 0), ("perm_ax1", 1), ("perm_bool", 0)):
            assert torch.equal(bc.ppermute(x[key], perm, axis),
                               mc.ppermute(x[key], perm, axis))


def test_process_mesh_hamming_cnb_search_on_card(dev, nccl_world):
    """A 16-node hamming cnb search and contains on the NCCL process mesh
    equal the one-process mesh's exactly, fused kernels and all."""
    from repro_torch.core import packed
    from repro_torch.core.runtime import IndexRuntime, RuntimeConfig

    n_users, d, k, L, c, nq = 20000, 64, 10, 3, 128, 512
    g = torch.Generator().manual_seed(16)
    x = torch.nn.functional.normalize(torch.randn((n_users, d), generator=g),
                                      dim=-1).to(dev)
    params = hashing.LshParams(d=d, k=k, L=L, seed=16)
    h = hashing.make_hyperplanes(params, device=dev)
    store = packed.pack_store_payload(build_store_host(
        hashing.sketch_codes(x, h), params.num_buckets, c, payload=x,
        device=dev), h)
    cfg = RuntimeConfig(params=params, n_nodes=16, m=10, variant="cnb",
                        score="hamming", cap_factor=16.0, use_kernels=True)
    outs = []
    for mesh in (nccl_world.ZoneMesh(16, 1, dev),
                 nccl_world.make_zone_mesh(16, device=dev)):
        rt = IndexRuntime(cfg, mesh=mesh)
        st = rt.shard_store(store)
        cache = rt.refresh_cache(st)
        ops.reset_launches()
        ids, sc, stats = rt.search(h, st, x[:nq], cache=cache)
        hits, hstats = rt.contains(h, st, x[:nq], torch.arange(nq),
                                   cache=cache)
        assert ops.LAUNCHES["fused_query"] >= 1
        assert ops.LAUNCHES["fused_contains"] >= 1
        outs.append((ids, sc, stats.host(), hits, hstats.host()))
    (i1, s1, st1, h1, hs1), (i2, s2, st2, h2, hs2) = outs
    assert isinstance(nccl_world.make_zone_mesh(16, device=dev),
                      nccl_world.ProcessZoneMesh)
    assert torch.equal(i1, i2) and torch.equal(s1, s2)
    assert torch.equal(h1, h2) and st1 == st2 and hs1 == hs2
    assert st1["dropped_probes"] == 0


@pytest.mark.parametrize("mode", ["first", "quorum"])
def test_process_mesh_replicas_kills_and_reshard_on_card(dev, nccl_world,
                                                        mode):
    """On the NCCL process mesh at world 1: a replicated search and
    contains (R = 2, 4 nodes, node 1 killed), `kill_node`'s store and
    replica slices, and a 4 -> 2 -> 4 reshard equal the one-process
    mesh's exactly, through the fused kernels."""
    from repro_torch.core.runtime import (IndexRuntime, RuntimeConfig,
                                          kill_node, reshard)

    n_users, d, k, L, c, nq = 20000, 64, 8, 3, 128, 512
    g = torch.Generator().manual_seed(22)
    x = torch.nn.functional.normalize(torch.randn((n_users, d), generator=g),
                                      dim=-1).to(dev)
    params = hashing.LshParams(d=d, k=k, L=L, seed=22)
    h = hashing.make_hyperplanes(params, device=dev)
    store = build_store_host(hashing.sketch_codes(x, h), params.num_buckets,
                             c, payload=x, device=dev)
    cfg = RuntimeConfig(params=params, n_nodes=4, m=10, variant="cnb",
                        cap_factor=4.0, replication=2, read_mode=mode)
    live = [1, 0, 1, 1]
    outs = []
    for mesh, two in ((nccl_world.ZoneMesh(4, 1, dev),
                       nccl_world.ZoneMesh(2, 1, dev)),
                      (nccl_world.make_zone_mesh(4, device=dev),
                       nccl_world.make_zone_mesh(2, device=dev))):
        rt = IndexRuntime(cfg, mesh=mesh)
        st = rt.shard_store(store)
        reps = rt.replicate_store(st)
        cache = rt.refresh_cache(st)
        st_k, reps_k = kill_node(rt, st, reps, 1)
        ops.reset_launches()
        ids, sc, stats = rt.search(h, st_k, x[:nq], cache=cache,
                                   replicas=reps_k, live=live)
        hits, hstats = rt.contains(h, st_k, x[:nq], torch.arange(nq),
                                   cache=cache, replicas=reps_k, live=live)
        assert ops.LAUNCHES["fused_query"] >= 1
        assert ops.LAUNCHES["fused_contains"] >= 1
        plain = dataclasses.replace(cfg, replication=1)
        rt_p = IndexRuntime(plain, mesh=mesh)
        rt2, st2, ev2 = reshard(rt_p, st, 2, mesh=two, cap_factor=2.0)
        rt4, st4, ev4 = reshard(rt2, st2, runtime=rt_p)
        ids4, sc4, stats4 = rt4.search(h, st4, x[:nq],
                                       cache=rt4.refresh_cache(st4))
        outs.append((ids, sc, stats.host(), hits, hstats.host(),
                     st_k.ids, st_k.payload, st_k.generation, *reps_k,
                     ev2, ev4, ids4, sc4, stats4.host(), st4.ids))
    assert isinstance(nccl_world.make_zone_mesh(4, device=dev),
                      nccl_world.ProcessZoneMesh)
    for a, b in zip(*outs):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b
    assert outs[0][2]["dropped_probes"] == 0
