"""The CUDA kernels against their plain PyTorch versions, on the card,
and the paper's sparse workload on the card against the CPU.

Marked `cuda`: they need an NVIDIA GPU and nvcc, and skip with a reason
where `torch.cuda.is_available()` is false.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import hashing, scoring
from repro_torch.core.corpus import exact_topk_sparse
from repro_torch.core.engine import EngineConfig, LshEngine
from repro_torch.core.store import build_store_host
from repro_torch.data import osn
from repro_torch.kernels import bucket_topk as bt
from repro_torch.kernels import fused_query as fq
from repro_torch.kernels import hamming as hm
from repro_torch.kernels import ops
from repro_torch.kernels import simhash as sh
from torch_fused_cases import CONTAINS_CASES, contains_case, edge_case_rows
from torch_parity_rules import flips_outside_band, topk_swaps

pytestmark = pytest.mark.cuda


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
