#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py            # the full-size world, as the port's proof
    python3 chip_smoke.py --users 65536 --batches 1   # a short rehearsal

The world is the paper's LiveJournal deployment (Sec. 6.2): 1.1 M users,
k = 12, with the repo's bench shape L = 4, D = 128, bucket capacity
C = 512 and m = 10, made from `--seed`.  Phases, each of which raises on
failure:

  1. environment: torch, CUDA, the card's name and power limit;
  2. build: every kernel from `src/repro_torch/kernels/csrc`, in parallel;
  3. world: corpus, hyperplanes, corpus codes through the simhash kernel,
     `build_store_host` at C = 512, and the packed (hamming) store;
  4. each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it, with times: simhash, fused_query
     (dot, also with the score buffer sized by a read-back of the pair
     count, and hamming, plus the edge cases of `tests/torch_fused_cases.
     py` at m = 1, 10, 700), fused_contains (under hit and under miss
     traffic), bucket_topk, and
     hamming_words at the CNB cache stage's shape of the 16-node mesh,
     hamming at [4096] x [4096, 6656]; simhash and bucket_topk also print
     the grid their module picked and the bytes/s and FLOP/s they reached
     beside the card's peaks, and simhash its wrapper's host cost a call,
     and its times at the OSN widths: 8192 densified users of the
     LIVEJOURNAL_S (d = 24 576, k = 11) and FRIENDSTER_S (d = 49 152,
     k = 12) shapes;
  5. runtime search through `IndexRuntime(use_kernels=True)`, dot and
     hamming, for lsh / nb / cnb and ranked cnb: ms per batch, queries/s,
     self-hit@1 and recall@10 against brute-force top-10; each cell
     holds fused_query against its plain version on the inputs it
     records from one batch; 5b. the staged
     hamming cnb cell (`fused="off"`), equal to the fused one exactly;
  6. contains, equal to the staged plain path: ms per batch, contains/s;
  7. the engine (`LshEngine(use_kernels=True)`), ids equal to the runtime's;
  8. churn: insert of re-announces, expire, search; `generation` advances
     as the reference's does;
  9. the mesh: n CAN nodes held on the one card (`make_zone_mesh`).
     16 nodes, hamming, 1024 queries: lsh / nb / cnb under alltoall and
     cnb under allgather at zero drops, ids and scores equal to the
     1-node runtime's exactly, and cnb at the default cap_factor with
     its drops; 4 nodes, dot, 256 queries: nb / cnb, ids equal up to
     near ties; contains at 16 nodes equal to the 1-node contains, with
     ms per batch and contains/s; the CNB cache refresh.  Per cell: ms
     per batch, queries/s, the router's counters, the wire bytes of
     `estimate_query_bytes`, and a torch.profiler trace of one batch
     (device time by kernel, busy share).
     Each cell holds its owner stage's fused_query, and, through the
     cache or NB stage, bucket_topk or hamming_words, against the plain
     version on the very inputs the path gives them, recorded from one
     batch, with times;
 10. the paper's workload: the LIVEJOURNAL_S OSN corpus (117 000
     users, 24 576 interests, k = 11; `repro_torch.data.osn`) with L = 4,
     hyperplane seed 13 and bucket capacity 256, as
     `benchmarks/common.py` builds it.  The corpus sketch through the
     simhash kernel in chunks of 8192 densified rows (every chunk held
     against plain, with times against the bound); recall@10, NCS@10
     and messages of lsh / layered / nb / cnb on 1024 queries against
     the sparse oracle (each query's own id excluded), failing unless
     cnb beats lsh at equal messages; the Fig. 4 success probability of
     lsh and nb through `LshEngine.contains` (fused_contains) by cosine
     interval beside `analysis`, failing on a mean gap above 0.15; 64
     queries of the card's cnb search against the port's CPU run; ms
     per batch of the staged sparse search and of contains;
 11. P2P dynamics (`repro_torch.core.churn`), with the earlier world
     freed: `ChurnConfig` at the LiveJournal deployment (N users, D, k,
     L, C as above, 1024 queries, m = 10, Gaussian unit vectors, refresh
     every 2 epochs, TTL 4), epochs cut from 12 to 8.  Cells: `run_churn`
     (1 node); `run_node_churn` over 1 -> 2 -> 4 -> 2 -> 1 nodes, failing
     unless every epoch's recall is within 0.02 of the 1-node run's and
     every `ReshardEvent` charges the closed-form handoff bytes;
     `run_failure_churn` (4 nodes, R = 2, node 1 killed at epoch 3) in
     first-responder and quorum reads, failing unless the reference's
     failure gates hold (`launch/failure_churn.smoke_gates`: degraded
     then recovered within the bounds, pre-kill recalls equal, closed-
     form bytes, flight records summing to the arrays); replicated
     contains on the killed mesh in both modes, failing unless every
     query whose own id sits in the killed zone still finds it.  Each
     cell prints per-epoch recall, staleness, nodes, byte charges and
     drops, ms per announce and per read epoch, and profiles one batch
     (busy share, fused_query's ms, the replica view's concat timed
     alone); fused_query (and fused_contains in the contains cell) is
     held against plain on inputs recorded from one read-epoch batch of
     each cell, outside the launch counts;
 12. the kernels line.  Each path of phases 5-11 runs with the launch
     counts set to 0 just before it and read just after, and fails
     unless each kernel it should go through was launched; a kernel's
     `launches` is the sum over the paths, `launches_by_path` the counts
     of each.  `hamming` (single word) is on no path: phase 4 holds it.

Kernel times come from one CUDA event pair per call, recorded while the
card still spins on a sleep kernel, so the host's launch pace stays out
of the reading.  Batch times are host clock, with Python's garbage
collector collected before and off during the timed batches.

The last line is `{"ok": true, "device": {...}}`.  With no CUDA device,
or without the repo around it, the script exits non-zero with no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12    # H100 SXM fp32 outside the tensor cores
TIE = 1e-5                  # dot-score tolerance and near-tie width
SPIN_CYCLES = 20_000_000    # ~10 ms of sleep kernel ahead of a timed call


def log(*a):
    print(*a, flush=True)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of one call of `fn` over `reps` calls, after one
    warm-up.  Each call has its own event pair, enqueued while the card
    spins on a ~10 ms sleep kernel: the host's launch pace (Python,
    ctypes, allocation) then falls before the start event is reached,
    and only device time lies between the two events."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def host_us(torch, fn, reps: int = 2000) -> float:
    """Mean host-clock microseconds `fn` takes to return, over `reps`
    back-to-back calls after one warm-up: a wrapper's host cost a call,
    where its device work is shorter (the card keeps up)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    return us


@contextlib.contextmanager
def gc_paused():
    """Collect, then keep Python's garbage collector off for the block:
    host-clock batch times then hold no collection's pause, wherever the
    allocations before them would have triggered one."""
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def bound(nbytes: float, flops: float = 0.0):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    fp32 operations over the fp32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profile_batch(torch, path: str, fn, top: int = 10) -> None:
    """Trace one call of `fn` with torch.profiler and print the device-side
    rows (kernels and copies, the top `top` by time), their total against
    the host-clock wall time (the busy share), and each row's count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"[profile] {path}: device {busy:.3f} ms of {wall:.3f} ms wall "
        f"(busy share {busy / wall:.3f})")
    for ms, count, key in rows[:top]:
        log(f"[profile]   {ms:9.3f} ms  x{count:<5d} {key[:90]}")
    return rows, wall


def compare_topk(ki, ks, pi, ps, what: str,
                 tie: float = TIE) -> tuple[float, int]:
    """Hold kernel (ki, ks) against plain (pi, ps) top-m rows.

    Scores agree to `tie`.  Ids agree exactly, except at ranks where the
    plain scores of a neighbouring rank lie within `tie` (the order of
    near-equal scores depends on summation order), and at the last rank,
    whose tie partner may be the unseen rank m + 1.  Returns (max score
    error, count of such near-tie exceptions)."""
    ks, ps = ks.cpu().numpy(), ps.cpu().numpy()
    ki, pi = ki.cpu().numpy(), pi.cpu().numpy()
    live = np.isfinite(ps)
    if not np.array_equal(live, np.isfinite(ks)):
        raise AssertionError(f"{what}: live lanes differ")
    err = float(np.max(np.abs(ks[live] - ps[live]), initial=0.0))
    if err > tie:
        raise AssertionError(f"{what}: max score error {err} > {tie}")
    near = np.zeros_like(live)
    gap = np.abs(np.diff(np.where(live, ps, 0.0), axis=1)) <= tie
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    near[:, -1] = True
    bad = (ki != pi) & ~near
    if bad.any():
        r, c = np.argwhere(bad)[0]
        raise AssertionError(
            f"{what}: ids differ at row {r} rank {c} outside a near tie: "
            f"kernel {ki[r]} {ks[r]} plain {pi[r]} {ps[r]}")
    return err, int(((ki != pi) & near).sum())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--users", type=int, default=1_100_000)
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import packed as packed_mod
    from repro_torch.core import runtime as rt_mod
    from repro_torch.core.corpus import DenseCorpus, exact_topk_dense
    from repro_torch.core.engine import EngineConfig, LshEngine
    from repro_torch.core.hashing import LshParams, make_hyperplanes
    from repro_torch.core.runtime import IndexRuntime, RuntimeConfig
    from repro_torch.core.store import BucketStore, build_store_host
    from repro_torch.data import osn
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import bucket_topk as bt_mod
    from repro_torch.kernels import fused_query as fq_mod
    from repro_torch.kernels import hamming as hm_mod
    from repro_torch.kernels import simhash as sh_mod
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_fused_cases import edge_case_rows

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")
    N, D, K, L, C, M, NQ = args.users, 128, 12, 4, 512, 10, 1024
    NB = 1 << K

    # -- 1. environment -----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} devices {torch.cuda.device_count()}")
    log(smi)

    # -- 2. build -----------------------------------------------------------
    t0 = time.time()
    _build.build_all()
    log(f"[build] {len(_build.SOURCES)} kernels in {time.time() - t0:.1f} s")
    for name, out in _build.ptxas_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # -- 3. world -----------------------------------------------------------
    t0 = time.time()
    rng = np.random.default_rng(args.seed)
    x = torch.from_numpy(
        rng.standard_normal((N, D), dtype=np.float32)).to(dev)
    x /= torch.linalg.vector_norm(x, dim=1, keepdim=True)
    params = LshParams(d=D, k=K, L=L, seed=args.seed)
    h = make_hyperplanes(params, torch.Generator().manual_seed(args.seed),
                         device=dev)
    corpus_codes = ops.simhash(x, h)
    store = build_store_host(corpus_codes, NB, C, payload=x, device=dev)
    store_h = packed_mod.pack_store_payload(store, h)
    ids_only = BucketStore(store.ids, store.timestamps, store.write_ptr, None)
    corpus = DenseCorpus(x)
    torch.cuda.synchronize()
    occ = store.occupancy().float()
    live = int((store.ids >= 0).sum())
    log(f"[world] N={N} D={D} k={K} L={L} NB={NB} C={C}: built in "
        f"{time.time() - t0:.1f} s; device bytes "
        f"{torch.cuda.memory_allocated()} (dot payload "
        f"{store.payload.numel() * 4}, hamming payload "
        f"{store_h.payload.numel() * 4}); occupancy mean "
        f"{float(occ.mean()):.1f} max {int(occ.max())}; evicted "
        f"{N * L - live} of {N * L} (entry, table) pairs")

    qids = torch.from_numpy(
        rng.choice(N, size=(args.batches, NQ), replace=False
                   ).astype(np.int64)).to(dev)
    q = x[qids[0]].contiguous()
    kernels = {}

    # -- 4. each kernel against its plain version ---------------------------
    # simhash, at the query batch and at the corpus build
    cfg = RuntimeConfig(params=params, variant="cnb", use_kernels=True)

    def simhash_check(xs, packed, got=None, hh=None):
        """Hold the kernel's codes `got` of xs against hyperplanes `hh`
        (default h; launched here if None) against the plain version:
        every flipped bit within the band.  Returns (flipped bits, the
        largest |projection| among them)."""
        hh = h if hh is None else hh
        Lh, Kh, _ = hh.shape
        if got is None:
            got = ops.simhash(xs, hh, packed=packed)
        want = sh_mod.simhash_plain(xs, hh, packed=packed)
        flips = torch.bitwise_xor(got, want)
        if not bool(flips.any()):
            return 0, 0.0
        proj = torch.einsum("nd,lkd->nlk", xs.double(), hh.double())
        band = 1e-5 * torch.linalg.vector_norm(xs.double(), dim=1)[:, None, None] \
            * torch.linalg.vector_norm(hh.double(), dim=2)[None]
        flat_proj = proj.reshape(xs.shape[0], -1)
        flat_band = band.reshape(xs.shape[0], -1)
        if packed:
            fl = packed_mod.unpack_codes(flips, Kh, Lh)
        else:
            fl = flips
        bits = ((fl.long()[..., None] >> torch.arange(Kh, device=fl.device))
                & 1)
        bits = bits.reshape(xs.shape[0], -1) > 0
        n_flip = int(bits.sum())
        outside = bits & (flat_proj.abs() > flat_band)
        if bool(outside.any()):
            raise AssertionError(
                f"simhash: {int(outside.sum())} flipped bits outside the "
                f"near-zero band")
        return n_flip, float(flat_proj.abs()[bits].max())

    n_q, e_q = simhash_check(q, False)
    n_w, e_w = simhash_check(q, True)
    n_c, e_c = 0, 0.0
    for s0 in range(0, N, 1 << 18):  # the corpus build's own codes
        sl = slice(s0, s0 + (1 << 18))
        a, b = simhash_check(x[sl], False, got=corpus_codes[sl])
        n_c, e_c = n_c + a, max(e_c, b)
    h_t = h.reshape(L * K, D).T.contiguous()
    sh_ms = cuda_ms(torch, lambda: ops.simhash(q, h), 50)
    sh_plain = cuda_ms(torch, lambda: sh_mod.simhash_plain(q, h), 50)
    sh_lib = cuda_ms(torch, lambda: torch.matmul(q, h_t), 50)
    shc_ms = cuda_ms(torch, lambda: ops.simhash(x, h), 5)
    shc_plain = cuda_ms(torch, lambda: torch.cat([
        sh_mod.simhash_plain(x[s:s + (1 << 18)], h)
        for s in range(0, N, 1 << 18)]), 2)
    shc_lib = cuda_ms(torch, lambda: torch.matmul(x, h_t), 5)
    shw_ms = cuda_ms(torch, lambda: ops.simhash(q, h, packed=True), 50)
    sh_bytes = NQ * D * 4 + L * K * D * 4 + NQ * L * 4
    shc_bytes = N * D * 4 + L * K * D * 4 + N * L * 4
    b_ms, b_by = bound(sh_bytes, 2.0 * NQ * D * L * K)
    bc_ms, _ = bound(shc_bytes, 2.0 * N * D * L * K)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    log(f"[kernel] simhash: flipped bits within the 1e-5 band: query codes "
        f"{n_q}, query words {n_w}, corpus codes {n_c} (max |proj| "
        f"{max(e_q, e_w, e_c):.3g}); n={NQ}: {sh_ms:.4f} ms (words "
        f"{shw_ms:.4f} ms), plain "
        f"{sh_plain:.4f} ms, matmul {sh_lib:.4f} ms, bound {b_ms:.4f} ms; "
        f"n={N}: {shc_ms:.4f} ms, plain {shc_plain:.4f} ms, matmul "
        f"{shc_lib:.4f} ms, bound {bc_ms:.4f} ms")
    for n_x, packed, t_ms, nbytes in ((NQ, False, sh_ms, sh_bytes),
                                      (NQ, True, shw_ms, sh_bytes),
                                      (N, False, shc_ms, shc_bytes)):
        g = sh_mod.grid(n_x, D, K, L, packed, sms)
        log(f"[kernel] simhash grid n={n_x} packed={packed}: {g.blocks} "
            f"blocks on {sms} SMs ({g}); achieved "
            f"{nbytes / t_ms / 1e6:.1f} GB/s of {HBM_BYTES_PER_S / 1e12:.2f} "
            f"TB/s, {2.0 * n_x * D * L * K / t_ms / 1e6:.1f} GFLOP/s of "
            f"{FP32_FLOPS_PER_S / 1e12:.0f} TFLOP/s")
    # the 1-node cells are host-bound: the wrapper's host cost a call at
    # the query batch, and that of its grid choice (a cached lookup)
    sh_host = host_us(torch, lambda: ops.simhash(q, h))
    sh_grid_host = host_us(torch, lambda: sh_mod.grid(NQ, D, K, L, False,
                                                      sms))
    log(f"[kernel] simhash host cost a call at n={NQ}: {sh_host:.2f} us "
        f"(the grid choice {sh_grid_host:.2f} us)")
    # at the OSN corpora's widths: densified interest vectors of 8192
    # users of the LIVEJOURNAL_S and FRIENDSTER_S shapes, L = 4
    sh_osn = []
    for spec in (osn.LIVEJOURNAL_S, osn.FRIENDSTER_S):
        cut = osn.generate(dataclasses.replace(spec, num_users=8192),
                           device=dev)
        xo = cut.densify(torch.arange(cut.n, device=dev))
        ho = make_hyperplanes(LshParams(d=spec.num_interests, k=spec.k, L=L,
                                        seed=13), device=dev)
        ho_t = ho.reshape(-1, ho.shape[2]).T.contiguous()
        n_o, e_o = simhash_check(xo, False, hh=ho)
        n_ow, e_ow = simhash_check(xo, True, hh=ho)
        o_ms = cuda_ms(torch, lambda: ops.simhash(xo, ho), 10)
        o_plain = cuda_ms(torch, lambda: sh_mod.simhash_plain(xo, ho), 5)
        o_lib = cuda_ms(torch, lambda: torch.matmul(xo, ho_t), 10)
        n_o_, d_o = xo.shape
        lk_o = L * spec.k
        o_b, o_by = bound(n_o_ * d_o * 4 + lk_o * d_o * 4 + n_o_ * L * 4,
                          2.0 * n_o_ * d_o * lk_o)
        g_o = sh_mod.grid(n_o_, d_o, spec.k, L, False, sms)
        log(f"[kernel] simhash at {spec.name} width: n={n_o_} d={d_o} "
            f"k={spec.k} L={L}: flipped bits within the 1e-5 band: codes "
            f"{n_o}, words {n_ow} (max |proj| {max(e_o, e_ow):.3g}); "
            f"{o_ms:.4f} ms, plain {o_plain:.4f} ms, matmul {o_lib:.4f} ms, "
            f"bound {o_b:.4f} ms ({o_by}), {o_b / o_ms:.1%} of it; grid "
            f"{g_o.blocks} blocks ({g_o})")
        sh_osn.append(dict(spec=spec.name, n=n_o_, d=d_o, k=spec.k, L=L,
                           ms=o_ms, plain_ms=o_plain, library_ms=o_lib,
                           bound_ms=o_b, bound_by=o_by, grid=str(g_o),
                           flipped_bits=n_o + n_ow))
        e_c = max(e_c, e_o, e_ow)
        del cut, xo, ho, ho_t
    kernels["simhash"] = dict(
        name="simhash", route="cuda",
        source="src/repro_torch/kernels/csrc/simhash.cu",
        replaces="src/repro/kernels/simhash.py:85",
        max_abs_err=max(e_q, e_w, e_c), ms=sh_ms, plain_ms=sh_plain,
        bound_ms=b_ms, bound_by=b_by, library_ms=sh_lib, words_ms=shw_ms,
        corpus_ms=shc_ms, corpus_plain_ms=shc_plain, corpus_bound_ms=bc_ms,
        corpus_library_ms=shc_lib, host_us=sh_host,
        grid_host_us=sh_grid_host, osn_widths=sh_osn)

    # fused_query / fused_contains on the main path's rows
    plan, flat = rt_mod._flat_plan(cfg, rt_mod.LOCAL, q, h)
    fb, pword = rt_mod._fused_probe_rows(cfg, NB, flat["table"],
                                         flat["local"], flat["mask"])
    r, P = fb.shape
    ids_flat = store.ids.reshape(L * NB, C)
    pay_flat = store.payload.reshape(L * NB, C, D)
    words_flat = store_h.payload.reshape(L * NB, C, -1)
    W = words_flat.shape[-1]
    q_rows = q[flat["qidx"]].contiguous()
    w_rows = packed_mod.pack_codes(plan.codes, K)[flat["qidx"]].contiguous()
    meta = torch.stack([pword, torch.full_like(pword, -1)], dim=1)
    tgt_meta = torch.stack([pword, qids[0][flat["qidx"]].to(torch.int32)],
                           dim=1)
    pvalid = ((pword[:, None] >> torch.arange(P, device=dev)) & 1) > 0
    n_probe_rows = int(pvalid.sum())
    # the bounds read each input once: the distinct bucket rows the valid
    # probes name (rows repeat across queries), and their live slots
    rows_read = torch.unique(fb[pvalid].long())
    n_rows_read = rows_read.numel()
    n_live = int(occ.reshape(-1)[rows_read].sum())
    chunk = 512

    def plain_rows(fn, n_rows=r):
        outs = [fn(slice(s, s + chunk)) for s in range(0, n_rows, chunk)]
        return tuple(torch.cat(t) for t in zip(*outs))

    def fused_plain(a, kw):
        """fused_query_plain on the rows of `a`, in row chunks."""
        ids_a, pay_a, q_a, fb_a, meta_a = a
        return plain_rows(lambda s: fq_mod.fused_query_plain(
            ids_a, pay_a, q_a[s], fb_a[s], meta_a[s], **kw), fb_a.shape[0])

    def hold_fused(a, kw, what):
        """Kernel against plain: hamming bit for bit, dot through
        compare_topk.  Returns (max score error, near-tie id swaps)."""
        ki, ks = ops.fused_query(*a, **kw)
        pi, ps = fused_plain(a, kw)
        if kw.get("score", "dot") == "hamming":
            if not (torch.equal(ki, pi) and torch.equal(ks, ps)):
                raise AssertionError(f"{what}: kernel != plain")
            return 0.0, 0
        return compare_topk(ki, ks, pi, ps, what)

    ki, ks = ops.fused_query(ids_flat, pay_flat, q_rows, fb, meta, m=M)
    pi, ps = plain_rows(lambda s: fq_mod.fused_query_plain(
        ids_flat, pay_flat, q_rows[s], fb[s], meta[s], m=M))
    fq_err, fq_ties = compare_topk(ki, ks, pi, ps, "fused_query dot")
    fq_ms = cuda_ms(torch, lambda: ops.fused_query(
        ids_flat, pay_flat, q_rows, fb, meta, m=M), 10)
    # the same call with the score buffer sized by the pair count read
    # back from the card, the path of batches whose r*P-pair buffer would
    # exceed fused_query.SCORE_BUFFER_BYTES
    budget, fq_mod.SCORE_BUFFER_BYTES = fq_mod.SCORE_BUFFER_BYTES, 0
    try:
        ki, ks = ops.fused_query(ids_flat, pay_flat, q_rows, fb, meta, m=M)
        rb_err, rb_ties = compare_topk(ki, ks, pi, ps,
                                       "fused_query dot, read-back")
        fq_err = max(fq_err, rb_err)
        fqr_ms = cuda_ms(torch, lambda: ops.fused_query(
            ids_flat, pay_flat, q_rows, fb, meta, m=M), 10)
    finally:
        fq_mod.SCORE_BUFFER_BYTES = budget
    fq_plain = cuda_ms(torch, lambda: plain_rows(
        lambda s: fq_mod.fused_query_plain(
            ids_flat, pay_flat, q_rows[s], fb[s], meta[s], m=M)), 1)
    fq_bytes = (n_rows_read * C * 4 + n_live * D * 4 + r * D * 4
                + r * (P + 2) * 4 + r * M * 8)
    fq_b, fq_by = bound(fq_bytes, 2.0 * n_live * D)

    ki, ks = ops.fused_query(ids_flat, words_flat, w_rows, fb, meta, m=M,
                             score="hamming")
    pi, ps = plain_rows(lambda s: fq_mod.fused_query_plain(
        ids_flat, words_flat, w_rows[s], fb[s], meta[s], m=M,
        score="hamming"))
    if not (torch.equal(ki, pi) and torch.equal(ks, ps)):
        raise AssertionError("fused_query hamming: kernel != plain")
    fqh_ms = cuda_ms(torch, lambda: ops.fused_query(
        ids_flat, words_flat, w_rows, fb, meta, m=M, score="hamming"), 10)
    fqh_plain = cuda_ms(torch, lambda: plain_rows(
        lambda s: fq_mod.fused_query_plain(
            ids_flat, words_flat, w_rows[s], fb[s], meta[s], m=M,
            score="hamming")), 1)
    fqh_b, _ = bound(n_rows_read * C * 4 + n_live * W * 4 + r * W * 4
                     + r * (P + 2) * 4 + r * M * 8)
    log(f"[kernel] fused_query: r={r} P={P} C={C}; valid probe rows "
        f"{n_probe_rows} over {n_rows_read} distinct bucket rows holding "
        f"{n_live} live slots; dot: max score err "
        f"{fq_err:.3g}, near-tie id swaps {fq_ties}, {fq_ms:.4f} ms "
        f"({fqr_ms:.4f} ms with the pair count read back, near-tie swaps "
        f"{rb_ties}), plain {fq_plain:.4f} ms, bound {fq_b:.4f} ms; "
        f"hamming: exact, "
        f"{fqh_ms:.4f} ms, plain {fqh_plain:.4f} ms, bound {fqh_b:.4f} ms")
    # where a call's device time goes: grouping glue, score, select
    profile_batch(torch, "fused_query dot", lambda: ops.fused_query(
        ids_flat, pay_flat, q_rows, fb, meta, m=M))
    profile_batch(torch, "fused_query hamming", lambda: ops.fused_query(
        ids_flat, words_flat, w_rows, fb, meta, m=M, score="hamming"))
    # the edge cases: a later copy of an id scoring higher (once, and 32
    # times over, which sends the selection to its hash), a row with no
    # valid probe, a bucket probed twice, an exclude id present, exact
    # ties, m above the live count, 40 rows on one bucket
    for score in ("dot", "hamming"):
        edge = edge_case_rows(score, device=dev)
        for m_edge in (1, M, 700):
            e_err, e_ties = hold_fused(edge, dict(m=m_edge, score=score),
                                       f"fused_query {score} edge cases "
                                       f"m={m_edge}")
            fq_err = max(fq_err, e_err)
            log(f"[kernel] fused_query edge cases, {score}, m={m_edge}: "
                f"equal to plain (max score err {e_err:.3g}, near-tie id "
                f"swaps {e_ties})")
    kernels["fused_query"] = dict(
        name="fused_query", route="cuda",
        source="src/repro_torch/kernels/csrc/fused_query.cu",
        replaces="src/repro/kernels/fused_query.py:115",
        max_abs_err=fq_err, ms=fq_ms, plain_ms=fq_plain, bound_ms=fq_b,
        bound_by=fq_by, library_ms=None, read_back_ms=fqr_ms,
        hamming_ms=fqh_ms, hamming_plain_ms=fqh_plain,
        hamming_bound_ms=fqh_b)

    # fused_contains under hit traffic (each row's own query id, which
    # lies in its exact bucket, the first probe, unless evicted) and miss
    # traffic (ids no bucket holds, so every valid probe is read)
    miss_meta = torch.stack([pword, N + torch.arange(
        r, dtype=torch.int32, device=dev)], dim=1)
    fc = {}
    for name, m in (("hit", tgt_meta), ("miss", miss_meta)):
        kh = ops.fused_contains(ids_flat, fb, m)
        ph = fq_mod.fused_contains_plain(ids_flat, fb, m)
        if not torch.equal(kh, ph):
            raise AssertionError(f"fused_contains, {name} traffic: kernel "
                                 f"!= plain")
        fc[name] = (int(kh.sum()),
                    cuda_ms(torch, lambda: ops.fused_contains(ids_flat, fb, m),
                            50),
                    cuda_ms(torch, lambda: fq_mod.fused_contains_plain(
                        ids_flat, fb, m), 10))
    # the bounds read the id rows of the distinct buckets the rows need:
    # under hit traffic, each row's valid probes up to the one that holds
    # its target (the kernel stops there); under miss traffic, all
    holds = (ids_flat[fb.long()] == tgt_meta[:, 1, None, None]).any(-1)
    first = torch.where(holds & pvalid, torch.arange(P, device=dev),
                        P).amin(1, keepdim=True)
    needed = pvalid & (torch.arange(P, device=dev) <= first)
    n_hit_rows = torch.unique(fb[needed].long()).numel()
    meta_bytes = r * (P + 2) * 4 + r
    fc_b, fc_by = bound(n_hit_rows * C * 4 + meta_bytes)
    fcm_b, fcm_by = bound(n_rows_read * C * 4 + meta_bytes)
    # what a grouped design would first spend: the counting sort of the
    # valid pairs by bucket row that fused_query's dot path runs
    fc_group = cuda_ms(torch, lambda: fq_mod.group_pairs_cuda(
        fb, miss_meta, L * NB, split_small=False), 20)
    # miss traffic over the first 4096 bucket rows (8 MB of ids, which
    # stay in L2): the kernel's rate when no read reaches HBM
    fb_l2 = (fb % NB).contiguous()
    fc_l2 = cuda_ms(torch, lambda: ops.fused_contains(ids_flat, fb_l2,
                                                      miss_meta), 50)
    log(f"[kernel] fused_contains: r={r} P={P} C={C}, exact under both "
        f"traffics; hit: {fc['hit'][0]} of {r} rows hit, {fc['hit'][1]:.4f} "
        f"ms, plain {fc['hit'][2]:.4f} ms, bound {fc_b:.4f} ms "
        f"({n_hit_rows} distinct bucket rows up to the hits); miss: "
        f"{fc['miss'][0]} hits, {fc['miss'][1]:.4f} ms, plain "
        f"{fc['miss'][2]:.4f} ms, bound {fcm_b:.4f} ms ({n_rows_read} "
        f"distinct rows; {n_probe_rows} probe rows read at "
        f"{n_probe_rows * C * 4 / fc['miss'][1] / 1e6:.1f} GB/s); miss over "
        f"{NB} L2-resident bucket rows {fc_l2:.4f} ms; the counting sort "
        f"a grouped design would start with {fc_group:.4f} ms")
    kernels["fused_contains"] = dict(
        name="fused_contains", route="cuda",
        source="src/repro_torch/kernels/csrc/fused_query.cu",
        replaces="src/repro/kernels/fused_query.py:195",
        max_abs_err=0.0, ms=fc["hit"][1], plain_ms=fc["hit"][2],
        bound_ms=fc_b, bound_by=fc_by, library_ms=None,
        miss_ms=fc["miss"][1], miss_plain_ms=fc["miss"][2],
        miss_bound_ms=fcm_b, miss_l2_resident_ms=fc_l2,
        grouping_ms=fc_group)
    del holds, fb_l2

    # bucket_topk on the engine's chunks: 32 queries = 32*L (query, table)
    # rows of P*C candidate lanes each, sorted by id with repeats masked
    from repro_torch.core import plan as plan_mod
    from repro_torch.core import scoring

    bq = 32 * L
    errs, ties, bt_t, btp_t, bt_bytes, bt_flops = [], 0, [], [], 0, 0
    for c0 in range(0, 256 * L, bq):
        sel = slice(c0, c0 + bq)
        qc = q_rows[sel]
        probes, pv = plan_mod.shard_local_probes(
            cfg.topo, flat["local"][sel], flat["mask"][sel], include_near=True)
        cand = store.ids[flat["table"][sel].long()[:, None], probes.long()]
        cand = torch.where(pv[..., None], cand, -1).reshape(bq, -1)
        order, ids_s, dup = scoring._sorted_dup_mask(cand)
        vecs = corpus.gather(ids_s)
        valid = (ids_s >= 0) & ~dup

        def plain():  # the wrapper's work on a CPU tensor, on the card
            return bt_mod.bucket_topk_plain(qc, vecs, bt_mod.pack_valid(valid),
                                            M)

        ks, ki = ops.bucket_topk(qc, vecs, valid, M)
        ps, pi = plain()
        e, t = compare_topk(ki, ks, pi, ps, "bucket_topk")
        errs.append(e)
        ties += t
        bt_t.append(cuda_ms(torch, lambda: ops.bucket_topk(qc, vecs, valid, M),
                            5))
        btp_t.append(cuda_ms(torch, plain, 2))
        vwords = bt_mod.pack_valid(valid)
        n_valid = int(valid.sum())
        bt_bytes += n_valid * D * 4 + qc.numel() * 4 + vwords.numel() * 4 \
            + bq * M * 8
        bt_flops += 2.0 * n_valid * D
        kc = vecs.shape[1]
    n_chunks = len(bt_t)
    bt_b, bt_by = bound(bt_bytes / n_chunks, bt_flops / n_chunks)
    log(f"[kernel] bucket_topk: b={bq} rows KC={kc} D={D}; max score err "
        f"{max(errs):.3g}, near-tie id swaps {ties}; mean over {n_chunks} "
        f"chunks {np.mean(bt_t):.4f} ms, plain {np.mean(btp_t):.4f} ms, "
        f"bound {bt_b:.4f} ms")
    # the wrapper's device time by kernel: the pack_valid glue, the part
    # and merge kernels (the last chunk)
    profile_batch(torch, "bucket_topk engine chunk",
                  lambda: ops.bucket_topk(qc, vecs, valid, M))
    g_bt = bt_mod.grid(bq, kc, M, sms)
    log(f"[kernel] bucket_topk grid b={bq} kc={kc} m={M}: {g_bt.parts} parts "
        f"a row of {g_bt.words_per_part} validity words, {g_bt.blocks} blocks "
        f"on {sms} SMs; achieved "
        f"{bt_bytes / n_chunks / np.mean(bt_t) / 1e6:.1f} GB/s of "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s, "
        f"{bt_flops / n_chunks / np.mean(bt_t) / 1e6:.1f} GFLOP/s of "
        f"{FP32_FLOPS_PER_S / 1e12:.0f} TFLOP/s")
    kernels["bucket_topk"] = dict(
        name="bucket_topk", route="cuda",
        source="src/repro_torch/kernels/csrc/bucket_topk.cu",
        replaces="src/repro/kernels/bucket_topk.py:66",
        max_abs_err=max(errs), ms=float(np.mean(bt_t)),
        plain_ms=float(np.mean(btp_t)), bound_ms=bt_b, bound_by=bt_by,
        library_ms=None)
    del vecs, cand, ids_s, valid

    # hamming_words at the CNB cache stage's shape of the 16-node hamming
    # mesh (phase 9): n*n*cap routed rows of node_bits*C packed candidate
    # rows each, gathered from real buckets
    cfg16 = RuntimeConfig(params=params, n_nodes=16, cap_factor=16.0)
    rows_c = 16 * 16 * rt_mod._route_cap(cfg16, NQ // 16)
    kc_c = cfg16.node_bits * C
    pick = torch.from_numpy(rng.integers(
        0, L * NB, size=(rows_c, cfg16.node_bits))).to(dev)
    hq = w_rows.repeat(-(-rows_c // r), 1)[:rows_c].contiguous()
    hc = words_flat[pick].reshape(rows_c, kc_c, W)
    got = ops.hamming(hq, hc)
    if not torch.equal(got, hm_mod.hamming_words_plain(hq, hc)):
        raise AssertionError("hamming_words: kernel != plain")
    hw_ms = cuda_ms(torch, lambda: ops.hamming(hq, hc), 20)
    hw_plain = cuda_ms(torch, lambda: hm_mod.hamming_words_plain(hq, hc), 2)
    hw_b, hw_by = bound(rows_c * kc_c * W * 4 + rows_c * kc_c * 4
                        + rows_c * W * 4)
    log(f"[kernel] hamming_words: n={rows_c} kc={kc_c} W={W}: exact, "
        f"{hw_ms:.4f} ms, plain {hw_plain:.4f} ms, bound {hw_b:.4f} ms")
    kernels["hamming_words"] = dict(
        name="hamming_words", route="cuda",
        source="src/repro_torch/kernels/csrc/hamming.cu",
        replaces="src/repro/kernels/hamming.py:70",
        max_abs_err=0.0, ms=hw_ms, plain_ms=hw_plain, bound_ms=hw_b,
        bound_by=hw_by, library_ms=None)
    del hq, hc, got

    # hamming (one word): each (query, table) row's own table code against
    # the codes of the P*C candidates of its probed buckets
    cand_ids = ids_flat[fb.long()].reshape(r, P * C).clamp(min=0).long()
    sq = plan.codes[flat["qidx"], flat["table"].long()].contiguous()
    sc1 = corpus_codes[cand_ids, flat["table"].long()[:, None]]
    got = ops.hamming(sq, sc1)
    if not torch.equal(got, hm_mod.hamming_plain(sq, sc1)):
        raise AssertionError("hamming: kernel != plain")
    h1_ms = cuda_ms(torch, lambda: ops.hamming(sq, sc1), 20)
    h1_plain = cuda_ms(torch, lambda: hm_mod.hamming_plain(sq, sc1), 5)
    h1_b, h1_by = bound(2 * sc1.numel() * 4 + sq.numel() * 4)
    log(f"[kernel] hamming: n={r} kc={P * C}: exact, {h1_ms:.4f} ms, plain "
        f"{h1_plain:.4f} ms, bound {h1_b:.4f} ms")
    kernels["hamming"] = dict(
        name="hamming", route="cuda",
        source="src/repro_torch/kernels/csrc/hamming.cu",
        replaces="src/repro/kernels/hamming.py:39",
        max_abs_err=0.0, ms=h1_ms, plain_ms=h1_plain, bound_ms=h1_b,
        bound_by=h1_by, library_ms=None)
    del cand_ids, sq, sc1, got

    def recorded_inputs(fn, names):
        """Run `fn` once with the wrappers `names` of `ops` recording the
        arguments of their first call at each shape: {(name, shapes,
        keywords): (args, kwargs)}.  The wrappers are restored before this
        returns."""
        seen = {}
        real = {n: getattr(ops, n) for n in names}

        def recorder(name):
            def call(*a, **kw):
                key = (name, tuple(tuple(t.shape) for t in a
                                   if torch.is_tensor(t)),
                       tuple(sorted(kw.items())))
                seen.setdefault(key, (a, kw))
                return real[name](*a, **kw)
            return call

        for name in real:
            setattr(ops, name, recorder(name))
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            for name, f in real.items():
                setattr(ops, name, f)
        return seen

    def fused_path_bound(name, a, kw):
        """(bound_ms, bound_by) of a fused_query / fused_contains call on
        its recorded inputs, counted as phase 4 counts them: the distinct
        bucket rows the valid probes name (contains: up to each row's
        first hit, where the kernel stops) and their live slots'
        payloads, each read once, plus the rows' metadata and outputs."""
        ids_a, fb_a, meta_a = (a[0], a[3], a[4]) if name == "fused_query" \
            else a
        r_a, p_a = fb_a.shape
        c_a = ids_a.shape[1]
        probe = torch.arange(p_a, device=fb_a.device)
        pv = ((meta_a[:, :1] >> probe) & 1) > 0
        meta_bytes = r_a * (p_a + 2) * 4
        if name == "fused_contains":
            holds = (ids_a[fb_a.long().clamp(0, ids_a.shape[0] - 1)]
                     == meta_a[:, 1, None, None]).any(-1)
            first = torch.where(holds & pv, probe, p_a).amin(1, keepdim=True)
            rows = torch.unique(fb_a[pv & (probe <= first)].long())
            return bound(rows.numel() * c_a * 4 + meta_bytes + r_a)
        rows = torch.unique(fb_a[pv].long())
        live = int((ids_a[rows] >= 0).sum())
        dw = a[1].shape[-1]
        return bound(rows.numel() * c_a * 4 + live * dw * 4 + r_a * dw * 4
                     + meta_bytes + r_a * kw["m"] * 8,
                     2.0 * live * dw if kw.get("score", "dot") == "dot"
                     else 0.0)

    def hold_at_path_shapes(path, fn, names):
        """Hold the kernels behind the wrappers `names` against their plain
        versions on the very inputs the path gives them (one batch of
        `fn`): dot to TIE with near-tie id swaps allowed, hamming and
        contains exactly; fused_query's plain version runs in row
        chunks."""
        for (name, shapes, _), (a, kw) in recorded_inputs(fn, names).items():
            if name == "fused_query":
                err, ties = hold_fused(a, kw, f"fused_query on {path}")
                k_ms = cuda_ms(torch, lambda: ops.fused_query(*a, **kw), 5)
                p_ms = cuda_ms(torch, lambda: fused_plain(a, kw), 1)
                # dot sizes its score buffer for r*P pairs, or by the
                # valid pairs' count read back when that would be too big
                buf = ("read-back" if kw.get("score", "dot") == "dot"
                       and fq_mod.score_buffer_rows(
                           a[3].shape[0], a[3].shape[1], a[0].shape[1])
                       is None else "sized")
                shapes = shapes + ((kw["m"], kw.get("score", "dot"), buf),)
            elif name == "fused_contains":
                if not torch.equal(ops.fused_contains(*a),
                                   fq_mod.fused_contains_plain(*a)):
                    raise AssertionError(f"fused_contains on {path}: kernel "
                                         f"!= plain")
                err, ties = 0.0, 0
                k_ms = cuda_ms(torch, lambda: ops.fused_contains(*a), 5)
                p_ms = cuda_ms(torch, lambda: fq_mod.fused_contains_plain(*a),
                               1)
            elif name == "bucket_topk":
                qa, cand, valid, m = a
                ks, ki = ops.bucket_topk(qa, cand, valid, m)
                ps, pi = bt_mod.bucket_topk_plain(
                    qa, cand, bt_mod.pack_valid(valid), m)
                err, ties = compare_topk(ki, ks, pi, ps,
                                         f"bucket_topk on {path}")
                k_ms = cuda_ms(torch, lambda: ops.bucket_topk(*a), 5)
                p_ms = cuda_ms(torch, lambda: bt_mod.bucket_topk_plain(
                    qa, cand, bt_mod.pack_valid(valid), m), 1)
            else:
                name = "hamming_words" if a[1].dim() == 3 else "hamming"
                plain = (hm_mod.hamming_words_plain if name == "hamming_words"
                         else hm_mod.hamming_plain)
                if not torch.equal(ops.hamming(*a), plain(*a)):
                    raise AssertionError(f"{name} on {path}: kernel != plain")
                err, ties = 0.0, 0
                k_ms = cuda_ms(torch, lambda: ops.hamming(*a), 5)
                p_ms = cuda_ms(torch, lambda: plain(*a), 1)
            b_ms, b_by = (fused_path_bound(name, a, kw) if name in (
                "fused_query", "fused_contains") else (None, None))
            k = kernels[name]
            k["max_abs_err"] = max(k["max_abs_err"], err)
            k.setdefault("path_shapes", []).append(dict(
                path=path, shapes=[list(s) for s in shapes],
                max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by))
            log(f"[kernel] {name} at {path} {list(shapes)}: equal to plain "
                f"(max score err {err:.3g}, near-tie id swaps {ties}); "
                f"{k_ms:.4f} ms, plain {p_ms:.4f} ms"
                + ("" if b_ms is None else f", bound {b_ms:.4f} ms ({b_by})"))

    # -- 5-9. the main path's paths, each with launch counts of its own -----
    by_path = {}
    expected = set()

    def counted(path, expect, fn):
        """Run `fn` with every launch count set to 0 just before and read
        just after; fail if a kernel of `expect` was not launched."""
        expected.update(expect)
        ops.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = dict(ops.LAUNCHES)
        missing = [n for n in expect if got[n] == 0]
        if missing:
            raise AssertionError(f"{path}: kernels never launched: {missing}")
        by_path[path] = got
        log(f"[launches] {path}: {got}")
        return out

    # -- 5. runtime search --------------------------------------------------
    n_rec = 64
    _, exact_i = exact_topk_dense(corpus, x[qids[0][:n_rec]], M)
    def timed_batches(rt, st, nq=NQ, **kw):
        """One warm-up batch, then `--batches` timed ones: ([(ids, scores,
        stats)], host ms per batch)."""
        rt.search(h, st, x[qids[0][:nq]], **kw)
        torch.cuda.synchronize()
        with gc_paused():
            t0 = time.perf_counter()
            outs = [rt.search(h, st, x[qids[b][:nq]], **kw)
                    for b in range(args.batches)]
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / args.batches
        return outs, ms

    def timed_contains(rt, st, nq=NQ, **kw):
        """Host ms per contains batch of each query's own id: one warm-up
        batch, then `--batches` timed ones."""
        rt.contains(h, st, x[qids[0][:nq]], qids[0][:nq], **kw)
        torch.cuda.synchronize()
        with gc_paused():
            t0 = time.perf_counter()
            for b in range(args.batches):
                rt.contains(h, st, x[qids[b][:nq]], qids[b][:nq], **kw)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / args.batches

    one_node = {}  # (score, variant) -> (ids, scores) of batch 0
    cells = [("lsh", {}), ("nb", {}), ("cnb", {}),
             ("cnb", dict(num_probes=4, ranked_probes=True))]
    for score in ("dot", "hamming"):
        st = store if score == "dot" else store_h
        for variant, pkw in cells:
            rt = IndexRuntime(RuntimeConfig(
                params=params, variant=variant, m=M, use_kernels=True,
                score=score, **pkw), device=dev)
            name = variant + ("" if not pkw else "-p4ranked")
            outs, ms = counted(f"search {score} {name}",
                               ("simhash", "fused_query"),
                               lambda: timed_batches(rt, st))
            hold_at_path_shapes(f"search {score} {name}", lambda: rt.search(
                h, st, x[qids[0]]), ("fused_query",))
            if not pkw:
                one_node[(score, variant)] = outs[0][:2]
            ids0 = outs[0][0]
            for o_i, o_s, _ in outs:
                if o_i.shape != (NQ, M) or not bool(
                        torch.isfinite(o_s[:, 0]).all()):
                    raise AssertionError(f"{score}/{variant}: bad results")
            self_hit = float(torch.cat([
                (o[0][:, 0] == qids[b]).float() for b, o in enumerate(outs)
            ]).mean())
            got = ids0[:n_rec].cpu().numpy()
            want = exact_i.cpu().numpy()
            recall = np.mean([len(set(got[i]) & set(want[i])) / M
                              for i in range(n_rec)])
            log(f"[search] {score:7s} {name:12s}: {ms:.3f} ms per batch of "
                f"{NQ}, {NQ / ms * 1e3:.0f} queries/s, self-hit@1 "
                f"{self_hit:.4f}, recall@10 {recall:.4f} ({n_rec} queries)")

    # -- 5b. the staged hamming cell: the hamming_words kernel scores -------
    rt = IndexRuntime(RuntimeConfig(
        params=params, variant="cnb", m=M, use_kernels=True, score="hamming",
        fused="off"), device=dev)
    outs, ms = counted("search hamming cnb staged",
                       ("simhash", "hamming_words"),
                       lambda: timed_batches(rt, store_h))
    hold_at_path_shapes("search hamming cnb staged", lambda: rt.search(
        h, store_h, x[qids[0]]), ("hamming",))
    f_ids, f_sc = one_node[("hamming", "cnb")]
    if not (torch.equal(outs[0][0], f_ids) and torch.equal(outs[0][1], f_sc)):
        raise AssertionError("staged hamming cnb != fused hamming cnb")
    log(f"[search] hamming cnb staged : {ms:.3f} ms per batch of {NQ}, "
        f"{NQ / ms * 1e3:.0f} queries/s; ids and scores equal the fused "
        f"cell's exactly")

    # -- 6. contains --------------------------------------------------------
    rt = IndexRuntime(RuntimeConfig(params=params, variant="cnb", m=M,
                                    use_kernels=True), device=dev)
    staged = IndexRuntime(RuntimeConfig(params=params, variant="cnb", m=M,
                                        fused="off"), device=dev)
    hits, _ = counted("contains", ("simhash", "fused_contains"),
                      lambda: rt.contains(h, store, q, qids[0]))
    want, _ = staged.contains(h, store, q, qids[0])
    if not torch.equal(hits, want):
        raise AssertionError("contains: fused kernel != staged plain path")
    ms = timed_contains(rt, store)
    log(f"[contains] {int(hits.sum())} of {NQ} queries find their own id; "
        f"equal to the staged path; {ms:.3f} ms per batch of {NQ}, "
        f"{NQ / ms * 1e3:.0f} contains/s")

    # -- 7. engine ----------------------------------------------------------
    eng = LshEngine(params, h, ids_only, corpus, None,
                    EngineConfig(variant="cnb", use_kernels=True), device=dev)
    torch.cuda.synchronize()
    with gc_paused():
        t0 = time.perf_counter()
        res = counted("engine search", ("simhash", "bucket_topk"),
                      lambda: eng.search(q[:256], m=M))
        ms = (time.perf_counter() - t0) * 1e3
    rt_ids, rt_sc, _ = rt.search(h, store, q[:256])
    e_err, e_ties = compare_topk(
        torch.from_numpy(res.ids), torch.from_numpy(res.scores),
        rt_ids, rt_sc, "engine vs runtime payload path")
    e_hits = counted("engine contains", ("simhash", "fused_contains"),
                     lambda: eng.contains(q[:256],
                                          qids[0][:256].cpu().numpy()))
    if not np.array_equal(e_hits, hits[:256].cpu().numpy()):
        raise AssertionError("engine contains != runtime contains")
    log(f"[engine] 256 queries in {ms:.1f} ms; ids equal to the runtime "
        f"payload path (near-tie swaps {e_ties}, max score err "
        f"{e_err:.3g}); contains equal")

    # -- 8. churn -----------------------------------------------------------
    n_re = min(16384, N)
    re_ids = torch.from_numpy(
        rng.choice(N, size=n_re, replace=False).astype(np.int64)).to(dev)
    noise = torch.from_numpy(
        rng.standard_normal((len(re_ids), D), dtype=np.float32)).to(dev)
    moved = x[re_ids] + 0.3 * noise
    moved /= torch.linalg.vector_norm(moved, dim=1, keepdim=True)
    gen0 = int(store.generation)

    def churn():
        st1 = rt.insert(h, store, moved, re_ids.to(torch.int32), 1)
        st2 = rt.expire(st1, now=1, ttl=0)
        return st1, st2, rt.search(h, st2, moved[:NQ])[:2]

    st1, st2, (ids_c, sc_c) = counted(
        "churn", ("simhash", "fused_query"), churn)
    if int(st1.generation) != gen0 + L or int(st2.generation) != gen0 + L + 1:
        raise AssertionError(
            f"churn: generation {gen0} -> {int(st1.generation)} -> "
            f"{int(st2.generation)}, expected +{L} then +1")
    if int((st2.ids >= 0).sum()) > L * len(re_ids):
        raise AssertionError("churn: expire left entries older than the TTL")
    churn_hit = float((ids_c[:, 0] == re_ids[:NQ]).float().mean())
    log(f"[churn] insert {len(re_ids)} re-announces + expire(ttl=0): "
        f"generation {gen0} -> {int(st1.generation)} -> "
        f"{int(st2.generation)}; {int((st2.ids >= 0).sum())} live slots; "
        f"self-hit@1 of moved vectors {churn_hit:.4f}")
    del st1, st2

    # -- 9. the mesh: n CAN nodes on this one card -------------------------
    from repro_torch.core import distributed as dist_mod
    from repro_torch.launch.mesh import make_zone_mesh

    def mesh_runtime(n, score, variant, **kw):
        kw.setdefault("cap_factor", float(n))
        return IndexRuntime(RuntimeConfig(
            params=params, variant=variant, m=M, n_nodes=n, use_kernels=True,
            score=score, **kw), mesh=make_zone_mesh(n, device=dev))

    def refreshed(n, score, st):
        """The CNB cache of an n-node mesh, with the refresh's time."""
        rt = mesh_runtime(n, score, "cnb")
        st = rt.shard_store(st)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache = rt.refresh_cache(st)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        moved = sum(c.numel() * c.element_size() for c in cache)
        per_node = dist_mod.estimate_refresh_bytes(rt.cfg, C, D)
        log(f"[mesh] refresh_cache n={n} {score}: {ms:.3f} ms, {moved} "
            f"bytes written on the card; wire model {per_node} bytes per "
            f"node, {per_node * n} in all")
        return st, cache

    def mesh_cell(n, score, variant, st, cache, nq, expect, **kw):
        rt = mesh_runtime(n, score, variant, **kw)
        c = cache if variant == "cnb" else None
        path = (f"mesh n={n} {score} {variant} {rt.cfg.routing} "
                f"cap_factor={rt.cfg.cap_factor:g}")
        outs, ms = counted(path, expect,
                           lambda: timed_batches(rt, st, nq, cache=c))
        stats = outs[0][2].host()
        wire = dist_mod.estimate_query_bytes(rt.cfg, nq, D, rt.n_devices)
        hold_at_path_shapes(path, lambda: rt.search(
            h, st, x[qids[0][:nq]], cache=c),
            ("bucket_topk", "hamming", "fused_query"))
        profile_batch(torch, path, lambda: rt.search(
            h, st, x[qids[0][:nq]], cache=c))
        log(f"[cell] {path}: {ms:.3f} ms per batch of {nq}, "
            f"{nq / ms * 1e3:.0f} queries/s; probes_routed "
            f"{stats['probes_routed']}, nodes_contacted "
            f"{stats['nodes_contacted']}, dropped {stats['dropped_probes']}; "
            f"wire bytes {wire['total']} (query {wire['query_routing']}, "
            f"results {wire['results']}, neighbor {wire['neighbor']})")
        return outs[0], stats

    st16, cache16 = refreshed(16, "hamming", store_h)
    for variant, routing in (("lsh", "alltoall"), ("nb", "alltoall"),
                             ("cnb", "alltoall"), ("cnb", "allgather")):
        expect = ("fused_query",) + (() if variant == "lsh"
                                     else ("hamming_words",))
        (ids_m, sc_m, _), stats = mesh_cell(
            16, "hamming", variant, st16, cache16, NQ, expect,
            routing=routing)
        want_i, want_s = one_node[("hamming", variant)]
        if stats["dropped_probes"] != 0:
            raise AssertionError(f"mesh {variant} {routing}: probes dropped")
        if not (torch.equal(ids_m, want_i) and torch.equal(sc_m, want_s)):
            raise AssertionError(f"mesh n=16 hamming {variant} {routing}: "
                                 f"results differ from the 1-node runtime's")
    mesh_cell(16, "hamming", "cnb", st16, cache16, NQ,
              ("fused_query", "hamming_words"), cap_factor=2.0)
    for variant in ("cnb", "nb"):
        rt = mesh_runtime(16, "hamming", variant)
        c = cache16 if variant == "cnb" else None
        got_h, cstats = counted(
            f"mesh n=16 contains {variant}", ("fused_contains",),
            lambda: rt.contains(h, st16, q, qids[0], cache=c))
        if int(cstats) != 0 or not torch.equal(got_h, hits):
            raise AssertionError(f"mesh contains {variant} != 1-node")
        ms = timed_contains(rt, st16, cache=c)
        log(f"[cell] mesh n=16 contains {variant}: {ms:.3f} ms per batch of "
            f"{NQ}, {NQ / ms * 1e3:.0f} contains/s")
    log("[mesh] n=16 hamming lsh/nb/cnb (alltoall) and cnb (allgather): "
        "ids and scores equal the 1-node runtime's exactly, 0 dropped; "
        "contains nb/cnb equal the 1-node contains")
    del cache16

    n_dot = 256
    st4, cache4 = refreshed(4, "dot", store)
    for variant in ("cnb", "nb"):
        (ids_m, sc_m, _), stats = mesh_cell(
            4, "dot", variant, st4, cache4, n_dot,
            ("fused_query", "bucket_topk"))
        want_i, want_s = one_node[("dot", variant)]
        err, ties = compare_topk(ids_m, sc_m, want_i[:n_dot],
                                 want_s[:n_dot], f"mesh n=4 dot {variant}")
        if stats["dropped_probes"] != 0:
            raise AssertionError(f"mesh n=4 dot {variant}: probes dropped")
        log(f"[mesh] n=4 dot {variant}: ids equal the 1-node runtime's "
            f"(near-tie swaps {ties}, max score err {err:.3g})")
    del cache4

    # -- 10. the paper's workload: LIVEJOURNAL_S, sparse interest vectors --
    from repro_torch.core import analysis, metrics
    from repro_torch.core.can import paper_topology
    from repro_torch.core.corpus import SparseCorpus, exact_topk_sparse
    from repro_torch.core.hashing import sketch_codes, sketch_codes_batched

    spec = osn.LIVEJOURNAL_S
    t0 = time.time()
    lj = osn.generate(spec, device=dev)
    gen_s = time.time() - t0
    lj_params = LshParams(d=spec.num_interests, k=spec.k, L=4, seed=13)
    lj_h = make_hyperplanes(lj_params, device=dev)
    d_lj, k_lj, L_lj, SK, CAP_LJ = spec.num_interests, spec.k, 4, 8192, 256
    # the corpus sketch: densified SK rows at a time, through the kernel
    torch.cuda.synchronize()
    with gc_paused():
        t0 = time.perf_counter()
        lj_codes = counted("paper sketch", ("simhash",),
                           lambda: sketch_codes_batched(lj, lj_h, batch=SK))
        sketch_wall = (time.perf_counter() - t0) * 1e3
    n_f, e_f, sk_ms, sk_plain, sk_lib = 0, 0.0, 0.0, 0.0, 0.0
    lj_h_t = lj_h.reshape(-1, d_lj).T.contiguous()
    for s0 in range(0, lj.n, SK):  # every chunk's codes against plain
        xs = lj.densify(torch.arange(s0, min(s0 + SK, lj.n), device=dev))
        a, b = simhash_check(xs, False, got=lj_codes[s0:s0 + SK], hh=lj_h)
        n_f, e_f = n_f + a, max(e_f, b)
        sk_ms += cuda_ms(torch, lambda: ops.simhash(xs, lj_h), 3)
        sk_plain += cuda_ms(torch, lambda: sh_mod.simhash_plain(xs, lj_h), 1)
        sk_lib += cuda_ms(torch, lambda: torch.matmul(xs, lj_h_t), 3)
    del xs
    lk_lj = L_lj * k_lj
    sk_b, sk_by = bound(lj.n * d_lj * 4 + lk_lj * d_lj * 4 + lj.n * L_lj * 4,
                        2.0 * lj.n * d_lj * lk_lj)
    g_sk = sh_mod.grid(SK, d_lj, k_lj, L_lj, False, sms)
    log(f"[paper] {spec.name}: {lj.n} users, d={d_lj}, nnz_max "
        f"{lj.nnz_ids.shape[1]}, generated in {gen_s:.1f} s; sketch k={k_lj} "
        f"L={L_lj} in chunks of {SK} densified rows: {sketch_wall:.1f} ms "
        f"wall; kernel {sk_ms:.4f} ms over {-(-lj.n // SK)} launches, plain "
        f"{sk_plain:.4f} ms, matmul {sk_lib:.4f} ms, bound {sk_b:.4f} ms "
        f"({sk_by}), {sk_b / sk_ms:.1%} of it; grid {g_sk.blocks} blocks "
        f"({g_sk}); flipped bits within the 1e-5 band {n_f} (max |proj| "
        f"{e_f:.3g})")
    kernels["simhash"].update(
        paper_sketch_ms=sk_ms, paper_sketch_plain_ms=sk_plain,
        paper_sketch_library_ms=sk_lib, paper_sketch_bound_ms=sk_b,
        paper_sketch_bound_by=sk_by, paper_sketch_grid=str(g_sk),
        paper_sketch_wall_ms=sketch_wall)
    kernels["simhash"]["max_abs_err"] = max(kernels["simhash"]["max_abs_err"],
                                            e_f)
    lj_store = build_store_host(lj_codes, lj_params.num_buckets, CAP_LJ,
                                device=dev)
    occ_lj = lj_store.occupancy().float()

    # the queries (benchmarks/common.py): rng seed 4, unit dense rows;
    # the ideal top-10 of each without itself, from the sparse oracle
    qidx_lj = np.random.default_rng(4).choice(lj.n, NQ, replace=False)
    qd = lj.densify(torch.from_numpy(qidx_lj).to(dev))
    qd /= torch.linalg.vector_norm(qd, dim=1, keepdim=True).clamp(min=1e-12)
    t0 = time.perf_counter()
    ideal_s = np.empty((NQ, M), np.float32)
    ideal_i = np.empty((NQ, M), np.int32)
    for s0 in range(0, NQ, 256):
        o_s, o_i = exact_topk_sparse(lj, qd[s0:s0 + 256], M + 1)
        o_s, o_i = o_s.cpu().numpy(), o_i.cpu().numpy()
        for j in range(o_s.shape[0]):
            keep = o_i[j] != qidx_lj[s0 + j]
            ideal_s[s0 + j] = o_s[j][keep][:M]
            ideal_i[s0 + j] = o_i[j][keep][:M]
    oracle_ms = (time.perf_counter() - t0) * 1e3
    log(f"[paper] store C={CAP_LJ}: occupancy mean {float(occ_lj.mean()):.1f} "
        f"max {int(occ_lj.max())}; {NQ} queries, oracle top-{M} in "
        f"{oracle_ms:.1f} ms")

    topo_lj = paper_topology(k_lj)
    quality = {}
    for variant in ("lsh", "layered", "nb", "cnb"):
        eng = LshEngine(lj_params, lj_h, lj_store, lj, topo_lj,
                        EngineConfig(variant=variant), device=dev)
        res = counted(f"paper search {variant}", (),
                      lambda: eng.search(qd, m=M, exclude=qidx_lj))
        with gc_paused():
            t0 = time.perf_counter()
            for _ in range(args.batches):
                eng.search(qd, m=M, exclude=qidx_lj)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / args.batches
        if variant in ("lsh", "cnb"):  # device time by kernel, busy share
            profile_batch(torch, f"paper search {variant}",
                          lambda: eng.search(qd, m=M, exclude=qidx_lj))
        if res.ids.shape != (NQ, M) or not np.isfinite(res.scores[:, 0]).all():
            raise AssertionError(f"paper search {variant}: bad results")
        quality[variant] = dict(
            recall=metrics.recall_at_m(res.ids, ideal_i),
            ncs=metrics.ncs_at_m(res.scores, ideal_s),
            messages=res.cost.messages, ms=ms, res=res)
        log(f"[paper] {variant:8s}: recall@10 {quality[variant]['recall']:.4f}"
            f" NCS@10 {quality[variant]['ncs']:.4f} messages "
            f"{res.cost.messages:g}; {ms:.3f} ms per batch of {NQ} (staged "
            f"sparse scoring), {NQ / ms * 1e3:.0f} queries/s")
    lsh_q, cnb_q = quality["lsh"], quality["cnb"]
    if not (cnb_q["messages"] == lsh_q["messages"]
            and cnb_q["recall"] > lsh_q["recall"]
            and cnb_q["ncs"] >= lsh_q["ncs"] - 1e-9):
        raise AssertionError(f"paper claim fails: cnb {cnb_q} lsh {lsh_q}")
    log(f"[paper] cnb over lsh at equal messages ({cnb_q['messages']:g}): "
        f"recall {cnb_q['recall'] / lsh_q['recall'] - 1:+.1%}, NCS "
        f"{cnb_q['ncs'] / lsh_q['ncs'] - 1:+.1%}")

    # Fig. 4: is each query's top non-self neighbour in a searched bucket?
    y, y_sim = ideal_i[:, 0], ideal_s[:, 0]
    s_ang = analysis.angular_from_cosine(np.clip(y_sim, 0, 1))
    fig4 = {}
    for variant, spf in (("lsh", analysis.sp_lsh),
                         ("nb", analysis.sp_nearbucket)):
        eng = LshEngine(lj_params, lj_h, lj_store, lj, topo_lj,
                        EngineConfig(variant=variant), device=dev)
        found = counted(f"paper contains {variant}", ("fused_contains",),
                        lambda: eng.contains(qd, y))
        hold_at_path_shapes(f"paper contains {variant}",
                            lambda: eng.contains(qd, y), ("fused_contains",))
        with gc_paused():
            t0 = time.perf_counter()
            for _ in range(args.batches):
                eng.contains(qd, y)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / args.batches
        profile_batch(torch, f"paper contains {variant}",
                      lambda: eng.contains(qd, y))
        centers, frac, counts = metrics.success_probability_by_interval(
            found, y_sim)
        gap = abs(float(found.mean()) - float(spf(s_ang, k_lj, L_lj).mean()))
        fig4[variant] = (frac, spf(analysis.angular_from_cosine(centers),
                                   k_lj, L_lj), gap)
        log(f"[paper] contains {variant}: success {float(found.mean()):.4f}, "
            f"analysis {float(spf(s_ang, k_lj, L_lj).mean()):.4f}, gap "
            f"{gap:.4f}; {ms:.3f} ms per batch of {NQ}, "
            f"{NQ / ms * 1e3:.0f} contains/s")
        if gap > 0.15:
            raise AssertionError(f"Fig. 4 {variant}: mean gap {gap} > 0.15")
    log("[paper] Fig. 4 by cosine interval: center, pairs, lsh observed / "
        "sp_lsh, nb observed / sp_nearbucket")
    for b, c in enumerate(centers):
        log(f"[paper]   {c:.2f} {int(counts[b]):5d}  "
            f"{fig4['lsh'][0][b]:.4f} / {fig4['lsh'][1][b]:.4f}  "
            f"{fig4['nb'][0][b]:.4f} / {fig4['nb'][1][b]:.4f}")

    # the card's cnb search against the port's own CPU run on 64 queries:
    # the query codes first, so that a flip shows as a flip
    n_cpu = 64
    lj_cpu = SparseCorpus(lj.nnz_ids.cpu(), lj.nnz_vals.cpu(), d_lj)
    store_cpu = build_store_host(lj_codes, lj_params.num_buckets, CAP_LJ,
                                 device="cpu")
    q_cpu, h_cpu = qd[:n_cpu].cpu(), lj_h.cpu()
    qc_card = sketch_codes(qd[:n_cpu], lj_h).cpu()
    same = (qc_card == sketch_codes(q_cpu, h_cpu)).all(dim=1).numpy()
    simhash_check(q_cpu, False, got=qc_card, hh=h_cpu)  # flips in the band
    cpu_res = LshEngine(lj_params, h_cpu, store_cpu, lj_cpu, topo_lj,
                        EngineConfig(variant="cnb"), device="cpu").search(
        q_cpu, m=M, exclude=qidx_lj[:n_cpu])
    card_res = cnb_q["res"]
    c_err, c_ties = compare_topk(
        torch.from_numpy(card_res.ids[:n_cpu][same]),
        torch.from_numpy(card_res.scores[:n_cpu][same]),
        torch.from_numpy(cpu_res.ids[same]),
        torch.from_numpy(cpu_res.scores[same]), "paper cnb card vs CPU",
        tie=1e-6)
    log(f"[paper] cnb on the card vs the port on the CPU, {n_cpu} queries: "
        f"query codes equal in {int(same.sum())}; ids equal there (near-tie "
        f"swaps {c_ties}, max score err {c_err:.3g})")
    del lj, lj_store, lj_codes, qd, lj_cpu, store_cpu

    # -- 11. P2P dynamics: replicas, kills, reshards, churn -----------------
    # the earlier phases' world leaves the card first
    del (x, corpus_codes, store, store_h, ids_only, corpus, q, ids_flat,
         pay_flat, words_flat, q_rows, w_rows, meta, tgt_meta, miss_meta, fb,
         pword, st16, st4, eng, rt, staged, one_node, outs, res, qc, ids_c,
         sc_c, moved, noise, re_ids, plan, flat, pvalid, rows_read, occ)
    gc.collect()
    torch.cuda.empty_cache()
    p2p_wall = time.perf_counter()
    from repro_torch.core import costmodel
    from repro_torch.core.churn import (
        ChurnConfig, FailureChurnConfig, NodeChurnConfig, run_churn,
        run_failure_churn, run_node_churn)
    from repro_torch.core.hashing import sketch_codes as sketch
    from repro_torch.launch.failure_churn import smoke_gates
    from repro_torch.obs import Observability

    EPOCHS, REFRESH = 8, 2
    ccfg = ChurnConfig(num_users=N, dim=D, k=K, L=L, capacity=C,
                       num_queries=NQ, m=M, epochs=EPOCHS,
                       refresh_every=REFRESH, ttl_epochs=4, update_rate=0.05,
                       churn_rate=0.02, mutation=0.5, seed=args.seed)
    log(f"[p2p] device bytes in use {torch.cuda.memory_allocated()} after "
        f"freeing the earlier world; {ccfg}; cut: epochs 12 -> {EPOCHS} (the "
        f"reference's default), so that six trajectories fit the smoke")

    @contextlib.contextmanager
    def uncounted():
        """Launches inside the block (kernel checks, profiles) leave the
        path's launch counts as they were."""
        saved = dict(ops.LAUNCHES)
        try:
            yield
        finally:
            ops.LAUNCHES.update(saved)

    def inspect_at(path, epoch, keep=None):
        """An `on_read` hook: at read epoch `epoch`, hold fused_query
        against plain on the inputs of one search batch of the live state
        and profile one batch (outside the path's launch counts); `keep`
        gets the state."""
        def hook(st):
            if st.epoch != epoch:
                return
            kw = {} if st.replicas is None else dict(replicas=st.replicas,
                                                     live=st.live)

            def batch():
                return st.rt.search(st.hyperplanes, st.store, st.queries,
                                    cache=st.cache, **kw)

            with uncounted():
                hold_at_path_shapes(f"{path} epoch {epoch}", batch,
                                    ("fused_query",))
                rows, wall = profile_batch(torch, f"{path} epoch {epoch}",
                                           batch)
            fq_ms = sum(r[0] for r in rows if "fq_" in r[2])
            busy = sum(r[0] for r in rows)
            # the primary + replica view the owner stage builds on every
            # replicated read (ids and payload), timed alone
            cat_ms = 0.0 if st.replicas is None else cuda_ms(
                torch, lambda: rt_mod._flat_view(
                    st.store.ids, st.store.payload, *st.replicas), 3)
            log(f"[p2p] {path} epoch {epoch} ({st.rt.cfg.n_nodes} nodes, "
                f"live {st.live.tolist()}): one batch {busy:.3f} device ms "
                f"of {wall:.3f} wall (busy share {busy / wall:.3f}); "
                f"fused_query kernels {fq_ms:.3f} ms; the replica view's "
                f"concat alone {cat_ms:.3f} ms")
            if keep is not None:
                keep(st)
        return hook

    def report(path, out):
        """Per-epoch recall, staleness, nodes, byte charges, drops; ms per
        announce epoch and per read epoch."""
        log(f"[p2p] {path}: epoch recall stale nodes live repl_B recov_B "
            f"handoff_B refresh_B dropped")
        for i in range(len(out["recalls"])):
            log(f"[p2p]   {i + 1} {out['recalls'][i]:.4f} "
                f"{out['staleness'][i]} {out['n_nodes'][i]} "
                f"{out['live_nodes'][i]} {out['replication_bytes'][i]} "
                f"{out['recovery_bytes'][i]} {out['handoff_bytes'][i]} "
                f"{out['refresh_bytes'][i]} {out['dropped_probes'][i]}")
        ep = out["epoch_ms"]
        ann = np.arange(len(ep)) % REFRESH == 0
        log(f"[p2p] {path}: mean recall {out['mean_recall']:.4f}; totals "
            f"replication {out['total_replication_bytes']} recovery "
            f"{out['total_recovery_bytes']} handoff "
            f"{out['total_handoff_bytes']} refresh "
            f"{out['total_refresh_bytes']} bytes, dropped "
            f"{int(out['dropped_probes'].sum())}; ms per announce epoch "
            f"{ep[ann].mean():.1f} (epoch 0 {ep[0]:.1f}), per read epoch "
            f"{ep[~ann].mean():.1f}; store generation "
            f"{out['store_generation']}")
        if int(out["dropped_probes"].sum()) != 0:
            raise AssertionError(f"{path}: probes dropped")

    # cell 1: the reference trajectory, one node
    one = counted("churn_1node", ("fused_query",), lambda: run_churn(
        ccfg, device=dev, on_read=inspect_at("churn_1node", 1)))
    report("churn_1node", one)

    # cell 2: node churn 1 -> 2 -> 4 -> 2 -> 1, against cell 1
    sched = (1, 2, 4, 2, 1)
    node = counted("node_churn", ("fused_query",), lambda: run_node_churn(
        NodeChurnConfig(churn=ccfg, schedule=sched), device=dev,
        on_read=inspect_at("node_churn", 2)))
    report("node_churn", node)
    gap = float(np.abs(node["recalls"] - one["recalls"]).max())
    log(f"[p2p] node_churn schedule {sched}: largest recall difference to "
        f"the 1-node trajectory {gap:.4f} (bound 0.02); "
        f"{len(node['reshard_events'])} rounds")
    if gap > 0.02:
        raise AssertionError(f"node churn recall gap {gap} > 0.02")
    for ev in node["reshard_events"]:
        want = costmodel.estimate_handoff_bytes(L, NB, C, D, ev.old_n,
                                                ev.new_n)
        log(f"[p2p]   reshard {ev.old_n} -> {ev.new_n}: moved "
            f"{ev.moved_buckets} bucket rows, handoff {ev.handoff_bytes} "
            f"bytes (closed form {want})")
        if ev.handoff_bytes != want:
            raise AssertionError(f"{ev}: handoff bytes != {want}")

    # cell 3: fail-stop kill of node 1 at epoch 3, 4 nodes, R = 2; the
    # pre-kill (epoch 2) and degraded (epoch 3) states are kept, ids only,
    # for cell 4
    KILL_EPOCH, VICTIM = 3, 1
    kept = {}

    def keep_ids(mode):
        def keep(st):
            kept[(mode, st.epoch)] = dict(
                rt=st.rt, hp=st.hyperplanes,
                store=BucketStore(st.store.ids, st.store.timestamps,
                                  st.store.write_ptr, None),
                cache=(st.cache[0], None), replicas=(st.replicas[0], None),
                live=st.live, queries=st.queries,
                qidx=torch.from_numpy(st.qidx).to(dev))
        return keep

    for mode in ("first", "quorum"):
        obs = Observability()
        hooks = {KILL_EPOCH - 1: keep_ids(mode),
                 KILL_EPOCH: inspect_at(f"failure_{mode}", KILL_EPOCH,
                                        keep_ids(mode))}
        fail = counted(f"failure_{mode}", ("fused_query",),
                       lambda: run_failure_churn(
                           FailureChurnConfig(churn=ccfg, n_nodes=4,
                                              replication=2, read_mode=mode,
                                              kills=((KILL_EPOCH, VICTIM),)),
                           obs=obs, device=dev,
                           on_read=lambda st: hooks.get(
                               st.epoch, lambda _: None)(st)))
        report(f"failure_{mode}", fail)
        smoke_gates(fail, obs.flight, L, N, D, 2, NB // 4, C, REFRESH,
                    EPOCHS, 1)
        ref_ms = fail["reference_epoch_ms"]
        log(f"[p2p] failure_{mode}: reference recalls "
            f"{np.round(fail['reference_recalls'], 4).tolist()}; degraded "
            f"gap {fail['degraded_gap']:.4f} (bound 0.05), recovered gap "
            f"{fail['recovered_gap']:.4f} (bound 0.02), recovery epochs "
            f"{fail['recovery_epochs']}; flight epoch records sum to the "
            f"arrays exactly; reference run ms per epoch "
            f"{ref_ms[1:].mean():.1f}")

    # cell 4: replicated contains on the killed mesh, each query's own id
    # the target: ids in the killed zone must hit through the replicas
    def contains_at(mode, epoch):
        """Contains of the degraded epoch's queries (own ids the targets)
        on the state kept at `epoch`: the kill epoch's, or the epoch
        before it (the same store before the kill, every node live)."""
        k, qe = kept[(mode, epoch)], kept[(mode, KILL_EPOCH)]
        return k["rt"].contains(k["hp"], k["store"], qe["queries"],
                                qe["qidx"], cache=k["cache"],
                                replicas=k["replicas"], live=k["live"])

    def contains_cell():
        got = {}
        for mode in ("first", "quorum"):
            contains_at(mode, KILL_EPOCH)  # warm-up
            torch.cuda.synchronize()
            with gc_paused():
                t0 = time.perf_counter()
                for _ in range(args.batches):
                    hits, cstats = contains_at(mode, KILL_EPOCH)
                torch.cuda.synchronize()
                got[mode] = (hits, cstats,
                             (time.perf_counter() - t0) * 1e3 / args.batches)
        return got

    creps = counted("contains_replicated", ("fused_contains",),
                    contains_cell)
    for mode, (hits, cstats, ms) in creps.items():
        k = kept[(mode, KILL_EPOCH)]
        pre = kept[(mode, KILL_EPOCH - 1)]
        # each query's own id in its exact bucket of a table the victim
        # owned, in the announced (pre-kill) store
        codes = sketch(k["queries"], k["hp"]).long()        # [nq, L]
        owner = k["rt"].topology.node_of(codes)
        tables = torch.arange(L, device=dev)[None, :]
        in_bucket = (pre["store"].ids[tables, codes]
                     == k["qidx"][:, None, None]).any(-1)
        zone_q = (in_bucket & (owner == VICTIM)).any(1)
        hits_pre, _ = contains_at(mode, KILL_EPOCH - 1)  # pre-kill, all live
        n_zone = int(zone_q.sum())
        zone_hits = int(hits[zone_q].sum())
        log(f"[p2p] contains_replicated {mode}: {int(hits.sum())} of {NQ} "
            f"queries find their own id with node {VICTIM} dead "
            f"(pre-kill {int(hits_pre.sum())}); {zone_hits} of {n_zone} whose "
            f"id sits in the killed zone; replica_fanout "
            f"{cstats.host()['replica_fanout']}, dropped {int(cstats)}; "
            f"{ms:.3f} ms per batch of {NQ}, {NQ / ms * 1e3:.0f} contains/s")
        if n_zone == 0 or zone_hits != n_zone or int(cstats) != 0:
            raise AssertionError(f"contains {mode}: ids in the killed zone "
                                 f"missed ({zone_hits} of {n_zone})")
        hold_at_path_shapes(f"contains_replicated {mode}",
                            lambda: contains_at(mode, KILL_EPOCH),
                            ("fused_contains",))
    del kept, creps
    log(f"[p2p] phase 11 in {time.perf_counter() - p2p_wall:.1f} s; peak "
        f"device bytes {torch.cuda.max_memory_allocated()}")

    # -- 12. kernels line ---------------------------------------------------
    for name, k in kernels.items():
        k["launches"] = sum(got[name] for got in by_path.values())
        k["launches_by_path"] = {p: got[name] for p, got in by_path.items()}
    missing = [n for n in expected if kernels[n]["launches"] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    log(f"[kernels] launches in phases 5-11: "
        f"{ {n: k['launches'] for n, k in kernels.items()} }")
    log(smi)
    log(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
