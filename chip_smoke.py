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
  4b. [autotune] (`repro_torch.kernels.autotune`): with the cache pointed
     at an empty scratch file, every grid at phase 4's shapes equals the
     modules' constant grid; a bounded sweep into that file (every
     candidate held against its plain version, each median printed);
     each op's winner timed again against the default, failing where it
     is slower by more than max(5 %, the default's own range); then the
     committed cache's kind and entries, on which every later phase
     launches;
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
     batch, with times.  Then one insert + payload-sync batch of phase
     8's re-announces followed by a search (16 nodes, hamming cnb).
     The process mesh, after those one-process cells: NCCL at world
     size 1 (`init_process_mesh`, a free port, rank 0), `make_zone_mesh`
     then giving this rank's `ProcessZoneMesh`, every exchange through
     the group's collective; the same cells again (the refreshes, the 16
     hamming and 4 dot search cells, contains, the insert chain), each
     equal to its one-process cell exactly (ids, scores, counters, hits,
     cache and store), with ms beside the one-process cell's and a
     profile of one call: a cell that runs a ppermute must show an NCCL
     kernel (`ncclDevKernel_SendRecv`), every other cell NCCL's
     `nccl:<op>` annotations over its one-rank copies (world 1 launches
     no NCCL kernel for those), annotations kept out of device time; their
     launches add into one path, `mesh_procs`, and each kernel they
     launch (fused_query, fused_contains, hamming_words, bucket_topk) is
     held against plain on their recorded inputs; the process group is
     destroyed at the end of the phase;
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
 11b. the P2P dynamics and serving on the process mesh, after the
     serve_lifecycle cells of phase 12 (whose `run_serve_failure` it
     compares with): NCCL at world size 1, as in phase 9, so that every
     mesh the drivers build through `make_zone_mesh` is this rank's
     `ProcessZoneMesh`.  `run_failure_churn` (4 nodes, R = 2, node 1
     killed at epoch 3) in first and quorum reads, the replicated
     contains on its killed mesh in both modes, `run_node_churn` over
     1 -> 2 -> 4 -> 2 -> 1, and `run_serve_failure` through
     `RuntimeBackend` on the process mesh; each equal to its
     one-process cell array by array (recalls, staleness, byte charges,
     drops, flight records, killed-zone hits; for serving the served ids
     and recalls), with ms per announce and per read epoch beside the
     one-process cell's, and a profile of one read batch (NCCL's
     annotations) and one replicate round (`ncclDevKernel_SendRecv`).
     Their launches add into one path, `p2p_procs`, which must launch
     fused_query, fused_contains, and bucket_topk or hamming_words,
     each held against plain on inputs recorded from one read-epoch
     batch (bucket_topk: one serving batch); then, on the same group,
     item 6c (path `serve_procs`):
     `serve_retrieval.run_openloop` on serve_closed's world under the
     controller rank (rank 0 announces every batch, `repro_torch.serve.
     control`), `run_serve_churn` through the threaded writer (recalls
     equal to phase 11's `run_churn`, ids equal to serve_lifecycle's
     writer run), and a threaded writer whose preps run a 4-node cnb
     mesh's insert, expire and cache refresh over the writer's own NCCL
     group while the controller serves; one stage under the controller
     makes no host sync (sync-debug mode "error"); simhash and
     bucket_topk (open loop) and fused_query (writer) held against plain
     on one batch of each backend; after the group is destroyed, each
     recorded event stream replayed in one process gives the served ids
     exactly through the kernels, and up to near ties (scores within
     TIE) through the plain versions on the same stores; ms per batch
     beside the one-process cells'; the process group is destroyed at
     the end of the phase;
 12. serving (`repro_torch.serve`), every cell's launches on one path
     `serve`, each cell with its wall time and peak device memory:
     serve_mesh (in phase 9, on its 16-node hamming cnb mesh: 1024
     queries through the frontend, alltoall, cap_factor 16, m + 1
     headroom, cache on; ids equal the 1-node runtime's with the self id
     excluded, exactly, 0 drops; the host syncs of one mesh stage
     counted); serve_closed (after phase 9: `serve_retrieval.run` over
     `LshEngine(use_kernels=True)` at the dense world's widths, a zipf(1)
     pool of 512 users, 4096 arrivals, 32 a tick, max_batch 64, queue
     256, churn every 50 ticks at 0.02, TTL 4; cache on, then off; the
     CLI's smoke gates, and every sampled served miss equal to
     `LshEngine.search` on the store of its generation); serve_open
     (`run_openloop` at half the measured capacity, 4096 queries, sync
     then depth 4, SLO p99 50 ms: ids bit-identical, no host sync in the
     engine backend's stage under `set_sync_debug_mode("error")`, the
     most batches in flight); serve_lifecycle (after phase 11, on its
     `ChurnConfig`: `run_serve_churn` direct at depth 1 and through the
     writer thread at depth 4, and `run_serve_reshard`, with recalls
     equal to phase 11's `run_churn` exactly; `run_serve_failure`, 4
     nodes, R = 2, node 1 killed at epoch 3, with the reference's
     assertions).  simhash and bucket_topk (closed), fused_query and
     hamming_words (mesh), fused_query and bucket_topk (failure) are
     held against plain on one serving batch's inputs, and one batch of
     each backend is profiled;
 14. the LM serving path (DESIGN.md Sec. 4), after phase 12 with the
     index worlds freed, every cell with its wall time and peak device
     memory: lm_gemma2 (gemma2-2b at full width, bf16 weights, random
     from `--seed`, through `launch.serve.generate`: greedy, batch 8,
     prompt 512, gen 64; prefill ms and the median decode step ms
     beside their bounds, tokens/s, a torch.profiler trace of one
     decode step, and a run of `generate` under
     `set_sync_debug_mode("error")`); lm_gemma2_long (batch 1, prompt
     5120, gen 16: the q-chunked prefill in every layer, the 4096 window
     in the local ones); lm_check (an f32 copy: prefill + teacher-forced
     decode_step logits against `forward` logits, 2 x 512 and 1 x 5120
     prompts with 8 steps each, failing above 1e-3, the bf16 weights'
     difference beside it; the card against the CPU at full width cut
     26 -> 2 layers, forward logits on 2 x 64 tokens, failing above
     1e-3); lm_archs (starcoder2-7b, codeqwen1.5-7b, phi3-medium-14b,
     seamless-m4t-medium with frames [4, 64, 1024], phi-3-vision-4.2b
     with 256 prefix embeds, each at full width, bf16, batch 4, prompt
     64, gen 32, then freed; the f32 teacher-forced check at full width
     cut to 2 layers, failing above 1e-3); lm_embed_index (path `lm`:
     8192 users of 64 tokens in 256 communities sharing a 32-token
     prefix, embedded by gemma2-2b in batches of 256 as mean-pooled
     final hidden states, unit-normalised; `LshParams(d=2304, k=10,
     L=4)`, `build_store_host` at C = 64; `LshEngine(cnb,
     use_kernels=True)` on the first 1024 users, m = 10, own id
     excluded, failing unless the same-community share exceeds 0.6 and
     the ids equal the plain engine's under the near-tie rule;
     `IndexRuntime(use_kernels=True)` dot search likewise against its
     plain path, contains of each query's own id, failing on a miss;
     simhash, bucket_topk, fused_query and fused_contains held against
     plain on the inputs the path recorded); then the recurrent mixers
     and MoE, bf16 weights from `--seed` at the published widths, each
     model freed before the next: lm_xlstm (xlstm-1.3b whole, 48
     blocks: 8 x 512 + 32 through `generate`, printed as lm_gemma2, and
     the sLSTM time loop's host ms a step at the prefill's shape);
     lm_xlstm_long (long_500k: batch 1, a 1024-token prompt, 16 decode
     steps at 524 272-524 287, failing unless their logits equal the
     steps at 1024-1039 and the peak bytes agree within 1 %; the state's
     bytes); lm_embed_index_xlstm (lm_embed_index's recipe on
     xlstm-1.3b: 4096 users in 128 communities, path `lm`; contains
     must find every own id its exact buckets still hold, and the count
     ring-evicted is printed); lm_moe (deepseek-moe-16b whole, 8 x 512 +
     32), lm_hybrid (jamba-v0.1-52b cut 32 -> 8 layers, 4 x 256 + 16,
     and one mamba layer's working set) and lm_llama4
     (llama4-maverick-400b-a17b cut 48 -> 2 layers, 4 x 64 + 16), each
     with its capacities, its dropped (token, expert) pairs a step, and
     the decode step beside two bounds (all expert bytes, and the active
     parameters' bytes); lm_check's teacher-forced gate (<= 1e-3) on each
     of the four archs cut to 2 layers with the MoE layers dropless (the
     cells' own models read beside it, ungated: random weights amplify
     rounding with depth in xLSTM), and xlstm-1.3b / deepseek-moe-16b
     cut to 2 layers on the card against the CPU (forward logits <= 1e-3;
     MoE expert ids equal but where the CPU's k-th and (k+1)-th router
     probabilities lie within 1e-6);
 15. [examples] (path `examples`): `examples/torch_quickstart.py` and
     `examples/torch_retrieval_serve.py` run on the card and on the CPU
     (`run(device=...)`), their printed tables equal up to the near-tie
     rule of tests/torch_parity_rules.py (retrieval_serve's p99 latency
     aside), retrieval_serve's served ids the CPU's up to near ties, its
     simhash and bucket_topk held against plain on the inputs the card's
     run gives them, and quickstart's cnb spends lsh's messages for a
     higher recall@10;
 16. [train] (after phase 15; no kernel of the six is on this path, and
     the phase fails if one launched), every cell with its wall time and
     peak device memory: train_gemma2 (gemma2-2b whole at full width,
     bf16 weights from `--seed`, batch 4 x 4096: configs/shapes.py
     train_4k's sequence, its global batch 256 cut to 4; loss chunk 512,
     remat on, fp32 AdamW at TRAIN_LR, warmup 2; 6 steps through
     `train_step.make_train_step`, each step's ms, tokens/s, xent,
     grad_norm and lr; the fp32 FLOP bound written out term by term and
     the share reached; the optimizer's device and host ms a step; peak
     bytes beside the state's; a 7th step traced with torch.profiler and
     its host syncs counted; fails on a non-finite xent or unless the
     last xent is below the first; then one checkpoint of the fp32
     tree: bytes, save, verify and restore ms, the restored tree equal
     to the saved one); train_gemma2_int8 (2 steps with int8 state,
     its bytes beside fp32's; then its checkpoint, which phase 17
     restores);
     train_check (f32 copies of gemma2-2b, deepseek-moe-16b dropless,
     jamba-v0.1-52b with its period cut to its first two layers, and
     xlstm-1.3b, each at full width cut to 2 layers, batch 2 x 256: one
     step's loss within 1e-4 relative and every gradient leaf within
     1e-3 of its largest magnitude, card against CPU; `apply_updates` on
     the CPU's gradients on both devices, parameters and moments within
     1e-6 relative, jamba aside; gradient accumulation A = 2 against the
     whole batch, cosine > 0.999; `launch.train` 4 steps + a checkpoint
     + `--resume` to 6 against 6 straight steps on the gemma2 cut, bit
     for bit under `torch.use_deterministic_algorithms(True)`: the
     embedding's backward adds with atomics otherwise, and the
     script's top sets `CUBLAS_WORKSPACE_CONFIG` for it);
     train_example (`examples/torch_train_lm.py` on the card at smoke
     size, its resume line);
 17. [train_mesh] (after phase 16, at NCCL world 1: one rank a card;
     no kernel of the six, checked): restore_check (phase 16's int8
     checkpoint restored with `restore(shardings=)` onto the one-rank
     LM mesh equals the saved tree); train_mesh (gemma2-2b whole, bf16,
     4 x 4096, 2 steps of `launch.train.run --mesh-data 1 --mesh-model
     1` through the named device mesh, ZeRO-3 placement and the model
     axis's code (a model group of one rank: every split whole, every
     enter / leave a no-op): step ms (and their distance from phase
     16's, against +-1 %) and peak beside phase 16's, step 0's xent
     equal to phase 16's bit for bit, grad_norm and step 1's xent
     within 1e-5); compress_check
     (`compressed_psum` over that step's 2.61 B gradients equals the
     plain quantize -> dequantize of g + e bit for bit, the error g32 -
     deq; wire bytes against f32's, device ms); pipeline_check (one
     stage, M = 2, on an f32 2-layer cut: within 2e-4 of the plain
     forward, gradient cosine > 0.999); serve_mesh (`launch.serve
     --mesh-data 1 --mesh-model 1`, gemma2-2b whole, 8 x 64 + 8, tokens
     equal the one-device `generate`'s);
 18. [dryrun] (after phase 17 has destroyed its NCCL group: the dry run
     opens a fake process group of its own; no kernel of the six,
     checked): `launch.dryrun.run_cell` on train_gemma2's cell (gemma2-2b
     whole, 4 x 4096, loss chunk 512, remat, fp32 state, mesh (1, 1)),
     stepped on the meta device: its argument bytes equal phase 16's
     bf16 params + fp32 state + batch exactly, its FLOPs are within 0.5 %
     of `train_flops`' total, its peak within 10 % of phase 16's
     measured peak (the signed gap printed); then one production cell,
     gemma2-2b decode_32k as rank 0 of a fake (16, 16) world, its
     record's summary line;
 13. the kernels line.  Each path of phases 5-12, 14 and 15 runs with the
     launch counts set to 0 just before it and read just after (the
     serve cells add into one path), and fails unless each kernel it
     should go through was launched; a kernel's `launches` is the sum
     over the paths, `launches_by_path` the counts of each.  `hamming`
     (single word) is on no path: phase 4 holds it.

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
import copy
import dataclasses
import gc
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import types
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
# phase 16 compares a resumed training run with a straight one under
# torch.use_deterministic_algorithms, which needs cuBLAS's workspace fixed
# before the first product
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12    # H100 SXM fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12   # H100 SXM bf16 dense, tensor cores
TIE = 1e-5                  # dot-score tolerance and near-tie width


def log(*a):
    print(*a, flush=True)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of one call of `fn` over `reps` calls, after one
    warm-up (`repro_torch.kernels.autotune.rep_ms`).  Each call has its
    own event pair, enqueued while the card spins on a ~10 ms sleep
    kernel: the host's launch pace (Python, ctypes, allocation) then
    falls before the start event is reached, and only device time lies
    between the two events."""
    from repro_torch.kernels.autotune import rep_ms

    return float(np.mean(rep_ms(fn, reps)))


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


def profile_batch(torch, path: str, fn, top: int = 10, warmup: int = 0):
    """Trace one call of `fn` with torch.profiler and print the device-side
    rows (kernels and copies, the top `top` by time), their total against
    the host-clock wall time (the busy share), and each row's count.
    With `warmup`, that many calls run under the profiler first (its
    warm-up steps, not recorded) and the next one is traced.

    GPU user-annotation rows (NCCL's `nccl:<op>` among them) span the
    kernels and copies they wrap, so they are left out of the busy time
    and returned apart.  Returns (rows, wall ms, annotation rows)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    sched = (torch.profiler.schedule(wait=0, warmup=warmup, active=1)
             if warmup else None)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=sched) as prof:
        for _ in range(warmup):
            fn()
            torch.cuda.synchronize()
            prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows, spans = [], []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            note = (getattr(e, "is_user_annotation", False)
                    or e.key.startswith("nccl:"))
            (spans if note else rows).append(
                (e.self_device_time_total / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"[profile] {path}: device {busy:.3f} ms of {wall:.3f} ms wall "
        f"(busy share {busy / wall:.3f})")
    for ms, count, key in rows[:top]:
        log(f"[profile]   {ms:9.3f} ms  x{count:<5d} {key[:90]}")
    for ms, count, key in sorted(spans, reverse=True):
        log(f"[profile]   annotation, not device time: {ms:9.3f} ms  "
            f"x{count:<5d} {key[:70]}")
    return rows, wall, spans


def flight_rows(obs) -> list:
    """The flight records of a run, their clock fields left out."""
    return [{k: v for k, v in dataclasses.asdict(r).items()
             if k not in ("t_us", "latency_us", "stage_us")}
            for r in obs.flight.records()]


def same_result(what: str, got: dict, want: dict) -> None:
    """A driver's result equals another's key by key and array by array
    (dtypes too); host times and the serving telemetry's clock-based
    numbers are left out."""
    timed = ("epoch_ms", "reference_epoch_ms", "stats", "p50_us", "p99_us",
             "p50_queue_us", "p99_queue_us", "qps")
    if set(got) != set(want):
        raise AssertionError(f"{what}: keys {sorted(set(got) ^ set(want))}")
    for key, val in want.items():
        if key in timed:
            continue
        mine = got[key]
        if key == "summary":
            mine, val = ({k: v for k, v in d.items() if k not in timed}
                         for d in (mine, val))
        if isinstance(val, np.ndarray):
            same = (isinstance(mine, np.ndarray) and mine.dtype == val.dtype
                    and np.array_equal(mine, val))
        else:
            same = mine == val
        if not same:
            raise AssertionError(f"{what}: {key} differs from the "
                                 f"one-process run: {mine} vs {val}")


@contextlib.contextmanager
def served_ids():
    """The ids of every `RetrievalFrontend.search` inside the block."""
    from repro_torch.serve import RetrievalFrontend

    got, real = [], RetrievalFrontend.search

    def spy(self, *a, **kw):
        res = real(self, *a, **kw)
        got.append(res[0])
        return res

    RetrievalFrontend.search = spy
    try:
        yield got
    finally:
        RetrievalFrontend.search = real


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


# -- 16. [train]: training on one card ---------------------------------------

TRAIN_LR = 1e-4     # train_gemma2's peak learning rate (warmup 2, 6 steps)
TRAIN_SHAPE = (4, 4096, 512)    # train_gemma2's batch, sequence, loss chunk
# lm_gemma2's median decode step on the H100 (700 W) as PERF.md recorded
# it before the layers read their model-axis split (one run; its host
# clock spreads ~10 % between runs)
LM_GEMMA2_DECODE_MS_BEFORE = 79.699


def tree_bytes(tree) -> int:
    """The bytes of every tensor in a nested dict (params, grads, a
    state)."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def train_flops(cfg, b: int, s: int) -> tuple[dict, dict]:
    """The fp32 operations of one remat train step at [b, s], term by
    term: (those the step needs, those the port adds).  N counts the
    parameters that enter a product (the matrices; the norms' weights
    scale elementwise).  Needed: 6 N T (forward and backward of every
    product, the tied logits included) and causal attention's two
    products (2 x 2 b H S^2 dh a layer forward, half of it unmasked; x 3
    with the backward).  Added: the remat's second forward over the
    layers and over the loss chunks (2 V d T), attention's in that
    second forward (4 b H S^2 dh L, unmasked as the port computes it),
    and the masked half of attention in the forward and backward (6 b H
    S^2 dh L).  The layers' second forward is 2 N_layers T less each
    period's last product, its last layer's w_down (2 d_ff d T a
    period): the non-reentrant checkpoint stops recomputing after the
    last tensor the backward saved, and that product's output is none.
    The sum equals the dry run's count of the step
    (`launch.dryrun`, phase 18) exactly."""
    from repro_torch.models import model as lm

    t = b * s
    n = sum(p.numel() for p in lm.Model(cfg, device="meta").parameters()
            if p.dim() >= 2)
    n_embed = cfg.vocab_size * cfg.d_model
    n_layers = n - n_embed * (1 if cfg.tie_embeddings else 2)
    periods = cfg.num_layers // cfg.scan_period
    bhs = float(b * cfg.num_heads * s * s * cfg.head_dim * cfg.num_layers)
    need = {"6NT": 6.0 * n * t, "causal attention 6 b H S^2 dh L": 6 * bhs}
    extra = {"remat layers 2 (N_layers - P d_ff d) T":
             2.0 * (n_layers - periods * cfg.d_ff * cfg.d_model) * t,
             "remat loss 2 V d T": 2.0 * n_embed * t,
             "remat attention 4 b H S^2 dh L": 4 * bhs,
             "masked attention half 6 b H S^2 dh L": 6 * bhs}
    return need, extra


def train_phase(torch, dev, smi: str, seed: int) -> dict:
    """Phase 16: training on the card (DESIGN.md Sec. 6).  No kernel of
    the six is on this path: the LM stack's products are torch ops.
    Returns what phase 17 compares with: train_gemma2's steps and peak,
    and train_gemma2_int8's model, state and checkpoint."""
    import shutil

    sys.path.insert(0, os.path.join(ROOT, "examples"))
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.data import tokens as tok
    from repro_torch.launch import train as train_mod
    from repro_torch.models import model as lm
    from repro_torch.models.config import count_params
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    @contextlib.contextmanager
    def cell(name):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        log(f"[train] {name}: cell wall {(time.perf_counter() - t0) * 1e3:.1f}"
            f" ms, peak device bytes {torch.cuda.max_memory_allocated()} "
            f"({start} in use at its start) ({smi})")

    # the optimizer's share of a step: host time of the call (launches
    # only; the host does not wait) and its device time between events
    opt_times = []
    real_apply = opt.apply_updates

    def timed_apply(*a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        t0 = time.perf_counter()
        out = real_apply(*a, **kw)
        host = (time.perf_counter() - t0) * 1e3
        ev[1].record()
        opt_times.append((host, ev))
        return out

    def run_steps(name, model, state, step_fn, steps, b, s):
        """`steps` steps on make_batch's batches 0..steps-1, each timed by
        a CUDA event pair and read back after it: [(ms, metrics)]."""
        cfg = model.cfg
        out = []
        for i in range(steps):
            batch = tok.make_batch(cfg, tok.DataConfig(seed=seed), i, b, s,
                                   device=dev)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            ev[0].record()
            state, m = step_fn(model, state, batch)
            ev[1].record()
            torch.cuda.synchronize()
            m = {k: float(v) for k, v in m.items()}
            ms = ev[0].elapsed_time(ev[1])
            out.append((ms, m))
            log(f"[train] {name} step {i}: {ms:.1f} ms, "
                f"{b * s / ms * 1e3:.0f} tokens/s, xent {m['xent']:.4f}, "
                f"grad_norm {m['grad_norm']:.4f}, lr {m['lr']:.3g}")
            if not np.isfinite(m["xent"]):
                raise AssertionError(f"{name}: non-finite xent at step {i}")
        return state, out

    def checkpoint_round_trip(name, model, state):
        """One checkpoint of {params, opt}: bytes, save / verify /
        restore ms, the restored tree equal to the saved one."""
        tmp = tempfile.mkdtemp(prefix="train_ckpt_")
        tree = {"params": model.state_dict(), "opt": state}
        try:
            free = shutil.disk_usage(tmp).free
            need = sum(4 * t.numel() if t.dtype == torch.bfloat16
                       else t.numel() * t.element_size()
                       for _, t in ckpt._leaves(tree))
            log(f"[train] {name} checkpoint dir {tmp}: {free} bytes free; "
                f"this tree writes {need} bytes (params widened to f32)")
            if free < 1.1 * need:
                raise AssertionError(f"{name}: {free} free bytes for a "
                                     f"{need}-byte checkpoint")
            t0 = time.perf_counter()
            path = ckpt.save(tmp, 7, tree, extra={"arch": "gemma2-2b"})
            save_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            ok = ckpt.verify(path)
            verify_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            back = ckpt.restore(path, tree)
            torch.cuda.synchronize()
            restore_ms = (time.perf_counter() - t0) * 1e3
            nbytes = os.path.getsize(os.path.join(path, "arrays.npz"))
            same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
                ckpt._leaves(tree), ckpt._leaves(back)))
            del back
            log(f"[train] {name} checkpoint: {nbytes} bytes (arrays.npz), "
                f"save {save_ms:.0f} ms (sha256 while writing), verify "
                f"{verify_ms:.0f} ms, restore to the card {restore_ms:.0f} ms "
                f"(its own verify included); checksum "
                f"{'ok' if ok else 'BAD'}; restored tree "
                f"{'equals' if same else 'DIFFERS FROM'} the saved one")
            if not (ok and same):
                raise AssertionError(f"{name}: checkpoint round trip")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    gemma = get_config("gemma2-2b")
    B, S, CHUNK = TRAIN_SHAPE
    hp = ts.TrainHParams(loss_chunk=CHUNK)
    phase_wall = time.perf_counter()
    log(f"[train] gemma2-2b at full width ({count_params(gemma):.0f} params, "
        f"{gemma.vocab_size * gemma.d_model} of them the tied embedding), "
        f"batch {B} x seq {S} (configs/shapes.py train_4k's sequence; its "
        f"global batch 256 cut to {B}), loss chunk {CHUNK}, remat on, bf16 "
        f"weights from --seed, fp32 products (TF32 off)")
    need, extra = train_flops(gemma, B, S)
    need_fl, extra_fl = sum(need.values()), sum(extra.values())
    bound_ms = need_fl / FP32_FLOPS_PER_S * 1e3
    done_ms = (need_fl + extra_fl) / FP32_FLOPS_PER_S * 1e3
    log(f"[train] fp32 FLOP bound of a step: "
        + " + ".join(f"{k} {v:.3e}" for k, v in need.items())
        + f" = {need_fl:.3e} FLOP over {FP32_FLOPS_PER_S / 1e12:.0f} "
        f"TFLOP/s = {bound_ms:.1f} ms; the port also computes "
        + " + ".join(f"{k} {v:.3e}" for k, v in extra.items())
        + f" = {extra_fl:.3e} FLOP, {need_fl + extra_fl:.3e} in all "
        f"= {done_ms:.1f} ms")

    with cell("train_gemma2"):
        model = lm.init_model(gemma, seed, device=dev)
        params = dict(model.named_parameters())
        ocfg = opt.OptConfig(peak_lr=TRAIN_LR, warmup_steps=2,
                             decay_steps=6)
        state = opt.init_opt_state(params, ocfg)
        p_bytes, s_bytes = tree_bytes(params), tree_bytes(state)
        step_fn = ts.make_train_step(gemma, ocfg, hp)
        opt.apply_updates = timed_apply
        try:
            state, steps = run_steps("train_gemma2", model, state, step_fn,
                                     6, B, S)
        finally:
            opt.apply_updates = real_apply
        peak = torch.cuda.max_memory_allocated()
        ms = [m for m, _ in steps]
        med = float(np.median(ms[1:]))
        readings = {"steps": steps, "peak": peak, "median_ms": med,
                    "p_bytes": p_bytes, "s_bytes": s_bytes}
        xents = [m["xent"] for _, m in steps]
        opt_host = [h for h, _ in opt_times[1:]]
        opt_dev = [e[0].elapsed_time(e[1]) for _, e in opt_times[1:]]
        log(f"[train] train_gemma2: step median {med:.1f} ms after the first "
            f"({ms[0]:.1f} ms), {B * S / med * 1e3:.0f} tokens/s; fp32 bound "
            f"{bound_ms:.1f} ms, share reached {bound_ms / med:.3f} (of the "
            f"{done_ms:.1f} ms that the FLOPs it computes take, remat and "
            f"masked attention included: {done_ms / med:.3f}); xent "
            f"{xents[0]:.4f} -> {xents[-1]:.4f}; the optimizer "
            f"(apply_updates) {np.median(opt_dev):.1f} ms of device time "
            f"and {np.median(opt_host):.1f} ms of host time a step (the "
            f"call's return, waits for launch-queue room included); peak "
            f"device bytes {peak} beside the state: bf16 params {p_bytes}, "
            f"bf16 grads {p_bytes}, fp32 m and v {s_bytes}, "
            f"{2 * p_bytes + s_bytes} in all ({smi})")
        if not xents[-1] < xents[0]:
            raise AssertionError(f"train_gemma2: xent did not fall "
                                 f"({xents})")
        # one more step, traced, its host syncs counted
        batch = tok.make_batch(gemma, tok.DataConfig(seed=seed), 6, B, S,
                               device=dev)
        readings["batch_bytes"] = tree_bytes(batch)
        syncs = []

        def traced_step():
            nonlocal state
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    state, _ = step_fn(model, state, batch)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            syncs.extend(w for w in caught if "called a synchronizing"
                         in str(w.message))

        rows, wall, _ = profile_batch(torch, "train_gemma2 step",
                                      traced_step, top=14)
        busy = sum(r[0] for r in rows)
        log(f"[train] train_gemma2 traced step: {sum(r[1] for r in rows)} "
            f"device ops, busy share {busy / wall:.3f} "
            f"({'device-bound' if busy / wall >= 0.5 else 'host-bound'}); "
            f"host syncs in the step {len(syncs)}"
            + (f" (first: {str(syncs[0].message)[:120]})" if syncs else ""))
        del params, step_fn, batch
        checkpoint_round_trip("train_gemma2", model, state)
        del model, state

    with cell("train_gemma2_int8"):
        ocfg8 = opt.OptConfig(peak_lr=TRAIN_LR, warmup_steps=2,
                              decay_steps=6, state_dtype="int8")
        model = lm.init_model(gemma, seed, device=dev)
        state = opt.init_opt_state(dict(model.named_parameters()), ocfg8)
        s8 = tree_bytes(state)
        state, steps = run_steps("train_gemma2_int8", model, state,
                                 ts.make_train_step(gemma, ocfg8, hp), 2, B,
                                 S)
        log(f"[train] train_gemma2_int8: step {steps[1][0]:.1f} ms (first "
            f"{steps[0][0]:.1f}); int8 state {s8} bytes beside fp32's "
            f"{s_bytes} ({s8 / s_bytes:.3f}); peak device bytes "
            f"{torch.cuda.max_memory_allocated()} ({smi})")
        # the int8 tree's checkpoint, which phase 17 restores onto the
        # one-rank mesh (it removes the directory)
        int8_dir = tempfile.mkdtemp(prefix="train_ckpt_int8_")
        t0 = time.perf_counter()
        int8_path = ckpt.save(int8_dir, 2, {"params": model.state_dict(),
                                            "opt": state},
                              extra={"arch": "gemma2-2b"})
        log(f"[train] train_gemma2_int8 checkpoint for phase 17: "
            f"{os.path.getsize(os.path.join(int8_path, 'arrays.npz'))} bytes,"
            f" save {(time.perf_counter() - t0) * 1e3:.0f} ms")
        readings["int8"] = dict(model=model, state=state, ocfg=ocfg8,
                                path=int8_path, dir=int8_dir)
        del model, state

    def rel_err(card_t, cpu_t) -> float:
        """max |got - want| / max |want|, computed on the card."""
        with torch.no_grad():
            want = cpu_t.detach().to(dev)
            return float((card_t.detach() - want).abs().max()
                         / torch.clamp(want.abs().max(), min=1e-30))

    def train_check(arch):
        """An f32 copy at full width cut to 2 layers (jamba's period of 8
        cut to its first two layers, attention + MLP and mamba + MoE, as
        a period of 2; deepseek dropless, as phase 14's lm_check makes
        it): one step's loss and gradients on the card against the CPU
        from the same weights and batch; then `apply_updates` given the
        CPU's gradients on both devices (not on jamba's 3.7 B f32
        parameters: the update is blind to the arch, and their CPU
        update would double the cell's time)."""
        full = get_config(arch)
        cut = dataclasses.replace(full, dtype="float32", num_layers=2,
                                  scan_period=min(full.scan_period, 2))
        if arch == "deepseek-moe-16b":
            cut = dataclasses.replace(cut, moe_capacity_factor=float(
                cut.moe_num_experts) / cut.moe_top_k)
        t0 = time.perf_counter()
        card = lm.init_model(cut, seed, device=dev)
        cpu = lm.Model(cut, device="cpu")
        cpu.load_state_dict(card.state_dict())
        hp2 = ts.TrainHParams(loss_chunk=256)
        out, secs = {}, {}
        for key, model, d in (("card", card, dev), ("cpu", cpu, "cpu")):
            batch = tok.make_batch(cut, tok.DataConfig(seed=seed), 0, 2, 256,
                                   device=d)
            params = ts.parameters(model)
            t1 = time.perf_counter()
            loss, _ = ts.make_loss_fn(cut, hp2)(model, batch)
            out[key] = (float(loss.detach()), ts.grads_of(loss, params),
                        params)
            torch.cuda.synchronize()
            secs[key] = time.perf_counter() - t1
        card_peak = torch.cuda.max_memory_allocated()
        (l_card, g_card, p_card), (l_cpu, g_cpu, p_cpu) = out["card"], \
            out["cpu"]
        del out
        l_err = abs(l_card - l_cpu) / abs(l_cpu)
        g_err = max(rel_err(g_card[n], g) for n, g in g_cpu.items())
        del g_card
        t1 = time.perf_counter()
        u_err = None
        if arch != "jamba-v0.1-52b":
            ocfg2 = opt.OptConfig(peak_lr=1e-3, warmup_steps=0,
                                  decay_steps=10)
            _, st_card, _ = opt.apply_updates(
                p_card, {n: g.to(dev) for n, g in g_cpu.items()},
                opt.init_opt_state(p_card, ocfg2), ocfg2)
            _, st_cpu, _ = opt.apply_updates(
                p_cpu, g_cpu, opt.init_opt_state(p_cpu, ocfg2), ocfg2)
            u_err = max(max(rel_err(p_card[n], p_cpu[n]),
                            rel_err(st_card["mu"][n]["m"],
                                    st_cpu["mu"][n]["m"]),
                            rel_err(st_card["mu"][n]["v"],
                                    st_cpu["mu"][n]["v"]))
                        for n in p_cpu)
        secs["update"] = time.perf_counter() - t1
        log(f"[train] train_check {arch} full width cut to 2 layers "
            f"({count_params(cut):.0f} params; kinds "
            f"{[cut.layer_kind(i) for i in range(2)]}, MoE "
            f"{[cut.layer_is_moe(i) for i in range(2)]}), f32, 2 x 256 "
            f"tokens: card vs CPU loss {l_err:.3g} relative (gate 1e-4), "
            f"worst gradient leaf {g_err:.3g} of its largest magnitude "
            f"(gate 1e-3); apply_updates on the CPU's gradients: parameters "
            f"and moments "
            + (f"{u_err:.3g} relative (gate 1e-6)" if u_err is not None
               else "not run")
            + f"; card peak {card_peak} bytes in the step (the optimizer "
            f"aside), {tree_bytes(p_cpu)} of them the f32 parameters; "
            f"{time.perf_counter() - t0:.1f} s (card step "
            f"{secs['card']:.1f} s, CPU step {secs['cpu']:.1f} s, updates "
            f"and their comparison {secs['update']:.1f} s)")
        if l_err > 1e-4 or g_err > 1e-3 or (u_err or 0.0) > 1e-6:
            raise AssertionError(f"train_check {arch}: card != CPU (loss "
                                 f"{l_err}, grads {g_err}, update {u_err})")

    for arch in ("gemma2-2b", "deepseek-moe-16b", "jamba-v0.1-52b",
                 "xlstm-1.3b"):
        with cell(f"train_check {arch}"):
            train_check(arch)

    with cell("train_check accumulation and resume"):
        # gradient accumulation on the card: A = 2 against the whole batch
        cut = dataclasses.replace(gemma, num_layers=2)
        model = lm.init_model(cut, seed, device=dev)
        p = ts.parameters(model)
        loss_fn = ts.make_loss_fn(cut, ts.TrainHParams(loss_chunk=256))
        batch = tok.make_batch(cut, tok.DataConfig(seed=seed), 0, 2, 256,
                               device=dev)
        full, _ = loss_fn(model, batch)
        g_full = ts.grads_of(full, p)
        g_sum = {n: torch.zeros(v.shape, device=dev) for n, v in p.items()}
        l_sum = 0.0
        for i in range(2):
            loss, _ = loss_fn(model, {k: v[i:i + 1] for k, v in
                                      batch.items()})
            l_sum += float(loss.detach())
            for n, g in ts.grads_of(loss, p).items():
                g_sum[n] += g.float()
        a = torch.cat([g.float().ravel() for g in g_full.values()])
        b = torch.cat([(g / 2).ravel() for g in g_sum.values()])
        cos = float(a @ b / (a.norm() * b.norm()))
        log(f"[train] train_check grad accumulation, gemma2-2b bf16 cut to "
            f"2 layers, 2 x 256: A = 2 in f32 against the whole batch, "
            f"loss {l_sum / 2:.6f} vs {float(full.detach()):.6f}, gradient "
            f"cosine {cos:.6f} (gate > 0.999)")
        if cos <= 0.999:
            raise AssertionError(f"train_check grad accumulation: cosine "
                                 f"{cos}")
        del model, p, g_full, g_sum, a, b

        # the entry point: make_grad_accum_train_step (A = 2 microbatches
        # of 1, f32 sums, then apply_updates) against make_train_step on
        # the whole batch, from the same f32 weights and state
        cut32 = dataclasses.replace(cut, dtype="float32")
        ocfg2 = opt.OptConfig(peak_lr=1e-3, warmup_steps=0, decay_steps=10)
        hp2 = ts.TrainHParams(loss_chunk=256)
        acc = lm.init_model(cut32, seed, device=dev)
        whole = lm.Model(cut32, device=dev)
        whole.load_state_dict(acc.state_dict())
        st_acc = opt.init_opt_state(dict(acc.named_parameters()), ocfg2)
        st_whole = opt.init_opt_state(dict(whole.named_parameters()), ocfg2)
        st_acc, m_acc = ts.make_grad_accum_train_step(cut32, ocfg2, hp2, 2)(
            acc, st_acc, {k: v.reshape(2, 1, *v.shape[1:])
                          for k, v in batch.items()})
        st_whole, m_whole = ts.make_train_step(cut32, ocfg2, hp2)(
            whole, st_whole, batch)
        m_err = {k: abs(float(m_acc[k]) - float(m_whole[k]))
                 / abs(float(m_whole[k])) for k in ("loss", "grad_norm")}
        mom_err = max(rel_err(st_acc["mu"][n]["m"], st_whole["mu"][n]["m"])
                      for n in st_whole["mu"])
        lr = float(m_whole["lr"])
        n_far = n_all = 0
        d_worst = 0.0   # the largest move apart, in learning rates
        with torch.no_grad():
            for (n, pa), pw in zip(acc.named_parameters(),
                                   whole.parameters()):
                d = (pa - pw).abs()
                tol = 1e-6 * float(pw.abs().max())
                n_far += int((d > tol).sum())
                n_all += pw.numel()
                d_worst = max(d_worst, (float(d.max()) - tol) / lr)
        log(f"[train] train_check make_grad_accum_train_step, gemma2-2b f32 "
            f"cut to 2 layers, [2, 1, 256] against make_train_step on "
            f"[2, 256] from the same state: loss {m_err['loss']:.3g} and "
            f"grad_norm {m_err['grad_norm']:.3g} relative (gate 1e-5); first"
            f" moments {mom_err:.3g} of each leaf's largest magnitude (gate "
            f"1e-3); parameters more than 1e-6 of their leaf's largest "
            f"magnitude apart: {n_far} of {n_all} (gate 1 in 1000), the "
            f"farthest {d_worst:.3f} learning rates beyond that (gate 2.2: "
            f"Adam's first step moves a parameter by about lr sign(g))")
        if (max(m_err.values()) > 1e-5 or mom_err > 1e-3
                or n_far >= 1e-3 * n_all or d_worst > 2.2):
            raise AssertionError(f"train_check make_grad_accum_train_step: "
                                 f"{m_err}, moments {mom_err}, {n_far} of "
                                 f"{n_all} far, worst {d_worst} lr")
        del acc, whole, st_acc, st_whole, batch

        # resume: 4 steps + a checkpoint + --resume to 6 against 6 straight
        # steps, under deterministic algorithms (the embedding's backward
        # adds with atomics otherwise), bit for bit
        cut16 = dataclasses.replace(gemma, num_layers=2)
        argv = ["--arch", "gemma2-2b", "--device", "cuda", "--batch", "2",
                "--seq", "256", "--ckpt-every", "4", "--log-every", "1",
                "--opt-state", "int8", "--seed", str(seed)]
        tmp = tempfile.mkdtemp(prefix="train_resume_")
        lines = []
        torch.use_deterministic_algorithms(True)
        try:
            train_mod.run(train_mod.parse_args(
                argv + ["--steps", "4", "--ckpt-dir", tmp]), cfg=cut16,
                log=lines.append)
            resumed, _ = train_mod.run(train_mod.parse_args(
                argv + ["--steps", "6", "--ckpt-dir", tmp, "--resume"]),
                cfg=cut16, log=lines.append)
            straight, _ = train_mod.run(train_mod.parse_args(
                argv + ["--steps", "6"]), cfg=cut16, log=lambda s: None)
        finally:
            torch.use_deterministic_algorithms(False)
            shutil.rmtree(tmp, ignore_errors=True)
        same = all(torch.equal(a, b) for a, b in zip(
            resumed.state_dict().values(), straight.state_dict().values()))
        resume_line = next(s for s in lines if s.startswith("[resume]"))
        log(f"[train] train_check resume, gemma2-2b bf16 cut to 2 layers, "
            f"2 x 256, int8 state: {resume_line.split(' (')[-1].rstrip(')')} -> 6 under "
            f"torch.use_deterministic_algorithms(True): parameters "
            f"{'equal' if same else 'DIFFER FROM'} 6 straight steps bit for "
            f"bit")
        if not same:
            raise AssertionError("train_check resume: resumed != straight")
        del resumed, straight

    with cell("train_example"):
        import torch_train_lm

        ex_lines = []
        torch_train_lm.run(device="cuda", log=ex_lines.append)
        resume = [s for s in ex_lines if s.startswith("[resume]")]
        xe = [float(s.split("xent=")[1].split()[0]) for s in ex_lines
              if s.startswith("[step")]
        log(f"[train] train_example examples/torch_train_lm.py (gemma2-2b "
            f"smoke, 200 steps, preempted at 100): "
            f"{resume[0] if resume else 'no resume line'}; xent "
            f"{xe[0]:.4f} -> {xe[-1]:.4f}")
        if not resume or not xe[-1] < xe[0]:
            raise AssertionError("train_example: no resume or no progress")
    log(f"[train] phase 16 in {time.perf_counter() - phase_wall:.1f} s")
    return readings


def train_mesh_phase(torch, dev, smi: str, seed: int, p16: dict) -> None:
    """Phase 17 [train_mesh]: training on several devices, at NCCL world
    1 (one rank a card; the worlds of 2, 4 and 8 run in gloo ranks on
    the CPU in tests/test_torch_train_dist.py and
    tests/test_torch_model_axis.py).  No kernel of the six is on this
    path.  restore_check (phase 16's int8 checkpoint restored with
    shardings onto the one-rank mesh), train_mesh (gemma2-2b whole, 2
    steps of `launch.train.run --mesh-data 1 --mesh-model 1` through
    the named device mesh, ZeRO-3 placement and the model axis's code,
    against phase 16's steps), compress_check (`compressed_psum` over
    that step's gradients), pipeline_check (one stage, M = 2, on an f32
    2-layer cut) and serve_mesh (`launch.serve --mesh-data 1
    --mesh-model 1`)."""
    import shutil
    import torch.distributed as tdist

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.data import tokens as tok
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import init_process_mesh, make_lm_mesh
    from repro_torch.models import model as lm
    from repro_torch.models.config import count_params
    from repro_torch.train import compression as comp
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    from repro_torch.train.pipeline import pipeline_forward

    wall = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    init_process_mesh(dev)
    mesh = make_lm_mesh(1, 1, device=dev)
    log(f"[train_mesh] process group: backend {tdist.get_backend()}, world "
        f"{tdist.get_world_size()}; LM mesh {mesh.shape} ({smi})")

    def sync_s(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # restore_check: phase 16's int8 tree, restored with the one-rank
    # mesh's shardings, equals the saved tree
    t0 = time.perf_counter()
    i8 = p16.pop("int8")
    try:
        zero = ts.Zero3(i8["model"], mesh)
        tmpl, shard = zero.checkpoint_template(i8["ocfg"])
        back = ckpt.restore(i8["path"], tmpl, device=dev, shardings=shard)
        saved = {"params": i8["model"].state_dict(), "opt": i8["state"]}
        pairs = list(zip(ckpt._leaves(saved), ckpt._leaves(back)))
        same = all(a_path == b_path and torch.equal(
            a, b.to_local() if hasattr(b, "to_local") else b)
            for (a_path, a), (b_path, b) in pairs)
        kinds = sorted({type(b).__name__ for _, (_, b) in pairs})
        log(f"[train_mesh] restore_check: phase 16's int8 checkpoint "
            f"({len(pairs)} leaves) restored with shardings onto the "
            f"one-rank mesh ({kinds}) in {sync_s(t0) * 1e3:.0f} ms (its "
            f"verify included): {'equals' if same else 'DIFFERS FROM'} "
            f"the saved tree")
        if not same:
            raise AssertionError("restore_check: restored != saved")
    finally:
        shutil.rmtree(i8["dir"], ignore_errors=True)
        del i8, zero
        back = saved = pairs = None
        gc.collect()
        torch.cuda.empty_cache()

    # train_mesh: 2 steps through the mesh path, each timed, the last
    # step's gradients kept for compress_check
    gemma = get_config("gemma2-2b")
    B, S, CHUNK = TRAIN_SHAPE
    times, kept = [], {}
    real_make, real_apply = ts.make_sharded_train_step, opt.apply_updates

    def timed_make(*a, **kw):
        inner = real_make(*a, **kw)

        def step(model, state, rows):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            ev[0].record()
            out = inner(model, state, rows)
            ev[1].record()
            torch.cuda.synchronize()
            times.append((ev[0].elapsed_time(ev[1]),
                          {k: float(v) for k, v in out[1].items()}))
            return out
        return step

    def keep_grads(params, grads, *a, **kw):
        if len(times) == 1:   # the second step's
            kept["grads"] = grads
        return real_apply(params, grads, *a, **kw)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ts.make_sharded_train_step, opt.apply_updates = timed_make, keep_grads
    try:
        model, _ = train_mod.run(train_mod.parse_args([
            "--arch", "gemma2-2b", "--device", dev.type, "--mesh-data", "1",
            "--mesh-model", "1", "--steps", "2", "--batch", str(B), "--seq",
            str(S), "--lr", str(TRAIN_LR), "--warmup", "2", "--log-every",
            "1", "--seed", str(seed)]), cfg=gemma, log=lambda s: None)
    finally:
        ts.make_sharded_train_step, opt.apply_updates = real_make, real_apply
    peak = torch.cuda.max_memory_allocated()
    run_s = sync_s(t0)
    (ms0, m0), (ms1, m1) = times
    (p_ms0, p_m0), (p_ms1, p_m1) = p16["steps"][:2]
    e_gn = abs(m0["grad_norm"] - p_m0["grad_norm"]) / p_m0["grad_norm"]
    e_x1 = abs(m1["xent"] - p_m1["xent"]) / p_m1["xent"]
    d_ms = [(a - b) / b * 100 for a, b in ((ms0, p_ms0), (ms1, p_ms1))]
    log(f"[train_mesh] train_mesh gemma2-2b whole, bf16, {B} x {S}, "
        f"launch.train --mesh-data 1 --mesh-model 1 (named device mesh, "
        f"ZeRO-3 placement, the model axis's code at one model rank; "
        f"{run_s:.1f} s with the init): step ms {ms0:.1f}, {ms1:.1f} beside "
        f"phase 16's {p_ms0:.1f}, {p_ms1:.1f} ({d_ms[0]:+.2f} %, "
        f"{d_ms[1]:+.2f} %: "
        f"{'within' if max(map(abs, d_ms)) <= 1 else 'OUTSIDE'} +-1 %; its "
        f"median {p16['median_ms']:.1f}); peak device bytes {peak} beside "
        f"phase 16's {p16['peak']}; step 0 xent {m0['xent']!r} vs "
        f"{p_m0['xent']!r}"
        f" ({'equal' if m0['xent'] == p_m0['xent'] else 'DIFFERENT'}); "
        f"grad_norm {e_gn:.3g} and step 1 xent {e_x1:.3g} relative apart "
        f"(gate 1e-5; the embedding backward adds with atomics) ({smi})")
    if m0["xent"] != p_m0["xent"] or e_gn > 1e-5 or e_x1 > 1e-5:
        raise AssertionError(f"train_mesh: step 0 xent {m0['xent']} vs "
                             f"{p_m0['xent']}, grad_norm {e_gn}, step 1 "
                             f"xent {e_x1}")
    del model

    # compress_check: compressed_psum at world 1 over that gradient tree
    grads = kept.pop("grads")
    n_par = sum(g.numel() for g in grads.values())
    stats = {}
    err0 = comp.init_error_state(grads)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    red, err = comp.compressed_psum(grads, err0, stats=stats)
    ev[1].record()
    torch.cuda.synchronize()
    c_ms = ev[0].elapsed_time(ev[1])
    same_red = same_err = True
    for n, g in grads.items():
        g32 = g.float() + err0[n]
        deq = opt.dequantize_blockwise(*opt.quantize_blockwise(g32, 256),
                                       g.shape)
        same_red &= torch.equal(red[n], deq)
        same_err &= torch.equal(err[n], g32 - deq)
    log(f"[train_mesh] compress_check: compressed_psum at world 1 over "
        f"train_mesh's last gradient tree ({n_par} parameters, "
        f"{len(grads)} leaves) in {c_ms:.1f} device ms; reduced gradients "
        f"{'equal' if same_red else 'DIFFER FROM'} quantize -> dequantize "
        f"of g + e bit for bit, error {'equals' if same_err else 'DIFFERS '
        'FROM'} g32 - deq; wire bytes {stats['wire_bytes']} (int8 codes + "
        f"f32 scales) against f32's {stats['f32_bytes']} "
        f"({stats['wire_bytes'] / stats['f32_bytes']:.4f})")
    if not (same_red and same_err and n_par == count_params(gemma)):
        raise AssertionError("compress_check")
    del grads, red, err, err0
    gc.collect()
    torch.cuda.empty_cache()

    # pipeline_check: one stage, M = 2, on train_check's f32 2-layer cut
    cut = dataclasses.replace(gemma, dtype="float32", num_layers=2,
                              scan_period=min(gemma.scan_period, 2))
    model = lm.init_model(cut, seed, device=dev)
    params = ts.parameters(model)
    batch = tok.make_batch(cut, tok.DataConfig(seed=seed), 0, 2, 256,
                           device=dev)
    x = lm._embed_inputs(model, batch).detach()
    pos = torch.arange(x.shape[1], dtype=torch.int32,
                       device=dev)[None].expand(x.shape[:2])
    names = [n for n in params if n.startswith("blocks.")]
    outs = {}
    for key in ("pipe", "plain"):
        t0 = time.perf_counter()
        if key == "pipe":
            y = pipeline_forward(cut, None, model.blocks, x, pos, 2)
        else:
            y = x
            for blk in model.blocks:
                y, _, _ = blk(y, pos)
        g = torch.autograd.grad(torch.sum(y ** 2), [params[n] for n in names])
        outs[key] = (y.detach(), g, sync_s(t0))
    (yp, gp, tp), (yr, gr, tr) = outs["pipe"], outs["plain"]
    y_err = float((yp - yr).abs().max())
    a = torch.cat([t.ravel() for t in gp])
    b = torch.cat([t.ravel() for t in gr])
    cos = float(a @ b / (a.norm() * b.norm()))
    log(f"[train_mesh] pipeline_check: pipeline_forward one stage, M = 2, "
        f"gemma2-2b f32 cut to 2 layers, 2 x 256: output {y_err:.3g} from "
        f"the plain forward (gate 2e-4), gradient cosine {cos:.6f} (gate > "
        f"0.999); {tp * 1e3:.0f} ms forward + backward against plain "
        f"{tr * 1e3:.0f} ms")
    if y_err > 2e-4 or cos <= 0.999:
        raise AssertionError(f"pipeline_check: {y_err}, cosine {cos}")
    del model, params, outs, a, b, gp, gr, yp, yr
    gc.collect()
    torch.cuda.empty_cache()

    # serve_mesh: launch.serve --mesh-data 1 against the one-device
    # generate on the same weights
    model = lm.init_model(gemma, seed, device=dev)
    argv = ["--arch", "gemma2-2b", "--device", dev.type, "--batch", "8",
            "--prompt-len", "64", "--gen", "8", "--mesh-data", "1",
            "--mesh-model", "1", "--seed", str(seed)]
    t0 = time.perf_counter()
    got = serve_mod.run(serve_mod.parse_args(argv), model=model,
                        log=lambda s: None)
    mesh_s = sync_s(t0)
    args = serve_mod.parse_args(argv)
    batch = serve_mod.make_batch(gemma, args.batch, args.prompt_len,
                                 args.seed, dev)
    t0 = time.perf_counter()
    want = serve_mod.generate(model, batch, steps=args.gen,
                              max_len=args.prompt_len + args.gen + 8,
                              seed=args.seed).cpu().numpy()
    one_s = sync_s(t0)
    same = np.array_equal(got, want)
    log(f"[train_mesh] serve_mesh: launch.serve --mesh-data 1 --mesh-model "
        f"1, gemma2-2b whole, 8 x 64 + 8: tokens {'equal' if same else 'DIFFER FROM'} "
        f"the one-device generate's; {mesh_s * 1e3:.0f} ms against "
        f"{one_s * 1e3:.0f} ms")
    if not same:
        raise AssertionError("serve_mesh: tokens differ")
    del model
    tdist.destroy_process_group()
    log(f"[train_mesh] phase 17 in {time.perf_counter() - wall:.1f} s")


# -- 18. [dryrun]: the dry run against phase 16's step --------------------

# the production cell phase 18 steps in a fake world of 256 ranks
DRYRUN_CELL = ("gemma2-2b", "decode_32k")


def dryrun_phase(p16: dict, smi: str) -> None:
    """Phase 18 [dryrun]: `launch.dryrun`'s counts of train_gemma2's step
    (built on the meta device, rank 0 of a fake one-rank world) held
    against what phase 16 measured on the card and against
    `train_flops`, then one production cell.  Raises on a failed check."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.train import train_step as ts

    wall = time.perf_counter()
    B, S, CHUNK = TRAIN_SHAPE
    if ts.TrainHParams().loss_chunk != CHUNK:
        raise AssertionError("the dry run's loss chunk is not phase 16's")
    rec = dryrun.run_cell("gemma2-2b", ShapeSpec("train_gemma2", S, B,
                                                 "train"),
                          False, mesh_shape=(1, 1))
    mem, flops = rec["memory"], rec["cost"]["flops"]
    want_args = p16["p_bytes"] + p16["s_bytes"] + p16["batch_bytes"]
    need, extra = train_flops(get_config("gemma2-2b"), B, S)
    want_flops = sum(need.values()) + sum(extra.values())
    flops_gap = flops / want_flops - 1.0
    peak_gap = mem["peak_bytes"] / p16["peak"] - 1.0
    log(f"[dryrun] train_gemma2 on the meta device, mesh (1, 1): "
        f"{dryrun.summary(rec)}; {rec['aten_ops']} aten ops")
    log(f"[dryrun] argument bytes {mem['argument_bytes']} vs phase 16's "
        f"bf16 params {p16['p_bytes']} + fp32 state {p16['s_bytes']} + "
        f"batch {p16['batch_bytes']} = {want_args} "
        f"({'equal' if mem['argument_bytes'] == want_args else 'DIFFERENT'})"
        f"; FLOPs {flops} vs train_flops' {want_flops:.0f} "
        f"({flops_gap * 100:+.4f} %, limit 0.5 %); peak {mem['peak_bytes']} "
        f"(temp {mem['temp_bytes']}) vs phase 16's measured "
        f"{p16['peak']} ({peak_gap * 100:+.2f} %, limit 10 %); the card's "
        f"memory {rec['device_memory_bytes']} ({smi})")
    arch, shape = DRYRUN_CELL
    prod = dryrun.run_cell(arch, shape, False)
    log(f"[dryrun] {arch} {shape} rank 0 of (16, 16), computed on the meta "
        f"device: {dryrun.summary(prod)}; wire bytes by op "
        f"{prod['collectives']['bytes_by_op']}, counts "
        f"{prod['collectives']['counts']}")
    if mem["argument_bytes"] != want_args:
        raise AssertionError(f"dryrun: argument bytes {mem['argument_bytes']}"
                             f" != phase 16's {want_args}")
    if abs(flops_gap) > 0.005:
        raise AssertionError(f"dryrun: FLOPs {flops} are {flops_gap:+.4%} "
                             f"from train_flops' {want_flops:.0f}")
    if abs(peak_gap) > 0.10:
        raise AssertionError(f"dryrun: peak {mem['peak_bytes']} is "
                             f"{peak_gap:+.2%} from phase 16's {p16['peak']}")
    log(f"[dryrun] phase 18 in {time.perf_counter() - wall:.1f} s")


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
    from repro_torch.core.hashing import (LshParams, make_hyperplanes,
                                          sketch_codes_batched)
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
    from torch_parity_rules import topk_swaps

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

    # -- 4b. [autotune]: the grid cache and a bounded sweep -----------------
    from repro_torch.kernels import autotune

    at_wall = time.perf_counter()
    kind = autotune.device_kind(dev)
    env_key = "REPRO_TORCH_AUTOTUNE_CACHE"
    with tempfile.TemporaryDirectory() as tmp:
        os.environ[env_key] = os.path.join(tmp, "autotune_cache.json")
        autotune._load.cache_clear()
        try:
            # an empty cache: the constants' grids at phase 4's shapes
            tuned = {op: autotune.get(op, kind)
                     for op in autotune.DEFAULTS["*"]}
            if tuned != autotune.DEFAULTS["*"]:
                raise AssertionError(f"autotune: an empty cache gives "
                                     f"{tuned}")
            ts, tb, tc = (tuned[op] for op in ("simhash", "bucket_topk",
                                               "fused_contains"))
            grids = [(sh_mod.grid(*a, sms, ts["warp_rows_per_sm"],
                                  ts["stream_groups"]),
                      sh_mod.grid(*a, sms, sh_mod.WARP_ROWS_PER_SM,
                                  sh_mod.STREAM_GROUPS))
                     for a in ((NQ, D, K, L, False), (NQ, D, K, L, True),
                               (N, D, K, L, False),
                               (8192, 24_576, 11, L, False),
                               (8192, 49_152, 12, L, False))]
            grids.append((bt_mod.grid(bq, kc, M, sms, tb["parts_per_sm"]),
                          bt_mod.grid(bq, kc, M, sms, bt_mod.PARTS_PER_SM)))
            grids.append((fq_mod.contains_grid(r, sms, tc["max_rows"]),
                          fq_mod.contains_grid(r, sms,
                                               fq_mod.CONTAINS_MAX_ROWS)))
            if any(a != b for a, b in grids):
                raise AssertionError(f"autotune: an empty cache changes a "
                                     f"grid: {grids}")
            log(f"[autotune] an empty cache on {kind}: the constants' "
                f"grids at phase 4's shapes ({len(grids)} grids equal)")
            # a bounded sweep into the scratch file; every candidate is
            # held against its plain version inside the sweep
            swept = autotune.sweep(reps=15, device=dev, log=log)
            for op, res in swept.items():
                # the winner timed again against the default
                d_m, d_r = autotune.time_params(res["cases"], res["default"],
                                                15)
                w_m, w_r = autotune.time_params(res["cases"], res["winner"],
                                                15)
                margin = max(0.05 * sum(d_m), sum(d_r))
                log(f"[autotune] {op}: winner {res['winner']} re-timed "
                    f"{sum(w_m):.4f} ms (ranges {sum(w_r):.4f}) against the "
                    f"default {res['default']} {sum(d_m):.4f} ms (ranges "
                    f"{sum(d_r):.4f}); recorded in the scratch file: "
                    f"{res['put']}")
                if sum(w_m) - sum(d_m) > margin:
                    raise AssertionError(
                        f"autotune {op}: the winner {res['winner']} is "
                        f"slower than the default by more than {margin:.4f}"
                        " ms")
            del swept, res
        finally:
            del os.environ[env_key]
            autotune._load.cache_clear()
    committed = autotune._load(str(autotune.cache_path())).get(kind, {})
    log(f"[autotune] the committed cache {autotune.cache_path().name} on "
        f"{kind}: {committed or 'no entry'}; every later phase launches on "
        f"{ {op: autotune.get(op, kind) for op in autotune.DEFAULTS['*']} }"
        f"; phase in {time.perf_counter() - at_wall:.1f} s")
    for name, op in (("simhash", "simhash"), ("bucket_topk", "bucket_topk"),
                     ("fused_contains", "fused_contains")):
        kernels[name]["tuned"] = autotune.get(op, kind)

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

    def path_bound(name, a, kw):
        """(bound_ms, bound_by) of one wrapper call on its recorded
        inputs: the fused kernels as `fused_path_bound` counts them;
        simhash x, the hyperplanes and the codes or words, and its
        multiply-adds; bucket_topk the valid lanes' vectors, the queries,
        the validity words and the top m, and their products; hamming
        and hamming_words their inputs and outputs."""
        if name in ("fused_query", "fused_contains"):
            return fused_path_bound(name, a, kw)
        if name == "simhash":
            (n_x, d_x), (l_h, k_h, _) = a[0].shape, a[1].shape
            out = (-(-l_h * k_h // 32) if kw.get("packed", False)
                   else l_h)
            return bound(n_x * d_x * 4 + l_h * k_h * d_x * 4 + n_x * out * 4,
                         2.0 * n_x * d_x * l_h * k_h)
        if name == "bucket_topk":
            qa, cand, valid, m = a
            n_valid = int(valid.sum())
            d_c = cand.shape[-1]
            return bound(n_valid * d_c * 4 + qa.numel() * 4
                         + qa.shape[0] * (-(-cand.shape[1] // 32)) * 4
                         + qa.shape[0] * m * 8, 2.0 * n_valid * d_c)
        return bound(a[0].numel() * 4 + a[1].numel() * 4
                     + a[1].shape[0] * a[1].shape[1] * 4)

    def hold_at_path_shapes(path, fn, names):
        """Hold the kernels behind the wrappers `names` against their plain
        versions on the very inputs the path gives them (one batch of
        `fn`): dot to TIE with near-tie id swaps allowed, hamming and
        contains exactly; fused_query's plain version runs in row
        chunks."""
        for (name, shapes, _), (a, kw) in recorded_inputs(fn, names).items():
            lib_ms = None
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
            elif name == "simhash":
                # flipped sign bits must lie within the 1e-5 band
                ties, err = simhash_check(a[0], kw.get("packed", False),
                                          hh=a[1])
                k_ms = cuda_ms(torch, lambda: ops.simhash(*a, **kw), 5)
                p_ms = cuda_ms(torch, lambda: sh_mod.simhash_plain(*a, **kw),
                               5)
                # the library's product of x by H^T alone, as phase 4's
                h_t = a[1].reshape(-1, a[1].shape[-1]).t().contiguous()
                lib_ms = cuda_ms(torch, lambda: torch.matmul(a[0], h_t), 5)
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
            b_ms, b_by = path_bound(name, a, kw)
            k = kernels[name]
            k["max_abs_err"] = max(k["max_abs_err"], err)
            k.setdefault("path_shapes", []).append(dict(
                path=path, shapes=[list(s) for s in shapes],
                max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms))
            log(f"[kernel] {name} at {path} {list(shapes)}: equal to plain "
                f"(max score err {err:.3g}, near-tie id swaps {ties}); "
                f"{k_ms:.4f} ms, plain {p_ms:.4f} ms"
                + ("" if b_ms is None else f", bound {b_ms:.4f} ms ({b_by})")
                + ("" if lib_ms is None else
                   f", torch.matmul x H^T {lib_ms:.4f} ms"))

    # -- 5-9. the main path's paths, each with launch counts of its own -----
    by_path = {}
    expected = set()

    def counted(path, expect, fn):
        """Run `fn` with every launch count set to 0 just before and read
        just after; fail if a kernel of `expect` was not launched.  A path
        run again adds this run's counts to its earlier ones."""
        expected.update(expect)
        ops.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = dict(ops.LAUNCHES)
        missing = [n for n in expect if got[n] == 0]
        if missing:
            raise AssertionError(f"{path}: kernels never launched: {missing}")
        if path in by_path:  # the serve cells add into one path
            got = {n: c + by_path[path][n] for n, c in got.items()}
        by_path[path] = got
        log(f"[launches] {path}: {got}")
        return out

    @contextlib.contextmanager
    def uncounted():
        """Launches inside the block (kernel checks, profiles) leave the
        path's launch counts as they were."""
        saved = dict(ops.LAUNCHES)
        try:
            yield
        finally:
            ops.LAUNCHES.update(saved)

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
    import torch.distributed as tdist

    from repro_torch.core import distributed as dist_mod
    from repro_torch.launch.mesh import (ProcessZoneMesh, init_process_mesh,
                                         make_zone_mesh)

    # each cell's label -> its one-process outputs and ms, which the same
    # cell on the process mesh must equal exactly
    one_proc = {}

    def procs_check(label, got, ms, trace, sendrecv):
        """Hold a process-mesh cell's outputs `got` against the one-process
        cell's exactly, print its ms beside that cell's, and read the NCCL
        part of the trace of one batch (`trace`, from `profile_batch`).

        At world 1, NCCL runs all_to_all with even splits, all_gather and
        all_reduce on its one-rank path: device copies under an
        `nccl:<op>` annotation, with no NCCL kernel.  A ppermute's uneven
        all_to_all launches `ncclDevKernel_SendRecv`.  So a cell that
        runs a ppermute (`sendrecv`) fails without an NCCL kernel in its
        trace, and every other cell fails without NCCL's annotations."""
        want = one_proc[label]
        for a, b in zip(got, want[:-1]):
            same = torch.equal(a, b) if torch.is_tensor(a) else a == b
            if not same:
                raise AssertionError(f"mesh_procs {label}: differs from the "
                                     f"one-process mesh")
        rows, _, spans = trace
        kernels = [r for r in rows if r[2].startswith("ncclDevKernel")]
        notes = [r for r in spans if r[2].startswith("nccl:")]
        if not notes or (sendrecv and not kernels):
            raise AssertionError(
                f"mesh_procs {label}: the trace of one batch shows "
                f"{len(kernels)} NCCL kernels and {len(notes)} NCCL "
                f"annotations")
        names = (", ".join(sorted({r[2] for r in kernels})) if kernels
                 else "annotation-only: one-rank copies")
        log(f"[procs] {label}: equal to the one-process mesh exactly; "
            f"{ms:.3f} ms, one process {want[-1]:.3f} ms; NCCL kernels "
            f"{sum(r[0] for r in kernels):.3f} device ms of one call in "
            f"{sum(r[1] for r in kernels)} launches ({names}); NCCL "
            f"annotations {sum(r[1] for r in notes)} spanning "
            f"{sum(r[0] for r in notes):.3f} ms "
            f"({', '.join(sorted({r[2] for r in notes}))})")

    def mesh_runtime(n, score, variant, **kw):
        kw.setdefault("cap_factor", float(n))
        kw.setdefault("m", M)
        return IndexRuntime(RuntimeConfig(
            params=params, variant=variant, n_nodes=n, use_kernels=True,
            score=score, **kw), mesh=make_zone_mesh(n, device=dev))

    def refreshed(n, score, st):
        """The CNB cache of an n-node mesh, with the refresh's time; on the
        process mesh, held against the one-process cache exactly."""
        rt = mesh_runtime(n, score, "cnb")
        st = rt.shard_store(st)
        procs = isinstance(rt.mesh, ProcessZoneMesh)
        refresh = (lambda: counted("mesh_procs", (), lambda: rt.refresh_cache(
            st))) if procs else (lambda: rt.refresh_cache(st))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache = refresh()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        moved = sum(c.numel() * c.element_size() for c in cache)
        per_node = dist_mod.estimate_refresh_bytes(rt.cfg, C, D)
        label = f"refresh_cache n={n} {score}"
        log(f"[mesh] {label}{' (processes)' if procs else ''}: {ms:.3f} ms, "
            f"{moved} bytes written on the card; wire model {per_node} bytes "
            f"per node, {per_node * n} in all")
        if procs:
            trace = profile_batch(torch, "mesh_procs " + label,
                                  lambda: rt.refresh_cache(st))
            procs_check(label, cache, ms, trace, sendrecv=True)
        else:
            one_proc[label] = (*cache, ms)
        return st, cache

    def mesh_cell(n, score, variant, st, cache, nq, expect, **kw):
        """One search cell; on the process mesh its launches add into the
        path `mesh_procs` and its outputs are held against the
        one-process cell's."""
        rt = mesh_runtime(n, score, variant, **kw)
        procs = isinstance(rt.mesh, ProcessZoneMesh)
        c = cache if variant == "cnb" else None
        label = (f"mesh n={n} {score} {variant} {rt.cfg.routing} "
                 f"cap_factor={rt.cfg.cap_factor:g}")
        path = "mesh_procs" if procs else label
        outs, ms = counted(path, expect,
                           lambda: timed_batches(rt, st, nq, cache=c))
        stats = outs[0][2].host()
        wire = dist_mod.estimate_query_bytes(rt.cfg, nq, D, rt.n_devices)
        hold_at_path_shapes(f"{path} {label}" if procs else path,
                            lambda: rt.search(h, st, x[qids[0][:nq]],
                                              cache=c),
                            ("bucket_topk", "hamming", "fused_query"))
        trace = profile_batch(torch, f"{path} {label}" if procs else path,
                              lambda: rt.search(h, st, x[qids[0][:nq]],
                                                cache=c))
        if procs:
            procs_check(label, (outs[0][0], outs[0][1], stats), ms, trace,
                        sendrecv=variant == "nb")
        else:
            one_proc[label] = (outs[0][0], outs[0][1], stats, ms)
        log(f"[cell] {'processes: ' if procs else ''}{label}: {ms:.3f} ms "
            f"per batch of {nq}, "
            f"{nq / ms * 1e3:.0f} queries/s; probes_routed "
            f"{stats['probes_routed']}, nodes_contacted "
            f"{stats['nodes_contacted']}, dropped {stats['dropped_probes']}; "
            f"wire bytes {wire['total']} (query {wire['query_routing']}, "
            f"results {wire['results']}, neighbor {wire['neighbor']})")
        return outs[0], stats

    def contains_cell(variant, st, cache):
        """16-node contains of each query's own id, equal to the 1-node
        contains; on the process mesh, also to the one-process cell."""
        rt = mesh_runtime(16, "hamming", variant)
        procs = isinstance(rt.mesh, ProcessZoneMesh)
        c = cache if variant == "cnb" else None
        label = f"mesh n=16 contains {variant}"

        def run():
            return rt.contains(h, st, q, qids[0], cache=c)

        got_h, cstats = counted("mesh_procs" if procs else label,
                                ("fused_contains",), run)
        if int(cstats) != 0 or not torch.equal(got_h, hits):
            raise AssertionError(f"mesh contains {variant} != 1-node")
        ms = timed_contains(rt, st, cache=c)
        log(f"[cell] {'processes: ' if procs else ''}{label}: {ms:.3f} ms "
            f"per batch of {NQ}, {NQ / ms * 1e3:.0f} contains/s")
        if procs:
            hold_at_path_shapes(f"mesh_procs {label}", run,
                                ("fused_contains",))
            trace = profile_batch(torch, f"mesh_procs {label}", run)
            procs_check(label, (got_h, cstats.host()), ms, trace,
                        sendrecv=variant == "nb")
        else:
            one_proc[label] = (got_h, cstats.host(), ms)

    def mesh16(st16, cache16):
        """The 16-node hamming cells: search, the cap_factor 2 cell with
        its drops, and contains."""
        for variant, routing in (("lsh", "alltoall"), ("nb", "alltoall"),
                                 ("cnb", "alltoall"), ("cnb", "allgather")):
            expect = ("fused_query",) + (() if variant == "lsh"
                                         else ("hamming_words",))
            (ids_m, sc_m, _), stats = mesh_cell(
                16, "hamming", variant, st16, cache16, NQ, expect,
                routing=routing)
            want_i, want_s = one_node[("hamming", variant)]
            if stats["dropped_probes"] != 0:
                raise AssertionError(f"mesh {variant} {routing}: probes "
                                     f"dropped")
            if not (torch.equal(ids_m, want_i) and torch.equal(sc_m, want_s)):
                raise AssertionError(f"mesh n=16 hamming {variant} {routing}"
                                     f": results differ from the 1-node "
                                     f"runtime's")
        mesh_cell(16, "hamming", "cnb", st16, cache16, NQ,
                  ("fused_query", "hamming_words"), cap_factor=2.0)
        for variant in ("cnb", "nb"):
            contains_cell(variant, st16, cache16)
        log("[mesh] n=16 hamming lsh/nb/cnb (alltoall) and cnb (allgather): "
            "ids and scores equal the 1-node runtime's exactly, 0 dropped; "
            "contains nb/cnb equal the 1-node contains")

    st16, cache16 = refreshed(16, "hamming", store_h)
    mesh16(st16, cache16)
    # -- 12. serving: the 16-node mesh backend (serve_mesh) ------------------
    from repro_torch.launch import serve_retrieval as sr_cli
    from repro_torch.serve import (
        FrontendConfig, RetrievalFrontend, RuntimeBackend)

    @contextlib.contextmanager
    def serve_cell(name):
        """Print the wall time and peak device memory of one serve cell."""
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        log(f"[serve] {name}: cell wall {time.perf_counter() - t0:.1f} s, "
            f"peak device bytes {torch.cuda.max_memory_allocated()}")

    @contextlib.contextmanager
    def spied(keep_state):
        """Record the `RuntimeBackend.dispatch_async` calls of the block:
        each batch's backend, padded queries and exclude ids, stage-time
        generation and `PendingDispatch`, and with `keep_state` the store
        and corpus it was staged on (else only the last call is kept)."""
        seen = []
        real = RuntimeBackend.dispatch_async

        def spy(backend, q_pad, ex_pad, m):
            pending = real(backend, q_pad, ex_pad, m)
            rec = types.SimpleNamespace(
                backend=backend, q=q_pad.copy(), ex=ex_pad.copy(), m=m,
                gen=backend.generation, pending=pending,
                store=backend._store if keep_state else None,
                corpus=backend._corpus if keep_state else None)
            if not keep_state:
                seen.clear()
            seen.append(rec)
            return pending

        RuntimeBackend.dispatch_async = spy
        try:
            yield seen
        finally:
            RuntimeBackend.dispatch_async = real

    def stage_syncs(backend, rec):
        """Host syncs of one `dispatch_async` of the batch `rec`, counted
        by torch's sync-debug warnings; the batch is then finished."""
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                pending = backend.dispatch_async(rec.q, rec.ex, rec.m)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        pending.wait()
        return sum("synchroniz" in str(w.message) for w in caught)

    with serve_cell("serve_mesh"):
        backend_m = RuntimeBackend(
            mesh_runtime(16, "hamming", "cnb", m=M + 1), hyperplanes=h,
            store=st16, cache=cache16)
        fe_m = RetrievalFrontend(backend_m, FrontendConfig(
            m=M, max_batch=256, queue_capacity=1024, cache=True))
        q_np, ex_np = x[qids[0]].cpu().numpy(), qids[0].cpu().numpy()

        def serve_twice():
            """The 1024 queries twice: all misses, then all hits."""
            outs = []
            for _ in range(2):
                t0 = time.perf_counter()
                outs.append(fe_m.search(q_np, exclude=ex_np))
                outs.append((time.perf_counter() - t0) * 1e3)
            return outs

        with spied(keep_state=False) as seen_m:
            (ids_m, sc_m), miss_ms, (ids_h, _), hit_ms = counted(
                "serve", ("fused_query", "hamming_words"), serve_twice)
        rt1 = IndexRuntime(RuntimeConfig(params=params, variant="cnb", m=M,
                                         use_kernels=True, score="hamming"),
                           device=dev)
        want_i, want_s, _ = rt1.search(h, store_h, x[qids[0]],
                                       exclude=qids[0])
        st_m = fe_m.stats.summary()
        if not (np.array_equal(ids_m, want_i.cpu().numpy())
                and np.array_equal(sc_m, want_s.cpu().numpy())
                and np.array_equal(ids_h, ids_m)):
            raise AssertionError("serve_mesh: ids differ from the 1-node "
                                 "runtime's")
        if st_m["dropped_probes"] != 0 or st_m["cache_hits"] != NQ:
            raise AssertionError(f"serve_mesh: {st_m}")
        rec_m = seen_m[-1]
        n_sync_m = stage_syncs(backend_m, rec_m)
        hold_at_path_shapes("serve mesh", lambda: backend_m.dispatch(
            rec_m.q, rec_m.ex, M), ("fused_query", "hamming"))
        profile_batch(torch, "serve mesh batch", lambda: backend_m.dispatch(
            rec_m.q, rec_m.ex, M))
        log(f"[serve] serve_mesh: 16 nodes, hamming cnb, alltoall "
            f"cap_factor 16, m+1 headroom, max_batch 256: {NQ} queries "
            f"{miss_ms:.1f} ms as misses ({NQ / miss_ms * 1e3:.0f} "
            f"queries/s, {st_m['batches']} batches), {hit_ms:.1f} ms as "
            f"cache hits; ids and scores equal the 1-node runtime's with "
            f"the self id excluded, exactly; dropped 0; p50 "
            f"{st_m['p50_us']:.0f} us p99 {st_m['p99_us']:.0f} us; host "
            f"syncs in one stage of a {len(rec_m.q)}-row batch {n_sync_m}")
        del backend_m, fe_m, seen_m, rec_m, rt1

    n_dot = 256

    def mesh4(st4, cache4):
        """The 4-node dot cells, equal to the 1-node runtime's up to near
        ties (the mesh scores other rows together)."""
        for variant in ("cnb", "nb"):
            (ids_m, sc_m, _), stats = mesh_cell(
                4, "dot", variant, st4, cache4, n_dot,
                ("fused_query", "bucket_topk"))
            want_i, want_s = one_node[("dot", variant)]
            err, ties = compare_topk(ids_m, sc_m, want_i[:n_dot],
                                     want_s[:n_dot], f"mesh n=4 dot {variant}")
            if stats["dropped_probes"] != 0:
                raise AssertionError(f"mesh n=4 dot {variant}: probes "
                                     f"dropped")
            log(f"[mesh] n=4 dot {variant}: ids equal the 1-node runtime's "
                f"(near-tie swaps {ties}, max score err {err:.3g})")

    st4, cache4 = refreshed(4, "dot", store)
    mesh4(st4, cache4)

    # one insert + payload-sync batch of phase 8's re-announces, then a
    # search, on the 16-node hamming mesh; `latest` is every user's vector
    latest = x.clone()
    latest[re_ids] = moved

    def chain_cell():
        rt = mesh_runtime(16, "hamming", "cnb")
        procs = isinstance(rt.mesh, ProcessZoneMesh)
        label = "mesh n=16 hamming cnb insert + payload_sync + search"

        def run():
            st = rt.shard_store(store_h)
            st = rt.insert(h, st, moved, re_ids.to(torch.int32), 1)
            st = rt.payload_sync(st, latest, hyperplanes=h)
            return st, rt.search(h, st, latest[qids[0]],
                                 cache=rt.refresh_cache(st))

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, (ids_c, sc_c, stats_c) = counted(
            "mesh_procs" if procs else label,
            ("fused_query", "hamming_words"), run)
        ms = (time.perf_counter() - t0) * 1e3
        got = (ids_c, sc_c, stats_c.host(), st.ids, st.timestamps,
               st.write_ptr, st.payload, st.generation)
        hit = float((ids_c[:, 0] == qids[0]).float().mean())
        log(f"[cell] {'processes: ' if procs else ''}{label}: "
            f"{len(re_ids)} re-announces, {ms:.3f} ms in all; self-hit@1 "
            f"{hit:.4f}, dropped {int(stats_c)}")
        if procs:
            trace = profile_batch(torch, f"mesh_procs {label}", run)
            procs_check(label, got, ms, trace, sendrecv=True)
        else:
            one_proc[label] = (*got, ms)

    chain_cell()

    # -- 9 (processes): the same cells on the process mesh ------------------
    # NCCL at world size 1 (the card's only size: NCCL refuses two ranks on
    # one card); every exchange passes the group's collective
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    procs_wall = time.perf_counter()
    init_process_mesh(dev)
    log(f"[procs] process group: backend {tdist.get_backend()}, world "
        f"{tdist.get_world_size()}; mesh {make_zone_mesh(16, device=dev)}")
    st16p, cache16p = refreshed(16, "hamming", store_h)
    mesh16(st16p, cache16p)
    chain_cell()
    st4p, cache4p = refreshed(4, "dot", store)
    mesh4(st4p, cache4p)
    tdist.destroy_process_group()
    log(f"[procs] the process mesh in {time.perf_counter() - procs_wall:.1f}"
        f" s; every cell equal to its one-process cell exactly")
    del cache16, cache4, cache16p, cache4p, st16p, st4p, latest
    one_proc.clear()

    # -- 12. serving: the CLI over the engine backend (serve_closed/open) ---
    def cli_args(**kw):
        """`serve_retrieval`'s arguments at the dense world's widths."""
        a = sr_cli.build_parser().parse_args([])
        a.n, a.d, a.k, a.L, a.m, a.capacity = N, D, K, L, M, C
        a.pool, a.queries, a.offered = 512, 4096, 32
        a.max_batch, a.queue_capacity = 64, 256
        a.churn_every, a.churn_frac, a.ttl_epochs = 50, 0.02, 4
        a.seed, a.device = args.seed, "cuda"
        for key, val in kw.items():
            setattr(a, key, val)
        return a

    def check_not_stale(seen, want=512):
        """Every sampled served miss (a row with an exclude id) equals
        `LshEngine.search` of the same query on the store and corpus of
        the generation it was staged at.  Returns (rows checked, rows
        equal exactly, generations, near-tie swaps)."""
        rows = [(r, i) for r in seen for i in np.flatnonzero(r.ex >= 0)]
        by_gen = {}
        for r, i in rows:
            by_gen.setdefault(r.gen, []).append((r, i))
        per = -(-want // len(by_gen))
        checked = exact = swaps = 0
        for gen, lst in sorted(by_gen.items()):
            pick = lst[::max(1, len(lst) // per)][:per]
            r0 = pick[0][0]
            eng_g = LshEngine(r0.backend.runtime.cfg.params, r0.backend._hp,
                              r0.store, r0.corpus, None,
                              EngineConfig(variant="cnb", use_kernels=True),
                              device=dev)
            qg = np.stack([r.q[i] for r, i in pick])
            res_g = eng_g.search(qg, m=M, exclude=np.array(
                [r.ex[i] for r, i in pick]))
            got_i = np.stack([r.pending.wait()[0][i] for r, i in pick])
            got_s = np.stack([r.pending.wait()[1][i] for r, i in pick])
            _, t = compare_topk(torch.from_numpy(got_i),
                                torch.from_numpy(got_s),
                                torch.from_numpy(res_g.ids),
                                torch.from_numpy(res_g.scores),
                                f"serve_closed generation {gen}")
            swaps += t
            exact += int((got_i == res_g.ids).all(1).sum())
            checked += len(pick)
        if checked < 256:
            raise AssertionError(f"serve_closed: only {checked} served "
                                 f"misses checked")
        return checked, exact, len(by_gen), swaps

    for cache_on in (True, False):
        name = "serve_closed" + ("" if cache_on else " --no-cache")
        with serve_cell(name):
            a = cli_args(no_cache=not cache_on)
            with spied(keep_state=True) as seen_c:
                t0 = time.perf_counter()
                s_c = counted("serve", ("simhash", "bucket_topk"),
                              lambda: sr_cli.run(a))
                wall_c = time.perf_counter() - t0
            sr_cli.smoke_gates(a, s_c)  # the CLI's smoke assertions
            gen_c = seen_c[-1].backend.generation
            checked, exact, n_gen, swaps = check_not_stale(seen_c)
            rec_c = seen_c[-1]
            log(f"[serve] {name}: p50 {s_c['p50_us']:.0f} us p99 "
                f"{s_c['p99_us']:.0f} us, {s_c['qps']:.0f} queries/s, hit "
                f"rate {s_c['hit_rate']:.4f}, messages/query "
                f"{s_c['messages_per_query']:.3f}, rejects "
                f"{s_c['rejected']}, ring_full {s_c['ring_full']}, "
                f"dropped {s_c['dropped_probes']}, batches {s_c['batches']} "
                f"(mean {s_c['mean_batch']:.1f} rows), store generation "
                f"{gen_c}; run wall {wall_c:.1f} s (world build and "
                f"warm-up included); {checked} served misses over {n_gen} "
                f"generations equal LshEngine.search on their generation's "
                f"store ({exact} exactly, near-tie swaps {swaps})")
            if cache_on:
                hold_at_path_shapes("serve closed", lambda: rec_c.backend
                                    .dispatch(rec_c.q, rec_c.ex, M),
                                    ("simhash", "bucket_topk"))
                profile_batch(torch, "serve closed batch", lambda: rec_c
                              .backend.dispatch(rec_c.q, rec_c.ex, M))
            del seen_c, rec_c

    with serve_cell("serve_open"):
        a = cli_args(open_loop=True, pipeline=4)
        in_flight = []
        real_stage = RetrievalFrontend._stage_batch

        def stage_spy(fe):
            real_stage(fe)
            in_flight.append((fe.cfg.pipeline_depth, len(fe._inflight)))

        RetrievalFrontend._stage_batch = stage_spy
        try:
            with spied(keep_state=False) as seen_o:
                ol = counted("serve", ("simhash", "bucket_topk"),
                             lambda: sr_cli.run_openloop(a))
        finally:
            RetrievalFrontend._stage_batch = real_stage
        if not ol["identical"]:
            raise AssertionError("serve_open: pipelined ids != sync ids")
        # the engine backend's stage: no host sync at all
        rec_o = seen_o[-1]
        rec_o.backend.dispatch(rec_o.q, rec_o.ex, M)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            pending = rec_o.backend.dispatch_async(rec_o.q, rec_o.ex, M)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        pending.wait()
        most = {d: max(n for dd, n in in_flight if dd == d) for d in (1, 4)}
        for mode in ("sync", "pipelined"):
            r = ol[mode]
            log(f"[serve] serve_open {mode}: p50 {r.p50_ms:.3f} ms p99 "
                f"{r.p99_ms:.3f} ms, served {r.served_qps:.0f} queries/s "
                f"of {r.offered_qps:.0f} offered, shed {r.shed}, SLO p99 "
                f"<= {a.slo_p99_ms:g} ms "
                f"{'PASS' if r.slo_ok(a.slo_p99_ms) else 'FAIL'}")
        log(f"[serve] serve_open: capacity {ol['capacity']:.0f} queries/s "
            f"(one {a.max_batch}-query batch), rate {ol['rate']:.0f}; "
            f"pipelined ids bit-identical to sync; the engine backend's "
            f"stage made no host sync (sync-debug mode 'error'); most "
            f"batches in flight at once: depth 1 {most[1]}, depth 4 "
            f"{most[4]}")
        open_one_ms = 1e3 * a.max_batch / ol["capacity"]
        del seen_o, rec_o, pending

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
                rows, wall, _ = profile_batch(
                    torch, f"{path} epoch {epoch}", batch)
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

    fails_one, flights_one = {}, {}
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
        fails_one[mode], flights_one[mode] = fail, flight_rows(obs)
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
    creps_one = {mode: (hits, cstats.host(), ms)
                 for mode, (hits, cstats, ms) in creps.items()}
    del kept, creps
    log(f"[p2p] phase 11 in {time.perf_counter() - p2p_wall:.1f} s; peak "
        f"device bytes {torch.cuda.max_memory_allocated()}")

    # -- 12. serving: read/write epochs through the frontend ----------------
    from repro_torch.core.churn import _trajectory as churn_trajectory
    from repro_torch.serve import (
        ServeChurnConfig, ServeFailureConfig, run_serve_churn,
        run_serve_failure, run_serve_reshard)

    with serve_cell("serve_lifecycle"):
        for depth, writer in ((1, False), (4, True)):
            # the direct run records its pipeline spans: where the serving
            # half of its wall time goes (the rest is the trajectory's
            # world, the ground truth and the write epochs)
            obs_sc = Observability() if depth == 1 else None
            t0 = time.perf_counter()
            with served_ids() as sc_ids:
                sc_out = counted("serve", ("simhash", "bucket_topk"),
                                 lambda: run_serve_churn(ServeChurnConfig(
                                     churn=ccfg, pipeline_depth=depth,
                                     use_writer=writer), obs=obs_sc,
                                     device=dev))
            wall = time.perf_counter() - t0
            if writer:  # phase 11b's threaded writer holds against these
                writer_one = (sc_out, sc_ids, wall)
            if obs_sc is not None:
                spans = {}
                for ev in obs_sc.tracer.events():
                    n_ms = spans.setdefault(ev[1], [0, 0.0])
                    n_ms[0] += 1
                    n_ms[1] += ev[4] / 1e3
                log("[serve] run_serve_churn depth 1, span totals (calls, "
                    "ms): " + ", ".join(f"{k} {v[0]} {v[1]:.1f}"
                                        for k, v in spans.items()))
                # the trajectory alone: its numpy world and ground truth,
                # which every churn driver spends before serving a query
                t1 = time.perf_counter()
                for _ in churn_trajectory(ccfg, dev):
                    pass
                torch.cuda.synchronize()
                log(f"[serve] the trajectory alone (world and ground truth, "
                    f"no index): {time.perf_counter() - t1:.1f} s")
            same = np.array_equal(sc_out["recalls"], one["recalls"])
            log(f"[serve] run_serve_churn depth {depth} "
                f"{'writer thread' if writer else 'direct'}: recalls "
                f"{np.round(sc_out['recalls'], 4).tolist()} "
                f"({'equal' if same else 'NOT equal'} to run_churn's), "
                f"repeat mismatches {sc_out['repeat_mismatches']}, hit rate "
                f"{sc_out['summary']['hit_rate']:.4f}, writer installs "
                f"{sc_out['writer_installed']}; {wall:.1f} s, "
                f"{wall * 1e3 / (EPOCHS + 1):.1f} ms per epoch")
            if not same or sc_out["repeat_mismatches"]:
                raise AssertionError(f"run_serve_churn depth {depth}: "
                                     f"recalls differ from run_churn's")
        t0 = time.perf_counter()
        rs_out = counted("serve", ("fused_query",), lambda: run_serve_reshard(
            ServeChurnConfig(churn=ccfg), device=dev))
        wall = time.perf_counter() - t0
        same = np.array_equal(rs_out["recalls"], one["recalls"])
        log(f"[serve] run_serve_reshard: recalls "
            f"{'equal' if same else 'NOT equal'} to run_churn's, swaps "
            f"{rs_out['swaps']}, handoff bytes "
            f"{rs_out['total_handoff_bytes']}, repeat mismatches "
            f"{rs_out['repeat_mismatches']}, stale evictions "
            f"{rs_out['stale_evictions']}; {wall:.1f} s, "
            f"{wall * 1e3 / (EPOCHS + 1):.1f} ms per epoch")
        if not same or rs_out["swaps"] != EPOCHS \
                or rs_out["total_handoff_bytes"] != 0 \
                or rs_out["repeat_mismatches"]:
            raise AssertionError(f"run_serve_reshard: {rs_out}")
        fcfg = ServeFailureConfig(churn=ccfg, n_nodes=4, replication=2,
                                  read_mode="first", kill_epoch=KILL_EPOCH,
                                  kill_node=VICTIM)
        t0 = time.perf_counter()
        with spied(keep_state=False) as seen_f, served_ids() as f_ids:
            f_out = counted("serve", ("fused_query", "bucket_topk"),
                            lambda: run_serve_failure(fcfg, device=dev))
        wall = time.perf_counter() - t0
        f_wall = wall
        g = f_out["generations"]
        # tests/test_failure.py's SERVE_FAILURE assertions
        ok = (f_out["repeat_mismatches"] == 0
              and f_out["degraded"][KILL_EPOCH - 1]
              and not f_out["degraded"][-1]
              and f_out["recall_after_kill"]
              >= f_out["recall_before_kill"] - 0.05
              and g[KILL_EPOCH - 1] > g[KILL_EPOCH - 2]
              and f_out["stale_evictions"] > 0 and f_out["cache_hits"] > 0
              and f_out["replication_bytes"] > 0
              and f_out["recovery_bytes"] > 0
              and f_out["stats"].dropped_probes == 0)
        log(f"[serve] run_serve_failure (4 nodes, R = 2, first, node "
            f"{VICTIM} killed at epoch {KILL_EPOCH}): recalls "
            f"{np.round(f_out['recalls'], 4).tolist()}, before / after the "
            f"kill {f_out['recall_before_kill']:.4f} / "
            f"{f_out['recall_after_kill']:.4f}, degraded "
            f"{f_out['degraded'].tolist()}, stale evictions "
            f"{f_out['stale_evictions']}, cache hits {f_out['cache_hits']}, "
            f"replication bytes {f_out['replication_bytes']}, recovery "
            f"bytes {f_out['recovery_bytes']}, dropped "
            f"{f_out['stats'].dropped_probes}; {wall:.1f} s, "
            f"{wall * 1e3 / (EPOCHS + 1):.1f} ms per epoch; the "
            f"reference's assertions {'hold' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("run_serve_failure: the reference's "
                                 "assertions fail")
        rec_f = seen_f[-1]
        n_sync_f = stage_syncs(rec_f.backend, rec_f)
        hold_at_path_shapes("serve failure", lambda: rec_f.backend.dispatch(
            rec_f.q, rec_f.ex, M), ("fused_query", "bucket_topk"))
        profile_batch(torch, "serve failure batch", lambda: rec_f.backend
                      .dispatch(rec_f.q, rec_f.ex, M))
        log(f"[serve] serve_failure: host syncs in one stage of a "
            f"{len(rec_f.q)}-row replicated mesh batch {n_sync_f}")
        del seen_f, rec_f
    missing = [n for n in ("simhash", "bucket_topk", "fused_query",
                           "hamming_words") if by_path["serve"][n] == 0]
    if missing:
        raise AssertionError(f"serve: kernels never launched: {missing}")

    # -- 11b. the P2P dynamics and serving on the process mesh --------------
    # NCCL at world size 1, as in phase 9 (NCCL refuses two ranks on one
    # card): every mesh the drivers build through make_zone_mesh is then
    # this rank's ProcessZoneMesh, every exchange the group's collective.
    # Each cell equals its one-process cell of phase 11 (or of
    # serve_lifecycle) exactly; the launches add into one path, p2p_procs
    p2p_procs_wall = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    init_process_mesh(dev)
    log(f"[p2p_procs] process group: backend {tdist.get_backend()}, world "
        f"{tdist.get_world_size()}; mesh {make_zone_mesh(4, device=dev)}")

    def epoch_ms_line(path, got, want):
        """ms per announce and per read epoch beside the one-process
        cell's."""
        def split(ep):
            ann = np.arange(len(ep)) % REFRESH == 0
            return ep[ann].mean(), ep[~ann].mean()

        (ga, gr), (wa, wr) = split(got["epoch_ms"]), split(want["epoch_ms"])
        log(f"[p2p_procs] {path}: equal to the one-process run array by "
            f"array; ms per announce epoch {ga:.1f} (one process {wa:.1f}), "
            f"per read epoch {gr:.1f} (one process {wr:.1f})")

    def nccl_profile(label, fn, sendrecv, tries=3):
        """Profile one call; a call that runs a ppermute (`sendrecv`)
        must show `ncclDevKernel_SendRecv`, any other NCCL's `nccl:<op>`
        annotations (at world 1 its even exchanges are one-rank copies
        under them), kept out of device time.  The profiler has lost
        most of a replicate round's device rows in one trace of the
        card (its index_select and index_copy as well as NCCL's, three
        traces in a row once), so each trace follows one profiled
        warm-up call, and a trace without them is taken again, up to
        `tries` traces."""
        for attempt in range(1, tries + 1):
            rows, _, spans = profile_batch(torch, f"p2p_procs {label}", fn,
                                           warmup=1)
            kernels = [r for r in rows if r[2].startswith("ncclDevKernel")]
            notes = [r for r in spans if r[2].startswith("nccl:")]
            if (any("SendRecv" in r[2] for r in kernels) if sendrecv
                    else notes):
                break
            log(f"[p2p_procs] {label}: trace {attempt} of {tries} shows "
                f"{len(kernels)} NCCL kernels and {len(notes)} NCCL "
                f"annotations among {len(rows)} device rows")
        else:
            raise AssertionError(f"p2p_procs {label}: no trace of {tries} "
                                 f"shows its NCCL rows")
        log(f"[p2p_procs] {label}: NCCL kernels "
            f"{sum(r[0] for r in kernels):.3f} device ms in "
            f"{sum(r[1] for r in kernels)} launches "
            f"({', '.join(sorted({r[2] for r in kernels})) or 'none'}); "
            f"NCCL annotations {sum(r[1] for r in notes)} spanning "
            f"{sum(r[0] for r in notes):.3f} ms")

    def procs_hook(mode):
        """Keep the pre-kill and kill-epoch states (ids only) for the
        contains cell; at the kill epoch hold fused_query against plain
        on one read batch, and for `first` profile that batch and one
        replicate round, outside the launch counts."""
        keep = keep_ids(mode)

        def hook(st):
            if st.epoch not in (KILL_EPOCH - 1, KILL_EPOCH):
                return
            keep(st)
            if st.epoch != KILL_EPOCH:
                return
            if not isinstance(st.rt.mesh, ProcessZoneMesh):
                raise AssertionError("p2p_procs: not on the process mesh")

            def batch():
                return st.rt.search(st.hyperplanes, st.store, st.queries,
                                    cache=st.cache, replicas=st.replicas,
                                    live=st.live)

            with uncounted():
                hold_at_path_shapes(f"p2p_procs failure_{mode} epoch "
                                    f"{KILL_EPOCH}", batch, ("fused_query",))
                if mode == "first":
                    nccl_profile(f"read batch ({mode}, node {VICTIM} dead)",
                                 batch, sendrecv=False)
                    nccl_profile("replicate round (R = 2, 4 nodes)",
                                 lambda: st.rt.replicate_store(st.store),
                                 sendrecv=True)
        return hook

    kept = {}
    for mode in ("first", "quorum"):
        obs = Observability()
        fail_p = counted("p2p_procs", ("fused_query",),
                         lambda: run_failure_churn(
                             FailureChurnConfig(churn=ccfg, n_nodes=4,
                                                replication=2, read_mode=mode,
                                                kills=((KILL_EPOCH, VICTIM),)),
                             obs=obs, device=dev, on_read=procs_hook(mode)))
        same_result(f"p2p_procs failure_{mode}", fail_p, fails_one[mode])
        if flight_rows(obs) != flights_one[mode]:
            raise AssertionError(f"p2p_procs failure_{mode}: flight records "
                                 "differ from the one-process run's")
        epoch_ms_line(f"failure_{mode} (flight records equal too)", fail_p,
                      fails_one[mode])
    creps_p = counted("p2p_procs", ("fused_contains",), contains_cell)
    for mode, (hits, cstats, ms) in creps_p.items():
        want_h, want_s, want_ms = creps_one[mode]
        if not (torch.equal(hits, want_h) and cstats.host() == want_s):
            raise AssertionError(f"p2p_procs contains_replicated {mode}: "
                                 "differs from the one-process cell")
        log(f"[p2p_procs] contains_replicated {mode} on the killed mesh: "
            f"hits and counters equal to the one-process cell; {ms:.3f} ms "
            f"per batch of {NQ} (one process {want_ms:.3f} ms)")
        hold_at_path_shapes(f"p2p_procs contains_replicated {mode}",
                            lambda: contains_at(mode, KILL_EPOCH),
                            ("fused_contains",))
    node_p = counted("p2p_procs", ("fused_query",), lambda: run_node_churn(
        NodeChurnConfig(churn=ccfg, schedule=sched), device=dev))
    same_result("p2p_procs node_churn", node_p, node)
    epoch_ms_line(f"node_churn {sched}", node_p, node)
    t0 = time.perf_counter()
    with spied(keep_state=False) as seen_p, served_ids() as p_ids:
        fp_out = counted("p2p_procs", ("fused_query", "bucket_topk"),
                         lambda: run_serve_failure(fcfg, device=dev))
    wall = time.perf_counter() - t0
    rec_p = seen_p[-1]
    if not isinstance(rec_p.backend.runtime.mesh, ProcessZoneMesh):
        raise AssertionError("p2p_procs serve_failure: not on the process "
                             "mesh")
    same_result("p2p_procs serve_failure", fp_out, f_out)
    if len(p_ids) != len(f_ids) or not all(
            np.array_equal(a, b) for a, b in zip(p_ids, f_ids)):
        raise AssertionError("p2p_procs serve_failure: served ids differ "
                             "from the one-process run's")
    log(f"[p2p_procs] serve_failure through RuntimeBackend on the process "
        f"mesh: {len(p_ids)} searches, ids, recalls and serving counters "
        f"equal to the one-process run; {wall:.1f} s, "
        f"{wall * 1e3 / (EPOCHS + 1):.1f} ms per epoch (one process "
        f"{f_wall:.1f} s)")
    hold_at_path_shapes("p2p_procs serve failure", lambda: rec_p.backend
                        .dispatch(rec_p.q, rec_p.ex, M),
                        ("fused_query", "bucket_topk"))
    got = by_path["p2p_procs"]
    if not (got["fused_query"] and got["fused_contains"]
            and (got["bucket_topk"] or got["hamming_words"])):
        raise AssertionError(f"p2p_procs: kernels never launched: {got}")

    # -- 12 (item 6c): serving under the controller rank, on the group ------
    # open-loop serving on serve_closed's world (rank 0 announces every
    # batch), serve_lifecycle's threaded writer (its install point agreed
    # at each stage boundary), and a threaded writer whose preps run a
    # 4-node mesh's insert, expire and cache refresh over the writer's own
    # NCCL group while the controller serves; launches on path serve_procs
    import torch_dist_worker as dist_worker
    from repro_torch.serve.control import Controller

    ctl_wall = time.perf_counter()
    a6 = cli_args(open_loop=True, pipeline=4)
    with spied(keep_state=False) as seen_6:
        ol6 = counted("serve_procs", ("simhash", "bucket_topk"),
                      lambda: sr_cli.run_openloop(a6))
    if ol6["control"] is None or not ol6["identical"]:
        raise AssertionError("serve_procs open loop: not under a controller, "
                             "or pipelined ids != sync ids")
    ol_stream = dist_worker.stream_arrays("openloop", ol6["control"])
    rec6 = seen_6[-1]
    ol_backend = rec6.backend
    del seen_6
    def call_ms(fn):
        """The host ms of one call of `fn`."""
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    def batch6():
        ol_backend.dispatch(rec6.q, rec6.ex, rec6.m)

    # a stage under the controller: no host sync, as serve_open's stage;
    # then the recorded batch dispatched and reaped under it, with the
    # group but no controller, and its announce alone, in turn, 30 times
    with Controller.of_world().leading(ol_backend) as ctl6:
        ol_backend.dispatch(rec6.q, rec6.ex, rec6.m)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            pending = ol_backend.dispatch_async(rec6.q, rec6.ex, rec6.m)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        pending.wait()
        disp6 = {"controller": [], "group": [], "announce": []}
        with gc_paused():
            for _ in range(30):
                disp6["controller"].append(call_ms(batch6))
                ol_backend.control = None
                disp6["group"].append(call_ms(batch6))
                ol_backend.control = ctl6
                disp6["announce"].append(call_ms(lambda: ctl6.dispatch(
                    rec6.q, rec6.ex, rec6.m)))
    hold_at_path_shapes("serve_procs open loop", lambda: ol_backend.dispatch(
        rec6.q, rec6.ex, rec6.m), ("simhash", "bucket_topk"))
    t0 = time.perf_counter()
    with served_ids() as w6_ids:
        w6_out = counted("serve_procs", ("simhash", "bucket_topk"),
                         lambda: run_serve_churn(ServeChurnConfig(
                             churn=ccfg, pipeline_depth=4, use_writer=True),
                             device=dev))
    w6_wall = time.perf_counter() - t0
    sc_one, ids_one, wall_one = writer_one
    if not (np.array_equal(w6_out["recalls"], one["recalls"])
            and len(w6_ids) == len(ids_one)
            and all(np.array_equal(x6, y6) for x6, y6 in zip(w6_ids, ids_one))
            and w6_out["writer_installed"] == sc_one["writer_installed"]):
        raise AssertionError("serve_procs run_serve_churn: the threaded "
                             "writer's run differs from the one-process one")
    log(f"[serve_procs] run_serve_churn through the threaded writer on the "
        f"group: recalls equal run_churn's, {len(w6_ids)} searches' ids "
        f"equal the one-process run's, writer installs "
        f"{w6_out['writer_installed']}; {w6_wall:.1f} s (one process "
        f"{wall_one:.1f} s)")
    rng6 = np.random.default_rng(args.seed + 6)
    x6 = torch.from_numpy(rng6.standard_normal((65536, D),
                                               dtype=np.float32)).to(dev)
    x6 /= torch.linalg.vector_norm(x6, dim=1, keepdim=True)
    p6 = LshParams(d=D, k=K, L=L, seed=args.seed + 6)
    h6 = make_hyperplanes(p6, torch.Generator().manual_seed(args.seed + 6),
                          device=dev)
    w6 = dict(params=p6, h=h6, q=x6[:48], store=build_store_host(
        ops.simhash(x6, h6), NB, 64, payload=x6, device=dev))
    t0 = time.perf_counter()
    kept6 = []
    wc6 = counted("serve_procs", ("fused_query",),
                  lambda: dist_worker.writer_under_control(w6, 1, dev,
                                                           keep=kept6))
    wc6_ms = (time.perf_counter() - t0) * 1e3
    n_wc6 = int((~wc6["writer/kinds"]).sum())
    if not (bool(wc6["writer/own_groups"]) and int(wc6["writer/installed"])
            == dist_worker.WRITER_JOBS and int(wc6["writer/kinds"].sum())):
        raise AssertionError(f"serve_procs writer under control: {wc6}")
    # the first batch of the stream, on the last store the writer installed
    rows6 = int(wc6["writer/arg"][~wc6["writer/kinds"]][0])
    m6 = int(wc6["writer/m"][~wc6["writer/kinds"]][0])
    hold_at_path_shapes("serve_procs writer", lambda: kept6[0].dispatch(
        wc6["writer/q"][:rows6], wc6["writer/ex"][:rows6], m6),
        ("fused_query",))
    got = by_path["serve_procs"]
    if not (got["simhash"] and got["bucket_topk"] and got["fused_query"]):
        raise AssertionError(f"serve_procs: kernels never launched: {got}")
    tdist.destroy_process_group()
    # the recorded streams replayed in one process (no process group):
    # through the kernels, exactly; through the plain versions (the same
    # stores: the writer's updates prepared once), up to near ties
    with uncounted():
        t0 = time.perf_counter()
        re_ol = dist_worker.replay(ol_stream, "openloop", ol_backend)
        re_ol_ms = (time.perf_counter() - t0) * 1e3
        fe1, be1, prep1, _ = dist_worker.writer_world(w6, 1, dev)
        ups = [prep1(be1.runtime, j) for j in range(dist_worker.WRITER_JOBS)]
        t0 = time.perf_counter()
        re_wc = dist_worker.replay(wc6, "writer", be1, ups)
        re_wc_ms = (time.perf_counter() - t0) * 1e3
        ol_plain = RuntimeBackend(
            IndexRuntime(dataclasses.replace(ol_backend.runtime.cfg,
                                             use_kernels=False), device=dev),
            hyperplanes=ol_backend._hp, store=ol_backend._store,
            corpus=ol_backend._corpus)
        pl_ol, pl_ol_s = dist_worker.replay(ol_stream, "openloop", ol_plain,
                                            scores=True)
        _, be_p, _, _ = dist_worker.writer_world(w6, 1, dev,
                                                 use_kernels=False)
        pl_wc, pl_wc_s = dist_worker.replay(wc6, "writer", be_p, ups,
                                            scores=True)
        with gc_paused():
            disp6["one process"] = [call_ms(batch6) for _ in range(30)]
    n_ol = int((~ol_stream["openloop/kinds"]).sum())
    if not (np.array_equal(re_ol, ol_stream["openloop/ids"])
            and np.array_equal(re_wc, wc6["writer/ids"])):
        raise AssertionError("serve_procs: a replay of the recorded stream "
                             "in one process differs from the served ids")
    # raises where an id differs outside a near tie, or a score by > TIE
    swaps6 = dict(
        openloop=topk_swaps(pl_ol_s, pl_ol, ol_stream["openloop/scores"],
                            ol_stream["openloop/ids"], tol=TIE),
        writer=topk_swaps(pl_wc_s, pl_wc, wc6["writer/scores"],
                          wc6["writer/ids"], tol=TIE))
    log(f"[serve_procs] the served streams against their replay through "
        f"the plain versions: ids equal up to near ties (id swaps "
        f"{swaps6}), scores within {TIE:g}; a stage under the controller "
        f"made no host sync (sync-debug mode 'error')")
    log(f"[serve_procs] one {len(rec6.q)}-row open-loop batch, dispatched "
        f"and reaped, median ms of 30 (host clock): "
        + ", ".join(f"{k} {np.median(v):.3f}" for k, v in disp6.items())
        + " (controller: under it; group: the NCCL group alive, no "
        "controller; announce: the controller's header and batch alone; "
        "one process: after the group is destroyed)")
    log(f"[serve_procs] open loop under the controller: {n_ol} dispatches "
        f"announced and served; sync == pipelined ids; the one-process "
        f"replay of the stream gives the same ids exactly; a "
        f"{a6.max_batch}-query batch {1e3 * a6.max_batch / ol6['capacity']:.3f}"
        f" ms under the controller (one process, serve_open: "
        f"{open_one_ms:.3f} ms); replay {re_ol_ms / n_ol:.3f} ms a batch")
    log(f"[serve_procs] threaded writer under the controller on the 4-node "
        f"process mesh (65536 users, its preps over the writer's own NCCL "
        f"group): {n_wc6} dispatches, installs at events "
        f"{np.flatnonzero(wc6['writer/kinds']).tolist()}; the one-process "
        f"replay gives the same ids exactly; {wc6_ms / n_wc6:.3f} ms a "
        f"batch with the preps alongside (one-process replay "
        f"{re_wc_ms / n_wc6:.3f} ms a batch); item 6c cells in "
        f"{time.perf_counter() - ctl_wall:.1f} s")
    del ol6, ol_stream, ol_backend, w6_out, w6_ids, writer_one, x6, w6, \
        wc6, fe1, be1, ups, rec6, pending, kept6, ol_plain, be_p
    log(f"[p2p_procs] phase 11b in {time.perf_counter() - p2p_procs_wall:.1f}"
        f" s; every cell equal to its one-process cell exactly")
    del (kept, creps_p, creps_one, fails_one, flights_one, fail_p, node_p,
         fp_out, seen_p, rec_p, p_ids, f_ids)

    # -- 14. the LM serving path (DESIGN.md Sec. 4) -------------------------
    # the index worlds of phases 3-12 are gone; what is left is small
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as lm_serve
    from repro_torch.models import layers as lm_layers
    from repro_torch.models import model as lm
    from repro_torch.models.config import count_params

    log(f"[lm] device bytes in use {torch.cuda.memory_allocated()} after "
        f"the index phases")

    @contextlib.contextmanager
    def lm_cell(name):
        """Print the wall time and peak device memory of one LM cell."""
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        log(f"[lm] {name}: cell wall {(time.perf_counter() - t0) * 1e3:.1f} "
            f"ms, peak device bytes {torch.cuda.max_memory_allocated()} "
            f"({smi})")

    def weight_bytes(model):
        return sum(p.numel() * p.element_size() for p in model.parameters())

    def lm_generate(model, batch, gen, max_len):
        """The serving driver's prefill and decode steps, as
        `launch.serve.generate` runs them, with a CUDA event after the
        prefill and after each decode step and no host sync in between:
        (tokens [B, gen], prefill ms, [decode step ms], wall ms).  An
        event pair spans the device timeline, idle gaps included, so a
        step's time is its serving pace."""
        prefill = lm_serve.make_prefill_step(model.cfg, max_len)
        decode = lm_serve.make_decode_step(model.cfg)
        pos0 = sum(batch[k].shape[1] for k in ("tokens", "prefix_embeds")
                   if k in batch)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(gen + 1)]
        torch.cuda.synchronize()
        with gc_paused():
            t0 = time.perf_counter()
            ev[0].record()
            logits, states = prefill(model, batch)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            ev[1].record()
            out = [tok]
            for t in range(gen - 1):
                tok, _, states = decode(model, states, tok, pos0 + t)
                out.append(tok)
                ev[t + 2].record()
            toks = torch.stack(out, dim=1)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        ms = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
        return toks, ms[0], ms[1:], wall

    def lm_serve_run(name, model, batch, gen):
        """Greedy generation through `launch.serve.generate` (the warm-up),
        then a timed run of the same steps, which must give the same
        tokens, all in [0, vocab).  Prints the timed run's prefill ms,
        median decode step ms and tokens/s beside the bounds:
        the decode step's weight bytes over the memory rate, and the
        prefill's 2 x active params x prompt tokens over the bf16 and fp32
        peaks.  Returns the median decode step ms."""
        cfg = model.cfg
        prompt = sum(batch[k].shape[1] for k in ("tokens", "prefix_embeds")
                     if k in batch)
        max_len = prompt + gen + 8
        want = lm_serve.generate(model, batch, steps=gen, max_len=max_len)
        toks, pre_ms, steps, wall = lm_generate(model, batch, gen, max_len)
        if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
            raise AssertionError(f"{name}: a token outside [0, vocab)")
        if not torch.equal(toks, want):
            raise AssertionError(f"{name}: the timed run's tokens differ "
                                 f"from generate's")
        b = toks.shape[0]
        med = float(np.median(steps))
        rate = b * gen / wall * 1e3
        dec_b = weight_bytes(model) / HBM_BYTES_PER_S * 1e3
        n_tok = b * prompt
        # the active parameters (an MoE's top-k experts; all, when dense)
        act = count_params(cfg, active_only=True)
        pre_b16 = 2.0 * act * n_tok / BF16_FLOPS_PER_S * 1e3
        pre_b32 = 2.0 * act * n_tok / FP32_FLOPS_PER_S * 1e3
        log(f"[lm] {name}: {cfg.name} batch {b} prompt "
            f"{batch['tokens'].shape[1]} gen {gen}: prefill {pre_ms:.3f} ms "
            f"(bound {pre_b16:.3f} ms at the bf16 peak, {pre_b32:.3f} ms at "
            f"the fp32 peak the f32 products run at), decode step median "
            f"{med:.3f} ms (min {min(steps):.3f}, max {max(steps):.3f}; "
            f"bound {dec_b:.3f} ms: {weight_bytes(model)} weight bytes over "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s), {rate:.1f} tokens/s, wall "
            f"{wall:.1f} ms ({smi})")
        return med

    def teacher_forced(model, b, s, steps):
        """Max |prefill + decode_step logits - forward logits| at the same
        positions: prefill of s tokens, then `steps` teacher-forced
        decode steps, against one forward over s + steps tokens."""
        batch = lm_serve.make_batch(model.cfg, b, s + steps, args.seed, dev)
        off = batch["prefix_embeds"].shape[1] if "prefix_embeds" in batch \
            else 0
        full = lm.forward(model, batch)
        want = lm.logits_from_hidden(model, full[:, off + s - 1:
                                                 off + s + steps])
        del full
        last, states = lm.prefill(model, dict(
            batch, tokens=batch["tokens"][:, :s]), max_len=off + s + steps)
        errs = [(last - want[:, 0]).abs().max()]
        for t in range(steps):
            lg, states = lm.decode_step(model, batch["tokens"][:, s + t],
                                        states, off + s + t)
            errs.append((lg - want[:, t + 1]).abs().max())
        return float(torch.stack(errs).max())

    def lm_step_profile(name, model, batch, gen):
        """One decode step traced on a state of the prompt: device ops a
        step and the busy share."""
        prompt = batch["tokens"].shape[1]
        logits, states = lm.prefill(model, batch, prompt + gen + 8)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        decode = lm_serve.make_decode_step(model.cfg)
        decode(model, states, tok, prompt)
        rows, wall, _ = profile_batch(
            torch, f"{name} decode step",
            lambda: decode(model, states, tok, prompt + 1), top=12)
        busy = sum(r[0] for r in rows)
        ops_n = sum(r[1] for r in rows)
        log(f"[lm] {name} decode step: {ops_n} device ops (kernels and "
            f"copies) a step, {ops_n / model.cfg.num_layers:.1f} a layer; "
            f"busy share {busy / wall:.3f}: "
            f"{'host-bound' if busy / wall < 0.5 else 'device-bound'}")

    def lm_no_sync(name, model, batch, gen):
        """Prefill and 7 decode steps under sync-debug "error"."""
        prompt = batch["tokens"].shape[1]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            lm_serve.generate(model, batch, steps=8,
                              max_len=prompt + gen + 8)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        log(f"[lm] {name}: prefill and 7 decode steps ran under "
            f"set_sync_debug_mode('error'): no host sync")

    gemma = get_config("gemma2-2b")
    lm_wall = time.perf_counter()
    with lm_cell("lm_gemma2"):
        g16 = lm.init_model(gemma, args.seed, device=dev)
        log(f"[lm] gemma2-2b: {weight_bytes(g16)} bf16 weight bytes, "
            f"{count_params(gemma):.0f} params; every product after the "
            f"embedding runs in f32 (the reference's sqrt(d_model) scale "
            f"is a numpy f64 scalar, which promotes bf16)")
        batch = lm_serve.make_batch(gemma, 8, 512, args.seed, dev)
        med = lm_serve_run("lm_gemma2", g16, batch, 64)
        log(f"[lm] lm_gemma2: decode step median {med:.3f} ms beside "
            f"{LM_GEMMA2_DECODE_MS_BEFORE} ms before the model axis's "
            f"per-layer split checks (the one-card path runs them as "
            f"no-ops; host-clock spread between runs ~10 %) ({smi})")
        lm_step_profile("lm_gemma2", g16, batch, 64)
        lm_no_sync("lm_gemma2", g16, batch, 64)
    with lm_cell("lm_gemma2_long"):
        batch = lm_serve.make_batch(gemma, 1, 5120, args.seed, dev)
        chunked = []
        real_chunked = lm_layers._sdpa_qchunked

        def counting(*a, **kw):
            chunked.append(1)
            return real_chunked(*a, **kw)

        lm_layers._sdpa_qchunked = counting
        try:
            lm_serve_run("lm_gemma2_long", g16, batch, 16)
        finally:
            lm_layers._sdpa_qchunked = real_chunked
        # generate's prefill and the timed one: every layer q-chunked
        if len(chunked) != 2 * gemma.num_layers:
            raise AssertionError(f"lm_gemma2_long: {len(chunked)} q-chunked "
                                 f"attentions, expected "
                                 f"{2 * gemma.num_layers}")
        log(f"[lm] lm_gemma2_long: prefill of 5120 tokens took the q-chunked "
            f"path in all {gemma.num_layers} layers; the 4096 window bites "
            f"in the {gemma.num_layers // 2} local layers")
    with lm_cell("lm_check"):
        g32 = lm.init_model(dataclasses.replace(gemma, dtype="float32"),
                            args.seed, device=dev)
        for b, s in ((2, 512), (1, 5120)):
            e32 = teacher_forced(g32, b, s, 8)
            e16 = teacher_forced(g16, b, s, 8)
            log(f"[lm] lm_check teacher-forced, batch {b} x prompt {s} + 8 "
                f"steps: max |prefill/decode - forward| logits f32 {e32:.3g} "
                f"(gate 1e-3), bf16 weights {e16:.3g}")
            if e32 > 1e-3:
                raise AssertionError(f"lm_check {b}x{s}: f32 teacher-forced "
                                     f"error {e32} > 1e-3")
        del g32, g16
        gc.collect()
        torch.cuda.empty_cache()
        # the card against the CPU: full width cut to 2 layers (one local,
        # one global), the same weights, forward logits on 2 x 64 tokens
        cut = dataclasses.replace(gemma, dtype="float32", num_layers=2)
        g2 = lm.init_model(cut, args.seed, device=dev)
        g2_cpu = lm.Model(cut, device="cpu")
        g2_cpu.load_state_dict(g2.state_dict())
        batch = lm_serve.make_batch(cut, 2, 64, args.seed, dev)
        on_card = lm.logits_from_hidden(g2, lm.forward(g2, batch)).cpu()
        on_cpu = lm.logits_from_hidden(g2_cpu, lm.forward(
            g2_cpu, {k: v.cpu() for k, v in batch.items()}))
        e_cpu = float((on_card - on_cpu).abs().max())
        log(f"[lm] lm_check card vs CPU, gemma2-2b full width cut 26 -> 2 "
            f"layers, forward logits on 2 x 64 tokens: max |diff| {e_cpu:.3g}"
            f" (gate 1e-3)")
        if e_cpu > 1e-3:
            raise AssertionError(f"lm_check: card != CPU ({e_cpu})")
        del g2, g2_cpu, on_card, on_cpu
    for arch in ("starcoder2-7b", "codeqwen1.5-7b", "phi3-medium-14b",
                 "seamless-m4t-medium", "phi-3-vision-4.2b"):
        cfg = get_config(arch)
        with lm_cell(f"lm_archs {arch}"):
            model = lm.init_model(cfg, args.seed, device=dev)
            batch = lm_serve.make_batch(cfg, 4, 64, args.seed, dev)
            lm_serve_run(f"lm_archs {arch}", model, batch, 32)
            del model, batch
            gc.collect()
            torch.cuda.empty_cache()
            cut = dataclasses.replace(
                cfg, dtype="float32", num_layers=2,
                encoder_layers=min(cfg.encoder_layers, 2))
            err = teacher_forced(lm.init_model(cut, args.seed, device=dev),
                                 2, 64, 8)
            log(f"[lm] lm_archs {arch}: f32 teacher-forced at full width cut "
                f"to 2 layers: {err:.3g} (gate 1e-3)")
            if err > 1e-3:
                raise AssertionError(f"lm_archs {arch}: teacher-forced error "
                                     f"{err} > 1e-3")
    def embed_index(name, model, U, N_COMM):
        """DESIGN.md Sec. 4 at full width: U users of 64 tokens in N_COMM
        communities sharing a 32-token prefix, embedded by `model` in
        batches of 256 (mean-pooled final hidden, unit-normalised),
        indexed (k = 10, L = 4, C = 64) and searched (cnb, m = 10, own id
        excluded) through the kernels on path `lm`: the same-community
        share, the kernel ids against plain, contains hitting every own
        id its L exact buckets still hold (a bucket keeps its last C
        writers); the kernels held against plain on the recorded
        inputs.  Returns how many of the queries' own ids contains
        found."""
        cfg = model.cfg
        SEQ, PRE, NQ_LM, CAP_LM = 64, 32, 1024, 64
        rng_lm = np.random.default_rng(args.seed)
        comm = rng_lm.integers(0, N_COMM, U)
        toks = rng_lm.integers(0, cfg.vocab_size, (U, SEQ))
        toks[:, :PRE] = rng_lm.integers(0, cfg.vocab_size,
                                        (N_COMM, PRE))[comm]
        toks = torch.from_numpy(toks.astype(np.int32)).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        parts = []
        for s0 in range(0, U, 256):
            hidden = lm.forward(model, {"tokens": toks[s0:s0 + 256]})
            e = hidden.mean(dim=1).float()
            parts.append(e / torch.linalg.vector_norm(e, dim=1, keepdim=True))
        emb = torch.cat(parts)
        torch.cuda.synchronize()
        embed_ms = (time.perf_counter() - t0) * 1e3 / (U // 256)
        del hidden, parts
        lshp = LshParams(d=cfg.d_model, k=10, L=4, seed=args.seed)
        h_lm = make_hyperplanes(lshp, device=dev)
        qi = torch.arange(NQ_LM, device=dev)
        ex_np = np.arange(NQ_LM)

        def index_and_search():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            codes = sketch_codes_batched(emb, h_lm)
            st = build_store_host(codes, lshp.num_buckets, CAP_LM,
                                  payload=emb, device=dev)
            torch.cuda.synchronize()
            build_ms = (time.perf_counter() - t0) * 1e3
            ids_st = BucketStore(st.ids, st.timestamps, st.write_ptr, None)
            eng = LshEngine(lshp, h_lm, ids_st, DenseCorpus(emb), None,
                            EngineConfig(variant="cnb", use_kernels=True),
                            device=dev)
            rt_lm = IndexRuntime(RuntimeConfig(
                params=lshp, variant="cnb", m=M, use_kernels=True),
                device=dev)
            with gc_paused():
                t0 = time.perf_counter()
                r = eng.search(emb[:NQ_LM], m=M, exclude=ex_np)
                eng_ms = (time.perf_counter() - t0) * 1e3
                t0 = time.perf_counter()
                ids, sc, _ = rt_lm.search(h_lm, st, emb[:NQ_LM], exclude=qi)
                torch.cuda.synchronize()
                rt_ms = (time.perf_counter() - t0) * 1e3
                t0 = time.perf_counter()
                hits, _ = rt_lm.contains(h_lm, st, emb[:NQ_LM], qi)
                torch.cuda.synchronize()
                ct_ms = (time.perf_counter() - t0) * 1e3
            return (st, ids_st, eng, rt_lm, r, ids, sc, hits,
                    dict(build_ms=build_ms, engine_search_ms=eng_ms,
                         runtime_search_ms=rt_ms, contains_ms=ct_ms))

        (st_lm, ids_lm, eng, rt_lm, r, ids, sc, hits, times) = counted(
            "lm", ("simhash", "bucket_topk", "fused_query", "fused_contains"),
            index_and_search)
        occ_lm = st_lm.occupancy()
        share = float(np.mean([comm[j] == comm[i]
                               for i in range(NQ_LM) for j in r.ids[i]
                               if j >= 0]))
        plain_eng = LshEngine(lshp, h_lm, ids_lm, DenseCorpus(emb), None,
                              EngineConfig(variant="cnb"), device=dev)
        rp = plain_eng.search(emb[:NQ_LM], m=M, exclude=ex_np)
        swaps_e = topk_swaps(rp.scores, rp.ids, r.scores, r.ids, tol=TIE)
        rt_plain = IndexRuntime(RuntimeConfig(params=lshp, variant="cnb",
                                              m=M), device=dev)
        ids_p, sc_p, _ = rt_plain.search(h_lm, st_lm, emb[:NQ_LM], exclude=qi)
        swaps_r = topk_swaps(sc_p.cpu(), ids_p.cpu(), sc.cpu(), ids.cpu(),
                             tol=TIE)
        n_hit = int(hits.sum())
        # an own id missing from all L of its exact buckets was ring-evicted
        # (each bucket keeps its last C writers): contains must miss it
        own = sketch_codes_batched(emb[:NQ_LM], h_lm).long() % lshp.num_buckets
        stored = (st_lm.ids[torch.arange(lshp.L, device=dev)[None, :], own]
                  == qi[:, None, None]).any(-1).any(-1)
        if not torch.equal(hits, stored | hits):
            raise AssertionError(f"{name}: contains missed a stored "
                                 "own id")
        log(f"[lm] {name}: {cfg.name}, {U} users of {SEQ} tokens in {N_COMM} "
            f"communities sharing a {PRE}-token prefix; embed "
            f"{embed_ms:.1f} ms per 256 users; index (simhash sketch + "
            f"build_store_host, k=10 L=4 C={CAP_LM}) {times['build_ms']:.1f} "
            f"ms, bucket occupancy mean {float(occ_lm.float().mean()):.2f} "
            f"max {int(occ_lm.max())}, |mean unit embedding| "
            f"{float(emb.mean(0).norm()):.4f}; {NQ_LM} queries: engine cnb "
            f"{times['engine_search_ms']:.2f} ms, runtime dot "
            f"{times['runtime_search_ms']:.2f} ms, contains "
            f"{times['contains_ms']:.2f} ms a batch; same-community share "
            f"{share:.4f} (gate > 0.6); kernel ids equal plain with near-tie "
            f"swaps engine {swaps_e}, runtime {swaps_r}; contains of own id "
            f"{n_hit} of {NQ_LM}, {NQ_LM - int(stored.sum())} own ids "
            f"ring-evicted from all L buckets ({smi})")
        if share <= 0.6:
            raise AssertionError(f"{name}: community share {share}")
        with uncounted():
            hold_at_path_shapes("lm", lambda: (
                eng.search(emb[:NQ_LM], m=M, exclude=ex_np),
                rt_lm.search(h_lm, st_lm, emb[:NQ_LM], exclude=qi),
                rt_lm.contains(h_lm, st_lm, emb[:NQ_LM], qi)),
                ("simhash", "bucket_topk", "fused_query", "fused_contains"))
        del st_lm, ids_lm, eng, rt_lm, emb, plain_eng, rt_plain
        return n_hit

    with lm_cell("lm_embed_index"):
        g16 = lm.init_model(gemma, args.seed, device=dev)
        n_hit = embed_index("lm_embed_index", g16, 8192, 256)
        del g16
        if n_hit != 1024:
            raise AssertionError(f"lm_embed_index: {1024 - n_hit} own ids "
                                 f"missed by contains")
    # -- 14, the recurrent mixers and MoE: xlstm-1.3b, deepseek-moe-16b,
    # jamba-v0.1-52b and llama4-maverick-400b-a17b, bf16 weights from
    # --seed at the published widths (jamba and llama4 cut in depth)
    from repro_torch.models import moe as lm_moe
    from repro_torch.models import ssm as lm_ssm
    from repro_torch.models import xlstm as lm_xlstm

    new_wall = time.perf_counter()

    @contextlib.contextmanager
    def dropless(model):
        """The MoE layers' capacity factor raised to E / k: cap covers
        every token, so prefill, decode and forward, which route different
        token counts (and so drop differently at the configured factor),
        compute the same function."""
        cfg = model.cfg
        saved = [(m, m.cfg) for m in model.modules()
                 if isinstance(m, lm_moe.Moe)]
        for m, c in saved:
            m.cfg = dataclasses.replace(
                c, moe_capacity_factor=cfg.moe_num_experts / cfg.moe_top_k)
        try:
            yield
        finally:
            for m, c in saved:
                m.cfg = c

    def lm_teacher_check(name, model):
        """lm_check's teacher-forced gate, 2 x 64 prompt + 8 steps, MoE
        layers dropless, every product after the embedding in f32: gated
        on the arch at full width cut to 2 layers (bf16 weights from
        --seed, as lm_archs cuts), and read ungated on the cell's own
        model.  Random weights amplify f32 rounding with depth in the
        recurrent stacks: xlstm's teacher-forced error on the CPU is
        7e-6 at 2 blocks, 7.6e-4 at 16 and 0.78 at 48."""
        cfg = model.cfg
        with dropless(model):
            deep = teacher_forced(model, 2, 64, 8)
        cut_cfg = dataclasses.replace(cfg, num_layers=2,
                                      scan_period=min(cfg.scan_period, 2))
        cut = (model if cfg.num_layers == 2
               else lm.init_model(cut_cfg, args.seed, device=dev))
        with dropless(cut):
            err = teacher_forced(cut, 2, 64, 8)
        kinds = [cut_cfg.layer_kind(i) + ("+moe" if cut_cfg.layer_is_moe(i)
                                          else "") for i in range(2)]
        log(f"[lm] lm_check teacher-forced {cfg.name} at full width cut to "
            f"2 layers {kinds}{', MoE dropless' if cfg.moe_num_experts else ''}"
            f", batch 2 x prompt 64 + 8 steps: max |prefill/decode - "
            f"forward| logits {err:.3g} (gate 1e-3); {name}'s own "
            f"{cfg.num_layers}-layer model {deep:.3g} (not gated)")
        if err > 1e-3:
            raise AssertionError(f"lm_check {cfg.name}: teacher-forced error "
                                 f"{err} > 1e-3")
        del cut

    def moe_report(name, model, batch, gen):
        """The MoE cells' extra lines: the decode step's second bound (the
        active parameters' bytes), the capacities, and the share of
        (token, expert) pairs dropped in the prefill and in each decode
        step of one `generate`, read from each layer's aux after it."""
        cfg = model.cfg
        b, prompt = batch["tokens"].shape
        act_b = count_params(cfg, active_only=True) * 2
        log(f"[lm] {name}: decode step bounds {weight_bytes(model)} weight "
            f"bytes ({weight_bytes(model) / HBM_BYTES_PER_S * 1e3:.3f} ms: "
            f"the capacity dispatch runs every expert's slots, full or "
            f"empty) and {act_b:.0f} active-parameter bytes "
            f"({act_b / HBM_BYTES_PER_S * 1e3:.3f} ms: top-{cfg.moe_top_k} "
            f"of {cfg.moe_num_experts} experts a token) over "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s")
        fracs = []
        real = lm_moe.moe

        def recording(p, x):
            y, aux = real(p, x)
            fracs.append(aux.dropped_fraction)
            return y, aux

        lm_moe.moe = recording
        try:
            lm_serve.generate(model, batch, steps=gen,
                              max_len=prompt + gen + 8)
        finally:
            lm_moe.moe = real
        n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.num_layers))
        per = torch.stack(fracs).reshape(gen, n_moe).mean(dim=1).cpu()
        log(f"[lm] {name}: capacity {lm_moe.capacity(cfg, b * prompt)} slots "
            f"an expert in the prefill ({b} x {prompt} tokens), "
            f"{lm_moe.capacity(cfg, b)} in a decode step ({b} tokens, "
            f"top-{cfg.moe_top_k} of {cfg.moe_num_experts}, factor "
            f"{cfg.moe_capacity_factor}); dropped (token, expert) pairs, "
            f"mean over {n_moe} MoE layers: prefill {float(per[0]):.4f}, "
            f"decode steps median {float(per[1:].median()):.4f} (min "
            f"{float(per[1:].min()):.4f}, max {float(per[1:].max()):.4f})")

    xcfg = get_config("xlstm-1.3b")
    with lm_cell("lm_xlstm"):
        x16 = lm.init_model(xcfg, args.seed, device=dev)
        log(f"[lm] xlstm-1.3b: {weight_bytes(x16)} bf16 weight bytes, "
            f"{count_params(xcfg):.0f} params, {xcfg.num_layers} blocks "
            f"(mLSTM / sLSTM alternating, no MLP)")
        batch = lm_serve.make_batch(xcfg, 8, 512, args.seed, dev)
        lm_serve_run("lm_xlstm", x16, batch, 32)
        lm_step_profile("lm_xlstm", x16, batch, 32)
        # the sLSTM's time loop at the prefill's shape, one layer
        hx = torch.randn((8, 512, xcfg.d_model), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(
                             args.seed)) * 0.5
        lm_xlstm.slstm_with_state(x16.blocks[1].slstm, hx)
        torch.cuda.synchronize()
        with gc_paused():
            t0 = time.perf_counter()
            lm_xlstm.slstm_with_state(x16.blocks[1].slstm, hx)
            host = time.perf_counter() - t0
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        n_sl = sum(xcfg.layer_kind(i) == "slstm"
                   for i in range(xcfg.num_layers))
        log(f"[lm] lm_xlstm sLSTM time loop, batch 8 x 512 steps, one layer: "
            f"{host / 512 * 1e3:.4f} host ms a time step (enqueue), "
            f"{wall / 512 * 1e3:.4f} ms a step to the sync; the prefill "
            f"runs {n_sl} such layers, {n_sl * 512} host steps "
            f"({n_sl * wall * 1e3:.1f} ms at this pace)")
        del hx
        lm_no_sync("lm_xlstm", x16, batch, 32)
        lm_teacher_check("lm_xlstm", x16)
    with lm_cell("lm_xlstm_long"):
        # long_500k (configs/shapes.py LONG_CAPABLE): the state is fixed-
        # size and no xLSTM layer reads the position, so decode steps at
        # 524 272-524 287 give the logits of steps at 1024-1039
        batch = lm_serve.make_batch(xcfg, 1, 1024, args.seed, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, states = lm.prefill(x16, batch, 1024 + 16)
        tok0 = torch.argmax(logits, dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3
        st_bytes = sum(t.numel() * t.element_size()
                       for st in states for t in st.values())

        def steps_at(pos0):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(17)]
            st, tok, out = states, tok0, []
            ev[0].record()
            for t in range(16):
                lg, st = lm.decode_step(x16, tok, st, pos0 + t)
                tok = torch.argmax(lg, dim=-1).to(torch.int32)
                out.append(lg)
                ev[t + 1].record()
            torch.cuda.synchronize()
            ms = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
            return (torch.stack(out), torch.cuda.max_memory_allocated(),
                    float(np.median(ms)))

        lm.decode_step(x16, tok0, states, 1024)  # warm-up at batch 1
        short, peak_s, ms_s = steps_at(1024)
        far, peak_l, ms_l = steps_at(524272)
        same = torch.equal(short, far)
        log(f"[lm] lm_xlstm_long: prefill 1 x 1024 {pre_ms:.1f} ms; state "
            f"{st_bytes} bytes for all {xcfg.num_layers} layers; 16 greedy "
            f"decode steps at 524272-524287: median {ms_l:.3f} ms a step, "
            f"peak {peak_l} device bytes; at 1024-1039: {ms_s:.3f} ms, peak "
            f"{peak_s}; logits equal: {same} (a prefill of 524288 tokens is "
            f"not run: {n_sl * 524288} host steps of the sLSTM loop)")
        if not same:
            raise AssertionError("lm_xlstm_long: the logits at 524272 differ "
                                 "from those at 1024")
        if abs(peak_l - peak_s) > 0.01 * peak_s:
            raise AssertionError(f"lm_xlstm_long: peak {peak_l} is not within "
                                 f"1 % of {peak_s}")
        del logits, states, short, far
    with lm_cell("lm_embed_index_xlstm"):
        before = dict(by_path.get("lm", {}))
        embed_index("lm_embed_index_xlstm", x16, 4096, 128)
        log(f"[lm] lm_embed_index_xlstm launches: "
            f"{ {n: c - before.get(n, 0) for n, c in by_path['lm'].items()} }")
        del x16

    def moe_cell(name, cfg, b, prompt, gen, cut=None):
        model = lm.init_model(cfg, args.seed, device=dev)
        log(f"[lm] {name}: {cfg.name} at full width, {weight_bytes(model)} "
            f"bf16 weight bytes, {count_params(cfg):.0f} params "
            f"({count_params(cfg, active_only=True):.0f} active)"
            + (f"; cut {cut}" if cut else ""))
        batch = lm_serve.make_batch(cfg, b, prompt, args.seed, dev)
        lm_serve_run(name, model, batch, gen)
        moe_report(name, model, batch, gen)
        lm_step_profile(name, model, batch, gen)
        lm_no_sync(name, model, batch, gen)
        lm_teacher_check(name, model)
        return model

    with lm_cell("lm_moe"):
        moe_cell("lm_moe", get_config("deepseek-moe-16b"), 8, 512, 32)
    jamba = get_config("jamba-v0.1-52b")
    with lm_cell("lm_hybrid"):
        j16 = moe_cell("lm_hybrid", dataclasses.replace(jamba, num_layers=8),
                       4, 256, 16, cut=f"32 -> 8 layers (one period: 1 "
                       f"attention, 7 mamba, 4 MoE); the whole model "
                       f"{count_params(jamba) * 2 / 1e9:.1f} GB in bf16")
        # the mamba scan's working set: one layer at the prefill's shape
        hj = torch.randn((4, 256, jamba.d_model), device=dev) * 0.5
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        lm_ssm.mamba_with_state(j16.blocks[1].mamba, hj)
        ev[1].record()
        torch.cuda.synchronize()
        n4 = 4 * 256 * jamba.d_inner * jamba.mamba_d_state * 4
        log(f"[lm] lm_hybrid mamba layer, batch 4 x 256 (one chunk): "
            f"{ev[0].elapsed_time(ev[1]):.3f} ms, working set "
            f"{torch.cuda.max_memory_allocated() - base} bytes above its "
            f"input, {(torch.cuda.max_memory_allocated() - base) / n4:.1f} "
            f"x one [B, Q, di, N] f32 tensor ({n4} bytes)")
        del j16, hj
    llama4 = get_config("llama4-maverick-400b-a17b")
    with lm_cell("lm_llama4"):
        moe_cell("lm_llama4", dataclasses.replace(llama4, num_layers=2), 4,
                 64, 16, cut=f"48 -> 2 layers (one dense and one MoE); the "
                 f"whole model {count_params(llama4) * 2 / 1e9:.1f} GB in "
                 f"bf16")
    with lm_cell("lm_check, recurrent and MoE"):
        # the card against the CPU, full width cut to 2 layers, forward
        # logits on 2 x 64 tokens; for MoE first each token's expert ids
        routes = []
        real_route = lm_moe.route

        def recording(p, x):
            out = real_route(p, x)
            routes.append((out[1], out[3]))
            return out

        for arch in ("xlstm-1.3b", "deepseek-moe-16b"):
            cut = dataclasses.replace(get_config(arch), dtype="float32",
                                      num_layers=2)
            m_card = lm.init_model(cut, args.seed, device=dev)
            m_cpu = lm.Model(cut, device="cpu")
            m_cpu.load_state_dict(m_card.state_dict())
            batch = lm_serve.make_batch(cut, 2, 64, args.seed, dev)
            lm_moe.route = recording
            try:
                on_card = lm.logits_from_hidden(
                    m_card, lm.forward(m_card, batch)).cpu()
                n_card = len(routes)
                on_cpu = lm.logits_from_hidden(m_cpu, lm.forward(
                    m_cpu, {k: v.cpu() for k, v in batch.items()}))
            finally:
                lm_moe.route = real_route
            # a token whose expert ids differ must sit on a near tie of
            # the CPU's k-th and (k+1)-th router probabilities
            tied = torch.zeros(on_cpu.shape[:2], dtype=torch.bool)
            k = cut.moe_top_k
            for (_, i_card), (p_cpu, i_cpu) in zip(routes[:n_card],
                                                   routes[n_card:]):
                differ = (i_card.cpu().sort(-1).values
                          != i_cpu.sort(-1).values).any(-1)
                top = p_cpu.sort(-1, descending=True).values
                near = (top[..., k - 1] - top[..., k]) < 1e-6
                if bool((differ & ~near).any()):
                    raise AssertionError(f"lm_check {arch}: expert ids differ "
                                         f"between card and CPU away from a "
                                         f"near tie")
                tied |= differ
            routes.clear()
            keep = ~tied
            e_cpu = float((on_card - on_cpu).abs()[keep].max())
            log(f"[lm] lm_check card vs CPU, {arch} full width cut to 2 "
                f"layers, f32, forward logits on 2 x 64 tokens: max |diff| "
                f"{e_cpu:.3g} (gate 1e-3)"
                + (f"; expert ids equal but for {int(tied.sum())} tokens on "
                   f"a near tie (< 1e-6), left out of the gate"
                   if cut.moe_num_experts else ""))
            if e_cpu > 1e-3:
                raise AssertionError(f"lm_check {arch}: card != CPU ({e_cpu})")
            del m_card, m_cpu, on_card, on_cpu
    log(f"[lm] recurrent and MoE cells in "
        f"{time.perf_counter() - new_wall:.1f} s")
    log(f"[lm] phase 14 in {time.perf_counter() - lm_wall:.1f} s")

    # -- 15. [examples]: the port's examples on the card and on the CPU ----
    ex_wall = time.perf_counter()
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import torch_quickstart
    import torch_retrieval_serve

    qs_lines = {"card": [], "cpu": []}
    qs = {"card": counted("examples", ("simhash",),
                          lambda: torch_quickstart.run(
                              device=dev, log=qs_lines["card"].append)),
          "cpu": torch_quickstart.run(device="cpu",
                                      log=qs_lines["cpu"].append)}
    # the near-tie rule: each variant's ids, and the oracle's, card
    # against CPU; a table row may differ only where they hold a near tie
    swaps = {v: topk_swaps(qs["cpu"][v]["scores"], qs["cpu"][v]["ids"],
                           qs["card"][v]["scores"], qs["card"][v]["ids"])
             for v in torch_quickstart.VARIANTS + ("ideal",)}
    for row_card, row_cpu in zip(qs_lines["card"], qs_lines["cpu"]):
        v = row_card.split()[0]
        if row_card != row_cpu and not (
                v in swaps and swaps[v] + swaps["ideal"]
                and row_card.split()[1] == row_cpu.split()[1]):
            raise AssertionError(f"examples quickstart: card row "
                                 f"{row_card!r} != CPU row {row_cpu!r}")
    card = qs["card"]
    if not (card["cnb"]["messages"] == card["lsh"]["messages"]
            and card["cnb"]["recall"] > card["lsh"]["recall"]):
        raise AssertionError("examples quickstart: cnb does not beat lsh at "
                             "lsh's messages")
    for row in qs_lines["card"]:
        log(f"[examples] quickstart | {row}")
    exact = qs_lines["card"] == qs_lines["cpu"]
    log(f"[examples] quickstart: the card's table equals the CPU's "
        f"{'exactly' if exact else 'up to near ties'} (near-tie id swaps "
        f"by variant {swaps}); cnb {card['cnb']['recall']:.3f} against lsh "
        f"{card['lsh']['recall']:.3f} recall@10 at "
        f"{card['lsh']['messages']:.0f} messages")
    # one draw of the weights for both devices (a generator on the card
    # draws other numbers than one on the CPU)
    from repro_torch.configs import get_config
    from repro_torch.models import model as lm_model

    rs_model = lm_model.init_model(get_config("gemma2-2b", smoke=True), 0,
                                   device="cpu")
    rs_lines = {"card": [], "cpu": []}
    rs = {"card": counted("examples", ("simhash", "bucket_topk"),
                          lambda: torch_retrieval_serve.run(
                              device=dev, model=copy.deepcopy(rs_model).to(
                                  dev), log=rs_lines["card"].append)),
          "cpu": torch_retrieval_serve.run(device="cpu", model=rs_model,
                                           log=rs_lines["cpu"].append)}

    def no_latency(lines):
        return [row.split("; p99 latency")[0] for row in lines]

    if no_latency(rs_lines["card"]) != no_latency(rs_lines["cpu"]):
        raise AssertionError(f"examples retrieval_serve: card lines "
                             f"{rs_lines['card']} != CPU lines "
                             f"{rs_lines['cpu']}")
    for row in rs_lines["card"]:
        log(f"[examples] retrieval_serve | {row}")
    # the served ids: the CPU's, or different only within near ties (a
    # score more than TIE from the CPU's, or an id swapped outside a near
    # tie, raises)
    same_ids = np.array_equal(rs["card"]["ids"], rs["cpu"]["ids"])
    swaps_rs = 0 if same_ids else topk_swaps(
        rs["cpu"]["scores"], rs["cpu"]["ids"], rs["card"]["scores"],
        rs["card"]["ids"], tol=TIE)
    hold_at_path_shapes("examples retrieval_serve", lambda:
                        torch_retrieval_serve.run(
                            device=dev, model=copy.deepcopy(rs_model).to(dev),
                            log=lambda *_: None),
                        ("simhash", "bucket_topk"))
    log(f"[examples] retrieval_serve: the card's lines equal the CPU's (the "
        f"p99 latency aside; CPU: {rs_lines['cpu'][-1].split('; ')[-1]}); "
        f"served ids {'equal' if same_ids else 'equal up to near ties'} to "
        f"the CPU's (one weight draw; near-tie id swaps {swaps_rs}); phase "
        f"in {time.perf_counter() - ex_wall:.1f} s")
    del qs, rs

    # -- 16. [train]: training on one card; no kernel of the six ---------
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launches()
    p16 = train_phase(torch, dev, smi, args.seed)
    if any(ops.LAUNCHES.values()):
        raise AssertionError(f"train: launched an index kernel "
                             f"{dict(ops.LAUNCHES)}")
    log(f"[launches] train (phase 16, not a kernel path): "
        f"{dict(ops.LAUNCHES)}")

    # -- 17. [train_mesh]: training on several devices, at world 1 -------
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launches()
    train_mesh_phase(torch, dev, smi, args.seed, p16)
    if any(ops.LAUNCHES.values()):
        raise AssertionError(f"train_mesh: launched an index kernel "
                             f"{dict(ops.LAUNCHES)}")
    log(f"[launches] train_mesh (phase 17, not a kernel path): "
        f"{dict(ops.LAUNCHES)}")

    # -- 18. [dryrun]: the dry run against phase 16's step ---------------
    ops.reset_launches()
    dryrun_phase(p16, smi)
    if any(ops.LAUNCHES.values()):
        raise AssertionError(f"dryrun: launched an index kernel "
                             f"{dict(ops.LAUNCHES)}")
    log(f"[launches] dryrun (phase 18, not a kernel path): "
        f"{dict(ops.LAUNCHES)}")

    # -- 13. kernels line ---------------------------------------------------
    for name, k in kernels.items():
        k["launches"] = sum(got[name] for got in by_path.values())
        k["launches_by_path"] = {p: got[name] for p, got in by_path.items()}
    missing = [n for n in expected if kernels[n]["launches"] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    log(f"[kernels] launches in phases 5-12, 14 and 15: "
        f"{ {n: k['launches'] for n, k in kernels.items()} }")
    log(smi)
    log(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
