"""Online retrieval frontend: request ring, dynamic batching, admission
control, and the pipelined dispatch machine (DESIGN.md Sec. 7 + 13).

Turns the batch-oriented query runtimes into an online service without
adding a serving-only query path:

  * requests land in a FIXED-CAPACITY ring (`submit`); the sketch-keyed
    result cache (`repro_torch.serve.qcache`) is consulted AT INTAKE — a
    hit is answered immediately and never occupies a ring slot or a
    dispatch-queue slot, so cache hits cannot be backpressured by queued
    misses; a miss beyond ring capacity gets the RETRYABLE `RING_FULL`
    pushback, an over-committed service sheds with `ADMIT_REJECT` — two
    distinct, counted outcomes (`ServeStats.ring_full` vs `.rejected`);
  * the step machine coalesces up to `max_batch` pending requests, pads
    the batch to a power of two (a BOUNDED set of dispatch shapes — at
    most log2(max_batch)+1 — instead of one per arrival count), and
    STAGES it onto a depth-K device queue (`FrontendConfig.
    pipeline_depth`): on the card the stage enqueues the step and the
    copies of its results into pinned host memory, then returns before
    the batch computes, so batch N+1 is staged while batch N runs, and
    completions are REAPED out of order by ticket (`wait`/`poll`) once
    the CUDA event recorded after the copies has fired.
    `pipeline_depth=1` is the synchronous path — stage then block — and
    pipelined served ids are bit-identical to it under any schedule
    (tests/test_torch_pipeline.py proves it on a deterministic one);
  * dispatch goes through ONE backend — `RuntimeBackend` — wrapping an
    `IndexRuntime` search step on ANY topology (DESIGN.md Sec. 8): over
    the 1-node runtime of an `LshEngine` it returns ids bit-identical to
    a direct `engine.search`; over a mesh runtime it runs the mesh step
    with host-side self-exclusion and one result of headroom.  The store
    (and corpus/cache) are step ARGUMENTS, and a staged batch holds
    references to every tensor its step reads, so a churn update may
    install BETWEEN dispatches (`apply_update`, the background-writer
    path) without draining: the in-flight batch completes as if
    serialized before the update, and its results are cached at its
    stage-time generation, which the update's bump makes stale on the
    next lookup.
"""

from __future__ import annotations

import dataclasses
import time
import zlib

import numpy as np
import torch
import torch.distributed as tdist

from repro_torch.core import costmodel
from repro_torch.core import metrics as metrics_mod
from repro_torch.core import plan as plan_mod
from repro_torch.core.engine import LshEngine
from repro_torch.core.runtime import IndexRuntime, process_world
from repro_torch.obs.flight import QueryRecord
from repro_torch.obs.trace import span_or_null
from repro_torch.serve.qcache import QueryCache
from repro_torch.serve.telemetry import ServeStats

NO_EXCLUDE = -2  # matches LshEngine.search's "no self id" sentinel


class SubmitReject:
    """Falsy `submit` outcome carrying WHY the request was not admitted.

    `retryable=True` (`RING_FULL`) means transient backpressure: the ring
    has no free slot right now, but a `step`/`pump` will drain it — the
    caller should retry.  `retryable=False` (`ADMIT_REJECT`) means
    admission control shed the request because the service is
    over-committed (`FrontendConfig.admit_limit`) — retrying immediately
    is pointless.  Instances are module-level singletons, so callers may
    compare with `is`; truthiness is False either way, so
    `if not ticket:` treats both as failure (note ticket 0 is a VALID
    ticket — compare against the sentinels or `isinstance`, never
    truthiness, when the distinction matters)."""

    __slots__ = ("reason", "retryable")

    def __init__(self, reason: str, retryable: bool):
        self.reason = reason
        self.retryable = retryable

    def __bool__(self) -> bool:
        return False

    def __repr__(self) -> str:
        return f"SubmitReject({self.reason!r}, retryable={self.retryable})"


RING_FULL = SubmitReject("ring_full", retryable=True)
ADMIT_REJECT = SubmitReject("admission", retryable=False)


def pow2_pad(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor) — the dispatch shape grid."""
    n = max(int(n), int(floor), 1)
    return 1 << (n - 1).bit_length()


def dispatch_pad(n: int, multiple: int = 1) -> int:
    """Dispatch size for `n` live rows: the smallest multiple of
    `multiple` >= pow2_pad(n).  `multiple` is a sharded backend's slice
    count — the global batch must divide evenly over the mesh, which a
    bare power of two does not guarantee on non-pow-2 meshes.  Still a
    bounded shape set: each pow-2 value maps to exactly one padded size."""
    m = max(int(multiple), 1)
    return -(-pow2_pad(n) // m) * m


# -----------------------------------------------------------------------------
# the dispatch backend (one class, any topology)
# -----------------------------------------------------------------------------


class PendingDispatch:
    """One in-flight search step: its results on their way to the host,
    plus enough context to finish host-side.

    `RuntimeBackend.dispatch_async` returns one of these BEFORE the batch
    computes.  On the card the step's ids and scores are copied into
    pinned host buffers with non-blocking copies, and a CUDA event is
    recorded after the copies: `ready()` is a non-blocking query of that
    event, and `wait()` — the only place the host waits for the device —
    synchronizes on it, then finishes host-side (on a mesh backend, the
    self-exclusion).  On the CPU the step has run when `dispatch_async`
    returns, so `ready()` is True.

    The batch holds references to every tensor its step read (store,
    corpus, cache, replicas) until `wait()`: a backend update installed
    while the batch is in flight cannot free memory it still reads, nor
    change how it finishes (exclusion row and m are captured at dispatch
    time).  The step's `StepStats` stays on the device until reap."""

    __slots__ = ("_backend", "_raw", "_ex", "_m", "_distributed", "_done",
                 "_event", "_inputs")

    def __init__(self, backend, raw, ex_pad, m, distributed, event=None,
                 inputs=()):
        self._backend = backend
        self._raw = raw
        self._ex = ex_pad
        self._m = m
        self._distributed = distributed
        self._done = None
        self._event = event
        self._inputs = inputs

    def ready(self) -> bool:
        """True once the results have reached the host (non-blocking)."""
        if self._done is not None or self._event is None:
            return True
        return bool(self._event.query())

    def wait(self):
        """Block until complete; returns (ids, scores, stats) host-side."""
        if self._done is None:
            with span_or_null(self._backend.tracer, "serve/compute"):
                if self._event is not None:
                    self._event.synchronize()
            self._done = self._backend._finish(
                self._raw, self._ex, self._m, self._distributed
            )
            # drop the result buffers and the step's inputs
            self._raw = self._event = self._inputs = None
        return self._done


class RuntimeBackend:
    """THE dispatch adapter: an `IndexRuntime` search step behind the
    frontend, on any topology.

    Built from an `LshEngine` (its 1-node runtime + store + corpus: result
    ids are bit-identical to a direct `engine.search`) or from a mesh or
    1-node `IndexRuntime` (+ hyperplanes/store/cache).  Either way the
    runtime's search step takes the store, corpus and cache as
    ARGUMENTS, so a churn update (`update`) swaps state without
    rebuilding anything.

    `traces` / `sketch_traces`: PyTorch compiles nothing per shape, so
    these count what a jit would retrace on — the distinct dispatch
    shapes, each the first time it is dispatched in a binding: `(pad,
    m)` for the search step, `pad` for `sketch_codes`.  A topology swap
    (`update(runtime=...)`) starts a new binding and keeps the running
    totals, so the pow-2 shape-budget assertions keep their meaning.

    The one topology-dependent branch is exclusion: the 1-node step
    excludes in-kernel (the reference semantics), while the mesh step has
    no exclusion (the id is not secret, paper Sec. 6) — the runtime is
    built with one result of headroom (`cfg.m = serve_m + 1`) and the
    self id is filtered host-side, the churn drivers' convention.
    `dropped_probes` from the capacitated router flows through to the
    telemetry (structurally 0 on one node).

    In a world of several processes (a `ProcessZoneMesh` runtime, or any
    runtime under a process group) every rank runs its frontend and must
    dispatch the same batches in the same order.  In lockstep (a closed
    loop, every rank forming the same batches) each dispatch checks that
    across the ranks first and raises `RuntimeError` where they differ.
    Under a controller (`control`, `repro_torch.serve.control`) rank 0
    announces each dispatch to the other ranks, which dispatch what
    they receive.
    """

    def __init__(self, source, hyperplanes=None, store=None, corpus=None,
                 cache=None, replicas=None, live=None):
        if isinstance(source, LshEngine):
            runtime = source.runtime
            hyperplanes = source.hyperplanes if hyperplanes is None \
                else hyperplanes
            store = source.store if store is None else store
            corpus = source.corpus if corpus is None else corpus
        elif isinstance(source, IndexRuntime):
            runtime = source
            if hyperplanes is None or store is None:
                raise ValueError(
                    "RuntimeBackend(IndexRuntime) needs hyperplanes= and "
                    "store="
                )
        else:
            raise TypeError(f"expected LshEngine or IndexRuntime, got "
                            f"{type(source).__name__}")
        if runtime.is_distributed and corpus is not None:
            raise ValueError("corpus scoring is 1-node only (mesh shards "
                             "embed payloads in their bucket slots)")
        if not runtime.is_distributed and cache is not None:
            raise ValueError("neighbor caches exist only on mesh runtimes "
                             "(the 1-node topology has no node bits)")
        if runtime.cfg.replication > 1 and replicas is None:
            raise ValueError(
                "cfg.replication > 1 needs replicas= "
                "(IndexRuntime.replicate_store)"
            )
        if runtime.cfg.replication == 1 and (replicas is not None
                                             or live is not None):
            raise ValueError("replicas/live require cfg.replication > 1")
        self._rt = runtime
        self._hp = runtime._put(hyperplanes, torch.float32)
        self._store = store
        self._corpus = corpus
        self._cache = cache
        self._replicas = replicas
        self._live = self._live_arr(runtime, live)
        self._generation = int(store.generation)
        self._cost_gen: int | None = None
        self._cost: costmodel.QueryCost | None = None
        self.traces = 0
        self.sketch_traces = 0
        # observability hooks — host-side only: the frontend installs a
        # Tracer here when built with obs; the exact-rescoring corpus
        # cache backs the sampled recall probe
        self.tracer = None
        self._exact_vecs: np.ndarray | None = None
        # the controller of a run across processes (serve.control), set
        # on every rank while it leads or follows
        self.control = None
        self._bind()
        self._settle_cost()

    def _bind(self) -> None:
        """(Re)bind the dispatch to the CURRENT runtime.

        Called at construction and again on every topology swap
        (`update(runtime=...)`): the step, the dispatch shape grid and the
        exclusion discipline are all functions of the runtime, so a
        resharded runtime gets a fresh binding and a fresh set of seen
        shapes.  `traces` keeps accumulating across rebinds."""
        runtime = self._rt
        self._step = runtime.search_step_fn(
            with_corpus=not runtime.is_distributed
            and self._corpus is not None)
        self._shapes: set = set()
        self._sketch_shapes: set = set()

    @staticmethod
    def _live_arr(runtime, live):
        if runtime.cfg.replication == 1:
            return None
        if live is None:
            return np.ones(runtime.cfg.n_nodes, np.int32)
        return np.array(live, np.int32)

    @property
    def runtime(self) -> IndexRuntime:
        return self._rt

    @property
    def device(self) -> torch.device:
        return self._rt.device

    @property
    def dim(self) -> int:
        return self._hp.shape[-1]

    @property
    def min_batch(self) -> int:
        # the global batch shards over every mesh slice, so dispatch sizes
        # must be multiples of the slice count (dispatch_pad enforces it;
        # 1 on the 1-node runtime)
        return self._rt.n_devices

    @property
    def max_m(self) -> int | None:
        if not self._rt.is_distributed:
            return None  # m is a call argument — no baked ceiling
        return self._rt.cfg.m - 1  # headroom for host-side self-exclusion

    @property
    def generation(self) -> int:
        return self._generation

    def update(self, store=None, corpus=None, cache=None, *,
               runtime=None, hyperplanes=None, replicas=None,
               live=None) -> None:
        """Install new store state (and/or corpus / refreshed neighbor
        cache) — a write epoch.  The host-side generation snapshot is what
        cache lookups compare against, so it is read here, once per
        update, off the query path.  It bumps on EVERY update, even when
        the store object is unchanged: a corpus swap or NB-cache refresh
        also changes scores, so cached results must die with it.

        `runtime=` accepts a RESHARDED runtime (a membership round,
        DESIGN.md Sec. 9): the dispatch is rebound to the new topology
        and `store=` (the migrated store, placed by the reshard) becomes
        mandatory.  The generation bump is what keeps the sketch-keyed
        cache honest across the swap.  The NB cache never survives a swap
        (its shape is topology-bound): pass the rewarmed one or it resets
        to None.  A pre-existing corpus is dropped when swapping to a mesh
        runtime, whose shards embed payloads in their bucket slots.
        Callers serving live traffic should swap through
        `RetrievalFrontend.update_backend`, which drains in-flight batches
        on the OLD topology first.

        `replicas=`/`live=` install fresh replica slices and a liveness
        mask on a replicated backend (DESIGN.md Sec. 10) — the failure
        path: a kill or a revival arrives as `update(store=...,
        replicas=..., live=...)` with NO runtime swap, so serving
        continues on the same binding (m-headroom preserved) while the
        generation bump kills every pre-failure cached result."""
        # -- validate the whole request before mutating anything ----------
        new_rt = self._rt if runtime is None else runtime
        if runtime is not None and store is None:
            raise ValueError(
                "a topology swap must install the migrated store "
                "(reshard returns it)"
            )
        if runtime is not None and runtime.is_distributed \
                and store.payload is None:
            # the mesh dispatch scores embedded slot payloads; an ids-only
            # store would only fail later, with the backend already mutated
            raise ValueError(
                "swapping to a mesh runtime needs a payload-carrying "
                "store (mesh shards embed payloads in their bucket slots)"
            )
        if runtime is None and hyperplanes is not None:
            raise ValueError("hyperplanes only change with a runtime swap")
        if corpus is not None and new_rt.is_distributed:
            # same guard as __init__: the mesh dispatch path scores slot
            # payloads and would silently ignore an installed corpus
            raise ValueError("corpus scoring is 1-node only (mesh shards "
                             "embed payloads in their bucket slots)")
        if corpus is not None and self._corpus is None and runtime is None:
            # the dispatch was bound for slot-payload scoring at
            # construction; a late corpus would go unread
            raise ValueError("this backend was built without a corpus "
                             "(slot-payload scoring); corpus swaps need a "
                             "corpus-built backend")
        if cache is not None and not new_rt.is_distributed:
            raise ValueError("neighbor caches exist only on mesh runtimes "
                             "(the 1-node topology has no node bits)")
        if new_rt.cfg.replication == 1 and (replicas is not None
                                            or live is not None):
            raise ValueError("replicas/live require cfg.replication > 1")
        if runtime is not None and runtime.cfg.replication > 1 \
                and replicas is None:
            raise ValueError(
                "swapping to a replicated runtime needs replicas= "
                "(IndexRuntime.replicate_store)"
            )

        # -- apply (each field assigned once; _bind reads the final state)
        if store is not None:
            self._store = store
        if corpus is not None:
            self._corpus = corpus
            self._exact_vecs = None  # recall-probe ground truth died too
        if cache is not None:
            self._cache = cache
        if replicas is not None:
            self._replicas = replicas
        if live is not None:
            self._live = self._live_arr(new_rt, live)
        if runtime is not None:
            self._rt = runtime
            if hyperplanes is not None:
                self._hp = runtime._put(hyperplanes, torch.float32)
            # topology-bound state never crosses a swap: a mesh target
            # scores slot payloads (no corpus), and the NB cache dies
            # unless the rewarmed one arrived with the swap
            if runtime.is_distributed:
                self._corpus = None
                self._exact_vecs = None
            if cache is None:
                self._cache = None
            # replica state is topology-bound too: an unreplicated target
            # drops it; a replicated one resets liveness to all-ones
            # unless the swap brought a mask along
            if runtime.cfg.replication == 1:
                self._replicas = None
                self._live = None
            elif live is None:
                self._live = self._live_arr(runtime, None)
            self._bind()
        self._generation = max(int(self._store.generation),
                               self._generation + 1)
        self._settle_cost()

    def _settle_cost(self) -> None:
        """On a process mesh of several ranks, read the store's occupancy
        (a collective) now, at install time, which every rank reaches in
        one order, and not at reap time, which it may not."""
        mesh = self._rt.mesh
        if mesh is not None and mesh.world > 1:
            self.cost()

    def _batch_guard(self, q_pad: np.ndarray, ex_pad: np.ndarray,
                     m: int) -> None:
        """In a world of several processes every rank must dispatch the
        same batch: all-gather (rows, m, a checksum of the query bytes,
        one of the excludes) and raise on a mismatch, before any step
        collective can hang or answer for another batch."""
        world = process_world()
        if world == 1:
            return
        mine = torch.tensor(
            [q_pad.shape[0], m, zlib.crc32(np.ascontiguousarray(q_pad)),
             zlib.crc32(np.ascontiguousarray(ex_pad))], dtype=torch.int64,
            device=self.device)
        every = mine.new_empty(world * mine.numel())
        tdist.all_gather_into_tensor(every, mine)
        every = every.reshape(world, -1).cpu()
        if not bool((every == every[0]).all()):
            raise RuntimeError(
                f"ranks dispatch different batches (rows, m, query and "
                f"exclude checksums by rank: {every.tolist()}): every rank "
                "must form the same batches in the same order")

    def _put(self, x: np.ndarray, dtype) -> torch.Tensor:
        """A private device copy of a host array: on the card through
        pinned memory with a non-blocking copy (no host sync), on the CPU
        a clone (a numpy buffer is never shared with a step)."""
        src = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type == "cuda":
            host = torch.empty(src.shape, dtype=dtype, pin_memory=True)
            host.copy_(src)
            return host.to(self.device, non_blocking=True)
        return src.to(dtype, copy=True)

    def sketch_codes(self, q_pad: np.ndarray) -> np.ndarray:
        """int32 codes [pad, L] of a query batch, through the simhash
        kernel where the runtime's config asks for kernels (1-node only,
        as the mesh steps sketch in plain torch)."""
        pad = int(q_pad.shape[0])
        if pad not in self._sketch_shapes:
            self._sketch_shapes.add(pad)
            self.sketch_traces += 1
        rt = self._rt
        codes = plan_mod.sketch(
            self._put(q_pad, torch.float32), self._hp,
            use_kernels=rt.cfg.use_kernels and not rt.is_distributed)
        return codes.cpu().numpy()

    def cost(self) -> costmodel.QueryCost:
        """Table-1 closed form at the current store occupancy (cached per
        generation — occupancy only changes when the store does)."""
        if self._cost_gen != self._generation:
            b = self._rt.mean_occupancy(self._store)
            c = self._rt.cfg
            self._cost = costmodel.table1(
                c.variant, c.params.k, c.params.L, b
            )
            self._cost_gen = self._generation
        return self._cost

    def dispatch_async(self, q_pad: np.ndarray, ex_pad: np.ndarray,
                       m: int) -> PendingDispatch:
        """Launch one batch through the search step WITHOUT waiting.

        The "stage" pipeline phase: host -> device copies of the batch,
        the step's launches, and non-blocking copies of its results into
        pinned host memory, all enqueued on the current stream; on the
        card nothing here waits for the device.  The returned
        `PendingDispatch` finishes the batch — `wait()` for the host-side
        results, `ready()` to probe without blocking.  Keeping stage and
        wait apart is what lets the frontend hold `pipeline_depth`
        batches in flight."""
        distributed = self._rt.is_distributed
        pad = int(q_pad.shape[0])
        control = self.control
        if control is None:
            self._batch_guard(q_pad, ex_pad, m)
        elif control.leads:
            control.dispatch(q_pad, ex_pad, m)
        pending = self._stage(q_pad, ex_pad, m, distributed, pad)
        if control is not None and control.leads:
            control.dispatched(pending)
        return pending

    def _stage(self, q_pad, ex_pad, m, distributed, pad) -> PendingDispatch:
        """The stage of `dispatch_async` on this rank's own backend."""
        with span_or_null(self.tracer, "serve/stage", pad=pad):
            if distributed and m > self.max_m:
                raise ValueError(
                    f"m={m} exceeds the step's headroom (built with "
                    f"cfg.m={self._rt.cfg.m}; serveable m <= {self.max_m})"
                )
            if (pad, m) not in self._shapes:
                self._shapes.add((pad, m))
                self.traces += 1
            q = self._put(q_pad, torch.float32)
            if not distributed:
                payload = (
                    self._corpus if self._corpus is not None
                    else self._store.payload
                )
                inputs = (self._hp, self._store.ids, payload)
                raw = self._step(*inputs, q,
                                 self._put(ex_pad, torch.int32), m)
                return self._pending(raw, None, m, False, inputs)
            inputs = (self._hp, self._store.ids, self._store.payload)
            if self._cache is not None:
                inputs += tuple(self._cache)
            if self._rt.cfg.replication > 1:
                inputs += (self._replicas[0], self._replicas[1],
                           self._put(self._live, torch.int32))
            raw = self._step(*inputs, q)
            return self._pending(raw, np.array(ex_pad), m, True, inputs)

    def _pending(self, raw, ex_pad, m, distributed, inputs):
        """Wrap a step's outputs: on the card, the copies of ids and
        scores into pinned host buffers and the event after them."""
        ids, scores, stats = raw
        event = None
        if ids.is_cuda:
            ids_h = torch.empty(ids.shape, dtype=ids.dtype, pin_memory=True)
            sc_h = torch.empty(scores.shape, dtype=scores.dtype,
                               pin_memory=True)
            ids_h.copy_(ids, non_blocking=True)
            sc_h.copy_(scores, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            ids, scores = ids_h, sc_h
        return PendingDispatch(self, (ids, scores, stats), ex_pad, m,
                               distributed, event, inputs)

    def _finish(self, raw, ex_pad, m, distributed):
        """Host-side tail of a dispatch (called by `PendingDispatch.wait`
        after the device sync): host arrays, and on a mesh the
        self-exclusion filter + slice to the serving m."""
        ids, scores, stats = raw
        ids = ids.numpy().copy()
        scores = scores.numpy().copy()
        if not distributed:
            return ids, scores, stats
        out_i = np.full((ids.shape[0], m), -1, np.int32)
        out_s = np.full((ids.shape[0], m), -np.inf, np.float32)
        for i in range(ids.shape[0]):
            keep = ids[i] != ex_pad[i]
            out_i[i] = ids[i][keep][:m]
            out_s[i] = scores[i][keep][:m]
        return out_i, out_s, stats

    def dispatch(self, q_pad: np.ndarray, ex_pad: np.ndarray, m: int):
        """One batch through the step, synchronously.  Returns (ids,
        scores, stats): `stats` is the step's `StepStats` aux output — use
        `int(stats)` for the bare dropped-probe count (the telemetry
        does), `stats.host()` for the full accounting record."""
        return self.dispatch_async(q_pad, ex_pad, m).wait()

    def exact_topm(self, q: np.ndarray, exclude: int, m: int):
        """Exact top-m ids by full corpus scan — ground truth for the
        sampled shadow-rescoring recall probe.  None when this backend
        cannot rescore exactly (mesh topologies embed payloads in bucket
        slots; sparse corpora have no dense row matrix)."""
        if self._corpus is None or not hasattr(self._corpus, "vectors"):
            return None
        if self._exact_vecs is None:
            self._exact_vecs = self._corpus.vectors.cpu().numpy()
        sims = self._exact_vecs @ np.asarray(q, np.float32)
        if 0 <= exclude < sims.size:
            sims[exclude] = -np.inf
        m = min(m, sims.size)
        top = np.argpartition(-sims, m - 1)[:m]
        return top[np.argsort(-sims[top])].astype(np.int32)


# -----------------------------------------------------------------------------
# the frontend
# -----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    m: int = 10                   # results per query
    max_batch: int = 64           # max requests coalesced per dispatch
    queue_capacity: int = 256     # request ring size (backpressure)
    cache: bool = True            # sketch-keyed result cache on/off
    cache_capacity: int = 4096
    sketch_only_cache: bool = False  # approximate keying (see qcache)
    pipeline_depth: int = 1       # in-flight device batches (1 = sync:
    #                               stage then block — the reference path)
    admit_limit: int | None = None  # shed (ADMIT_REJECT) when ring +
    #                                 in-flight rows reach this; None = off

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.queue_capacity < 1:
            raise ValueError(
                f"queue_capacity must be >= 1, got {self.queue_capacity}"
            )
        if self.pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {self.pipeline_depth}"
            )
        if self.admit_limit is not None and self.admit_limit < 1:
            raise ValueError(
                f"admit_limit must be >= 1 (or None), got {self.admit_limit}"
            )


class _InflightBatch:
    """One staged batch on the device dispatch queue: the
    `PendingDispatch` plus everything needed to reap it host-side."""

    __slots__ = ("pending", "tickets", "ticket_set", "keys", "t_sub",
                 "mq", "mex", "nm", "pad", "gen", "seq", "stage_us")

    def __init__(self, pending, tickets, keys, t_sub, mq, mex, nm, pad,
                 gen, seq, stage_us):
        self.pending = pending
        self.tickets = tickets
        self.ticket_set = {int(t) for t in tickets}
        self.keys = keys
        self.t_sub = t_sub
        self.mq = mq
        self.mex = mex
        self.nm = nm
        self.pad = pad
        self.gen = gen
        self.seq = seq
        self.stage_us = stage_us


class RetrievalFrontend:
    """Single-threaded event-loop frontend over a dispatch backend.

    submit() -> int ticket, or a falsy `SubmitReject` (`RING_FULL` to
    retry, `ADMIT_REJECT` on shed); cache hits are answered at intake —
    the ticket's result is immediately pollable and no ring slot is
    consumed.  step() advances the pipelined step machine one
    deterministic notch (stage a batch if there is room, block-reap when
    the pipeline is full); pump() advances it without unnecessary
    blocking (the open-loop serving loop); poll(ticket) -> (ids, scores)
    once served, wait(ticket) block-reaps exactly the batch carrying the
    ticket — out-of-order completion.  The convenience `search()` drives
    the loop synchronously for a whole query matrix and is the surface
    the bit-identity tests compare against `engine.search`.

    With `pipeline_depth=1` every stage is immediately followed by a
    blocking reap — the synchronous reference path.  Deeper pipelines
    keep up to K batches in flight on the device queue; batch
    composition depends only on the submit/step schedule (FIFO intake of
    min(pending, max_batch) rows), and per-row results are independent
    of batch composition, so served ids are bit-identical across depths
    (tests/test_torch_pipeline.py).
    """

    def __init__(
        self,
        backend,
        config: FrontendConfig = FrontendConfig(),
        stats: ServeStats | None = None,
        obs=None,
    ):
        if backend.max_m is not None and config.m > backend.max_m:
            raise ValueError(
                f"m={config.m} unsupported by backend (max {backend.max_m})"
            )
        self.backend = backend
        self.cfg = config
        self.stats = stats if stats is not None else ServeStats()
        # observability (DESIGN.md Sec. 12): `obs` is an
        # `repro_torch.obs.Observability` bundle or None.  Strictly
        # host-side — the dispatch is identical either way.
        self.obs = obs
        if obs is not None:
            backend.tracer = obs.tracer
        self._dispatch_seq = 0
        self._probe_seen = 0    # served misses, for 1-in-N probe sampling
        self._probe_sum = 0.0
        self._probe_n = 0
        self.cache = (
            QueryCache(config.cache_capacity, config.sketch_only_cache)
            if config.cache
            else None
        )
        cap, d = config.queue_capacity, backend.dim
        # fixed-capacity request ring (preallocated; no per-request alloc)
        self._ring_q = np.zeros((cap, d), np.float32)
        self._ring_ex = np.full((cap,), NO_EXCLUDE, np.int32)
        self._ring_ticket = np.zeros((cap,), np.int64)
        self._ring_t = np.zeros((cap,), np.float64)
        # cache key per ring slot, computed once at intake (None w/o cache)
        self._ring_key: list = [None] * cap
        self._head = 0
        self._size = 0
        self._next_ticket = 0
        self._results: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        # the device dispatch queue: up to pipeline_depth staged batches,
        # in dispatch order (reaped FIFO by step/flush, out-of-order by
        # ready()/wait(ticket))
        self._inflight: list[_InflightBatch] = []
        # host-side hyperplanes for intake-time cache keys (lazy; see
        # _intake_codes)
        self._hp_host: np.ndarray | None = None
        self._bit_weights: np.ndarray | None = None
        # background churn writer hook (repro_torch.serve.writer):
        # prepared updates install at stage boundaries on THIS thread
        self.writer = None
        # obs instrument handles, resolved once (the submit path is hot)
        if obs is not None:
            self._g_depth = obs.registry.gauge(
                "serve_queue_depth",
                "requests waiting in the intake ring",
            )
            self._h_queue = obs.registry.histogram(
                "serve_time_in_queue_us",
                "submit -> device stage, per request",
            )
        else:
            self._g_depth = self._h_queue = None

    # -- request lifecycle ----------------------------------------------------

    @property
    def pending(self) -> int:
        return self._size

    @property
    def free(self) -> int:
        return self.cfg.queue_capacity - self._size

    @property
    def inflight(self) -> int:
        """Batches currently staged on the device dispatch queue."""
        return len(self._inflight)

    @property
    def inflight_rows(self) -> int:
        """Live (non-padding) queries across all in-flight batches."""
        return sum(b.nm for b in self._inflight)

    def _intake_codes(self, q: np.ndarray) -> np.ndarray:
        """Sketch codes for ONE query, host-side — the intake cache key.

        A numpy replica of `hashing.sketch_codes` (sign bits of the
        random projections, packed little-endian): cheap enough to run
        per arrival, no device round-trip on the submit path.  Keys only
        have to be consistent WITH EACH OTHER — every lookup and every
        put uses this function — so the (measure-zero) risk of a sign
        differing from the device sketch at a projection that is exactly
        0.0 costs at most a cache miss, never a wrong result (exact-mode
        keys carry the raw query bytes regardless)."""
        hp = self._hp_host
        if hp is None:
            hp = self.backend._hp.cpu().numpy().astype(np.float32)
            L, k, d = hp.shape
            self._hp_host = hp = hp.reshape(L * k, d)
            self._bit_weights = (
                np.uint32(1) << np.arange(k, dtype=np.uint32)
            )
        bits = (hp @ q >= 0).reshape(-1, self._bit_weights.size)
        return (bits * self._bit_weights).sum(axis=1, dtype=np.uint32)

    def submit(self, q: np.ndarray, exclude: int = NO_EXCLUDE):
        """Admit one query; returns an int ticket or a falsy
        `SubmitReject`.

        The sketch-keyed cache is consulted HERE, at intake: a hit's
        result is stored against the ticket immediately — it never
        occupies a ring or dispatch-queue slot, so a full queue cannot
        backpressure hits behind queued misses.  Misses enter the ring;
        `RING_FULL` (retryable) when the ring has no slot, `ADMIT_REJECT`
        (shed) when `admit_limit` says the service is over-committed.
        The cache linearizes at submit time: a hit observes the store
        generation current at THIS call, which is exactly when the
        caller handed the query over."""
        t0 = time.perf_counter()
        q = np.asarray(q, np.float32)
        key = None
        if self.cache is not None:
            gen = self.backend.generation
            key = self.cache.key(
                self._intake_codes(q), int(exclude), q, self.cfg.m
            )
            e = self.cache.get(key, gen)
            if e is not None:
                ticket = self._next_ticket
                self._next_ticket += 1
                self._results[ticket] = (e.ids, e.scores)
                self.stats.record_submit(True)
                lat = (time.perf_counter() - t0) * 1e6
                self.stats.record_done(lat, hit=True)
                if self.obs is not None:
                    self.obs.flight.record(QueryRecord(
                        qid=ticket, kind="query", latency_us=lat,
                        cache_hit=True, generation=gen,
                    ))
                return ticket
        if self.cfg.admit_limit is not None and \
                self._size + self.inflight_rows >= self.cfg.admit_limit:
            self.stats.record_submit(False)
            return ADMIT_REJECT
        if self._size >= self.cfg.queue_capacity:
            self.stats.record_ring_full()
            return RING_FULL
        slot = (self._head + self._size) % self.cfg.queue_capacity
        self._ring_q[slot] = q
        self._ring_ex[slot] = exclude
        self._ring_key[slot] = key
        ticket = self._next_ticket
        self._next_ticket += 1
        self._ring_ticket[slot] = ticket
        self._ring_t[slot] = t0
        self._size += 1
        self.stats.record_submit(True)
        if self._g_depth is not None:
            self._g_depth.set(self._size)
        return ticket

    def poll(self, ticket: int):
        """(ids, scores) for a served ticket, else None.  Pops the
        result.  Sweeps completed in-flight batches first (non-blocking),
        so out-of-order completions become visible as the device
        finishes them."""
        if ticket not in self._results and self._inflight:
            self._reap_ready()
        return self._results.pop(ticket, None)

    def wait(self, ticket: int):
        """Block until `ticket` is served; returns and pops its result.

        Reaps exactly the batch carrying the ticket — batches dispatched
        BEFORE it stay in flight (out-of-order reap by ticket).  A
        ticket still in the intake ring drives the step machine until
        its batch stages and completes."""
        r = self._results.pop(ticket, None)
        if r is not None:
            return r
        for b in list(self._inflight):
            if ticket in b.ticket_set:
                self._reap_batch(b)
                return self._results.pop(ticket)
        while self._size or self._inflight:
            self.step()
            r = self._results.pop(ticket, None)
            if r is not None:
                return r
        raise KeyError(f"unknown ticket {ticket}")

    def take_results(self) -> dict:
        """Pop every completed result at once: {ticket: (ids, scores)}.
        The open-loop serving loop's bulk drain."""
        out = self._results
        self._results = {}
        return out

    # -- the pipelined step machine -------------------------------------------

    def _install_updates(self) -> None:
        """Stage boundary hook: install any churn updates the background
        writer has prepared (repro_torch.serve.writer).  Runs on the
        serving thread, BETWEEN dispatches — the writer never touches the
        backend from its own thread."""
        if self.writer is not None:
            self.writer.install(self)

    def _stage_batch(self) -> None:
        """Intake up to `max_batch` ring rows and stage them onto the
        device dispatch queue (async — returns before the batch
        computes).  Caller guarantees ring rows exist and the pipeline
        has a free slot."""
        self._install_updates()
        obs = self.obs
        tr = obs.tracer if obs is not None else None
        cap = self.cfg.queue_capacity
        n = min(self._size, self.cfg.max_batch)
        with span_or_null(tr, "serve/intake", n=n):
            idx = (self._head + np.arange(n)) % cap
            q = self._ring_q[idx].copy()
            ex = self._ring_ex[idx].copy()
            tickets = self._ring_ticket[idx].copy()
            t_sub = self._ring_t[idx].copy()
            keys = [self._ring_key[i] for i in idx]
            self._head = (self._head + n) % cap
            self._size -= n

        with span_or_null(tr, "serve/enqueue", rows=n):
            pad = dispatch_pad(n, self.backend.min_batch)
            mq = np.zeros((pad, q.shape[1]), np.float32)
            mex = np.full((pad,), NO_EXCLUDE, np.int32)
            mq[:n] = q
            mex[:n] = ex
            t_stage = time.perf_counter()
            queue_us = (t_stage - t_sub[:n]) * 1e6
            for us in queue_us:
                self.stats.record_queue_time(us)
            if self._h_queue is not None:
                # bulk observe: per-row Python observes are measurable
                # against the obs_overhead budget
                self._h_queue.observe_many(queue_us)
            if self._g_depth is not None:
                self._g_depth.set(self._size)

        gen = self.backend.generation
        t0 = time.perf_counter()
        pending = self.backend.dispatch_async(mq, mex, self.cfg.m)
        stage_us = (time.perf_counter() - t0) * 1e6
        seq = self._dispatch_seq
        self._dispatch_seq += 1
        self._inflight.append(_InflightBatch(
            pending, tickets, keys, t_sub, mq, mex, n, pad, gen, seq,
            stage_us,
        ))

    def _reap_ready(self) -> int:
        """Reap every in-flight batch whose results have already reached
        the host (non-blocking, out of dispatch order)."""
        done = 0
        for b in list(self._inflight):
            if b.pending.ready():
                done += self._reap_batch(b)
        return done

    def _reap_batch(self, b: _InflightBatch) -> int:
        """Finish one staged batch: device sync (if still computing),
        host conversion, result scatter, cache fill at the STAGE-TIME
        generation, telemetry, and flight records."""
        self._inflight.remove(b)
        obs = self.obs
        tr = obs.tracer if obs is not None else None
        t0 = time.perf_counter()
        ids, scores, stats = b.pending.wait()
        compute_us = (time.perf_counter() - t0) * 1e6
        nm, pad, gen, seq, m = b.nm, b.pad, b.gen, b.seq, self.cfg.m
        # the batch's StepStats reach the host here, at reap — never on
        # the stage path (that would serialize the pipeline on the device)
        self.stats.record_batch(nm, pad - nm, stats, self.backend.cost())
        hs = None
        if obs is not None:
            hs = stats.host()
            obs.flight.record(QueryRecord(
                qid=seq, kind="dispatch", batch=seq, batch_size=pad,
                generation=gen,
                stage_us=dict(stage=b.stage_us, compute=compute_us),
                extra=dict(live_rows=nm, padded_rows=pad - nm), **hs,
            ))
        with span_or_null(tr, "serve/reap", batch=seq, rows=nm):
            for j in range(nm):
                ids_j, sc_j = ids[j], scores[j]
                self._results[int(b.tickets[j])] = (ids_j, sc_j)
                if self.cache is not None and b.keys[j] is not None:
                    # stage-time generation: a write installed while this
                    # batch was in flight already bumped past `gen`, so
                    # the entry is born stale and dies on its next lookup
                    # — never served across the update
                    self.cache.put(b.keys[j], ids_j, sc_j, gen)
        with span_or_null(tr, "serve/respond", batch=seq):
            t_done = time.perf_counter()
            if obs is not None:
                # per-row share of the batch's planned probes (uniform:
                # the planner issues the same probe count per row); drops
                # stay on the dispatch record — the authoritative sum.
                share = hs["probes_issued"] // pad
                fanout = hs.get("replica_fanout", 1)
                stage = dict(stage=b.stage_us, compute=compute_us)
                t_rec = obs.flight.to_us(t_done)  # one stamp per batch
            for j in range(nm):
                lat = (t_done - b.t_sub[j]) * 1e6
                self.stats.record_done(lat, hit=False)
                if obs is not None:
                    obs.flight.record(QueryRecord(
                        qid=int(b.tickets[j]), kind="query", t_us=t_rec,
                        latency_us=lat, cache_hit=False, generation=gen,
                        batch=seq, batch_size=pad,
                        probes_issued=share, replica_fanout=fanout,
                        stage_us=stage,
                    ))
        if obs is not None and obs.config.recall_probe_every > 0:
            self._recall_probe(obs, b.mq, b.mex, ids, nm, m)
        return nm

    def step(self) -> int:
        """Advance the step machine one DETERMINISTIC notch; returns
        #completed.

        Stages one batch when ring rows are pending and the pipeline has
        a free slot; block-reaps the OLDEST in-flight batch when the
        pipeline is full (or when there was nothing to stage).  With
        `pipeline_depth=1` that is exactly the synchronous loop — stage,
        then block on it.  Deliberately no `ready()` probes here: the
        call sequence alone determines batch composition and reap order,
        which is what the pipelined==synchronous equivalence test pins
        down.  (The open-loop serving path uses `pump`, which does probe.)

        With obs installed the stages emit spans (intake -> enqueue ->
        stage -> compute -> reap -> respond) and every served query +
        every backend dispatch appends a `QueryRecord` to the flight
        recorder — dispatch records carry the step's EXACT `StepStats`,
        query records their batch's per-row share plus the latency
        breakdown.
        """
        done = 0
        staged = False
        if self._size and len(self._inflight) < self.cfg.pipeline_depth:
            self._stage_batch()
            staged = True
        if self._inflight and (
            len(self._inflight) >= self.cfg.pipeline_depth or not staged
        ):
            done += self._reap_batch(self._inflight[0])
        return done

    def pump(self) -> int:
        """Advance without unnecessary blocking — the open-loop serving
        loop's driver.  Reaps whatever the device has finished
        (out-of-order), stages GREEDILY whenever the pipeline has a free
        slot (batch N+1 goes onto the device queue while batch N
        computes — partial batches included: the pow-2 grid makes small
        dispatches cheap, and waiting to fill `max_batch` would trade
        tail latency for nothing), and blocks only when the pipeline is
        completely full.  Returns #completed."""
        done = self._reap_ready()
        depth = self.cfg.pipeline_depth
        if depth == 1:
            if self._size:
                done += self.step()
            return done
        if self._size and len(self._inflight) < depth:
            self._stage_batch()
        elif self._inflight and len(self._inflight) >= depth:
            done += self._reap_batch(self._inflight[0])
        return done

    def _recall_probe(self, obs, mq, mex, ids, nm, m) -> None:
        """Sampled shadow-rescoring recall probe (DESIGN.md Sec. 12): every
        `recall_probe_every`-th served miss is rescored EXACTLY against
        the corpus and `recall_at_m` lands in the registry — live search
        quality next to the live cost counters.  Silently inactive on
        backends with no exact ground truth (mesh topologies)."""
        every = obs.config.recall_probe_every
        for j in range(nm):
            self._probe_seen += 1
            if self._probe_seen % every:
                continue
            exact = self.backend.exact_topm(mq[j], int(mex[j]), m)
            if exact is None:
                return
            r = metrics_mod.recall_at_m(ids[j][None, :], exact[None, :])
            self._probe_sum += r
            self._probe_n += 1
            obs.registry.counter(
                "serve_recall_probes_total",
                "queries shadow-rescored against the exact corpus",
            ).inc()
            g = obs.registry.gauge(
                "serve_recall_probe",
                "recall@m of sampled served queries vs exact top-m",
            )
            g.set(r, window="last")
            g.set(self._probe_sum / self._probe_n, window="mean")

    def flush(self) -> None:
        """Drive the step machine until the ring AND the device dispatch
        queue are empty."""
        while self._size or self._inflight:
            self.step()

    def apply_update(self, **kw) -> None:
        """Install a backend update WITHOUT draining in-flight batches —
        the background-writer path for store/corpus/replica churn.

        Safe because a staged batch holds references to every tensor it
        was dispatched with: it completes as if serialized before this
        update, and its results enter the cache at its stage-time
        generation, which this update's bump makes stale on the next
        lookup.  Topology swaps rebind the dispatch and must drain first
        — use `update_backend`."""
        if kw.get("runtime") is not None:
            raise ValueError(
                "topology swaps must go through update_backend (drains "
                "in-flight batches before rebinding the dispatch)"
            )
        self.backend.update(**kw)

    def update_backend(self, **kw) -> None:
        """Live backend update through the frontend — REQUIRED for topology
        swaps while serving: in-flight batches (everything already in the
        ring) drain on the OLD topology first, then the new runtime/store
        install via `backend.update(**kw)`.  The generation bump that
        comes with every update is what makes each cached result from
        before the swap stale — the sketch-keyed cache serves nothing
        across a reshard (tests/test_torch_serve.py)."""
        rt = kw.get("runtime")
        if rt is not None and rt.is_distributed and self.cfg.m > rt.cfg.m - 1:
            raise ValueError(
                f"serving m={self.cfg.m} exceeds the new runtime's headroom "
                f"(cfg.m={rt.cfg.m}; mesh dispatch keeps one result for "
                "host-side self-exclusion)"
            )
        self.flush()  # in-flight batches complete on the old topology
        self.backend.update(**kw)

    # -- synchronous convenience (tests / examples) ---------------------------

    def search(
        self, queries: np.ndarray, exclude: np.ndarray | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Submit a whole query matrix, drive the loop, gather results in
        order — the drop-in replacement for `engine.search(...)[:2]`."""
        queries = np.asarray(queries, np.float32)
        nq = queries.shape[0]
        m = self.cfg.m
        out_i = np.full((nq, m), -1, np.int32)
        out_s = np.full((nq, m), -np.inf, np.float32)
        tickets = np.empty((nq,), np.int64)
        for i in range(nq):
            while self.free == 0:
                self.step()  # drain before the ring would push back
            ex = NO_EXCLUDE if exclude is None else int(exclude[i])
            t = self.submit(queries[i], ex)
            if isinstance(t, SubmitReject):  # free >= 1 was guaranteed
                raise RuntimeError(f"submit refused with a free slot: {t}")
            tickets[i] = t
        self.flush()
        for i in range(nq):
            ids_i, sc_i = self._results.pop(int(tickets[i]))
            out_i[i], out_s[i] = ids_i, sc_i
        return out_i, out_s
