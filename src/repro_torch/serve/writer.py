"""Background churn writer: prepare write-epoch state off the serving
thread, install it at stage boundaries (DESIGN.md Sec. 13).

A write epoch has two halves with very different costs.  PREPARATION —
sketching re-announced vectors, building the inserted/expired store,
re-replicating — is heavy host+device work that has no business on the
serving thread.  INSTALLATION — swapping the backend's store/corpus
references and bumping the generation — is a few pointer writes, but it
mutates state the step machine reads, so it must happen on the serving
thread at a well-defined point.

`ChurnWriter` splits them exactly there: `submit(prep_fn)` hands the
heavy half to a daemon worker thread (`inline=True` runs it on the spot —
the deterministic mode the equivalence tests use); the worker queues the
prepared update kwargs; and the frontend drains that queue through
`install` at every STAGE BOUNDARY — immediately before a new batch is
dispatched, never while one is being assembled.  In-flight batches are
not drained first: they hold references to the tensors they were
dispatched with, complete as if serialized before the update, and their
cached results die with the generation bump (`RetrievalFrontend.
apply_update`).  Topology swaps (runtime=) are refused — those rebind
the dispatch and must drain through `update_backend` on the serving
thread.

On the card the worker prepares on a CUDA stream of its own, so a prep's
kernels overlap the serving stream's batches instead of queueing behind
them:

  * `submit` records an event on the submitting thread's stream, and the
    worker's stream waits on it before the prep runs: the prep sees every
    tensor the serving thread wrote before it submitted;
  * the worker records an event after the prep and waits for it (on its
    own thread) before it publishes the update, so the tensors the prep
    read are no longer in use when the prep function is dropped;
  * `install` makes the serving stream wait on that event and calls
    `record_stream` on every installed tensor: the caching allocator then
    keeps their memory out of the writer stream's reuse until the
    serving batches that read them have run.

The port's `insert_batch` / `expire` clone their input store (the JAX
reference donates it), so a prep may chain from the installed store
directly.

In a world of several processes every rank builds the writer alike, in
one order, and its worker runs the same preps from the same seed:

  * a prep's collectives (a mesh runtime's insert, refresh, replicate)
    go through `runtime`, the backend's runtime over a second set of
    process groups, made by the first writer of the mesh's layout and
    reused by the later ones (`ProcessZoneMesh.with_own_groups`), so the
    worker thread never shares a communicator with the serving thread's
    collectives;
  * the install point is rank 0's: at the stage boundary where its jobs
    up to j are ready it announces "install j" (through the serving
    run's controller, `repro_torch.serve.control`, or, in a closed loop
    where every rank reaches the same boundaries, by a broadcast there);
    every other rank waits for its own jobs up to j, then installs them
    at that same point (`install_through`).

Concurrent NCCL operations on two communicators can deadlock where the
ranks launch them in different orders.  Here each communicator is issued
in one order on every rank (the serving thread's by the controller's
event stream, the worker's by its job order), but only one card (a
world of one) has run it; a world of several cards is unproven.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import deque

import torch
import torch.distributed as tdist

from repro_torch.core.mesh import broadcast0
from repro_torch.core.runtime import IndexRuntime, process_world


def _tensors(x):
    """Every tensor in an update's value: tensors, tuples / lists of
    them, and dataclass stores and corpora."""
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _tensors(y)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name))


class ChurnWriter:
    """Background writer for one `RetrievalFrontend`.

    prep_fn: () -> dict of `RuntimeBackend.update` kwargs.  Jobs run
    FIFO on ONE worker thread, so a prep that chains on the previous
    epoch's store sees it completed.  `prepared`/`installed` count the
    two halves; `drain()` blocks until every submitted job is prepared
    AND installed (the end-of-run / deterministic-test barrier).

    `runtime` is the runtime a prep issues its collectives through: the
    backend's, and on a process mesh with a worker thread the same over
    the writer's own process groups.
    """

    def __init__(self, frontend, *, inline: bool = False):
        rt = frontend.backend.runtime
        mesh = None if inline or rt.mesh is None else \
            rt.mesh.with_own_groups()
        self.runtime = rt if mesh is None or mesh is rt.mesh else \
            IndexRuntime(rt.cfg, mesh=mesh)
        self._frontend = frontend
        self._inline = inline
        self._ready: deque = deque()  # (kwargs, event or None), in order
        self._submitted = 0
        self.prepared = 0
        self.installed = 0
        self._error: Exception | None = None
        device = frontend.backend.device
        self._stream = (torch.cuda.Stream(device)
                        if device.type == "cuda" and not inline else None)
        if inline:
            self._jobs = None
            self._thread = None
        else:
            self._jobs: queue.Queue = queue.Queue()
            self._thread = threading.Thread(
                target=self._worker, name="serve-churn-writer", daemon=True
            )
            self._thread.start()
        frontend.writer = self

    def _worker(self) -> None:
        while True:
            job = self._jobs.get()
            if job is None:
                return
            fn, after = job
            try:
                self._ready.append(self._prepare(fn, after))
                self.prepared += 1
            except Exception as e:  # surfaced on the serving thread
                self._error = e
                return

    def _prepare(self, fn, after):
        """Run one prep on the writer's stream (on the card): after the
        submitter's work, ended by an event it has reached."""
        if self._stream is None:
            return fn(), None
        with torch.cuda.stream(self._stream):
            self._stream.wait_event(after)
            kw = fn()
            done = torch.cuda.Event()
            done.record(self._stream)
        done.synchronize()
        return kw, done

    def submit(self, prep_fn) -> None:
        """Queue one write epoch for preparation (non-blocking unless
        `inline`)."""
        if self._error is not None:
            raise RuntimeError("churn writer died") from self._error
        self._submitted += 1
        if self._inline:
            self._ready.append((prep_fn(), None))
            self.prepared += 1
            return
        after = None
        if self._stream is not None:
            after = torch.cuda.Event()
            after.record(torch.cuda.current_stream(self._stream.device))
        self._jobs.put((prep_fn, after))

    def install(self, frontend=None) -> int:
        """Install every prepared update — called by the frontend at
        stage boundaries, on the serving thread.  Returns #installed.

        In a world of several processes a worker's updates install on
        rank 0's word: rank 0 installs what it has ready and announces
        the last job's index; a rank that follows a controller installs
        only when that announcement reaches it, and in a closed loop
        every rank receives it here and installs up to it."""
        if self._error is not None:
            raise RuntimeError("churn writer died") from self._error
        fe = self._frontend if frontend is None else frontend
        control = fe.backend.control
        last = self.installed + len(self._ready) - 1
        if control is not None:  # rank 0 announces; the others follow
            if not control.leads or last < self.installed:
                return 0
            control.install(last)
        elif self._inline or process_world() == 1:
            return self._install_upto(fe, last + 1)
        else:  # a closed loop: every rank is at this boundary
            last = int(broadcast0(
                [torch.tensor([last], device=fe.backend.device)]
                if tdist.get_rank() == 0 else None,
                [((1,), torch.int64)], fe.backend.device)[0])
        return self.install_through(last, fe)

    def install_through(self, j: int, frontend=None,
                        timeout_s: float = 600.0) -> int:
        """Wait until this writer's jobs up to `j` are prepared, then
        install those not installed yet, in order (a rank's install at
        rank 0's announcement).  Returns #installed."""
        deadline = time.perf_counter() + timeout_s
        while self.prepared <= j:
            if self._error is not None:
                raise RuntimeError("churn writer died") from self._error
            if time.perf_counter() > deadline:
                raise TimeoutError(f"churn writer: job {j} not prepared "
                                   f"after {timeout_s} s")
            time.sleep(0.0005)
        return self._install_upto(
            self._frontend if frontend is None else frontend, j + 1)

    def _install_upto(self, fe, count: int) -> int:
        """Install prepared updates until `count` are installed."""
        n = 0
        while self.installed < count:
            kw, done = self._ready.popleft()
            if done is not None:
                serving = torch.cuda.current_stream(self._stream.device)
                serving.wait_event(done)
                for t in _tensors(list(kw.values())):
                    if t.is_cuda:
                        t.record_stream(serving)
            fe.apply_update(**kw)
            self.installed += 1
            n += 1
        return n

    def drain(self, timeout_s: float = 30.0) -> None:
        """Block until every submitted epoch is prepared, then install
        the lot.  The end-of-run barrier (and the whole story in
        `inline` mode, where nothing was ever pending)."""
        deadline = time.perf_counter() + timeout_s
        while self.prepared < self._submitted:
            if self._error is not None:
                raise RuntimeError("churn writer died") from self._error
            if time.perf_counter() > deadline:
                raise TimeoutError(
                    f"churn writer: {self._submitted - self.prepared} "
                    f"epoch(s) still preparing after {timeout_s}s"
                )
            time.sleep(0.0005)
        self.install()

    def close(self) -> None:
        """Stop the worker (prepared-but-uninstalled updates are
        dropped); detaches from the frontend."""
        if self._thread is not None:
            self._jobs.put(None)
            self._thread.join(timeout=10.0)
            self._thread = None
        if self._frontend.writer is self:
            self._frontend.writer = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
