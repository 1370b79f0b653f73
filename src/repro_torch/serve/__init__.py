"""Online retrieval serving: the NearBucket-LSH query service (DESIGN.md
Sec. 7) on PyTorch, driven by `repro_torch.launch.serve_retrieval`.

  - `frontend`  — request ring, dynamic pow-2 batching, admission
                  control, the depth-K pipelined dispatch machine on
                  CUDA events (DESIGN.md Sec. 13), and the ONE dispatch
                  backend (`RuntimeBackend`) over an `IndexRuntime` of
                  any topology (DESIGN.md Sec. 8);
  - `qcache`    — sketch-keyed result cache with generation-based
                  invalidation wired to store churn;
  - `writer`    — background churn writer: prepare off-thread (on a CUDA
                  stream of its own on the card), install at stage
                  boundaries;
  - `loadgen`   — open-loop Poisson load + the max-qps-at-SLO sweep;
  - `lifecycle` — read/write epochs: churn maintenance interleaved
                  with serving;
  - `telemetry` — p50/p99 latency, time-in-queue, qps, hit rate,
                  Table-1 cost and dropped-probe aggregation.
"""

from repro_torch.serve.frontend import (  # noqa: F401
    ADMIT_REJECT,
    RING_FULL,
    FrontendConfig,
    PendingDispatch,
    RetrievalFrontend,
    RuntimeBackend,
    SubmitReject,
    dispatch_pad,
    pow2_pad,
)
from repro_torch.serve.lifecycle import (  # noqa: F401
    ServeChurnConfig,
    ServeFailureConfig,
    run_serve_churn,
    run_serve_failure,
    run_serve_reshard,
)
from repro_torch.serve.loadgen import (  # noqa: F401
    OpenLoopResult,
    max_qps_at_slo,
    poisson_arrivals,
    run_open_loop,
)
from repro_torch.serve.qcache import CacheEntry, QueryCache  # noqa: F401
from repro_torch.serve.telemetry import ServeStats  # noqa: F401
from repro_torch.serve.writer import ChurnWriter  # noqa: F401
