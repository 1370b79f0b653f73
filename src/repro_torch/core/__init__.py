"""NearBucket-LSH core on PyTorch: the paper's index, query path and analysis.

Layers (the same names as `repro.core`):
  hashing     — cosine LSH (sign random projection), sketch packing
  packed      — dense multi-word sketch layout and its hamming distance
  multiprobe  — near-bucket enumeration (Sec. 4.2)
  can         — bucket -> node coordinates of the CAN overlay
  plan        — the shared probe planner
  routing     — capacitated routing (run ranks, send buffers, overflow)
  store       — soft-state bucket store (insert/refresh/GC, Sec. 4.1)
  corpus      — dense/sparse corpora + exact oracles
  scoring     — dedupe + top-m, staged and kernel paths
  runtime     — the IndexRuntime (1 node, or n nodes on one card), R-way
                replicas, fail-stop kills and resharding
  engine      — LshEngine, a façade over the 1-node runtime
  distributed — the mesh adapter: step functions over a zone mesh
  churn       — dynamic-OSN soft-state trajectories, one driver on any
                topology (content, node and failure churn)
  layered     — Layered-LSH and its LSH-equivalence (Sec. 5.2)
  analysis    — Propositions 1-4 closed forms (Sec. 5)
  costmodel   — Table 1 cost accounting
  metrics     — recall@m, NCS@m, success probability (Sec. 6.1, 6.3)
"""

from repro_torch.core.hashing import (  # noqa: F401
    LshParams,
    make_hyperplanes,
    normalize,
    sketch_bits,
    sketch_codes,
    pack_bits,
    unpack_bits,
    hamming_distance,
    collision_probability,
)
from repro_torch.core.can import CanTopology, paper_topology  # noqa: F401
from repro_torch.core.corpus import DenseCorpus, SparseCorpus  # noqa: F401
from repro_torch.core import analysis, costmodel, metrics, multiprobe  # noqa: F401
from repro_torch.core.store import BucketStore, make_store, insert_batch, expire  # noqa: F401
from repro_torch.core.runtime import IndexRuntime, RuntimeConfig  # noqa: F401
from repro_torch.core.engine import EngineConfig, LshEngine, SearchResult  # noqa: F401
from repro_torch.core.scoring import dedupe_topk  # noqa: F401
from repro_torch.core import plan, routing  # noqa: F401
from repro_torch.core.plan import ProbePlan, ProbeSpec, make_plan  # noqa: F401
from repro_torch.core.routing import RoutePlan, plan_routes, run_ranks  # noqa: F401
