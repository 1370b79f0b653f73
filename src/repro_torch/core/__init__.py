"""NearBucket-LSH core on PyTorch: the paper's index, query path and analysis.

Layers (the same names as `repro.core`):
  hashing     — cosine LSH (sign random projection), sketch packing
  packed      — dense multi-word sketch layout and its hamming distance
  multiprobe  — near-bucket enumeration (Sec. 4.2)
  can         — bucket -> node coordinates of the CAN overlay
  plan        — the shared probe planner
  routing     — run ranks (the store's ring-append slot ranking)
  store       — soft-state bucket store (insert/refresh/GC, Sec. 4.1)
  corpus      — dense/sparse corpora + exact oracles
  scoring     — dedupe + top-m, staged and kernel paths
  runtime     — the IndexRuntime (1 node, or n nodes on one card)
  engine      — LshEngine, a façade over the 1-node runtime
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

