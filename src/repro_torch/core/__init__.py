"""NearBucket-LSH core on PyTorch: the 1-node query path.

Layers (the same names as `repro.core`):
  hashing     — cosine LSH (sign random projection), sketch packing
  packed      — dense multi-word sketch layout and its hamming distance
  multiprobe  — near-bucket enumeration (Sec. 4.2)
  can         — bucket -> node coordinates of the CAN overlay
  plan        — the shared probe planner
  routing     — run ranks (the store's ring-append slot ranking)
  store       — soft-state bucket store (insert/refresh/GC, Sec. 4.1)
  corpus      — dense corpus + exact oracle
  scoring     — dedupe + top-m, staged and kernel paths
  runtime     — the 1-node IndexRuntime
  engine      — LshEngine, a façade over the 1-node runtime
  costmodel   — Table 1 cost accounting
"""
