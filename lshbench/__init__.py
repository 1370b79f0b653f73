"""The benchmark of `repro_torch`, the PyTorch and CUDA port of
NearBucket-LSH.

`python3 lshbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once.  Everything that
belongs to one configuration, traffic mix or per-layer metric lives in a
file of its own that the harness finds by name (see README.md).
"""
