"""Cells of BENCHMARK.json cut to a size that a CPU holds, for tests."""

import dataclasses
import time

from lshbench import harness, spec

# 20 000 users over 4096 buckets a table (about 5 a bucket) with room
# for 6, so that skewed buckets evict; 1024 interests in 60 communities
USERS, CAPACITY = 20_000, 6
CORPUS = {"interests": 1024, "communities": 60}


def tiny_config(name: str) -> dict:
    cfg = spec.load_config(name)
    return dict(cfg, users=USERS, bucket_capacity=CAPACITY,
                corpus=dict(cfg["corpus"], **CORPUS))


def tiny_cell(name: str, batch: int = 64) -> spec.Cell:
    cell = spec.find_cell(name)
    mix = dict(cell.traffic, batch=batch)
    return dataclasses.replace(cell, config=tiny_config(cell.config["name"]),
                               traffic=mix)


def run(cell: spec.Cell, seed: int = 2_147_483_659, seconds: float = 0.5,
        trace: bool = False, device: str = "cpu") -> dict:
    return harness.run_cell(cell, seed, seconds, trace, device=device,
                            t_start=time.perf_counter(),
                            log=lambda *a: None)
