"""Distributed CNB-LSH over processes (the PyTorch port's process mesh).

Maps the CAN overlay onto a (data x model) mesh of processes: each
process holds a contiguous block of the 4 CAN nodes with their bucket
zones, the query batch splits over the data rows and the nodes, and the
neighbour-bucket caches are refreshed off the query path.  The port of
`examples/distributed_search.py` (2 data rows x 4 nodes).

    # the CPU: 2 gloo processes, each one data row of all 4 nodes
    torchrun --standalone --nproc-per-node 2 \\
        examples/torch_distributed_search.py --device cpu
    # the cards: one process a card (NCCL); 8 cards give the reference's
    # 2 x 4 layout, one card runs 1 data row of 4 nodes
    torchrun --standalone --nproc-per-node <cards> \\
        examples/torch_distributed_search.py

With `--out PATH` the first rank saves the ids it printed about.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.core import distributed as tdist       # noqa: E402
from repro_torch.core.hashing import (LshParams, make_hyperplanes,  # noqa: E402
                                      sketch_codes_batched)
from repro_torch.core.store import build_store_host     # noqa: E402
from repro_torch.launch.mesh import (init_process_mesh,  # noqa: E402
                                     make_zone_mesh)

N, D, B = 20_000, 128, 64


def run(mesh, log=lambda *a: None) -> dict:
    """Search, ranked search and contains on `mesh` (a process mesh or the
    one-process mesh): the whole batch's ids and hits, as numpy."""
    dev = mesh.device
    rng = np.random.default_rng(0)
    params = LshParams(d=D, k=7, L=4, seed=3)
    h = make_hyperplanes(params, torch.Generator().manual_seed(0),
                         device=dev)
    # centered embeddings (the model-produced case): sign-hash buckets are
    # balanced
    vecs = torch.from_numpy(
        rng.standard_normal((N, D)).astype(np.float32)).to(dev)
    vecs /= torch.linalg.vector_norm(vecs, dim=1, keepdim=True)
    store = tdist.shard_store(mesh, build_store_host(
        sketch_codes_batched(vecs, h), params.num_buckets, 384,
        payload=vecs, device=dev))

    cfg = tdist.DistConfig(params=params, n_shards=mesh.n_model,
                           variant="cnb", m=10)
    cache_ids, cache_payload = tdist.make_refresh_cache(cfg, mesh)(
        store.ids, store.payload)
    search = tdist.make_search_step(cfg, mesh)
    q = vecs[:B]
    ids, _, stats = search(h, store.ids, store.payload, cache_ids,
                           cache_payload, q)
    ids = ids.cpu().numpy()
    self_hit = float(np.mean(ids[:, 0] == np.arange(B)))
    n_total = mesh.data * mesh.n_model
    est = tdist.estimate_query_bytes(cfg, batch=B, d=D, n_total=n_total)
    log(f"searched {B} queries over {N} vectors on mesh {mesh.shape} "
        f"({getattr(mesh, 'world', 1)} processes)")
    log(f"top-1 self-hit rate: {self_hit:.2f} (should be ~1.0)")
    log(f"dropped probes (routing overflow): {int(stats)} (0 in healthy "
        f"operation; raise cap_factor otherwise)")
    log(f"estimated wire bytes/step: {est['total']:.0f} (routing "
        f"{est['query_routing']}, results {est['results']}, neighbor "
        f"{est['neighbor']})")
    assert self_hit > 0.95
    assert int(stats) == 0

    # margin-ranked probe budget (beyond paper): the p=3 most promising
    # near buckets per table, the single-host engine's planner
    cfg_p3 = tdist.DistConfig(params=params, n_shards=mesh.n_model,
                              variant="cnb", m=10, num_probes=3,
                              ranked_probes=True)
    ids3, _, _ = tdist.make_search_step(cfg_p3, mesh)(
        h, store.ids, store.payload, cache_ids, cache_payload, q)
    ids3 = ids3.cpu().numpy()
    log(f"ranked p=3 probes: top-1 self-hit "
        f"{float(np.mean(ids3[:, 0] == np.arange(B))):.2f} at "
        f"{cfg_p3.probe_spec.probes_per_table}/"
        f"{cfg.probe_spec.probes_per_table} buckets per table")

    # distributed `contains` (paper Sec. 6.3): metadata-only routing
    hits, _ = tdist.make_contains_step(cfg, mesh)(
        h, store.ids, cache_ids, q, torch.arange(B, dtype=torch.int32,
                                                 device=dev))
    hits = hits.cpu().numpy()
    log(f"contains(self) success probability: {float(np.mean(hits)):.2f}")
    return dict(ids=ids, ids_p3=ids3, hits=hits)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu for gloo processes; the cards by default")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    init_process_mesh(args.device)
    try:
        # 2 data rows where the world splits in two, as the reference
        mesh = make_zone_mesh(4, 2 - dist.get_world_size() % 2,
                              device=args.device)
        first = dist.get_rank() == 0
        out = run(mesh, log=print if first else (lambda *a: None))
        if first and args.out:
            np.savez(args.out, **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
