"""Quickstart: the paper in one script (the PyTorch port's).

Builds a synthetic OSN dataset, indexes it with cosine-LSH over a
CAN-style overlay, and compares LSH / Layered-LSH / NB-LSH / CNB-LSH
search quality at their Table-1 network costs, reproducing the paper's
headline: CNB-LSH gives NB-LSH quality at LSH cost.  The port of
`examples/quickstart.py`; it prints the same table.

    PYTHONPATH=src python examples/torch_quickstart.py             # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

On the card the corpus sketch runs through the simhash kernel; the
sparse corpus is scored in plain torch ops (the kernels score dense
rows).  `run(hyperplanes=...)` takes another draw of the hyperplanes
(the JAX package's, to compare the two scripts' tables).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch import resolve_device                   # noqa: E402
from repro_torch.core import (EngineConfig, LshEngine,   # noqa: E402
                              LshParams, make_hyperplanes, metrics,
                              paper_topology)
from repro_torch.core.corpus import (exact_topk_sparse,  # noqa: E402
                                     sparse_densify_host)
from repro_torch.core.hashing import sketch_codes_batched  # noqa: E402
from repro_torch.core.store import build_store_host      # noqa: E402
from repro_torch.data import osn                         # noqa: E402

VARIANTS = ("lsh", "layered", "nb", "cnb")


def run(device=None, hyperplanes=None, log=print) -> dict:
    """The quickstart on `device` (the card unless "cpu"); returns, per
    variant, its messages a query, recall@10, NCS@10, ids and scores,
    and under "ideal" the oracle's top-10 (each query's own id left
    out)."""
    dev = resolve_device(device)
    spec = osn.tiny_spec()
    log(f"dataset: {spec.num_users} users x {spec.num_interests} interests "
        f"(k={spec.k})")
    corpus = osn.generate(spec, device=dev)
    params = LshParams(d=spec.num_interests, k=spec.k, L=4, seed=7)
    h = (make_hyperplanes(params, device=dev) if hyperplanes is None
         else torch.tensor(np.asarray(hyperplanes, np.float32), device=dev))

    codes = sketch_codes_batched(corpus, h)
    store = build_store_host(codes, params.num_buckets, capacity=128,
                             device=dev)

    nq, m = 128, 10
    qidx = np.random.default_rng(0).choice(corpus.n, nq, replace=False)
    qd = sparse_densify_host(corpus, qidx)
    qd /= np.maximum(np.linalg.norm(qd, axis=1, keepdims=True), 1e-12)
    ideal_s, ideal_i = (t.cpu().numpy() for t in exact_topk_sparse(
        corpus, qd, m + 1))
    keep_s = np.empty((nq, m), np.float32)
    keep_i = np.empty((nq, m), np.int32)
    for i in range(nq):
        mask = ideal_i[i] != qidx[i]
        keep_s[i], keep_i[i] = ideal_s[i][mask][:m], ideal_i[i][mask][:m]

    topo = paper_topology(spec.k)
    log(f"{'variant':10s} {'msgs/query':>10s} {'recall@10':>10s} "
        f"{'NCS@10':>8s}")
    out = dict(ideal=dict(ids=keep_i, scores=keep_s))
    for variant in VARIANTS:
        e = LshEngine(params, h, store, corpus, topo,
                      EngineConfig(variant=variant), device=dev)
        r = e.search(qd, m=m, exclude=qidx)
        rec = metrics.recall_at_m(r.ids, keep_i)
        ncs = metrics.ncs_at_m(r.scores, keep_s)
        log(f"{variant:10s} {r.cost.messages:10.0f} {rec:10.3f} {ncs:8.3f}")
        out[variant] = dict(messages=float(r.cost.messages), recall=rec,
                            ncs=ncs, ids=r.ids, scores=r.scores)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
