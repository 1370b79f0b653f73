"""Framework integration: model-produced embeddings behind NearBucket-LSH
(the PyTorch port's).

Embeds "users" (token histories) with an assigned-architecture backbone
(gemma2-2b's smoke configuration), indexes the embeddings in the LSH
store, and serves similar-user queries through the online serving
frontend (`repro_torch.serve`, DESIGN.md Sec. 7): dynamic batching plus
the sketch-keyed result cache.  Users re-query (a second pass over the
same queries), so the cache hit rate and the messages/query saving show
beside the paper's community-purity check.  The port of
`examples/retrieval_serve.py`; it prints the same lines.

    PYTHONPATH=src python examples/torch_retrieval_serve.py   # the card
    PYTHONPATH=src python examples/torch_retrieval_serve.py --device cpu

The reference embeds under a one-device mesh (`sharding.use_mesh`); the
port runs the model on one device with no mesh.  On the card the store
build and the engine's sketch run through the simhash kernel and its
scoring through bucket_topk.  `run(model=..., hyperplanes=...)` takes
other weights and hyperplanes (the JAX package's, to compare the two
scripts).
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
from repro_torch.configs import get_config               # noqa: E402
from repro_torch.core import (DenseCorpus, EngineConfig,  # noqa: E402
                              LshEngine, LshParams, make_hyperplanes)
from repro_torch.core.hashing import sketch_codes_batched  # noqa: E402
from repro_torch.core.store import build_store_host      # noqa: E402
from repro_torch.models import model as M                # noqa: E402
from repro_torch.serve import (FrontendConfig,           # noqa: E402
                               RetrievalFrontend, RuntimeBackend)


def run(device=None, model=None, hyperplanes=None, log=print) -> dict:
    """The example on `device` (the card unless "cpu"); returns the
    served ids and scores, the purity counts and the serving summary."""
    dev = resolve_device(device)
    cfg = get_config("gemma2-2b", smoke=True)
    model = M.init_model(cfg, seed=0, device=dev) if model is None else model
    rng = np.random.default_rng(0)

    n_users, seq, n_comm = 512, 16, 16
    comm = rng.integers(0, n_comm, n_users)
    toks = rng.integers(0, cfg.vocab_size, (n_users, seq))
    proto = rng.integers(0, cfg.vocab_size, (n_comm, 8))
    toks[:, :8] = proto[comm]  # community members share a token prefix

    log(f"embedding {n_users} users with {cfg.name} ...")
    embs = []
    with torch.no_grad():
        for s in range(0, n_users, 128):
            hidden = M.forward(model, {"tokens": torch.as_tensor(
                toks[s:s + 128], dtype=torch.int32, device=dev)})
            embs.append(hidden.mean(dim=1).float().cpu().numpy())
    emb = np.concatenate(embs)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)

    lsh = LshParams(d=emb.shape[1], k=6, L=4, seed=1)
    h = (make_hyperplanes(lsh, device=dev) if hyperplanes is None
         else torch.tensor(np.asarray(hyperplanes, np.float32), device=dev))
    vecs = torch.as_tensor(emb, device=dev)
    codes = sketch_codes_batched(vecs, h)
    store = build_store_host(codes, lsh.num_buckets, capacity=128,
                             device=dev)
    engine = LshEngine(lsh, h, store, DenseCorpus(vecs), None,
                       EngineConfig(variant="cnb",
                                    use_kernels=dev.type == "cuda"),
                       device=dev)

    frontend = RetrievalFrontend(
        RuntimeBackend(engine),
        FrontendConfig(m=10, max_batch=32, queue_capacity=128),
    )

    nq = 64
    ids, scores = frontend.search(emb[:nq], exclude=np.arange(nq))
    # the served ids equal a direct engine.search (tests/test_torch_
    # serve.py); the purity check is the reference's
    total = match = 0
    for i in range(nq):
        for j in ids[i]:
            if j >= 0:
                total += 1
                match += int(comm[j] == comm[i])

    # second pass: the users re-query, served from the sketch-keyed cache
    ids2, _ = frontend.search(emb[:nq], exclude=np.arange(nq))
    assert np.array_equal(ids2, ids)

    s = frontend.stats.summary()
    log(f"community purity of retrieved neighbors: {match/total:.2f} "
        f"({match}/{total})")
    log(f"cache hit rate = {s['hit_rate']:.2f}; "
        f"messages/query = {s['messages_per_query']:.1f} "
        f"(no-cache closed form {frontend.backend.cost().messages:.0f}); "
        f"p99 latency = {s['p99_us']:.0f}us")
    assert match / total > 0.5
    assert s["hit_rate"] >= 0.5  # the whole second pass hit
    return dict(ids=ids, scores=scores, match=match, total=total,
                summary=s)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
