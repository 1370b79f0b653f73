"""Single-host search engine: LSH / Layered / NB-LSH / CNB-LSH.

A façade over the 1-node `IndexRuntime`: the probe / gather / score /
top-m path is the runtime's search step, run over the query batch in
chunks.  Algorithms 1/2 of the paper, with network cost accounted per
Table 1:
  * lsh / layered : search the L exact buckets.
  * nb            : + the k 1-near buckets of each (forwarded to neighbors).
  * cnb           : + the k 1-near buckets of each (served from local cache).
With `use_kernels=True` the sketch runs through the simhash kernel and
score/top-m through the bucket_topk kernel; ids are identical to the
reference path.  A `SparseCorpus` (the paper's OSN interest vectors) is
scored in plain torch, as the reference scores it outside any kernel,
and refuses `use_kernels`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import costmodel, hashing
from repro_torch.core import plan as plan_mod
from repro_torch.core import runtime as runtime_mod
from repro_torch.core.can import CanTopology
from repro_torch.core.corpus import DenseCorpus, SparseCorpus
from repro_torch.core.hashing import LshParams
from repro_torch.core.runtime import IndexRuntime, RuntimeConfig
from repro_torch.core.store import BucketStore


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    variant: str = "cnb"          # lsh | layered | nb | cnb
    num_probes: int | None = None  # None => all k 1-near buckets (the paper)
    ranked_probes: bool = False    # beyond-paper: margin-ranked probe subset
    chunk: int = 32                # queries scored per chunk
    use_kernels: bool = False      # simhash sketch + bucket_topk scoring


@dataclasses.dataclass
class SearchResult:
    ids: np.ndarray      # int32 [nq, m], -1 padded
    scores: np.ndarray   # f32   [nq, m]
    cost: costmodel.QueryCost          # closed-form per-query cost (Table 1)
    sim_messages: float | None = None  # simulated avg messages (hop-counted)
    dropped_probes: int = 0  # always 0: the 1-node router is the identity


class LshEngine:
    """Engine over an id-only BucketStore + a dense or sparse corpus.

    The corpus is the id-keyed payload source (the latest announced vector
    of each id).  Computes on the store's device.
    """

    def __init__(
        self,
        params: LshParams,
        hyperplanes: torch.Tensor,
        store: BucketStore,
        corpus: DenseCorpus | SparseCorpus,
        topology: CanTopology | None = None,
        config: EngineConfig = EngineConfig(),
        *,
        device=None,
    ):
        if config.variant not in costmodel.VARIANTS:
            raise ValueError(f"unknown variant {config.variant!r}")
        if config.use_kernels and not isinstance(corpus, DenseCorpus):
            raise ValueError(
                "use_kernels requires a DenseCorpus: the bucket_topk "
                "kernel scores dense candidate payloads")
        self.params = params
        self.hyperplanes = hyperplanes
        self.store = store
        self.corpus = corpus
        # overlay topology for the message SIMULATION (paper: one bucket
        # per node); execution runs on the runtime's 1-node topology.
        self.topology = topology or CanTopology(params.k, 1 << params.k)
        self.config = config
        self.runtime = IndexRuntime(RuntimeConfig(
            params=params,
            variant=config.variant,
            n_nodes=1,
            num_probes=config.num_probes,
            ranked_probes=config.ranked_probes,
            use_kernels=config.use_kernels,
        ), device=device)
        self.device = self.runtime.device

    @property
    def probe_spec(self) -> plan_mod.ProbeSpec:
        return self.runtime.cfg.probe_spec

    @property
    def probes_per_table(self) -> int:
        return self.probe_spec.probes_per_table

    def _pad_chunks(self, arrs: list[torch.Tensor], pad_vals: list):
        """Pad the leading dim to a chunk multiple and add a
        [nchunks, chunk] axis.  The chunk count rounds up to a power of two
        (small batches) or a multiple of 16 chunks (large batches), as the
        reference does; padded rows are sliced off by the caller."""
        c = self.config.chunk
        nq = arrs[0].shape[0]
        nchunks = max(1, -(-nq // c))
        if nchunks <= 16:
            nchunks = 1 << (nchunks - 1).bit_length()
        else:
            nchunks = -(-nchunks // 16) * 16
        out = []
        for a, v in zip(arrs, pad_vals):
            pad = nchunks * c - nq
            if pad:
                a = torch.cat([a, a.new_full((pad,) + a.shape[1:], v)])
            out.append(a.reshape(nchunks, c, *a.shape[1:]))
        return out

    def search(
        self,
        queries,                         # [nq, d] unit dense queries
        m: int,
        exclude: np.ndarray | None = None,  # [nq] self ids to drop, or None
        simulate_messages: bool = False,
        rng: np.random.Generator | None = None,
    ) -> SearchResult:
        q = torch.as_tensor(queries).to(self.device, torch.float32)
        nq = q.shape[0]
        ex = (np.full((nq,), -2, np.int32) if exclude is None
              else np.asarray(exclude, np.int32))
        qc, ec = self._pad_chunks(
            [q, torch.from_numpy(ex).to(self.device)], [0.0, -2])
        cfg = self.runtime.cfg
        parts = [
            runtime_mod.search_kernel(
                cfg, runtime_mod.LOCAL, m, self.hyperplanes, self.store.ids,
                None, None, None, qc[i], corpus=self.corpus,
                exclude=ec[i])[:2]
            for i in range(qc.shape[0])
        ]
        out_i = torch.cat([p[0] for p in parts])[:nq].cpu().numpy()
        out_s = torch.cat([p[1] for p in parts])[:nq].cpu().numpy()
        bucket_b = float(self.store.occupancy().float().mean())
        cost = costmodel.table1(
            self.config.variant, self.params.k, self.params.L, bucket_b)
        sim = (self.simulate_messages(queries, rng)
               if simulate_messages else None)
        return SearchResult(out_i, out_s, cost, sim, dropped_probes=0)

    def contains(self, queries, target_ids) -> np.ndarray:
        """Was target y searched for query x? (success-probability metric,
        paper Sec. 6.3 — membership in searched buckets, not top-m)."""
        q = torch.as_tensor(queries).to(self.device, torch.float32)
        nq = q.shape[0]
        tgt = torch.as_tensor(np.asarray(target_ids, np.int32)).to(self.device)
        qc, tc = self._pad_chunks([q, tgt], [0.0, -2])
        hits = [
            runtime_mod.contains_kernel(
                self.runtime.cfg, runtime_mod.LOCAL, self.hyperplanes,
                self.store.ids, None, qc[i], tc[i])[0]
            for i in range(qc.shape[0])
        ]
        return torch.cat(hits)[:nq].cpu().numpy()

    def simulate_messages(self, queries,
                          rng: np.random.Generator | None = None) -> float:
        """Hop-counted message simulation over the CAN topology; converges
        to Table 1's closed forms."""
        rng = rng or np.random.default_rng(0)
        q = torch.as_tensor(queries).to(self.device, torch.float32)
        codes = hashing.sketch_codes(q, self.hyperplanes).cpu().numpy()
        topo = self.topology
        counter = costmodel.MessageCounter()
        nq = codes.shape[0]
        src = rng.integers(0, topo.n_nodes, size=(nq,))
        for i in range(nq):
            for l in range(self.params.L):
                dst = int(topo.node_of_np(np.uint32(codes[i, l])))
                counter.add_lookup(topo.lookup_hops(int(src[i]), dst))
                counter.add_result()
                if self.config.variant == "nb":
                    counter.add_neighbor(topo.node_bits)
                    counter.add_result(topo.node_bits)
        return counter.total / nq
