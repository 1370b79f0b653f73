"""Network/storage/work cost accounting (paper Table 1).

Message unit = one CAN overlay hop (the paper's unit).  The distributed TPU
runtime additionally reports *collective bytes* measured from compiled HLO
(see benchmarks/bench_distributed.py); this module is the overlay-level
model that Table 1 is written in, and is what the simulator counts.

             nodes contacted   avg messages    vectors/node   vectors searched
  LSH              L              k L / 2            B               L B
  Layered          L              k L / 2            B               L B
  NB-LSH        L (1 + k)       3 k L / 2            B           L (k + 1) B
  CNB-LSH          L              k L / 2        (k + 1) B       L (k + 1) B
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class QueryCost:
    nodes_contacted: float
    messages: float
    vectors_stored_per_node: float
    vectors_searched: float


VARIANTS = ("lsh", "layered", "nb", "cnb")


def table1(variant: str, k: int, L: int, bucket_size: float = 1.0) -> QueryCost:
    """Closed-form per-query costs of paper Table 1."""
    B = float(bucket_size)
    if variant in ("lsh", "layered"):
        return QueryCost(L, 0.5 * k * L, B, L * B)
    if variant == "nb":
        return QueryCost(L * (1 + k), 1.5 * k * L, B, L * (k + 1) * B)
    if variant == "cnb":
        return QueryCost(L, 0.5 * k * L, (k + 1) * B, L * (k + 1) * B)
    raise ValueError(f"unknown variant {variant!r}")


def lsh_L_for_budget(variant: str, k: int, message_budget: float) -> int:
    """Largest L whose average message cost fits the budget (Fig. 3 setup)."""
    per_L = {"lsh": 0.5 * k, "layered": 0.5 * k, "nb": 1.5 * k, "cnb": 0.5 * k}[
        variant
    ]
    return max(int(message_budget // per_L), 0)


@dataclasses.dataclass
class MessageCounter:
    """Mutable per-run message accounting used by the overlay simulator."""

    dht_lookups: int = 0
    lookup_hops: int = 0
    neighbor_messages: int = 0
    result_messages: int = 0

    @property
    def total(self) -> int:
        # The paper counts routing hops + neighbor forwards as "messages";
        # result returns are symmetric across variants and excluded from
        # Table 1's accounting, so `total` matches Table 1.
        return self.lookup_hops + self.neighbor_messages

    def add_lookup(self, hops: int) -> None:
        self.dht_lookups += 1
        self.lookup_hops += int(hops)

    def add_neighbor(self, n: int = 1) -> None:
        self.neighbor_messages += int(n)

    def add_result(self, n: int = 1) -> None:
        self.result_messages += int(n)

    def publish(self, registry, **labels) -> None:
        """Mirror the counts into an `repro.obs` metrics registry (the
        unified export surface, DESIGN.md Sec. 12).  Gauges, not
        counters: a MessageCounter is itself the accumulator, so
        publishing is an idempotent snapshot."""
        for field in ("dht_lookups", "lookup_hops", "neighbor_messages",
                      "result_messages"):
            registry.gauge(f"overlay_{field}").set(
                getattr(self, field), **labels)
        registry.gauge(
            "overlay_messages_total",
            "Table-1 overlay messages (lookup hops + neighbor forwards)",
        ).set(self.total, **labels)


# -- elastic membership: bucket-state handoff (DESIGN.md Sec. 9) -------------


def estimate_handoff_bytes(
    L: int,
    num_buckets: int,
    capacity: int,
    d: int,
    old_n: int,
    new_n: int,
) -> int:
    """Protocol-level bytes of one power-of-two join/leave round.

    The Table-1 analogue for membership: every bucket row changing owner
    ships its id (4 B) and timestamp (4 B) slots, its embedded payload
    slots (4 B * d; 0 for id-only stores), and its ring pointer (4 B),
    across all L tables.  With contiguous prefix zones exactly
    NB * (1 - min(N, N')/max(N, N')) rows move per table — the closed
    form `repro.core.can.moved_buckets` is derived from.  Charged by the
    node-churn driver alongside the refresh bytes, never silently."""
    lo, hi = sorted((int(old_n), int(new_n)))
    if lo < 1:
        raise ValueError(f"node counts must be >= 1, got {old_n}, {new_n}")
    moved = num_buckets - num_buckets * lo // hi
    per_bucket = capacity * (8 + 4 * d) + 4
    return L * moved * per_bucket


# -- R-way replication: announce fan-out + zone recovery (DESIGN.md Sec. 10) --


def estimate_replication_bytes(L: int, n_vectors: int, d: int, R: int) -> int:
    """Protocol-level bytes of fanning ONE full announce out to the R-1
    replica owners (the availability analogue of Table 1's maintenance
    column).

    Soft state makes replication cheap to keep fresh (paper Sec. 4.1):
    replicas are not separately maintained — each re-announce simply
    lands on R owners instead of one, so the extra cost per announce is
    (R-1) copies of every announced entry: id (4 B) + timestamp (4 B) +
    embedded payload (4 B * d), per table.  0 when R == 1.  Charged by
    the failure-churn driver at every announce epoch, never silently."""
    R = int(R)
    if R < 1:
        raise ValueError(f"replication R must be >= 1, got {R}")
    return (R - 1) * int(L) * int(n_vectors) * (8 + 4 * int(d))


def estimate_recovery_bytes(
    L: int, buckets_per_node: int, capacity: int, d: int
) -> int:
    """Protocol-level bytes of repopulating ONE revived node's zone.

    A fail-stop kill loses the node's bucket state with NO handoff; the
    node rejoins at the next re-announce and receives its full zone back
    (ids + timestamps + embedded payloads + ring pointers across all L
    tables) — the same per-bucket form as `estimate_handoff_bytes`, over
    one zone.  Charged by the failure-churn driver on every revival."""
    per_bucket = int(capacity) * (8 + 4 * int(d)) + 4
    return int(L) * int(buckets_per_node) * per_bucket


# -- ICI byte model for the TPU runtime (DESIGN.md Sec. 2) --------------------

ICI_LINK_GBPS = 50e9  # ~50 GB/s per link, v5e 2-D torus


def collective_seconds(bytes_on_wire: float, n_links: int = 1) -> float:
    return bytes_on_wire / (ICI_LINK_GBPS * max(n_links, 1))
