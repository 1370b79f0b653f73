"""Assigned input-shape cells (seq_len x global_batch) and applicability."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# long_500k needs sub-quadratic sequence mixing (DESIGN.md Sec. 5): only the
# hybrid/SSM archs run it; pure full-attention archs skip (recorded, not run).
LONG_CAPABLE = {"jamba-v0.1-52b", "xlstm-1.3b"}


def cell_applicable(arch_name: str, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return arch_name in LONG_CAPABLE
    return True


def all_cells(arch_names):
    """(arch, shape, applicable) triples — 40 nominal cells."""
    out = []
    for a in arch_names:
        for s in SHAPES:
            out.append((a, s, cell_applicable(a, s)))
    return out
