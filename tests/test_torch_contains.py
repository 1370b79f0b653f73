"""fused_contains on the CPU: the wrapper's plain path against the JAX
oracle on the cases of `tests/torch_fused_cases.py`, and the blocks the
host picks for the CUDA kernel (`fused_query.contains_grid`), a pure
function of the row count and the SM count.  `test_torch_cuda.py` holds the
kernel itself against the plain version on the same cases."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import ref as jref
from repro_torch.kernels import fused_query as fq
from repro_torch.kernels import ops
from torch_fused_cases import CONTAINS_CASES, contains_case

# SM counts of an H100 SXM (132), an H100 PCIe (114) and a larger part
SM_COUNTS = (114, 132, 144)
SMALL_CASES = [n for n in CONTAINS_CASES if not n.startswith("main")]


@pytest.mark.parametrize("case", SMALL_CASES)
def test_fused_contains_matches_jax(case):
    ids, fb, meta = contains_case(case, seed=3)
    want = np.asarray(jref.fused_contains_ref(
        jnp.asarray(ids.numpy()), jnp.asarray(fb.numpy()),
        jnp.asarray(meta.numpy())))[:, 0] > 0
    got = ops.fused_contains(ids, fb, meta)
    np.testing.assert_array_equal(got.numpy(), want)
    if case in ("hit", "miss"):  # the traffic is what it says
        assert want.all() if case == "hit" else not want.any()
    if case == "no_valid_probe":
        assert not want[::2].any()


@pytest.mark.parametrize("sms", SM_COUNTS)
@pytest.mark.parametrize("r", [0, 1, 7, 128, 1000, 4096, 4097, 65_536])
def test_contains_grid_covers_each_row_once(sms, r):
    """A warp a row: the blocks' warps cover rows 0 .. r-1 once (only the
    last block has idle warps); a block for every SM while rows allow,
    at most CONTAINS_MAX_ROWS rows a block."""
    g = fq.contains_grid(r, sms)
    assert g.rows in (1, 2, 4, 8, 16) and g.rows <= fq.CONTAINS_MAX_ROWS
    assert (g.blocks - 1) * g.rows < r <= g.blocks * g.rows \
        or r == g.blocks == 0
    assert g.blocks >= min(sms, r)
    if g.rows < fq.CONTAINS_MAX_ROWS:  # more rows a block leave SMs idle
        assert -(-r // (2 * g.rows)) < sms


def test_contains_grid_main_path():
    """4096 rows (1024 queries x 4 tables) on 132 SMs: 16 rows a block, 256
    blocks; an engine chunk's 128 rows: a block a row."""
    assert fq.contains_grid(4096, 132) == fq.ContainsGrid(16, 256)
    assert fq.contains_grid(128, 132) == fq.ContainsGrid(1, 128)
