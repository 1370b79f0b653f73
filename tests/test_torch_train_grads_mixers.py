"""The port's training loss and gradients (`repro_torch.train.
train_step.make_loss_fn` through `torch.autograd`) against JAX's
`make_loss_fn` value-and-grad, on JAX's weights and JAX's token batch,
for the MoE, mamba-hybrid and xLSTM SMOKE configs, f32 and bf16.  Remat on (the
default), a 16-token loss chunk over 32 tokens.  Tolerances in
`tests/torch_train_cases.py`; the attention-only configs are in
`tests/test_torch_train_grads.py`.  The MoE layers (deepseek, jamba,
llama4) recompute their routing and capacity table in the backward's
remat pass, which must give the forward's.
"""

from __future__ import annotations

import pytest

from torch_train_cases import LOSS_TOL, compare, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCHS = ("deepseek-moe-16b", "jamba-v0.1-52b", "xlstm-1.3b",
         "llama4-maverick-400b-a17b")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_equal_reference(arch, dtype):
    jm, tm, errs, bound = compare(arch, dtype)
    assert set(tm) == set(jm)
    assert tm["tokens"] == jm["tokens"]
    for k in ("loss", "xent", "lb_loss", "z_loss"):
        assert abs(tm[k] - jm[k]) <= LOSS_TOL[dtype] * max(abs(jm[k]), 1.0), k
    worst = max(errs, key=errs.get)
    assert errs[worst] <= bound, (worst, errs[worst], bound)
