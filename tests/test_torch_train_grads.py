"""The port's training loss and gradients (`repro_torch.train.
train_step.make_loss_fn` through `torch.autograd`) against JAX's
`make_loss_fn` value-and-grad, on JAX's weights and JAX's token batch,
for the six attention-only SMOKE configs, f32 and bf16.  Remat on (the
default), a 16-token loss chunk over 32 tokens.  Tolerances in
`tests/torch_train_cases.py`; the MoE, mamba and xLSTM configs are in
`tests/test_torch_train_grads_mixers.py`.
"""

from __future__ import annotations

import pytest

from torch_train_cases import LOSS_TOL, compare, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCHS = ("gemma2-2b", "starcoder2-7b", "codeqwen1.5-7b", "phi3-medium-14b",
         "seamless-m4t-medium", "phi-3-vision-4.2b")


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
