"""The port's examples against the JAX package's scripts, on the CPU.

`examples/torch_quickstart.py` and `examples/torch_retrieval_serve.py`
print the tables of `examples/quickstart.py` and
`examples/retrieval_serve.py` line for line when they take the JAX
package's draws: its hyperplanes (drawn as the scripts draw them) and,
for retrieval_serve, its gemma2 smoke weights through
`repro_torch.convert.model_from`.  The one field left out is
retrieval_serve's p99 latency, a host time.  Both reference scripts run
here in-process, loaded from their files.  `examples/torch_train_lm.py`
trains, stops and resumes from its checkpoint, as `examples/train_lm.py`
does.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import os
import re

import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core import LshParams as JParams
from repro.core import make_hyperplanes as j_make_hyperplanes
from repro.data import osn as josn
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs import get_config
from torch_train_cases import one_torch_thread  # noqa: F401

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


def load(name: str):
    """`examples/<name>.py` as a module (its main is not run)."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def printed(fn) -> list[str]:
    """The lines `fn()` prints."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue().splitlines()


def test_quickstart_prints_the_reference_table():
    want = printed(load("quickstart").main)
    spec = josn.tiny_spec()
    jh = j_make_hyperplanes(JParams(d=spec.num_interests, k=spec.k, L=4,
                                    seed=7))
    lines = []
    out = load("torch_quickstart").run(device="cpu",
                                       hyperplanes=np.asarray(jh),
                                       log=lines.append)
    assert lines == want
    assert len(lines) == 6 and lines[1].split()[:2] == ["variant",
                                                        "msgs/query"]
    # the paper's claim as the script shows it: cnb spends lsh's messages
    # and finds more
    assert out["cnb"]["messages"] == out["lsh"]["messages"]
    assert out["cnb"]["recall"] > out["lsh"]["recall"]


def _no_latency(lines):
    return [re.sub(r"p99 latency = \d+us", "p99 latency = <host time>", s)
            for s in lines]


def test_retrieval_serve_prints_the_reference_lines():
    want = printed(load("retrieval_serve").main)
    jcfg = jget_config("gemma2-2b", smoke=True)
    params, _ = JM.init_model(jcfg, seed=0)
    model = convert.model_from(params, get_config("gemma2-2b", smoke=True),
                               device="cpu")
    jh = j_make_hyperplanes(JParams(d=jcfg.d_model, k=6, L=4, seed=1))
    lines = []
    out = load("torch_retrieval_serve").run(
        device="cpu", model=model, hyperplanes=np.asarray(jh),
        log=lines.append)
    assert _no_latency(lines) == _no_latency(want)
    assert len(lines) == 3 and lines[1].startswith("community purity")
    assert out["match"] / out["total"] > 0.5


def test_train_lm_resumes_from_its_checkpoint(one_torch_thread):
    """`examples/torch_train_lm.py` at 50 steps: phase 1 trains 25 steps
    and writes step 25, phase 2 prints the training CLI's resume line, goes on
    from step 25 to 50 and ends with a finite, lower xent."""
    lines = []
    out = load("torch_train_lm").run(device="cpu", steps=50,
                                     log=lines.append)
    assert lines[0] == ("=== phase 1: steps 0..25 (then simulated "
                        "preemption) ===")
    i = lines.index("=== phase 2: resume from checkpoint to 50 ===")
    assert lines[i + 1].startswith("[resume] restoring ")
    assert lines[i + 1].endswith("step_00000025 (step 25)")
    assert not any(s.startswith("[step     0]") for s in lines[i:])
    xents = [float(s.split("xent=")[1].split()[0]) for s in lines
             if s.startswith("[step")]
    assert all(np.isfinite(xents)) and xents[-1] < xents[0]
    assert int(out["opt_state"]["count"]) == 50
    assert lines[-1] == "[done]"


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_retrieval_serve",
                                  "torch_train_lm"])
def test_examples_refuse_to_drop_to_the_cpu_unasked(name):
    """With no card and no `--device`, an example raises rather than run
    on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a host with a card runs the example there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load(name).main([])
