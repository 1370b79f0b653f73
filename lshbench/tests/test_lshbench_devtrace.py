"""The trace reader's arithmetic and the per-layer readers built on
it."""

import types
from pathlib import Path

import torch

from lshbench import devtrace, harness, spec


def test_csrc_kernel_names_are_read_from_the_sources():
    from repro_torch.kernels import _build

    names = devtrace.csrc_kernels(_build.CSRC)
    assert {"fq_score_dot", "fq_select", "hamming_kernel",
            "simhash_warp_kernel", "bt_part_fast"} <= names
    assert devtrace.kernel_id(
        "void fq_select<true>(int const*, float const*)") == "fq_select"
    assert devtrace.kernel_id("void at::native::radixSortKVInPlace<2>(x)"
                              ) == "radixSortKVInPlace"
    assert devtrace.kernel_id("Memcpy DtoD (Device -> Device)") == \
        "Memcpy DtoD"


def _event(name, start_us, end_us, cuda):
    from torch.autograd import DeviceType

    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start_us,
                                                    end=end_us),
        device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
        is_user_annotation=False)


def test_trace_summary_busy_share_and_idle_by_span():
    events = [
        _event(devtrace.WINDOW, 0, 100, False),
        _event("lshbench/dispatch", 0, 30, False),
        _event("lshbench/readback", 60, 100, False),
        _event("k1", 10, 40, True),
        _event("k2", 30, 50, True),      # overlaps k1: busy 10..50
        _event("k3", 70, 80, True),
    ]
    s = devtrace.TraceSummary(types.SimpleNamespace(events=lambda: events))
    assert abs(s.window_s - 100e-6) < 1e-12
    assert abs(s.busy_s - 50e-6) < 1e-12
    gaps = dict(s.idle_gaps())
    # idle 0..10 (dispatch), 50..70 (harness 50..60, readback 60..70),
    # 80..100 (readback)
    assert abs(gaps["lshbench/dispatch"] - 10e-6) < 1e-12
    assert abs(gaps["lshbench/readback"] - 30e-6) < 1e-12
    assert abs(gaps["lshbench/harness"] - 10e-6) < 1e-12
    assert s.device_ops()[0][0] == "k1"
    assert Path(devtrace.__file__).parent.name == "lshbench"


def test_layer_readers_read_the_trace_or_nothing():
    events = [_event(devtrace.WINDOW, 0, 100, False),
              _event("fq_select", 10, 30, True),
              _event("radixSortKVInPlace", 40, 80, True)]
    s = devtrace.TraceSummary(types.SimpleNamespace(events=lambda: events))
    win = harness.Window(0.0, 8, 0, [], 0, {}, batches=4)
    ctx = harness.LayerContext({}, s, {"fq_select"}, win)
    for cell in ("can16", "1node"):
        idle = spec.metric_reader(f"device_idle.{cell}")(ctx)
        glue = spec.metric_reader(f"glue_ms.{cell}")(ctx)
        assert abs(idle - 40.0) < 1e-9
        assert abs(glue - 1e3 * 40e-6 / 4) < 1e-12
        none = harness.LayerContext({}, None, set(), win)
        assert spec.metric_reader(f"device_idle.{cell}")(none) is None
        assert spec.metric_reader(f"glue_ms.{cell}")(none) is None
