"""The attribution of a window's device operations to the program's spans
(``benchmark/attribution.py``), on synthetic event lists, and a tiny cell
run with the program's collection on."""

from types import SimpleNamespace

import pytest
import torch

from benchmark import attribution as at
from benchmark.trace import DeviceTrace
from tiny import tiny_root

SEED = 2**31 + 91
CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Event:
    """The parts of a ``torch.profiler`` event that the reducers read."""

    def __init__(self, name, start, dur, device=CPU, corr=0, linked=0):
        self._v = (name, start, dur, device, corr, linked)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


def window():
    """Two training steps on one thread, the backward's propagation on a
    second one, and device work that trails the launches.  Times in ns."""
    spans = [
        ("train.step", 1000, 2000), ("train.forward", 1000, 1300),
        ("spmm.forward", 1010, 1290), ("spmm.hub", 1100, 1150),
        ("train.backward", 1400, 1800), ("spmm.backward", 1420, 1790),  # autograd's thread
        ("train.adam", 1850, 1990),
        ("train.step", 3000, 4000), ("train.forward", 3000, 3300),
        ("spmm.forward", 3010, 3290), ("train.backward", 3400, 3800),
        ("spmm.backward", 3420, 3790),
    ]
    events = [
        # (runtime call on the host, the kernel it launched)
        Event("cudaLaunchKernel", 1020, 5, corr=1), Event("gather", 1100, 300, CUDA, 1),
        Event("cudaLaunchKernel", 1120, 5, corr=2), Event("gemm", 1400, 100, CUDA, 2),
        Event("cudaLaunchKernel", 1500, 5, corr=3), Event("gather", 1600, 300, CUDA, 3),
        Event("cudaMemcpyAsync", 1900, 5, corr=4), Event("copy", 1950, 50, CUDA, 4),
        # launched between the steps, outside every span
        Event("cudaLaunchKernel", 2500, 5, corr=5), Event("fill", 2600, 10, CUDA, 5),
        Event("cudaLaunchKernel", 3020, 5, corr=6), Event("gather", 3100, 300, CUDA, 6),
        Event("cudaLaunchKernel", 3500, 5, corr=7), Event("gather", 3700, 300, CUDA, 7),
        # linked to its call by the linked id only
        Event("cudaLaunchKernel", 3850, 5, corr=8), Event("adam", 4100, 40, CUDA, 9, 8),
    ]
    return spans, events


def test_a_backward_kernel_on_another_thread_counts_under_its_spans():
    spans, events = window()
    ops, launch = at.device_launches(events)
    assert launch == [1020, 1120, 1500, 1900, 2500, 3020, 3500, 3850]
    att = at.attribute(ops, launch, spans, (0, 5000))
    assert att["unit"] == "train.step" and att["steps"] == 2
    sp = att["spans"]
    # inclusive, by time: the backward's gathers count under spmm.backward,
    # train.backward and train.step alike, a step being two units
    assert sp["spmm.backward"]["device_ms"] == pytest.approx(600 / 2 * 1e-6)
    assert sp["train.backward"]["device_ms"] == pytest.approx(600 / 2 * 1e-6)
    assert sp["spmm.forward"]["device_ms"] == pytest.approx(700 / 2 * 1e-6)
    assert sp["spmm.hub"]["device_ms"] == pytest.approx(100 / 2 * 1e-6)
    assert sp["train.step"]["device_ms"] == pytest.approx(1390 / 2 * 1e-6)
    assert sp["train.step"]["launches"] == 7 / 2
    assert sp["train.step"]["host_ms"] == pytest.approx(1000 * 1e-6)
    assert att["device_s"] == pytest.approx(1400e-9)
    assert att["covered"] == pytest.approx(1390 / 1400)
    assert att["unit_covered"] == pytest.approx(1390 / 1400)


def test_idle_gaps_are_named_by_the_shortest_span_holding_their_middle():
    spans, events = window()
    att = at.attribute(*at.device_launches(events), spans, (0, 5000))
    # gaps 1500-1600 (middle 1550: spmm.backward, inside train.backward and
    # train.step), 1900-1950 (1925: train.adam), 2000-2600 (2300: none),
    # 2610-3100 (2855: none), 3400-3700 (3550: spmm.backward), 4000-4100
    # (4050: none)
    assert dict(att["idle_by_span"]) == pytest.approx(
        {at.OUTSIDE: (600 + 490 + 100) * 1e-9, "spmm.backward": 400e-9, "train.adam": 50e-9})
    assert att["idle_by_span"][0][0] == at.OUTSIDE


def test_only_the_window_counts():
    spans, events = window()
    att = at.attribute(*at.device_launches(events), spans, (2500, 5000))
    assert att["steps"] == 1
    assert att["spans"]["train.step"]["launches"] == 3


def test_layer_metrics_of_a_training_window():
    spans, events = window()
    att = at.attribute(*at.device_launches(events), spans, (0, 5000))
    setup = [("spmm.to_device", 10, 2_000_000_010), ("spmm.to_device", 0, 500_000_000)]
    m = at.layer_metrics(att, 10_000, setup)
    assert m == pytest.approx({"step_propagate_ms": 1300 / 2 * 1e-6,
                               "step_hub_ms": 100 / 2 * 1e-6, "step_launches": 3.5,
                               "step_gathered_rows": 5000, "device_graph_s": 2.5})
    assert set(m) <= set(at.METRICS)


def test_layer_metrics_of_an_evaluation_window():
    spans = [("eval.validate", 0, 1000), ("spmm.forward", 0, 100), ("topk.mask", 200, 300),
             ("topk.select", 300, 400), ("eval.metrics", 400, 500)]
    events = [Event("cudaLaunchKernel", 250, 5, corr=1), Event("scatter", 260, 20, CUDA, 1),
              Event("cudaLaunchKernel", 350, 5, corr=2), Event("sort", 360, 80, CUDA, 2)]
    att = at.attribute(*at.device_launches(events), spans, (0, 2000))
    m = at.layer_metrics(att, None, [])
    assert m == pytest.approx({"eval_select_ms": 80e-6, "eval_mask_ms": 20e-6})
    assert at.layer_metrics(at.attribute([], [], [], (0, 1)), None, []) == {}


def test_the_device_traces_summary_is_unchanged():
    """``SpanTrace`` reduces a window's events to the same summary as
    ``DeviceTrace``, byte for byte, and attributes them besides."""
    spans, events = window()
    plain = DeviceTrace._reduce(events, 1e-5)
    st = at.SpanTrace(True, "cpu")

    at.SpanTrace.recorder = SimpleNamespace(
        spans=[SimpleNamespace(name=n, start_ns=a, end_ns=b) for n, a, b in spans])
    try:
        st.w0, st.w1, st.counters0, st.counters1, st.probes = 0, 5000, {}, {}, []
        summary = st._reduce(iter(events), 1e-5)
    finally:
        at.SpanTrace.recorder = None
    assert summary == plain
    assert repr(summary) == repr(plain)
    assert set(summary) == {"busy_s", "window_s", "device_ops", "idle_gaps"}
    assert at.SpanTrace.found["steps"] == 2
    assert at.SpanTrace.found["launched_share"] == 1.0


def test_skew_of_a_synchronise_inside_its_readings():
    # a synchronise of the window, two probes, the trace's closing one
    calls = [Event("cudaDeviceSynchronize", 10, 5), Event("cudaDeviceSynchronize", 100, 50),
             Event("cudaDeviceSynchronize", 158, 20), Event("cudaDeviceSynchronize", 900, 30)]
    assert at.skew_ns([(90, 155), (156, 185)], calls) == 0
    assert at.skew_ns([(90, 155), (160, 175)], calls) == 3
    assert at.skew_ns([(110, 140)], calls[1:2]) == 10
    assert at.skew_ns([], calls) is None and at.skew_ns([(1, 2), (3, 4)], calls[:1]) is None


@pytest.mark.parametrize("workload", ["books_d64.train", "books_d64.eval"])
def test_a_tiny_cell_with_the_programs_spans(tmp_path, workload):
    """On the CPU the trace holds no device operation: the spans, the
    counter and the set-up's upload still reach the line."""
    from benchmark import harness
    from benchmark.loads import train

    root = tiny_root(tmp_path)
    plain_cell = harness.run_cell
    with at.spans_attributed():
        line = harness.run_cell(root, workload, SEED, 0.5, True, device="cpu")
    assert harness.run_cell is plain_cell and train.DeviceTrace is DeviceTrace
    assert line["correct"], line["checks"]
    b = line["breakdown"]
    unit = "train.step" if workload.endswith("train") else "eval.validate"
    assert b["attribution"]["unit"] == unit and b["attribution"]["steps"] > 0
    assert b["spans"][unit]["host_ms"] > 0
    assert line["metrics"]["device_graph_s"]["value"] > 0
    if unit == "train.step":
        assert line["metrics"]["step_gathered_rows"]["value"] > 0
        assert {"train.forward", "train.loss", "train.backward", "train.adam",
                "spmm.forward", "spmm.backward"} <= set(b["spans"])
    else:
        assert {"topk.mask", "topk.select", "eval.metrics"} <= set(b["spans"])
    # the plain run is as it was: no span breakdown
    plain = harness.run_cell(root, workload, SEED, 0.5, True, device="cpu")
    assert "spans" not in plain.get("breakdown", {})
