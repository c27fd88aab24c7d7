"""The span reduction (``benchmark/spans.py``) on synthetic kineto-like
events: device operations matched to their launching runtime call by
correlation id, on any thread; the blocking calls; idle intervals given by
their midpoint; nothing read without spans; each reading; and
``trace.reduce_events`` reading the same with and without the program's
ranges in the events.  Then the tool's whole run at tiny sizes on the CPU,
where only the host's readings exist."""

from __future__ import annotations

import pytest
import torch

from benchmark import spans
from benchmark.tests import tiny
from benchmark.trace import WINDOW_LABEL, reduce_events
from mm_diffusion_tpu_torch.utils.tracing import Span

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Event:
    """What the reductions read of a kineto event; times in microseconds."""

    def __init__(self, name, start, end, device=CPU, correlation=0, annotation=False):
        self._name, self._start, self._end = name, start, end
        self._device, self._correlation, self._annotation = device, correlation, annotation

    def name(self):
        return self._name

    def device_type(self):
        return self._device

    def start_ns(self):
        return int(self._start * 1000)

    def end_ns(self):
        return int(self._end * 1000)

    def is_user_annotation(self):
        return self._annotation

    def correlation_id(self):
        return self._correlation


def launch(at, correlation, kernel, start, end):
    """A runtime launch call on the host and the kernel it launched."""
    return [Event("cudaLaunchKernel", at, at + 5, correlation=correlation),
            Event(kernel, start, end, device=CUDA, correlation=correlation)]


def train_events(ranges=True):
    """One train step in a window of 1000 us.  Device operations: 60-90 (launched outside
    every span), 160-250 (forward), 610-650 (launched at 400 from another thread while the
    main thread is in the backward), 660-700 (optimizer).  Idle: 0-60, 90-160, 250-610,
    650-660, 700-1000 (midpoints 30, 125, 430, 655, 850)."""
    events = [Event(WINDOW_LABEL, 0, 1000), Event("aten::add", 140, 260, correlation=3)]
    events += launch(50, 4, "elementwise_kernel", 60, 90)
    events += launch(150, 1, "elementwise_kernel", 160, 250)
    events += launch(400, 2, "cudnn_wgrad", 610, 650)
    events += launch(620, 3, "multi_tensor_apply_kernel", 660, 700)
    events += [Event("cudaStreamSynchronize", 640, 655), Event("cudaMemcpyAsync", 630, 632),
               Event("cudaDeviceSynchronize", 950, 999)]
    if ranges:
        events += [Event("train.step", 100, 900), Event("train.forward", 110, 300),
                   Event("train.backward", 300, 600), Event("train.optimizer", 600, 700),
                   Event("train.ema", 700, 800),
                   Event("train.step", 100, 900, device=CUDA, annotation=True)]
    return events


def sample_events():
    """One sampler call (100-900) with two model evaluations (200-400, 500-700); its own
    launch at 450 and a blocking copy at 480 between them.  Idle: 0-260, 390-460,
    470-560, 690-1000 (midpoints 130, 425, 515, 845; only 515 in an evaluation)."""
    events = [Event(WINDOW_LABEL, 0, 1000), Event("sample.call", 100, 900),
              Event("sample.nfe", 200, 400), Event("sample.nfe", 500, 700),
              Event("cudaStreamSynchronize", 480, 490)]
    events += launch(250, 1, "conv_fprop", 260, 390)
    events += launch(450, 2, "elementwise_kernel", 460, 470)
    events += launch(550, 3, "conv_fprop", 560, 690)
    return events


def test_launches_are_matched_by_correlation_id_into_the_span_that_launched_them():
    tr = spans.reduce_spans(train_events())
    got = {n: (st.count, st.launches, st.busy_us, st.syncs) for n, st in tr.spans.items()}
    assert got == {
        "train.step": (1, 3, 170.0, 1),
        "train.forward": (1, 1, 90.0, 0),
        "train.backward": (1, 1, 40.0, 0),  # launched at 400, ran at 610-650
        "train.optimizer": (1, 1, 40.0, 1),
        "train.ema": (1, 0, 0.0, 0),
        spans.OUTSIDE: (0, 1, 30.0, 1),
    }


def test_the_blocking_calls():
    assert {"cudaDeviceSynchronize", "cudaStreamSynchronize", "cudaEventSynchronize",
            "cudaMemcpy"} <= set(spans.SYNC_CALLS)
    assert not {"cudaMemcpyAsync", "cudaLaunchKernel", "cudaStreamWaitEvent",
                "cudaEventRecord"} & set(spans.SYNC_CALLS)
    assert len(set(spans.SYNC_CALLS)) == len(spans.SYNC_CALLS)


def test_idle_intervals_go_to_the_spans_open_at_their_midpoint():
    tr = spans.reduce_spans(train_events())
    assert tr.window_us == 1000.0 and tr.idle_us == 800.0
    idle = {n: st.idle_us for n, st in tr.spans.items()}
    assert idle == {"train.step": 740.0, "train.forward": 70.0, "train.backward": 360.0,
                    "train.optimizer": 10.0, "train.ema": 0.0, spans.OUTSIDE: 60.0}


def test_nothing_is_read_without_spans():
    assert spans.reduce_spans(train_events(ranges=False)) is None
    assert spans.reduce_spans([e for e in train_events() if e.device_type() == CPU]) is None
    for read in spans.READERS.values():
        assert read([], None) is None


@pytest.mark.parametrize("name,events,want", [
    ("launches_per_step.train", train_events, 3.0),
    ("host_syncs_per_step.train", train_events, 1.0),
    ("launches_per_nfe.sample", sample_events, 1.0),
    ("host_syncs_per_call.sample", sample_events, 1.0),
    ("solver_idle_share.sample", sample_events, 100.0 * (260 + 70 + 310) / 730),
])
def test_each_device_reading(name, events, want):
    assert spans.READERS[name]([], spans.reduce_spans(events())) == pytest.approx(want)


def test_a_count_of_no_syncs_is_a_reading():
    events = [e for e in sample_events() if e.name() != "cudaStreamSynchronize"]
    assert spans.host_syncs_per_call_sample([], spans.reduce_spans(events)) == 0.0


def test_each_host_reading():
    ms = 1_000_000
    records = []
    for step, (total, opt, ema) in enumerate([(300, 10, 2), (500, 30, 4), (400, 20, 3)]):
        records += [Span("train.step", step, -1, 0, total * ms),
                    Span("train.optimizer", step, 0, 0, opt * ms),
                    Span("train.ema", step, 0, 0, ema * ms)]
    assert spans.host_ms_train(records, None) == 400.0
    assert spans.optimizer_host_ms_train(records, None) == 23.0


def test_reduce_events_reads_the_same_with_the_programs_ranges():
    plain, ranged = reduce_events(train_events(ranges=False)), reduce_events(train_events())
    for field in ("window_us", "busy_us", "kernel_us", "by_kind", "top_ops"):
        assert getattr(plain, field) == getattr(ranged, field), field
    assert [us for _, us in plain.idle_gaps] == [us for _, us in ranged.idle_gaps]
    # a gap is now named after the span the host was in
    assert dict((us, n) for n, us in ranged.idle_gaps)[360.0] == "train.backward"


@pytest.mark.parametrize("workload", ["sr-ddim25-clip", "mm-train-b4"])
def test_the_tool_runs_a_tiny_cell_on_the_cpu(workload):
    torch.set_num_threads(1)
    config, traffic = tiny.cell(workload)
    got = spans.measure(tiny.spec(), workload, 2**31 + 9, 0.05, 1, torch.device("cpu"),
                        config=config, traffic=traffic)
    assert [w["tracing"] for w in got["windows"]] == [False, True]
    assert got["spans"] == []  # no device operations on the CPU: no device readings
    if workload == "mm-train-b4":
        assert set(got["readings"]) == {"host_ms.train", "optimizer_host_ms.train"}
        assert got["readings"]["host_ms.train"] > got["readings"]["optimizer_host_ms.train"] > 0
    else:
        assert got["readings"] == {}
