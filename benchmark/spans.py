"""The port's spans (``mm_diffusion_tpu_torch/utils/tracing.py``) in one
cell: how long the host stays inside each layer boundary, and what it
launches, waits for and leaves idle on the device while it is there.

    python3 benchmark/spans.py --workload <cell> --seed <n> --seconds <s> [--rounds 2]

One process, one card.  After the cell's set-up (as ``run.py`` makes it),
``--rounds`` pairs of windows of ``--seconds`` each run whole calls back
to back with tracing off and on in turn (off, on, on, off, ...): the
cell's rate both ways, and the spans' host times from the ring with the
profiler off.  Then a profiler window over the traffic's ``trace_calls``
calls, tracing on, is reduced twice from the same events: as ``run.py``'s
traced window (``trace.reduce_events``) and span by span
(:func:`reduce_spans`).  The per-span table goes to standard error; the
last line of standard output is a JSON object with the windows, the table
and the readings of :data:`READERS`.

In the profiler's trace a span is a range on the host, on the kernels'
clock.  Each device operation (kernel, copy, fill) is matched to the
runtime call that launched it by correlation id and counts for every span
whose interval holds that call, on whichever thread made it: the kernels
that autograd's device thread launches count for ``train.backward``.  A
runtime call in :data:`SYNC_CALLS` blocks the host on the device.  Each
idle interval of the device (the window less the union of its operations)
counts for every span open at its midpoint.
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import itertools
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import run  # noqa: E402
from benchmark.trace import WINDOW_LABEL, _union, reduce_events  # noqa: E402

# A frozen copy of the port's span names, so that a later change to the
# port cannot move what a reading counts.
SPANS = ("sample.call", "sample.nfe", "train.step", "train.forward", "train.backward",
         "train.optimizer", "train.ema")
# Runtime and driver calls that return only when the device has reached
# them: the synchronisations, and the synchronous copies (PyTorch's own
# blocking copies and ``.item()`` end in ``cudaStreamSynchronize``).
SYNC_CALLS = (
    "cudaDeviceSynchronize", "cudaStreamSynchronize", "cudaEventSynchronize",
    "cudaMemcpy", "cudaMemcpy2D", "cudaMemcpy3D", "cudaMemcpyFromSymbol", "cudaMemcpyToSymbol",
    "cuCtxSynchronize", "cuStreamSynchronize", "cuEventSynchronize",
    "cuMemcpy", "cuMemcpyDtoH", "cuMemcpyDtoH_v2", "cuMemcpyHtoD", "cuMemcpyHtoD_v2",
)
OUTSIDE = "(outside spans)"


@dataclasses.dataclass
class SpanStats:
    """What one span name holds in a traced window, summed over its spans;
    times in microseconds."""

    count: int = 0
    host_us: float = 0.0
    launches: int = 0  # device operations launched while the host was inside
    busy_us: float = 0.0  # their device time
    syncs: int = 0  # calls of SYNC_CALLS made inside
    idle_us: float = 0.0  # device idle time with its midpoint inside


@dataclasses.dataclass
class SpanTrace:
    window_us: float
    idle_us: float  # the window's device idle time
    spans: Dict[str, SpanStats]  # by span name; OUTSIDE: what no span holds (count 0)


def _counter(points: List[float], weights: List[float]):
    """``(s, e) -> (points in [s, e], their summed weights)``."""
    order = sorted(range(len(points)), key=points.__getitem__)
    xs = [points[i] for i in order]
    sums = list(itertools.accumulate((weights[i] for i in order), initial=0.0))

    def within(s: float, e: float):
        i, j = bisect.bisect_left(xs, s), bisect.bisect_right(xs, e)
        return j - i, sums[j] - sums[i]

    return within


def reduce_spans(events) -> Optional[SpanTrace]:
    """A :class:`SpanTrace` from the profiler's raw (kineto) events of one
    window (``name()``, ``device_type()``, ``start_ns()``, ``end_ns()``,
    ``is_user_annotation()``, ``correlation_id()``); None where the window
    holds no span or no device operation."""
    window, ops, launched_at, syncs, spans = None, [], {}, [], []
    for e in events:
        name, s, t = e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                ops.append((e.correlation_id(), s, t))
        elif name == WINDOW_LABEL:
            window = (s, t)
        elif name in SPANS:
            spans.append((name, s, t))
        elif name.startswith("cu"):  # a CUDA runtime or driver call
            launched_at[e.correlation_id()] = s
            if name in SYNC_CALLS:
                syncs.append(s)
    if window is None:
        raise RuntimeError(f"the profiler recorded no {WINDOW_LABEL!r} range")
    w0, w1 = window
    ops = [(c, max(s, w0), min(t, w1)) for c, s, t in ops if t > w0 and s < w1]
    if not spans or not ops:
        return None
    ours = [(launched_at[c], t - s) for c, s, t in ops if c in launched_at]
    launches = _counter([x for x, _ in ours], [d for _, d in ours])
    blocking = _counter(syncs, [0.0] * len(syncs))
    edges = [w0] + [x for iv in _union([(s, t) for _, s, t in ops]) for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    idle = _counter([(s + t) / 2 for s, t in gaps], [t - s for s, t in gaps])

    def stats(intervals) -> SpanStats:
        st = SpanStats()
        for s, t in intervals:
            n, busy = launches(s, t)
            st.count, st.host_us = st.count + 1, st.host_us + t - s
            st.launches, st.busy_us = st.launches + n, st.busy_us + busy
            st.syncs += blocking(s, t)[0]
            st.idle_us += idle(s, t)[1]
        return st

    by_name = {name: stats([(s, t) for n, s, t in spans if n == name])
               for name in SPANS if any(n == name for n, _, _ in spans)}
    inside, total = stats(_union([(s, t) for _, s, t in spans])), stats([window])
    by_name[OUTSIDE] = SpanStats(0, total.host_us - inside.host_us, total.launches - inside.launches,
                                 total.busy_us - inside.busy_us, total.syncs - inside.syncs,
                                 total.idle_us - inside.idle_us)
    return SpanTrace(window_us=w1 - w0, idle_us=total.idle_us, spans=by_name)


# -- the readings: each takes the ring's records of the untraced window and
# -- the traced window's SpanTrace, and gives None where it has nothing to read


def _median_ms(values) -> Optional[float]:
    values = list(values)
    return statistics.median(values) / 1e6 if values else None


def host_ms_train(records, trace) -> Optional[float]:
    """Median host ms of ``train.step`` (spans on, profiler off)."""
    return _median_ms(r.end_ns - r.start_ns for r in records if r.name == "train.step")


def optimizer_host_ms_train(records, trace) -> Optional[float]:
    """Median a step of the host ms of ``train.optimizer`` and ``train.ema``."""
    per_step: Dict[object, int] = {}
    for r in records:
        if r.name in ("train.optimizer", "train.ema"):
            per_step[r.id] = per_step.get(r.id, 0) + r.end_ns - r.start_ns
    return _median_ms(per_step.values())


def _per_span(trace, name: str, field: str) -> Optional[float]:
    st = trace.spans.get(name) if trace is not None else None
    if st is None or not st.count:
        return None
    return getattr(st, field) / st.count


def launches_per_step_train(records, trace) -> Optional[float]:
    return _per_span(trace, "train.step", "launches")


def host_syncs_per_step_train(records, trace) -> Optional[float]:
    return _per_span(trace, "train.step", "syncs")


def launches_per_nfe_sample(records, trace) -> Optional[float]:
    return _per_span(trace, "sample.nfe", "launches")


def host_syncs_per_call_sample(records, trace) -> Optional[float]:
    return _per_span(trace, "sample.call", "syncs")


def solver_idle_share_sample(records, trace) -> Optional[float]:
    """Share of the window's device idle time during which the host was
    inside ``sample.call`` and outside every ``sample.nfe``, in %."""
    if trace is None or "sample.call" not in trace.spans or not trace.idle_us:
        return None
    nfe = trace.spans.get("sample.nfe", SpanStats()).idle_us
    return 100.0 * (trace.spans["sample.call"].idle_us - nfe) / trace.idle_us


READERS = {
    "host_ms.train": host_ms_train,
    "optimizer_host_ms.train": optimizer_host_ms_train,
    "launches_per_step.train": launches_per_step_train,
    "host_syncs_per_step.train": host_syncs_per_step_train,
    "launches_per_nfe.sample": launches_per_nfe_sample,
    "host_syncs_per_call.sample": host_syncs_per_call_sample,
    "solver_idle_share.sample": solver_idle_share_sample,
}


# -- the run ---------------------------------------------------------------------


def profile_events(fn, calls: int, sync):
    """The raw (kineto) events of a profiler window over ``calls`` calls of
    ``fn``, labelled as ``trace.trace_calls`` labels its window."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(WINDOW_LABEL):
            for _ in range(calls):
                fn()
            sync()
    return prof.profiler.kineto_results.events()


def table(span_trace: SpanTrace, records) -> List[dict]:
    """One row a span name: spans in the untraced window and their median
    host ms; spans in the traced window, and a span's device ms, launches,
    syncs and idle ms there (the outside row: the traced window's totals)."""
    rows = []
    for name, st in span_trace.spans.items():
        host = [r.end_ns - r.start_ns for r in records if r.name == name]
        per = max(st.count, 1)
        rows.append({"span": name, "window_n": len(host), "host_ms": _median_ms(host),
                     "traced_n": st.count, "device_ms": st.busy_us / 1e3 / per,
                     "launches": st.launches / per, "syncs": st.syncs / per,
                     "idle_ms": st.idle_us / 1e3 / per})
    return rows


def print_table(rows: List[dict], file) -> None:
    print(f"{'span':<16} {'n':>5} {'host ms':>10} {'traced':>6} {'device ms':>10} {'launches':>9} "
          f"{'syncs':>6} {'idle ms':>9}", file=file)
    for r in rows:
        host = "-" if r["host_ms"] is None else f"{r['host_ms']:.3f}"
        print(f"{r['span']:<16} {r['window_n']:>5} {host:>10} {r['traced_n']:>6} "
              f"{r['device_ms']:>10.3f} {r['launches']:>9.1f} {r['syncs']:>6.1f} "
              f"{r['idle_ms']:>9.3f}", file=file)


def measure(spec: dict, workload: str, seed: int, seconds: float, rounds: int, device,
            config: Optional[dict] = None, traffic: Optional[dict] = None) -> dict:
    """The windows, the table and the readings of one cell (the JSON line)."""
    from mm_diffusion_tpu_torch.utils import tracing

    _, cfg_file, traffic_file = run.cell_files(spec, workload)
    config, traffic = config or cfg_file, traffic or traffic_file
    driver_mod = run.load_file(run.BENCH / "drivers" / f"{traffic['driver']}.py")
    driver = driver_mod.Driver(config, traffic, seed, device)
    driver.setup()
    run.sync(device)

    windows, records = [], []
    for on in itertools.islice(itertools.cycle((False, True, True, False)), 2 * rounds):
        if on:
            tracing.enable()
        units, t0 = 0, time.perf_counter()
        while True:
            units += driver.call()
            run.sync(device)
            window_s = time.perf_counter() - t0
            if window_s >= seconds:
                break
        if on:
            tracing.disable()
            records += tracing.drain()
        rate = ({"clips_per_s": units / window_s} if driver_mod.UNIT == "clips"
                else {"train_step_ms": window_s / units * 1e3})
        windows.append({"tracing": on, "units": units, "seconds": window_s, **rate})

    tracing.enable()
    events = profile_events(driver.call, int(traffic["trace_calls"]), lambda: run.sync(device))
    tracing.disable()
    tracing.drain()
    tr, span_trace = reduce_events(events), reduce_spans(events)
    readings = {name: read(records, span_trace) for name, read in READERS.items()}
    return {
        "workload": workload, "seed": seed,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
        "windows": windows,
        "readings": {n: v for n, v in readings.items() if v is not None},
        "spans": table(span_trace, records) if span_trace is not None else [],
        "traced": {"window_s": tr.window_us / 1e6, "busy_s": tr.busy_us / 1e6,
                   "idle_s": None if span_trace is None else span_trace.idle_us / 1e6,
                   **tr.breakdown()},
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="The port's spans in one cell of BENCHMARK.json.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True, help="each window's length")
    parser.add_argument("--rounds", type=int, default=2, help="pairs of windows, tracing off and on")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("spans: needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)  # as run.py
    result = measure(run.load_json(ROOT / "BENCHMARK.json"), args.workload, args.seed, args.seconds,
                     args.rounds, torch.device("cuda", 0))
    print_table(result["spans"], sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
