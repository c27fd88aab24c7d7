"""Device-time measurement on one CUDA card, and the card's identity.

:func:`device_ms` captures a fixed number of calls of a function in one CUDA
graph and times replays of that graph between two CUDA events, so that the
reading is the device's time per call and not the host's cost of issuing it
(a small kernel issued eagerly measures launch and Python overhead).  Work
whose backward autograd must record on the capture stream (a forward whose
``autograd.grad`` is timed) is set up inside :func:`on_capture_stream`.

On the CPU, :func:`host_ms` times with the host clock; its numbers are host
times and are never reported as device times.
"""

from __future__ import annotations

import contextlib
import subprocess
import time

import torch

_capture_stream = None


def capture_stream() -> "torch.cuda.Stream":
    """The side stream that :func:`device_ms` captures on (one per process)."""
    global _capture_stream
    if _capture_stream is None:
        _capture_stream = torch.cuda.Stream()
    return _capture_stream


@contextlib.contextmanager
def on_capture_stream():
    """Run the block on the capture stream, ordered after the work already
    queued on the current stream."""
    torch.cuda.synchronize()
    with torch.cuda.stream(capture_stream()):
        yield
    torch.cuda.synchronize()


def device_ms(fn, calls: int = 10, replays: int = 5, warmup: int = 2) -> float:
    """Device milliseconds per call of ``fn``: ``calls`` calls captured in
    one CUDA graph (after ``warmup`` eager calls on the capture stream),
    the graph replayed once, then ``replays`` times between two CUDA events."""
    stream = capture_stream()
    with on_capture_stream():
        for _ in range(warmup):
            fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * calls)
    del graph
    torch.cuda.empty_cache()
    return ms


def host_ms(fn, calls: int = 3, warmup: int = 1) -> float:
    """Host-clock milliseconds per call of ``fn`` (CPU runs only)."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls * 1e3


def nvidia_smi_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU): the end of a
    host-clock measurement on a card."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def resolve_device(name: str) -> torch.device:
    """The A/B tools' ``--device``: ``cuda`` needs a card and
    never falls back to the CPU; ``cpu`` is taken only when asked for.  A
    tool runs in one process: under a multi-process launcher it stops."""
    from ..parallel.bootstrap import refuse_launcher

    refuse_launcher("the A/B tools")
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise SystemExit(f"unsupported device {name!r}")
    return dev


def device_header(dev: torch.device) -> str:
    """The first line a tool prints: the card's name and power limit, or
    that the run is on the CPU and its times are host times."""
    if dev.type == "cuda":
        return f"{nvidia_smi_line()} (torch {torch.__version__}, CUDA {torch.version.cuda})"
    return "cpu (no card): plain versions, host-clock ms"


def timer(dev: torch.device, calls: int, replays: int):
    """``fn -> ms per call``: device time on a card, host time on the CPU."""
    if dev.type == "cuda":
        return lambda fn: device_ms(fn, calls=calls, replays=replays)
    return lambda fn: host_ms(fn, calls=max(1, replays))
