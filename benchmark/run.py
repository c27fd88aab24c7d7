"""The benchmark of the PyTorch / CUDA port (``mm_diffusion_tpu_torch``) on
one NVIDIA H100: one process runs one cell of ``BENCHMARK.json`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell names a configuration (``benchmark/configs/<config>.json``) and a
traffic mix (``benchmark/traffic/<traffic>.json``); the mix names the
driver (``benchmark/drivers/<driver>.py``) that builds the port's entry,
feeds it from the seed and holds it against the plain reference
(``benchmark/reference/``).  Each per-layer metric is read by
``benchmark/metrics/<metric>.py``.  All of them are found by name, so a
new cell, mix, configuration or metric is a new file.

A run: set-up (imports, the kernel library, the model with seeded weights,
the warm-up of the cell's shapes; ``setup_s``), the measured window of
``--seconds`` (whole calls back to back, ended at the first call boundary
after it, the device synchronised), then with ``--trace 1`` a profiler
window over a few more calls, then the comparison with the reference,
after the program's state is freed.  The last line of standard output is
the result; the numbers compared, each beside its limit, are the last
lines of standard error and the result's last key.  Without a CUDA card,
or with JAX or the JAX package loaded, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import List, Optional  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark.harness import Check  # noqa: E402
from benchmark.trace import Trace, trace_calls  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "mm_diffusion_tpu")  # top-level module names, compared whole


@dataclasses.dataclass
class Record:
    """What a run measured, for the per-layer readers."""

    units: int  # clips or steps finished in the window
    window_s: float
    flops_per_unit: float  # the yardstick's model FLOPs
    attn_bound_s_per_unit: float  # the yardstick's least attention seconds
    span_s: Optional[float]  # device seconds inside the model's calls in the window
    trace: Optional[Trace]  # the profiler window
    traced_units: int


def load_file(path: Path):
    spec = importlib.util.spec_from_file_location(f"benchmark_{path.parent.name}_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(spec: dict, workload: str):
    """(cell entry, configuration, traffic) of ``workload``."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    config_file = {c["name"]: c["file"] for c in spec["configs"]}[cell["config"]]
    return cell, load_json(ROOT / config_file), load_json(BENCH / "traffic" / f"{cell['traffic']}.json")


def applies(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(spec: dict, workload: str, seed: int, seconds: float, trace: bool, device: torch.device,
             t_start: float, config: Optional[dict] = None, traffic: Optional[dict] = None) -> dict:
    """One run of one cell; returns the result line's object."""
    _, cfg_file, traffic_file = cell_files(spec, workload)
    config, traffic = config or cfg_file, traffic or traffic_file
    driver_mod = load_file(BENCH / "drivers" / f"{traffic['driver']}.py")
    driver = driver_mod.Driver(config, traffic, seed, device)
    driver.setup()
    sync(device)
    setup_s = time.perf_counter() - t_start

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    spanned = getattr(driver, "model", None) if trace else None
    if spanned is not None:
        spanned.on = True
    units = 0
    t0 = time.perf_counter()
    while True:
        units += driver.call()
        sync(device)
        window_s = time.perf_counter() - t0
        if window_s >= seconds:
            break
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    span_s = None
    if spanned is not None:
        spanned.on = False
        span_s = spanned.span_s()

    tr = None
    traced = 0
    if trace:

        def one():
            nonlocal traced
            traced += driver.call()

        tr = trace_calls(one, int(traffic["trace_calls"]), lambda: sync(device))
    found = forbidden_modules()
    if found:
        raise SystemExit(f"JAX or the JAX package is loaded in the benchmark's process: {found}")

    flops_per_unit, attn_per_unit = driver.work()
    record = Record(units=units, window_s=window_s, flops_per_unit=flops_per_unit,
                    attn_bound_s_per_unit=attn_per_unit, span_s=span_s, trace=tr, traced_units=traced)

    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    driver.release()
    checks: List[Check] = driver.check(traffic["limits"])
    correct = all(c.ok for c in checks)

    e2e_values = {"setup_s": setup_s, "peak_gib": peak / 2**30}
    if driver_mod.UNIT == "clips":
        e2e_values["clips_per_s"] = units / window_s
    else:
        e2e_values["train_step_ms"] = window_s / units * 1e3
    units_of = {m["name"]: m["unit"] for m in spec["end_to_end"]}
    e2e = [m["name"] for m in spec["end_to_end"] if applies(m, workload, e2e_values)]
    if not trace:
        metrics = {n: {"value": e2e_values[n], "unit": units_of[n]} for n in e2e}
    else:
        metrics = {}
        for m in spec["per_layer"]:
            if not applies(m, workload, e2e):
                continue
            value = load_file(BENCH / "metrics" / f"{m['name']}.py").read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    device_info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": peak,
    }
    result = {"correct": correct, "attempted": units, "failed": 0 if correct else units,
              "metrics": metrics, "device": device_info}
    if tr is not None:
        device_info["busy_s"] = tr.busy_us / 1e6
        device_info["window_s"] = tr.window_us / 1e6
        result["breakdown"] = tr.breakdown()
    result["compared"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="One run of one cell of BENCHMARK.json on one card.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    spec = load_json(ROOT / "BENCHMARK.json")
    cell, _, _ = cell_files(spec, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"benchmark: needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)  # one host thread: the host's work is launches and scalars
    result = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
