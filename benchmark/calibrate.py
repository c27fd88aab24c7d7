"""The readings that a cell's limits are set from, in one process: for each
seed, the numbers that a run compares, with the program's outputs (the
lower readings), with the reference computed in fp8 in the program's place
(the control), and for a training cell with the reference over half of
each batch (a fault: rows left out, the mean taken over the rest).

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,13 [--control] [--faults] \
        [--window-steps 16]

The program runs exactly what a run's timed path runs at the cell's sizes
(the calls whose outputs a run checks; or the first train steps, then
``--window-steps`` steps standing in for the window, then the checked step
after it), with weights and inputs from each seed; one JSON line a seed,
then a summary:
the largest program reading and the smallest control and fault readings
of each number.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import run  # noqa: E402
from benchmark.harness import free_cuda  # noqa: E402


def readings(spec: dict, workload: str, seed: int, device, control: bool, faults: bool,
             config=None, traffic=None, window_steps: int = 2) -> dict:
    """One seed's readings of ``workload``: {"program": {...}, "fp8": {...}, "half": {...}}."""
    _, cfg_file, traffic_file = run.cell_files(spec, workload)
    config, traffic = config or cfg_file, traffic or traffic_file
    driver_mod = run.load_file(run.BENCH / "drivers" / f"{traffic['driver']}.py")
    driver = driver_mod.Driver(config, traffic, seed, device)
    driver.setup()
    if driver_mod.UNIT == "clips":
        per_call = int(traffic.get("batch", 1))
        wanted = int(traffic.get("check_rows", traffic.get("check_clips", 1)))
        for _ in range(math.ceil(wanted / per_call)):
            driver.call()
    else:
        for _ in range(window_steps):
            driver.call()
    driver.release()
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    out = {"seed": seed, "program": driver.numbers()}
    info = {"program": getattr(driver, "info", None)}
    if control:
        out["fp8"] = driver.numbers("fp8")
        info["fp8"] = getattr(driver, "info", None)
    if faults and driver_mod.UNIT == "steps":
        out["half"] = driver.numbers("half")
        info["half"] = getattr(driver, "info", None)
    if info["program"] is not None:
        out["info"] = info
    del driver
    free_cuda()
    return out


def summary(lines) -> dict:
    s = {}
    for kind, pick in (("program", max), ("fp8", min), ("half", min)):
        rows = [line[kind] for line in lines if kind in line]
        if rows:
            s[kind] = {n: pick(r[n] for r in rows) for n in rows[0]}
    return s


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--faults", action="store_true")
    parser.add_argument("--window-steps", type=int, default=16, help="train steps before the checked one")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    spec = run.load_json(ROOT / "BENCHMARK.json")
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        line = readings(spec, args.workload, seed, torch.device("cuda", 0), args.control, args.faults,
                        window_steps=args.window_steps)
        line["seconds"] = time.perf_counter() - t0
        lines.append(line)
        print(json.dumps(line), flush=True)
    print(json.dumps({"workload": args.workload, "summary": summary(lines)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
