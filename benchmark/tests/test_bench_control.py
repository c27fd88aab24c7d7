"""The control of every cell: the reference put in the program's place and
computed in fp8, the precision below the configurations' bf16, has to
fail the cell's limits -- on the CPU at the tiny sizes, and on a card at
the cell's own sizes (``cuda`` marker: skipped without a card)."""

from __future__ import annotations

import pytest
import torch

from benchmark import calibrate, run
from benchmark.tests import tiny

CELLS = ["sr-ddim25-clip", "base-dpm20-b8", "mm-train-b4"]


def fails(numbers: dict, limits: dict) -> bool:
    return any(not v <= limits[n] for n, v in numbers.items())


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_at_tiny_sizes(workload):
    torch.set_num_threads(1)
    config, traffic = tiny.cell(workload)
    got = calibrate.readings(tiny.spec(), workload, 2**31 + 5, torch.device("cpu"), True, False,
                             config=config, traffic=traffic)
    assert not fails(got["program"], traffic["limits"]), got
    assert fails(got["fp8"], traffic["limits"]), got


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_at_the_cells_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own sizes")
    spec = run.load_json(run.ROOT / "BENCHMARK.json")
    _, _, traffic = run.cell_files(spec, workload)
    got = calibrate.readings(spec, workload, 2**31 + 5, torch.device("cuda", 0), True, False)
    assert not fails(got["program"], traffic["limits"]), got
    assert fails(got["fp8"], traffic["limits"]), got
