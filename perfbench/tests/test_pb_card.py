"""On the card, at each cell's own size: the control (the reference in
float8 in the program's place) fails at least one of the cell's limits
on three seeds. Skips without a CUDA device.

    python -m pytest perfbench/tests -q -m cuda
"""
from __future__ import annotations

import pytest

from perfbench import bench
from perfbench.tools import readings

CELLS = [w["name"] for w in bench.load_benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [4_000_000_001, 4_000_000_002,
                                  4_000_000_003])
def test_control_fails_at_the_cells_size(card, name, seed):
    import torch
    cell = bench.find_cell(name)
    fn = (readings.control_predict if cell.route == "predict"
          else readings.control_train)
    got = fn(cell, seed, card)
    torch.cuda.empty_cache()
    assert any(got[k] > v["limit"] for k, v in cell.limits.items()), got
