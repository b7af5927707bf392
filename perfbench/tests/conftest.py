"""Shared pieces of the benchmark's CPU tests."""
from __future__ import annotations

import copy

import pytest
import torch

from perfbench import bench

# a size the CPU runs in seconds: 2 images of 128x256 a batch, 2 batches
SMALL_HW = [128, 256]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def card():
    """A CUDA device, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def small_cell(name: str, dtype: str = "float32") -> bench.Cell:
    """The cell ``name`` at a size a CPU test can hold."""
    cell = copy.deepcopy(bench.find_cell(name))
    cell.config = dict(cell.config, image_hw=SMALL_HW, compute_dtype=dtype)
    cell.traffic = dict(cell.traffic, batch=2, pool=3, traced_calls=2,
                        traced_steps=2, calibration_images=1,
                        sample_cycles=1)
    return cell
