"""The golden config ``fastscnn`` through the port's Trainer on the CPU:
within the reference's spread over seeds, and equal to the port's pin
(``tests/_torch_golden.py``)."""
import pytest

import _torch_golden as golden

NAME = "fastscnn"


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    return golden.run(NAME, tmp_path_factory)


def test_fastscnn_within_the_reference_spread(result):
    golden.check_spread(NAME, result)


def test_fastscnn_equals_the_port_pin(result):
    golden.check_pin(NAME, result)


def test_fastscnn_bound_breaks_on_mirrored_labels(tmp_path_factory):
    """A planted fault (train labels mirrored left to right, their images
    not) breaks the bound at every seed: the mIoU floor."""
    runs = golden.run(NAME, tmp_path_factory, plant="mirrored_labels")
    bound = golden.G.load_spread()["bounds"][NAME]
    assert all(golden.G.check(r, bound) for r in runs), golden.summary(runs)
    assert golden.G.check_runs(runs, bound)
