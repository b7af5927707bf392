"""The golden config ``enet_ohem`` through the port's Trainer on the CPU:
within the reference's spread over seeds, and equal to the port's pin
(``tests/_torch_golden.py``)."""
import pytest

import _torch_golden as golden

NAME = "enet_ohem"


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    return golden.run(NAME, tmp_path_factory)


def test_enet_ohem_within_the_reference_spread(result):
    golden.check_spread(NAME, result)


def test_enet_ohem_equals_the_port_pin(result):
    golden.check_pin(NAME, result)
