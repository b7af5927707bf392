"""Shared body of ``tests/test_torch_golden_*.py``: one golden config of
``esn_tpu_torch/tools/golden_run.py`` trained by the port on the CPU at
``golden_run.SEEDS`` (f32, one process and one torch thread a seed, all
started together), then held

- against the reference's spread over seeds (``golden_spread.json``: a
  majority of the runs within the bound of ``golden_run.check``), and
- against the port's own pin (``golden_torch.json``), tightly: at one
  torch version and CPU capability each run is deterministic. Where either
  differs from the pin's, the runs must stay within a loose bound, then
  the test xfails, as ``tests/test_golden_run.py`` does for jax versions.
"""
import json

import numpy as np
import pytest
import torch

from esn_tpu_torch.tools import golden_run as G

# deterministic on one machine, torch version and thread count: these
# only absorb summation-order noise that never appears there
PIN_LOSS_RTOL, PIN_MIOU_ATOL = 1e-4, 1e-4
# across torch versions or CPU capabilities the trajectory is another
# draw of the same training; a lost gradient term or broken augmentation
# moves it by more than this
LOOSE_LOSS_RTOL, LOOSE_MIOU_ATOL = 0.15, 0.1


def run(name, tmp_path_factory, plant=None):
    root = G.build_fixture(str(tmp_path_factory.mktemp("golden_ds")))
    return G.run_seeds(name, root, str(tmp_path_factory.mktemp("ckpt")),
                       plant=plant, processes=True)


def summary(runs):
    return [(r["seed"], round(r["miou"], 4),
             round(G.tail_loss(r["losses"]), 4)) for r in runs]


def check_spread(name, runs):
    assert [r["seed"] for r in runs] == list(G.SEEDS)
    bound = G.load_spread()["bounds"][name]
    assert G.check_runs(runs, bound) == [], (name, summary(runs))


def check_pin(name, runs):
    with open(G.PIN_PATH) as f:
        pin = json.load(f)
    pinned = pin["results"][name]
    assert [r["seed"] for r in pinned] == [r["seed"] for r in runs]
    try:
        for got, want in zip(runs, pinned):
            np.testing.assert_allclose(got["losses"], want["losses"],
                                       rtol=PIN_LOSS_RTOL,
                                       err_msg=f"{name} seed {got['seed']}")
            assert abs(got["miou"] - want["miou"]) <= PIN_MIOU_ATOL, \
                (name, got["seed"], got["miou"], want["miou"])
    except AssertionError:
        here = (torch.__version__, torch.backends.cpu.get_cpu_capability())
        pinned_at = (pin["torch_version"], pin["cpu_capability"])
        if here == pinned_at:
            raise
        for got, want in zip(runs, pinned):
            np.testing.assert_allclose(got["losses"], want["losses"],
                                       rtol=LOOSE_LOSS_RTOL, err_msg=name)
            assert abs(got["miou"] - want["miou"]) <= LOOSE_MIOU_ATOL
        pytest.xfail(f"golden_torch.json pinned on torch {pinned_at}, "
                     f"running {here}: re-pin with `python -m "
                     "esn_tpu_torch.tools.golden_run --device cpu --write`")
