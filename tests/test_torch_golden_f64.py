"""The port's training steps against the reference's in float64 on the
golden configs' own batches (``tests/_golden_f64.py``): from the
reference's init, dropout off, both packages take five steps in f64 with
the config's loss (class-weighted CE, CE + OHEM), optimizer, weight decay
and poly schedule, each its own.

At this size f32 training is chaotic (a 1e-12 change of the init grows to
a 0.04-0.4 change of the state within 10-40 steps; PERF.md), so only f64
separates a fault from rounding. The bounds, from the readings: after five
steps each parameter and BN statistic lies within 1e-7 of the reference's
move since the init (read: 4.6e-10 with adam, 6.1e-8 with SGD, whose
steps amplify more), the losses within 1e-9 relative (read: 2.4e-11), the
learning rates within 1e-12.
"""
import pytest
import torch

import _golden_f64 as W

STATE, LOSS, LR = 1e-7, 1e-9, 1e-12


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("config,optim", [("enet", "adam"),
                                          ("enet_ohem", "adam"),
                                          ("enet", "sgd")])
def test_five_f64_steps_follow_the_reference(config, optim):
    record = W.witness(config, optim, steps=5, control=False)
    last = record["snapshots"][-1]
    assert last["step"] == 5
    for row in record["snapshots"]:
        assert row["max"] <= STATE, (config, optim, row)
        assert row["loss_gap"] <= LOSS, (config, optim, row)
        assert row["lr_gap"] <= LR, (config, optim, row)
