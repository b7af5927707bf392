"""Every loss of the port at 2 ranks against one process on the CPU under
gloo, in f64: ``ce``, ``label_smoothing``, the K3 route
(``resize_cross_entropy``, its plain version on the CPU), ``ohem`` (with
the default ``min_kept`` of the global pixel count, and with a
``min_kept`` above a rank's own count), ``focal``, ``lovasz`` and
``lovasz_hist``: the ranks' losses sum to the one-process loss and each
rank's gradient is the one-process gradient of its rows, within 1e-12.
OHEM's threshold (the global radix select under a group, ``torch.topk``
in one process) is bit for bit the one-process value, on inputs whose
probabilities tie across the rank boundary, and on confident logits
whose k-th smallest probability lies above OHEM's 0.7 (elsewhere the
clamp at 0.7 decides the threshold), the two ranks' rows drawn from
different distributions, so that no rank's own rows give the global
k-th.

One spawn of 2 ranks (``file://`` rendezvous, one torch thread a rank,
its own time limit) computes every case.
"""
import numpy as np
import pytest
import torch

import _torch_parallel as TP
from esn_tpu_torch.parallel import launch
from esn_tpu_torch.train import losses as L

RANKS, B, H, W, C = 2, 4, 8, 12, TP.CLASSES
# f64 on both sides: the sums are split over the ranks, so the value and
# gradients may differ by rounding of order 1e-16 only
VALUE_REL, GRAD_ABS = 1e-12, 1e-12
KINDS = ("random", "tied", "confident")
NAMES = ("ce", "label_smoothing", "ohem", "ohem_min_kept", "focal", "lovasz",
         "lovasz_hist", "resize_ce", "resize_ce_smooth")
MIN_KEPT = (1, 7, 40, 512, 700, 1023)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's own torch work (each rank runs
    one too): the quick tier runs six workers on a few cores, and torch's
    OpenMP teams, one a worker, spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(kind):
    rng = np.random.RandomState({"random": 0, "tied": 1, "confident": 2}[kind])
    if kind == "random":
        logits = rng.randn(B, H, W, C) * 2
        labels = rng.randint(0, C, (B, H, W))
    elif kind == "confident":
        # the true class ahead by a margin that differs between the
        # ranks' rows: rank 0's pixels are surer than rank 1's
        labels = rng.randint(0, C, (B, H, W))
        logits = rng.randn(B, H, W, C)
        margin = rng.uniform(4.0, 9.0, (B, H, W))
        margin[B // 2:] -= 2.5
        np.put_along_axis(logits, labels[..., None], margin[..., None], -1)
    else:
        # every pixel one of 6 (logits, label) pairs: the true-class
        # probabilities, and the Lovász errors, tie across the ranks
        bank = rng.randn(6, C) * 2
        pick = rng.randint(0, 6, (B, H, W))
        logits, labels = bank[pick], pick * 3
    labels[:, 0, :3] = 255                       # ignored pixels
    z = rng.randn(B, H // 4, W // 4, C)
    zlabels = labels.copy()
    cw = rng.uniform(0.5, 2.0, C)
    return (logits.astype(np.float64), labels.astype(np.int64), cw,
            z.astype(np.float64), zlabels.astype(np.int32))


def _p_true():
    """Probabilities from 5 values, each rank's rows in other shares:
    every k-th smallest ties across the rank boundary, and no rank's own
    counts give it."""
    rng = np.random.RandomState(2)
    values = np.float32([0.1, 0.25, 0.25001, 0.5, 2.0])
    return np.concatenate([
        rng.choice(values, (B // 2, 256), p=[0.5, 0.2, 0.1, 0.1, 0.1]),
        rng.choice(values, (B // 2, 256), p=[0.05, 0.1, 0.2, 0.5, 0.15])
    ]).astype(np.float32)


@pytest.fixture(scope="module")
def runs():
    inputs = {k: _inputs(k) for k in KINDS}
    one = {k: TP.loss_case(*v) for k, v in inputs.items()}
    torch_one = [L.ohem_threshold(torch.from_numpy(_p_true()).reshape(-1),
                                  0.7, k) for k in MIN_KEPT]
    ranks = launch.run_ranks(TP.losses_case, RANKS, inputs, _p_true(),
                             MIN_KEPT, timeout=120.0)
    return one, torch_one, ranks


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", NAMES)
def test_loss_at_two_ranks_matches_one_process(runs, name, kind):
    one, _, ranks = runs
    want = one[kind][name]
    rows = B // RANKS
    for r, out in enumerate(ranks):
        got = out[kind][name]
        assert abs(float(got["value"]) - float(want["value"])) \
            <= VALUE_REL * abs(float(want["value"])), (got["value"],
                                                       want["value"])
        np.testing.assert_allclose(got["grad"],
                                   want["grad"][r * rows:(r + 1) * rows],
                                   rtol=0, atol=GRAD_ABS)
        assert np.abs(got["grad"]).max() > 0


@pytest.mark.parametrize("kind", KINDS)
def test_ohem_threshold_is_the_one_process_value_bit_for_bit(runs, kind):
    """The thresholds of ``ohem`` (min_kept of the global count, which is
    not a rank's) and ``ohem_min_kept`` (above a rank's own count); on
    the confident logits the latter lies above the clamp at 0.7."""
    one, _, ranks = runs
    want = np.asarray(one[kind]["thresholds"])
    assert want.shape == (2,)
    if kind == "confident":
        assert want[1] > 0.7, want
    for out in ranks:
        np.testing.assert_array_equal(np.asarray(out[kind]["thresholds"]),
                                      want)


def test_global_select_is_the_kth_smallest_bit_for_bit(runs):
    """kth_smallest over the ranks' rows of tied probabilities against
    numpy's sort and the one-process topk threshold."""
    _, torch_one, ranks = runs
    flat = np.sort(_p_true().reshape(-1))
    for out in ranks:
        for k, sel, want in zip(MIN_KEPT, out["select"], torch_one):
            assert sel["kth"].tobytes() == flat[k - 1].tobytes(), k
            assert sel["threshold"].tobytes() == want.numpy().tobytes(), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kth_smallest_in_one_process(dtype):
    x = torch.rand(4099, dtype=dtype, generator=torch.Generator()
                   .manual_seed(0))
    x[::5] = x[7]
    x[3] = 0.0
    srt = torch.sort(x).values
    for k in (1, 2, 100, 2049, 4099):
        got = L.kth_smallest(x, k)
        assert got.dtype == dtype and bool(got == srt[k - 1]), k
