"""The spatially sharded train step where a stage's rows do not split into
equal shards (``parallel.spatial.bounds``), on the CPU under gloo, against
one process in f64 within 1e-10 of the largest value of each kind (loss,
gradients, BN running statistics and parameters), as
``tests/test_torch_spatial_train.py`` holds the even step:

- Fast-SCNN-19 at 144x64 over (1, 2) ranks: 9 rows at 1/16 (4 + 5) and 5
  at 1/32 (2 + 3); class-weighted CE and CE + OHEM with its dropout on,
  and CE with two microbatches of one image;
- Fast-SCNN-19 at 144x64 over (1, 4): 18 rows at 1/8 (4, 5, 4, 5), 9 at
  1/16, 5 at 1/32 (1, 1, 1, 2);
- LEDNet-19 at 128x64 over (1, 4): its attention pyramid keeps 2 rows at
  1/64, so model indices 0 and 2 hold none there; CE and CE + OHEM with
  its dropout on.

Each bound must break under a planted fault: BatchNorm counting ``h x S``
rows (``t_miscount``: the count of equal shards) and every row exchange
one row off (``shifted_halo``), each at both layouts with dropout off.
One spawn per layout runs every case of it.
"""
import numpy as np
import pytest
import torch

import _torch_spatial as TS
from esn_tpu_torch.parallel import launch

C = 19
F64 = 1e-10
LIMIT = 240.0
FAST_HW, LED_HW = (144, 64), (128, 64)
# (name, arch, hw, step options): the cases of each layout
CASES = {
    2: [("fastscnn_ce", "fastscnn", FAST_HW, {}),
        ("fastscnn_ohem", "fastscnn", FAST_HW, dict(loss="ohem")),
        ("fastscnn_grad_accum", "fastscnn", FAST_HW, dict(grad_accum=2))],
    4: [("fastscnn_ce", "fastscnn", FAST_HW, {}),
        ("fastscnn_ohem", "fastscnn", FAST_HW, dict(loss="ohem")),
        ("lednet_ce", "lednet", LED_HW, {}),
        ("lednet_ohem", "lednet", LED_HW, dict(loss="ohem"))],
}
FAULTS = ("none", "t_miscount", "shifted_halo")
# the planted faults' model at each layout
FAULT_ARCH = {2: ("fastscnn", FAST_HW), 4: ("lednet", LED_HW)}
# how far over the f64 bound each fault must read
FAULT_MARGIN = 1e3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed, hw, b=2):
    """Smooth seeded images (NCHW f64), labels with an ignored band, and
    class weights from their histogram."""
    rng = np.random.RandomState(seed)
    h, w = hw
    low = rng.randn(b, 3, h // 8, w // 8)
    img = low.repeat(8, 2).repeat(8, 3) + 0.1 * rng.randn(b, 3, h, w)
    scores = rng.rand(b, h // 16, w // 16, C).repeat(16, 1).repeat(16, 2)
    lab = np.argmax(scores, -1).astype(np.int64)
    lab[:, h // 2 - 2:h // 2 + 2] = 255
    hist = np.bincount(lab[lab != 255], minlength=C).astype(np.float64)
    cw = (1.0 / np.log(1.10 + hist / hist.sum())).astype(np.float32)
    return img, lab, cw


@pytest.fixture(scope="module")
def runs():
    got, one = {}, {}
    for s, cases in CASES.items():
        calls = [("spatial_step_case", (arch, *_batch(1, hw)), kw)
                 for _, arch, hw, kw in cases]
        arch, hw = FAULT_ARCH[s]
        calls += [("spatial_fault_case", (fault, arch, *_batch(3, hw)),
                   dict(dropout=False)) for fault in FAULTS]
        outs = launch.run_ranks(
            TS.many_case, s, [(c, a + (s,), k) for c, a, k in calls],
            timeout=LIMIT)
        names = [c[0] for c in cases] + list(FAULTS)
        got[s] = [dict(zip(names, o)) for o in outs]
        for name, arch, hw, kw in cases:
            if name not in one:
                one[name] = TS.spatial_step_case(arch, *_batch(1, hw), 1,
                                                 **kw)
        one[f"fault_{arch}"] = TS.spatial_step_case(
            arch, *_batch(3, hw), 1, dropout=False)
    return got, one


def _scale(arrays):
    return max([1.0] + [float(np.abs(a).max()) for a in arrays])


def _readings(got, one):
    """The largest distance of each kind over the f64 bound's scale."""
    out = {"loss": abs(float(got["loss"]) - float(one["loss"]))
           / _scale([one["loss"]])}
    for kind in ("grads", "state"):
        scale = _scale(one[kind].values())
        out[kind] = max(float(np.abs(got[kind][k] - v).max())
                        for k, v in one[kind].items()) / scale
    return out


@pytest.mark.parametrize("name,s", [(c[0], s) for s, cases in CASES.items()
                                    for c in cases])
def test_uneven_step_matches_one_process_f64(runs, name, s):
    got_all, one = runs[0][s], runs[1][name]
    for out in got_all:
        got = out[name]
        assert set(got["grads"]) == set(one["grads"])
        r = _readings(got, one)
        assert max(r.values()) <= F64, r
        np.testing.assert_array_equal(np.asarray(got["thresholds"]),
                                      np.asarray(one["thresholds"]))
    launch.assert_ranks_equal([o[name]["state"] for o in got_all])


def test_the_dropout_masks_matter(runs):
    """LEDNet's and Fast-SCNN's dropout is on in these steps: with its
    rate at 0 a step differs, so the f64 equality above holds the ranks'
    masks (each its shard of the global draw, uneven) to one process's."""
    for name, arch, hw in (("lednet_ce", "lednet", LED_HW),
                           ("fastscnn_ce", "fastscnn", FAST_HW)):
        off = TS.spatial_step_case(arch, *_batch(1, hw), 1, dropout=False)
        assert abs(float(off["loss"]) - float(runs[1][name]["loss"])) > 1e-6


@pytest.mark.parametrize("s", sorted(CASES))
@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_breaks_the_f64_bound(runs, s, fault):
    """As they are the ranks meet the f64 bound at the faults' batch; a
    miscount of T in BatchNorm and a halo one row off each break it by
    FAULT_MARGIN or more on every rank."""
    arch, _ = FAULT_ARCH[s]
    one = runs[1][f"fault_{arch}"]
    for out in runs[0][s]:
        r = _readings(out[fault], one)
        if fault == "none":
            assert max(r.values()) <= F64, r
        else:
            assert max(r.values()) >= FAULT_MARGIN * F64, (fault, r)
