"""The ops of spatial sharding (``esn_tpu_torch.parallel.spatial``) at (1, 2)
and (1, 4) ranks on the CPU under gloo, against the same op on the whole
tensor in one process, in f64 within 1e-12 of the largest value of each
result: the forward and the backward (input and parameter gradients).

- convs of kernel 1, 3, 5 and 7 at stride 1 and 2, dilations 2-16, k x 1
  and 1 x k kernels, depthwise; transposed convs; max and average pools
  (the padded count in and out); the 2x2 index pool and its unpool;
  bilinear resizes x2, x4, x8, x1/4 and x1/2 of a sharded input;
- the global pool and PPM's adaptive pools of the whole map (bins 1, 2,
  3, 6), whose result is replicated on the model group, back-propagated
  from one rank only (an adaptive pool of a shard raises);
- a replicated map resized to this rank's rows (PPM's upsample);
- the training Dropout and SpatialDropout masks (the global draw's
  block), and a training BatchNorm (moments, statistics, gradients).

The shards hold 8 rows at (1, 2) and 4 at (1, 4), so a dilation of 16
reads rows of every other rank and the global border. One spawn per world
size runs every case. The checks of the envelope, the layout and the
deepest stage need no spawn.
"""
import numpy as np
import pytest
import torch

import _torch_spatial as TS
from esn_tpu_torch.models import build_model
from esn_tpu_torch.parallel import launch, mesh, spatial

N, C, H, W = 2, 4, 16, 8
TOL = 1e-12
LIMIT = 120.0


def _x(seed, shape=(N, C, H, W)):
    return np.random.RandomState(seed).randn(*shape)


def _op_calls():
    """(case, args, kwargs) of every case (without the world's S) and the
    one-process results."""
    calls, want = [], []
    x = _x(0)
    for i, name in enumerate(TS.OPS):
        p = TS.op_params(name, C, i)
        y = TS.OPS[name][0](torch.from_numpy(x),
                            {k: torch.from_numpy(v) for k, v in p.items()})
        cot = _x(100 + i, tuple(y.shape))
        calls.append(("op_case", (name, x, cot, p), {}))
        want.append(TS.op_case(name, x, cot, p, 1))
    for i, name in enumerate(TS.REDUCTIONS):
        y = TS.REDUCTIONS[name](torch.from_numpy(x))
        cot = _x(200 + i, tuple(y.shape))
        calls.append(("reduction_case", (name, x, cot), {}))
        want.append(TS.reduction_case(name, x, cot, 1))
    for i, (name, (bh, bw)) in enumerate(TS.UPSAMPLES.items()):
        m = _x(300 + i, (N, C, bh, bw))
        cot = _x(400 + i, (N, C, H, W))
        calls.append(("upsample_case", (name, m, cot), {}))
        want.append(TS.upsample_case(name, m, cot, 1))
    calls.append(("dropout_case", (x, 0.3, 5), {}))
    want.append(TS.dropout_case(x, 0.3, 5, 1))
    bn = {"weight": _x(500, (C,)), "bias": _x(501, (C,)),
          "running_mean": 0.1 * _x(502, (C,)),
          "running_var": 1.0 + 0.1 * np.abs(_x(503, (C,)))}
    xs = 3.0 + _x(504)
    calls.append(("bn_case", (xs, _x(505), bn), {}))
    want.append(TS.bn_case(xs, _x(505), bn, 1))
    calls.append(("regroup_case", (), {}))
    want.append(TS.regroup_case(1))
    return calls, want


NAMES = (list(TS.OPS) + list(TS.REDUCTIONS) + list(TS.UPSAMPLES)
         + ["dropout", "bn"])


@pytest.fixture(scope="module")
def runs():
    torch.set_num_threads(1)
    calls, want = _op_calls()
    got = {s: launch.run_ranks(TS.many_case, s,
                               [(c, a + (s,), k) for c, a, k in calls],
                               timeout=LIMIT)
           for s in (2, 4)}
    return got, want


def _scale(a):
    return max(1.0, float(np.abs(a).max()))


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * _scale(want),
                               err_msg=what)


def _rows(outs, key):
    return np.concatenate([o[key] for o in outs], axis=2)


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("name", NAMES)
def test_sharded_op_matches_the_whole_tensor(runs, s, name):
    got, want = runs
    i = NAMES.index(name)
    outs, one = [o[i] for o in got[s]], want[i]
    if name in TS.OPS:
        _close(_rows(outs, "y"), one["y"], "y")
        _close(_rows(outs, "dx"), one["dx"], "dx")
        for k, g in one["grads"].items():
            for o in outs:
                _close(o["grads"][k], g, k)
    elif name in TS.REDUCTIONS:
        for o in outs:                  # replicated on the group
            _close(o["y"], one["y"], "y")
        _close(_rows(outs, "dx"), one["dx"], "dx")
    elif name in TS.UPSAMPLES:
        _close(_rows(outs, "y"), one["y"], "y")
        for o in outs:
            _close(o["dx"], one["dx"], "dx")
    elif name == "dropout":
        for k in ("dropout", "spatial_dropout"):
            np.testing.assert_array_equal(_rows(outs, k), one[k], k)
        assert 0.5 < (one["dropout"] != 0).mean() < 0.9
    else:
        for k in ("y", "dx"):
            _close(_rows(outs, k), one[k], k)
        for k in ("dweight", "dbias", "running_mean", "running_var"):
            for o in outs:
                _close(o[k], one[k], k)


@pytest.mark.parametrize("s", [2, 4])
def test_a_second_layout_reuses_the_model_groups(runs, s):
    got, want = runs
    assert want[-1] == dict(same=True, spatial=1, total=np.ones(1))
    for o in got[s]:
        r = o[len(NAMES)]
        assert r["same"] and r["spatial"] == s
        np.testing.assert_array_equal(r["total"], [s])


def test_the_envelope_is_the_reference_s():
    spatial.check_spatial_config((512, 1024), 4)
    spatial.check_spatial_config((128, 128), 2)
    for hw, s in (((64, 64), 2), ((160, 160), 4), ((96, 96), 2)):
        with pytest.raises(ValueError, match=r"need >=4 rows divisible"):
            spatial.check_spatial_config(hw, s)


def test_a_batch_the_data_axis_does_not_divide_raises():
    """At (2, 2) a rank holds its data index's rows: batch 3 does not
    split over 2 data ranks, and the message names the layout."""
    w = mesh.World(3, 4, 3, "gloo", torch.device("cpu"), spatial=2)
    assert (w.n_data, w.data_index, w.model_index) == (2, 1, 1)
    np.testing.assert_array_equal(mesh.rank_rows(4, 1, w), [2, 3])
    with pytest.raises(ValueError, match=r"2 data rank\(s\) \(4 ranks / "
                                         r"spatial=2\).*cannot shrink"):
        mesh.rank_rows(3, 1, w)


def test_a_world_the_model_axis_does_not_divide_raises():
    with pytest.raises(ValueError, match=r"1 rank\(s\) are not divisible "
                                         r"by spatial=2.*cannot shrink"):
        mesh.set_spatial(2)
    assert mesh.world().spatial == 1


def test_lednet_s_pyramid_names_the_height_that_works():
    """LEDNet's attention pyramid reaches 1/64: at H=128 over 4 shards it
    keeps 2 rows there, which 4 shards cannot split; H=256 works, and so
    does H=128 over 2."""
    model = build_model("lednet", 19, device="cpu")
    spatial.check_model(model, (128, 128), 2)
    spatial.check_model(model, (256, 256), 4)
    with pytest.raises(ValueError, match=r"LEDNet: its attention pyramid "
                                         r"\(apn.down3\).*H=256"):
        spatial.check_model(model, (128, 128), 4)
    spatial.check_model(build_model("fastscnn", 19, device="cpu"),
                        (128, 128), 4)


def test_no_spatial_context_without_a_model_axis():
    """With S = 1 the context enters nothing: every op sees no axis."""
    with spatial.sharded():
        assert spatial.axis() is None and spatial.replicated_axis() is None
        with spatial.replicated():
            assert spatial.replicated_axis() is None


def _on_a_shard(monkeypatch):
    """Mark the ops' inputs as shard 0 of 2 without a group: an op that
    raises on a shard does so before any collective."""
    monkeypatch.setattr(spatial, "_AXIS", spatial.Axis(2, 0, None))
    assert spatial.axis() is not None


def test_an_adaptive_pool_of_a_shard_raises(monkeypatch):
    from esn_tpu_torch.ops import pooling as P
    x = torch.from_numpy(_x(0))
    _on_a_shard(monkeypatch)
    with pytest.raises(ValueError, match=r"spatial.whole\(x\) inside "
                                         r"spatial.replicated\(\)"):
        P.adaptive_avg_pool2d(x, 3)
    with spatial.replicated():
        np.testing.assert_array_equal(
            P.adaptive_avg_pool2d(x, 3),
            torch.nn.functional.adaptive_avg_pool2d(x, 3))


def test_the_fused_resize_ce_loss_raises_on_a_shard(monkeypatch):
    """The fused resize-CE loss reads no rows across shards: on a shard
    it raises and names the plain route, which the Trainer takes."""
    from esn_tpu_torch.train.losses import resize_cross_entropy
    z = torch.from_numpy(_x(1, (N, 2, 2, 3))).float()
    labels = torch.zeros((N, 16, 16), dtype=torch.int64)
    _on_a_shard(monkeypatch)
    with pytest.raises(ValueError, match=r"reads no rows across shards.*"
                                         r"plain loss"):
        resize_cross_entropy(z, labels, num_classes=3)
