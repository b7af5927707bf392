"""The ops of spatial sharding (``esn_tpu_torch.parallel.spatial``) where the
rows do not split into equal shards: a tensor of ``T`` rows over ``S``
ranks is split balanced (``spatial.bounds``: model index ``j`` holds rows
``[floor(j*T/S), floor((j+1)*T/S))``), so shards differ by a row, and at
``T < S`` some are empty. Each op runs at (1, 2), (1, 3) and (1, 4) gloo
ranks on the CPU over 13 rows (6+7, 4+4+5, 3+3+3+4), and at (1, 4) over
3 rows (0+1+1+1; a stride-2 output of 2 rows leaves two ranks empty),
against the same op on the whole tensor in one process, in f64 within
1e-12 of the largest value of each result, forward and backward (input
and parameter gradients): the cases of ``tests/test_torch_spatial_ops.py``
(convs of every kernel, stride and dilation, transposed convs, max and
average pools, bilinear resizes x2, x4, x8, 1/2 and 1/4, the global and
PPM's adaptive pools, a replicated map resized to a rank's rows, dropout
and a training BatchNorm).

The 2x2 index pool stays local: it runs where every shard starts on an
even row (13 rows over 2 and 3) and raises on every rank where one does
not (13 over 4, 3 over 4). Each rank also reports the row-count sums
(``spatial.ROW_SUMS``) its cases made, which every rank must make alike.
"""
import numpy as np
import pytest
import torch

import _torch_spatial as TS
from esn_tpu_torch.parallel import launch, spatial

N, C, W = 2, 4, 8
TOL = 1e-12
LIMIT = 150.0
# (S, T): the shards above
WORLDS = ((2, 13), (3, 13), (4, 13), (4, 3))
# resizes to 3 // 4 = 0 rows, and the index pool where a shard starts odd
SKIP = {(4, 13): {"index_pool_unpool"},
        (4, 3): {"index_pool_unpool", "resize_quarter"}}
NAMES = (list(TS.OPS) + list(TS.REDUCTIONS) + list(TS.UPSAMPLES)
         + ["dropout", "bn"])


def _x(seed, shape):
    return np.random.RandomState(seed).randn(*shape)


def _calls(s, h):
    """(case, args) of every case run at (s, h) by name, and the
    one-process results."""
    calls, want = {}, {}
    x = _x(0, (N, C, h, W))
    for i, name in enumerate(TS.OPS):
        if name in SKIP.get((s, h), ()):
            continue
        p = TS.op_params(name, C, i)
        y = TS.OPS[name][0](torch.from_numpy(x),
                            {k: torch.from_numpy(v) for k, v in p.items()})
        cot = _x(100 + i, tuple(y.shape))
        calls[name] = ("op_case", (name, x, cot, p))
        want[name] = TS.op_case(name, x, cot, p, 1)
    for i, name in enumerate(TS.REDUCTIONS):
        y = TS.REDUCTIONS[name](torch.from_numpy(x))
        cot = _x(200 + i, tuple(y.shape))
        calls[name] = ("reduction_case", (name, x, cot))
        want[name] = TS.reduction_case(name, x, cot, 1)
    for i, (name, (bh, bw)) in enumerate(TS.UPSAMPLES.items()):
        m = _x(300 + i, (N, C, bh, bw))
        cot = _x(400 + i, (N, C, h, W))
        calls[name] = ("upsample_case", (name, m, cot))
        want[name] = TS.upsample_case(name, m, cot, 1)
    calls["dropout"] = ("dropout_case", (x, 0.3, 5))
    want["dropout"] = TS.dropout_case(x, 0.3, 5, 1)
    bn = {"weight": _x(500, (C,)), "bias": _x(501, (C,)),
          "running_mean": 0.1 * _x(502, (C,)),
          "running_var": 1.0 + 0.1 * np.abs(_x(503, (C,)))}
    xs = 3.0 + x
    calls["bn"] = ("bn_case", (xs, _x(505, x.shape), bn))
    want["bn"] = TS.bn_case(xs, _x(505, x.shape), bn, 1)
    if "index_pool_unpool" in SKIP.get((s, h), ()):
        calls["index_pool_raises"] = ("index_pool_guard_case", (x,))
    return calls, want


@pytest.fixture(scope="module")
def runs():
    torch.set_num_threads(1)
    got, want = {}, {}
    for s, h in WORLDS:
        calls, want[s, h] = _calls(s, h)
        names = list(calls)
        outs = launch.run_ranks(
            TS.many_case, s,
            [(c, a + (s,), {}) for c, a in calls.values()]
            + [("row_sums_case", (), {})], timeout=LIMIT)
        got[s, h] = [dict(zip(names + ["row_sums"], o)) for o in outs]
    return got, want


def _close(got, want, what):
    np.testing.assert_allclose(
        got, want, rtol=0, atol=TOL * max(1.0, float(np.abs(want).max())),
        err_msg=what)


def _rows(outs, key):
    return np.concatenate([o[key] for o in outs], axis=2)


@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"S{w[0]}_T{w[1]}")
@pytest.mark.parametrize("name", NAMES)
def test_uneven_shards_match_the_whole_tensor(runs, world, name):
    got, want = runs
    if name in SKIP.get(world, ()):
        assert all(name not in o for o in got[world])
        return
    outs, one = [o[name] for o in got[world]], want[world][name]
    s, h = world
    if name in TS.OPS:
        rows = [o["y"].shape[2] for o in outs]
        b = spatial.bounds(one["y"].shape[2], s)
        if name != "index_pool_unpool":     # local: 2 x its pooled rows
            assert rows == [b[j + 1] - b[j] for j in range(s)], rows
        _close(_rows(outs, "y"), one["y"], "y")
        _close(_rows(outs, "dx"), one["dx"], "dx")
        for k, g in one["grads"].items():
            for o in outs:
                _close(o["grads"][k], g, k)
    elif name in TS.REDUCTIONS:
        for o in outs:
            _close(o["y"], one["y"], "y")
        _close(_rows(outs, "dx"), one["dx"], "dx")
    elif name in TS.UPSAMPLES:
        _close(_rows(outs, "y"), one["y"], "y")
        for o in outs:
            _close(o["dx"], one["dx"], "dx")
    elif name == "dropout":
        for k in ("dropout", "spatial_dropout"):
            np.testing.assert_array_equal(_rows(outs, k), one[k], k)
    else:
        for k in ("y", "dx"):
            _close(_rows(outs, k), one[k], k)
        for k in ("dweight", "dbias", "running_mean", "running_var"):
            for o in outs:
                _close(o[k], one[k], k)


@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"S{w[0]}_T{w[1]}")
def test_every_rank_sums_the_same_row_counts(runs, world):
    """Every rank made the same number of row-count sums (each is a
    collective of the model group), and at least one an op."""
    got, _ = runs
    counts = {o["row_sums"] for o in got[world]}
    assert len(counts) == 1 and counts.pop() >= len(NAMES)


@pytest.mark.parametrize("world", [w for w in WORLDS
                                   if "index_pool_unpool" in SKIP.get(w, ())],
                         ids=lambda w: f"S{w[0]}_T{w[1]}")
def test_an_index_pool_over_odd_shard_starts_raises_on_every_rank(runs,
                                                                  world):
    got, _ = runs
    for o in got[world]:
        assert "would cross shards" in o["index_pool_raises"]
