"""The host side of K5 and K6 (``esn_tpu_torch/ops/kernels/
resize_bilinear_bwd.py``, ``adaptive_pool_bwd.py``), on the CPU: the
tables the kernels read, the plans that tile their work, and the order in
which the kernels sum, emulated here in numpy as the kernels walk it.

- the tables equal ``axis_taps`` and ``pool_bins``, and every (input
  element, term) lies in exactly one run: each output index is read by
  exactly the input indices of its two taps;
- each plan's blocks cover every input element exactly once, hold every
  term of their elements, and fit their shared memory; the fan-in lanes
  cover each run exactly once;
- the emulated kernels agree with the plain versions (f32 within 1e-5 of
  the largest |gradient|, f64 within 1e-12), the two K5 routes give the
  same bits, and a window of rows, as ``ops/resize.py``'s sharded backward
  forms it, gives the whole tensor's bits on every row whose run lies in
  it;
- planted faults (a dropped term, a window one row off, a bin count one
  short) break these checks.
"""
import importlib

import numpy as np
import pytest
import torch

from esn_tpu_torch.ops import kernels as K

KR = importlib.import_module("esn_tpu_torch.ops.kernels.resize_bilinear_bwd")
KP = importlib.import_module("esn_tpu_torch.ops.kernels.adaptive_pool_bwd")

F32, F64 = torch.float32, torch.float64
# (n_in, n_out, scale factor or None): the models' ratios (x2, x4, x8,
# PPM's bins to a 1/32 map, CamVid's 45-row stages, downscales), the ratio
# route, odd ratios
AXES = [(8, 16, None), (32, 128, None), (128, 1024, None), (4, 32, None),
        (1, 32, None), (2, 64, None), (3, 32, None), (6, 64, None),
        (3, 23, None), (45, 90, None), (23, 45, None), (90, 22, None),
        (45, 22, None), (13, 29, None), (17, 11, None), (13, 52, 4.0),
        (5, 40, 8.0), (16, 4, 0.25), (5, 15, 3.0), (7, 10, 1.5)]


def _ids(axis):
    return "%dto%d%s" % (axis[0], axis[1], "" if axis[2] is None
                         else "_r%g" % axis[2])


def _scale(n_in, n_out, factor, dtype):
    return KR.axis_scale(n_in, n_out, factor, dtype)


def check_runs(i0, i1, lo, hi, n_in):
    """Every output index d lies in the runs of exactly the inputs its
    taps read, ``{i0[d], i1[d]}``: each (input element, term) once."""
    for d in range(len(i0)):
        holders = {i for i in range(n_in) if lo[i] <= d < hi[i]}
        assert holders == {int(i0[d]), int(i1[d])}, (d, holders)


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("axis", AXES, ids=_ids)
def test_axis_tables_equal_axis_taps_and_cover_each_term_once(axis, dtype):
    n_in, n_out, factor = axis
    scale = _scale(n_in, n_out, factor, dtype)
    i0, i1, l0, l1 = KR.axis_taps(n_in, n_out, scale, dtype)
    t = KR.axis_tables(n_in, n_out, scale, dtype)
    lo, hi = KR.table_runs(t, n_in, n_out)
    assert t.taps.dtype == np.int32
    assert np.array_equal(t.taps[:n_out], i0)
    assert np.array_equal(t.weights, np.concatenate([l0, l1]))
    assert t.weights.dtype == (np.float32 if dtype == F32 else np.float64)
    check_runs(i0, i1, lo, hi, n_in)
    a = KR.axis_matrix(n_in, n_out, scale, dtype)
    d, i = np.nonzero(a)
    assert np.all((lo[i] <= d) & (d < hi[i]))


def test_f64_taps_round_once():
    """f64 sources are the exact ``scale (d + 0.5) - 0.5`` rounded once
    (the card's fused multiply-add), not the product rounded first."""
    from fractions import Fraction
    scale = 3 / 23
    i0, _, _, l1 = KR.axis_taps(3, 23, scale, F64)
    src = i0 + l1
    for d in range(23):
        exact = Fraction(scale) * (2 * d + 1) / 2 - Fraction(1, 2)
        assert src[d] == max(0.0, float(exact))


def test_planted_dropped_term_breaks_the_runs():
    n_in, n_out = 4, 32
    scale = _scale(n_in, n_out, None, F32)
    i0, i1, _, _ = KR.axis_taps(n_in, n_out, scale, F32)
    lo, hi = KR.axis_runs(i0, n_in)
    hi = hi.copy()
    hi[2] -= 1
    with pytest.raises(AssertionError):
        check_runs(i0, i1, lo, hi, n_in)


# ------------------------------------------------------------- the plans
def _runs(n_in, n_out, scale, dtype):
    return KR.table_runs(KR.axis_tables(n_in, n_out, scale, dtype), n_in,
                         n_out)


def _plan(n, c, hw, out_hw, cl, dtype, factors=(None, None)):
    (h, w), (ho, wo) = hw, out_hw
    itemsize = torch.empty((), dtype=dtype).element_size()
    acc = 8 if dtype == F64 else 4
    rh = _runs(h, ho, _scale(h, ho, factors[0], dtype), dtype)
    rw = _runs(w, wo, _scale(w, wo, factors[1], dtype), dtype)
    return KR.resize_plan(n, c, h, w, cl, itemsize, acc, rh, rw), rh, rw


# (n, c, input (H, W), output (H, W)): config 5's shapes (PPM's
# upsamples, the fusion's x4, the x8 tail), CamVid's, a downscale, odd
PLANS = {"ppm1": (8, 32, (1, 1), (32, 64)), "ppm6": (8, 32, (6, 6), (32, 64)),
         "fusion_x4": (8, 128, (32, 64), (128, 256)),
         "tail_x8": (8, 19, (128, 256), (1024, 2048)),
         "camvid_x4": (8, 128, (23, 30), (90, 120)),
         "down": (2, 64, (90, 120), (22, 30)),
         "odd": (3, 40, (29, 37), (61, 75))}


def check_stream_plan(plan, n, c, h, w, cl, itemsize, rh, rw):
    """Streaming: the blocks' bands tile the input once; each staged row
    (with its 16-byte head room) fits plan.stage and holds every column
    term of the band; the band's output rows hold every row term; the
    items fit the threads; the shared memory fits."""
    vals = c if cl else 1
    (lo_h, hi_h), (lo_w, hi_w) = rh, rw
    seen = np.zeros((h, w), np.int64)
    for ia in range(0, h, plan.ti):
        ib = min(h, ia + plan.ti)
        assert all(lo_h[ia] <= lo_h[i] and hi_h[i] <= hi_h[ib - 1]
                   for i in range(ia, ib))
        for ja in range(0, w, plan.tj):
            jb = min(w, ja + plan.tj)
            seen[ia:ib, ja:jb] += 1
            assert all(lo_w[ja] <= lo_w[j] and hi_w[j] <= hi_w[jb - 1]
                       for j in range(ja, jb))
            assert (hi_w[jb - 1] - lo_w[ja]) * vals * itemsize + 15 \
                <= plan.stage
            assert (jb - ja) * vals <= KR.STREAM_THREADS * KR.STREAM_ITEMS
    assert np.all(seen == 1)
    assert plan.stage % 16 == 0 and plan.wmax >= int((hi_w - lo_w).max())
    assert plan.smem <= KR.SMEM_MAX


@pytest.mark.parametrize("dtype", [torch.bfloat16, F32, F64],
                         ids=["bf16", "f32", "f64"])
@pytest.mark.parametrize("cl", [True, False], ids=["nhwc", "nchw"])
@pytest.mark.parametrize("name", list(PLANS))
def test_resize_plan_covers_every_element_and_term_once(name, cl, dtype):
    n, c, hw, out_hw = PLANS[name]
    plan, rh, rw = _plan(n, c, hw, out_hw, cl, dtype)
    itemsize = torch.empty((), dtype=dtype).element_size()
    want_stream = (n * c * hw[0] * hw[1] >= KR.STREAM_MIN_INPUTS)
    if plan.route == KR.STREAM:
        assert want_stream
        check_stream_plan(plan, n, c, *hw, cl, itemsize, rh, rw)
    else:
        assert plan.lanes * plan.lines <= KR.FANIN_THREADS
        assert plan.smem >= (plan.wmax + plan.lanes * plan.lines) * (
            8 if dtype == F64 else 4)
        check_lanes(plan.lanes, int((rh[1] - rh[0]).max()))


def test_main_path_routes():
    """Config 5: PPM's upsamples take the fan-in route, the fusion's x4
    and the x8 tail stream."""
    for name, route in (("ppm1", KR.FANIN), ("ppm6", KR.FANIN),
                        ("fusion_x4", KR.STREAM), ("tail_x8", KR.STREAM)):
        n, c, hw, out_hw = PLANS[name]
        dtype = F32 if name == "tail_x8" else torch.bfloat16
        assert _plan(n, c, hw, out_hw, True, dtype)[0].route == route


def check_lanes(lanes, nd):
    """Lane k takes rows k, k + lanes, ... of a run of nd rows: each row
    once."""
    for n in range(nd + 1):
        rows = sorted(m for k in range(lanes) for m in range(k, n, lanes))
        assert rows == list(range(n))


# -------------------------------------------------- the kernels' order
def _fma(a, b, c, acc):
    """a * b + c rounded once to f32 (the product exact in f64); in f64
    two roundings (no exact f64 fused multiply-add in numpy)."""
    if acc == np.float32:
        return (a.astype(np.float64) * b + c).astype(np.float32)
    return a * b + c


def _axis(n_in, n_out, scale, dtype):
    t = KR.axis_tables(n_in, n_out, scale, dtype)
    i0 = t.taps[:n_out].astype(np.int64)
    lo, hi = KR.table_runs(t, n_in, n_out)
    l0, l1 = t.weights[:n_out], t.weights[n_out:]
    i1 = i0 + (i0 < n_in - 1)

    def weight(d, i):
        return (np.where(i0[d] == i, l0[d], 0) +
                np.where(i1[d] == i, l1[d], 0)).astype(t.weights.dtype)
    return i0, lo.astype(np.int64), hi.astype(np.int64), weight


def emulate_resize(g, in_hw, scales, route, dtype, ti=3):
    """K5 as its kernel sums, on g (n, c, ho, wo) numpy in the
    accumulation type: the fan-in route element by element (the lanes'
    row sums, then lane 0's fold), the streaming route band of ``ti`` rows
    by band, walking the band's output rows with the two open
    accumulators; both vectorised over (n, c)."""
    acc = np.float32 if dtype == F32 else np.float64
    n, c, ho, wo = g.shape
    h, w = in_hw
    sh = KR.axis_scale(h, ho, scales[0], dtype)
    sw = KR.axis_scale(w, wo, scales[1], dtype)
    i0_h, lo_h, hi_h, wt_h = _axis(h, ho, sh, dtype)
    _, lo_w, hi_w, wt_w = _axis(w, wo, sw, dtype)
    gx = np.zeros((n, c, h, w), acc)

    def row_sum(d, j):
        r = np.zeros((n, c), acc)
        for q in range(lo_w[j], hi_w[j]):
            r = _fma(wt_w(q, j), g[:, :, d, q], r, acc)
        return r

    if route == KR.FANIN:
        for y in range(h):
            for x in range(w):
                rows = [row_sum(d, x) for d in range(lo_h[y], hi_h[y])]
                a = np.zeros((n, c), acc)
                for d, r in zip(range(lo_h[y], hi_h[y]), rows):
                    a = _fma(wt_h(d, y), r, a, acc)
                gx[:, :, y, x] = a
        return gx
    for ia in range(0, h, ti):
        ib = min(h, ia + ti)
        cur = ia
        a0, a1 = np.zeros((n, c, w), acc), np.zeros((n, c, w), acc)
        for d in range(lo_h[ia], hi_h[ib - 1]):
            while cur < i0_h[d] and cur < ib:
                gx[:, :, cur] = a0
                a0, a1, cur = a1, np.zeros_like(a1), cur + 1
            r = np.stack([row_sum(d, j) for j in range(w)], axis=-1)
            if lo_h[cur] <= d < hi_h[cur]:
                a0 = _fma(wt_h(d, cur), r, a0, acc)
            if cur + 1 < ib and lo_h[cur + 1] <= d < hi_h[cur + 1]:
                a1 = _fma(wt_h(d, cur + 1), r, a1, acc)
        while cur < ib:
            gx[:, :, cur] = a0
            a0, a1, cur = a1, np.zeros_like(a1), cur + 1
    return gx


EMULATED = {"x4": ((5, 6), (20, 24), (None, None)),
            "x8_ratio": ((3, 4), (24, 32), (8.0, 8.0)),
            "ppm2": ((2, 2), (16, 32), (None, None)),
            "down": ((22, 30), (6, 8), (None, None)),
            "odd": ((13, 17), (29, 11), (None, None))}


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", list(EMULATED))
def test_emulated_routes_match_plain_and_each_other(name, dtype):
    in_hw, out_hw, scales = EMULATED[name]
    rng = np.random.RandomState(3)
    acc = np.float32 if dtype == F32 else np.float64
    g = rng.randn(2, 3, *out_hw).astype(acc)
    fan = emulate_resize(g, in_hw, scales, KR.FANIN, dtype)
    stream = emulate_resize(g, in_hw, scales, KR.STREAM, dtype)
    assert np.array_equal(fan, stream)
    want = K.resize_bilinear_bwd_ref(torch.from_numpy(g), in_hw,
                                     None if scales[0] is None else scales)
    tol = (1e-5 if dtype == F32 else 1e-12) * max(1.0, float(want.abs().max()))
    assert float(np.abs(fan - want.numpy()).max()) <= tol


def window_rows(g, h, w, r, lo, hi, dtype, shift=0):
    """K5's emulation on input rows [lo, hi) of an (h, w) input upsampled
    x r by scale factors, as the sharded backward forms it: the window's
    own resize, its output rows [lo r, hi r) of g (``shift`` moves the
    window's output rows, a planted fault); and the whole tensor's."""
    whole = emulate_resize(g, (h, w), (float(r), float(r)), KR.STREAM, dtype)
    part = emulate_resize(g[:, :, lo * r + shift:hi * r + shift],
                          (hi - lo, w), (float(r), float(r)), KR.FANIN,
                          dtype)
    return whole, part


@pytest.mark.parametrize("r", [2, 4, 8])
def test_a_window_sums_as_the_whole_tensor(r):
    """Every input row of the window whose run lies inside it (all but
    its first and last) gets the whole tensor's bits: the order depends
    on the terms alone, not on the window or the route."""
    h, w, lo, hi = 9, 3, 3, 7
    g = np.random.RandomState(r).randn(1, 2, h * r, w * r).astype(np.float32)
    whole, part = window_rows(g, h, w, r, lo, hi, F32)
    assert np.array_equal(part[:, :, 1:-1], whole[:, :, lo + 1:hi - 1])


def test_planted_window_off_by_one_breaks_the_window_check():
    h, w, lo, hi, r = 9, 3, 3, 7, 4
    g = np.random.RandomState(5).randn(1, 2, h * r, w * r).astype(np.float32)
    whole, part = window_rows(g, h, w, r, lo, hi, F32, shift=1)
    assert not np.array_equal(part[:, :, 1:-1], whole[:, :, lo + 1:hi - 1])


# ------------------------------------------------------------------- K6
POOL_AXES = [(32, 1), (32, 2), (32, 3), (32, 6), (64, 6), (23, 6), (30, 3),
             (5, 6), (13, 2), (17, 3), (7, 7), (1, 1)]


def check_bins(tables, length, n):
    """The table's (first, count) of each index name exactly the bins
    that hold it, and its sizes are the bins' sizes."""
    start, end = KP.pool_bins(length, n)
    first, count, size = (tables[:length], tables[length:2 * length],
                          tables[2 * length:])
    assert np.array_equal(size, end - start)
    for i in range(length):
        holders = [a for a in range(n) if start[a] <= i < end[a]]
        assert holders == list(range(first[i], first[i] + count[i])), i


@pytest.mark.parametrize("axis", POOL_AXES, ids=lambda a: "%dby%d" % a)
def test_pool_tables_equal_pool_bins(axis):
    length, n = axis
    t = KP.pool_tables(length, n)
    assert t.dtype == np.int32 and t.shape == (2 * length + n,)
    check_bins(t, length, n)


def test_planted_short_bin_count_breaks_the_bins():
    t = KP.pool_tables(13, 2).copy()
    t[13 + 6] -= 1           # index 6 lies in both bins
    with pytest.raises(AssertionError):
        check_bins(t, 13, 2)


# (c, input (H, W), bins): PPM's at config 5 and CamVid's, odd, and a
# shape that must split its channels and columns to fit
POOL_PLANS = {**{f"ppm{b}": (128, (32, 64), (b, b)) for b in (1, 2, 3, 6)},
              "camvid6": (128, (23, 30), (6, 6)), "odd": (5, (13, 17), (2, 3)),
              "c19": (19, (12, 20), (6, 6)),
              "split": (512, (8, 400), (6, 200))}


@pytest.mark.parametrize("dtype", [torch.bfloat16, F32, F64],
                         ids=["bf16", "f32", "f64"])
@pytest.mark.parametrize("cl", [True, False], ids=["nhwc", "nchw"])
@pytest.mark.parametrize("name", list(POOL_PLANS))
def test_pool_plan_covers_every_element_once(name, cl, dtype):
    c, (h, w), (oh, ow) = POOL_PLANS[name]
    itemsize = torch.empty((), dtype=dtype).element_size()
    acc = 8 if dtype == F64 else 4
    th, tw = KP.pool_tables(h, oh), KP.pool_tables(w, ow)
    plan = KP.pool_plan(c, w, cl, itemsize, acc, th, tw, h)
    assert plan.smem <= KP.SMEM_BUDGET
    if plan.vec > 1:
        assert cl and plan.vec * itemsize == 16 and c % plan.vec == 0
        assert plan.cb % plan.vec == 0
    seen = np.zeros((w, c), np.int64)
    first, count = tw[:w], tw[w:2 * w]
    na = int(th[h:2 * h].max())
    for xa in range(0, w, plan.xb):
        xe = min(w, xa + plan.xb)
        nb = first[xe - 1] + count[xe - 1] - first[xa]
        assert nb <= plan.nbb
        assert na * plan.nbb * min(plan.cb, c) * acc <= plan.smem
        for c0 in range(0, c, plan.cb):
            seen[xa:xe, c0:c0 + plan.cb] += 1
    assert np.all(seen == 1)


def emulate_pool(g, in_hw, dtype):
    """K6 as its kernel sums: each bin's g / kh / kw once, then for each
    input element the bins of its row (outer) and column (inner)."""
    acc = np.float32 if dtype == F32 else np.float64
    n, c, oh, ow = g.shape
    h, w = in_hw
    th, tw = KP.pool_tables(h, oh), KP.pool_tables(w, ow)
    v = (g.astype(acc) / th[2 * h:].astype(acc)[:, None]
         / tw[2 * w:].astype(acc))
    gx = np.zeros((n, c, h, w), acc)
    for y in range(h):
        for x in range(w):
            a_ = np.zeros((n, c), acc)
            for a in range(th[y], th[y] + th[h + y]):
                for b in range(tw[x], tw[x] + tw[w + x]):
                    a_ = a_ + v[:, :, a, b]
            gx[:, :, y, x] = a_
    return gx


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", [((32, 64), 6), ((23, 30), 3), ((13, 17), 2),
                                  ((5, 7), 6)], ids=str)
def test_emulated_pool_matches_plain(case, dtype):
    (h, w), b = case
    acc = np.float32 if dtype == F32 else np.float64
    g = np.random.RandomState(b).randn(2, 3, b, b).astype(acc)
    got = emulate_pool(g, (h, w), dtype)
    want = K.adaptive_pool_bwd_ref(torch.from_numpy(g), (h, w)).numpy()
    tol = (1e-6 if dtype == F32 else 1e-14) * max(
        1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol
