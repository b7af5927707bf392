"""K7's bf16 route on the CPU: the wrapper's packed B operand, its plan,
and a numpy emulation of the kernel's tile walk.

``csrc/subpixel_argmax.cu`` runs only on the card. What it reads is made
here: the bf16 weights packed ``[slot][n][k]`` with a zero slot
(``_pack_weights_bf16``) and the int32 descriptor that carries the
planner's ``Plan`` (``plan_bf16``) and the phase pairs' offset tables
(``pair_taps``). The emulation reads those field by field and walks the
tiles as the kernel does (flat shared-memory indices, the staged tile with
its halo and zero fill, each pair's offsets and K steps, each n-tile's B
rows from its two phases' slots, tiles past the image's last row and
column), in f64: it must give ``phase_logits``, and its walk must cover
every low-res pixel exactly once. The shapes are the
heads of the zoo (ENet; ERFNet and ESNet; ESPNet's I = 19; FSSNet; SQNet's
and LinkNet's I = 32), chip_smoke's odd head and a one-pixel input, at
small H and W.
"""
import importlib

import numpy as np
import pytest
import torch

SA = importlib.import_module("esn_tpu_torch.ops.kernels.subpixel_argmax")

# (name, I, O, kernel, padding, bias)
HEADS = [("enet", 16, 19, 3, 1, False),
         ("erfnet_esnet", 16, 19, 2, 0, True),
         ("espnet", 19, 19, 2, 0, False),
         ("fssnet", 16, 19, 3, 1, True),
         ("sqnet", 32, 19, 2, 0, True),
         ("linknet", 32, 11, 2, 0, True),
         ("odd", 19, 11, 3, 1, True),
         ("one_pixel", 8, 5, 3, 1, True)]
# (N, H, W) of each head's emulation: H and W not multiples of the tile
SPATIAL = {"odd": (2, 37, 53), "one_pixel": (1, 1, 1)}
SPATIAL_DEFAULT = (2, 21, 37)
TABLE_END = 11 + 4 * SA.MAX_TAPS * 3
PLAN_END = TABLE_END + len(SA.Plan._fields)
WARPS = 8


def _case(seed, cin, cout, k, bias, nhw):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(*nhw, cin).astype(np.float32)).to(
        torch.bfloat16)
    w = torch.from_numpy((rng.randn(cin, cout, k, k) / np.sqrt(cin * k))
                         .astype(np.float32))
    b = torch.from_numpy((rng.randn(cout) * 0.1).astype(np.float32)) \
        if bias else None
    return x, w, b


def _fields(desc):
    """The descriptor as the kernel reads it."""
    n, h, w, ci, co, _, nslots = (int(v) for v in desc[:7])
    ntaps = [int(v) for v in desc[7:11]]
    taps = desc[11:TABLE_END].reshape(4, SA.MAX_TAPS, 3)
    plan = SA.Plan(*(int(v) for v in desc[TABLE_END:PLAN_END]))
    npairs = [int(v) for v in desc[PLAN_END:PLAN_END + 2]]
    pairs = desc[PLAN_END + 2:].reshape(2, SA.MAX_PAIRS, 4)
    pairs = [[tuple(int(v) for v in pairs[rh, e]) for e in range(npairs[rh])]
             for rh in range(2)]
    return (n, h, w, ci, co, nslots), ntaps, taps, plan, pairs


def _walk(desc, x=None, wflat=None, bias=None):
    """The kernel's tile walk (``subpixel_argmax_mma``): every tile, its
    staging (``stage_tile``) and each warp's rows and phase pairs
    (``tile_rows``): per pair offset (its A offset into the staged tile)
    and K step, the product of A with the n-tiles' B rows (row r of n-tile
    j: class 4j + r%4 of phase r/4's slot, or of the zero slot), the
    accumulators starting at the bias, padded classes at -inf. With x, the
    packed weights (flat) and bias it returns the (N, 2H, 2W, np) f64
    logits; always the count of times each low-res pixel is stored. Every
    A read is checked to lie in the staged tile and every B read in the
    packed weights."""
    (n, h, w, ci, co, nslots), _, _, p, pairs = _fields(desc)
    ntp = p.np // 4
    tiles_x, tiles_y = -(-w // SA.TILE_W), -(-h // p.th)
    rpw = 2 if p.th > WARPS else 1
    stored = np.zeros((n, h, w), np.int64)
    out = None if x is None else np.full((n, 2 * h, 2 * w, p.np), np.nan)
    if bias is not None:
        bias = np.where(np.arange(p.np) < co, bias, -np.inf)
    for tile in range(n * tiles_y * tiles_x):
        tx, rest = tile % tiles_x, tile // tiles_x
        ty, b = rest % tiles_y, rest // tiles_y
        gy0, gx0 = ty * p.th + p.y0, tx * SA.TILE_W + p.x0
        s = None
        if x is not None:
            s = np.full(p.rows * p.cols * p.ldk, np.nan)   # unset: NaN
            for pix in range(p.rows * p.cols):
                r, c = divmod(pix, p.cols)
                gy, gx = gy0 + r, gx0 + c
                inside = 0 <= gy < h and 0 <= gx < w
                for k in range(p.kp):
                    s[pix * p.ldk + k] = (x[b, gy, gx, k] if inside and k < ci
                                          else 0.0)
        for warp in range(min(WARPS, p.th)):
            for i in range(rpw):
                r0 = warp + i * WARPS
                q = ty * p.th + r0
                for rh in range(2):
                    # merged columns 8j + r: (phase r // 4, class 4j + r % 4)
                    acc = None
                    if x is not None:
                        acc = np.array([bias[4 * (c // 8) + c % 4]
                                        for c in range(8 * ntp)])
                        acc = np.tile(acc, (SA.TILE_W, 1))
                    for dy, dx, s0, s1 in pairs[rh]:
                        a_row = (r0 * p.cols - p.x0) * p.ldk + \
                            ((dy - p.y0) * p.cols + dx) * p.ldk
                        assert 0 <= a_row and (a_row + (SA.TILE_W - 1) * p.ldk
                                               + p.kp <= p.rows * p.cols * p.ldk)
                        assert 0 <= r0 + dy - p.y0 < p.rows
                        assert 0 <= dx - p.x0 and SA.TILE_W - 1 + dx - p.x0 < p.cols
                        assert 0 <= min(s0, s1) and max(s0, s1) <= nslots
                        rows = [((s0, s1)[(c % 8) // 4] * p.np + 4 * (c // 8)
                                 + c % 4) * p.ldk for c in range(8 * ntp)]
                        assert max(rows) + p.kp <= (nslots + 1) * p.np * p.ldk
                        if x is None:
                            continue
                        for k0 in range(0, p.kp, 16):
                            a = np.array([[s[a_row + m * p.ldk + k0 + kk]
                                           for kk in range(16)]
                                          for m in range(SA.TILE_W)])
                            bm = np.array([[wflat[row + k0 + kk]
                                            for kk in range(16)]
                                           for row in rows])
                            acc += a @ bm.T
                    if q >= h:
                        continue
                    for m in range(SA.TILE_W):
                        px = tx * SA.TILE_W + m
                        if px >= w:
                            continue
                        if rh == 0:
                            stored[b, q, px] += 1
                        if x is None:
                            continue
                        for rw in range(2):
                            cols = [8 * j + 4 * rw + r for j in range(ntp)
                                    for r in range(4)]
                            out[b, 2 * q + rh, 2 * px + rw] = acc[m, cols]
    return out, stored


def _packed(w, b):
    return SA._pack_weights_bf16(w, b, torch.device("cpu"))


@pytest.mark.parametrize("name, cin, cout, k, p, bias", HEADS,
                         ids=[h[0] for h in HEADS])
def test_bf16_operand_reads_back_the_weights(name, cin, cout, k, p, bias):
    """``[slot][n][k]`` at ``(slot * np + n) * ldk + k``: the weight in
    bf16 in slot order (``uh * kw + uw``), zeros in the padded classes and
    K, then the zero slot; the bias in bf16 then f32, zeros past O."""
    _, w, b = _case(1, cin, cout, k, bias, (1, 2, 2))
    wb, bb = _packed(w, b)
    plan = SA.plan_bf16(cin, cout, k * k, SA._taps(w.shape, (2, 2), (p, p)))
    assert wb.dtype == torch.bfloat16 and bb.dtype == torch.float32
    assert tuple(wb.shape) == (k * k + 1, plan.np, plan.ldk)
    assert plan.np == SA.pair_classes(cout) and plan.np % 4 == 0
    assert cout <= plan.np and plan.np // 4 in (2, 3, 5, 8)
    assert plan.kp % 16 == 0 and plan.kp - 16 < cin <= plan.kp
    assert plan.ldk == plan.kp + 8 and (plan.ldk * 2 // 16) % 2 == 1
    flat = wb.reshape(-1)
    want = w.to(torch.bfloat16)
    for uh in range(k):
        for uw in range(k):
            slot = uh * k + uw
            for n in range(plan.np):
                got = flat[(slot * plan.np + n) * plan.ldk:
                           (slot * plan.np + n + 1) * plan.ldk]
                if n < cout:
                    assert torch.equal(got[:cin], want[:, n, uh, uw])
                assert not got[cin if n < cout else 0:].float().any()
    assert not wb[k * k].float().any()      # the zero slot
    assert tuple(bb.shape) == (plan.np,) and not bb[cout:].any()
    if bias:
        assert torch.equal(bb[:cout], b.to(torch.bfloat16).float())
    else:
        assert not bb.any()


@pytest.mark.parametrize("name, cin, cout, k, p, bias", HEADS,
                         ids=[h[0] for h in HEADS])
def test_tile_walk_gives_the_phase_logits(name, cin, cout, k, p, bias):
    """The emulated walk, in f64 from the packed operands and the
    descriptor, equals ``phase_logits`` within 1e-12 and its first-max
    argmax equals the plain version's on the f64 logits; every low-res
    pixel is stored once."""
    nhw = SPATIAL.get(name, SPATIAL_DEFAULT)
    x, w, b = _case(2, cin, cout, k, bias, nhw)
    wb, bb = _packed(w, b)
    desc = SA._descriptor(tuple(x.shape), tuple(w.shape), (2, 2), (p, p))
    logits, stored = _walk(desc, x.double().numpy(),
                           wb.double().reshape(-1).numpy(),
                           bb.double().numpy())
    assert (stored == 1).all()
    want, _ = SA.phase_logits(x, w, b, stride=(2, 2), padding=(p, p))
    np.testing.assert_allclose(logits[..., :cout], want.numpy(), atol=1e-12,
                               rtol=0)
    live = np.where(np.arange(logits.shape[-1]) < cout, logits, -np.inf)
    np.testing.assert_array_equal(np.argmax(live, -1),
                                  want.argmax(-1).numpy())


PLANS = [(16, 19, 3, 1), (16, 19, 2, 0), (19, 19, 2, 0), (32, 11, 2, 0),
         (8, 5, 3, 1), (48, 32, 3, 1), (64, 19, 3, 1), (128, 19, 3, 1),
         (256, 19, 3, 1), (288, 32, 3, 1), (300, 32, 3, 1), (512, 19, 2, 0), (16, 19, 4, 1),
         (16, 32, 8, 3)]


@pytest.mark.parametrize("cin, cout, k, p", PLANS,
                         ids=[f"I{c}-O{o}-k{k}p{p}" for c, o, k, p in PLANS])
@pytest.mark.parametrize("nhw", [(1, 1, 1), (2, 17, 15), (1, 33, 47)],
                         ids=["1x1", "17x15", "33x47"])
def test_plan_fits_and_walk_covers_each_pixel_once(cin, cout, k, p, nhw):
    """The planner's shared memory (the bias, the packed weights and its
    x buffers, in 16-byte units) fits one block's ``MAX_SMEM``, and two
    blocks' where it picks two buffers of 16 rows; its walk over the
    tiles stores each low-res pixel exactly once and reads A only inside
    the staged tile (wider I drops to fewer rows or one buffer)."""
    taps = SA._taps((cin, cout, k, k), (2, 2), (p, p))
    plan = SA.plan_bf16(cin, cout, k * k, taps)
    assert plan is not None and plan.bytes <= SA.MAX_SMEM
    assert plan.th in SA.TILE_ROWS and plan.nbuf in (1, 2)
    assert plan.o_w == -(-plan.np * 4 // 16) * 16 + SA.TAP_BYTES
    assert plan.o_w % 16 == 0 and plan.o_x % 16 == 0 and plan.tile_bytes % 16 == 0
    assert plan.o_x == plan.o_w + (k * k + 1) * plan.np * plan.ldk * 2
    assert plan.bytes == plan.o_x + plan.nbuf * plan.tile_bytes
    assert plan.tile_bytes == plan.rows * plan.cols * plan.ldk * 2
    if (plan.th, plan.nbuf) == (16, 2):
        assert plan.bytes <= SA.SMEM_TWO_BLOCKS
    desc = SA._descriptor((*nhw, cin), (cin, cout, k, k), (2, 2), (p, p))
    assert tuple(desc[TABLE_END:PLAN_END]) == tuple(plan)
    _, stored = _walk(desc)
    assert (stored == 1).all()


def test_plan_refuses_weights_that_do_not_fit():
    """I = 1024, 32 classes, k2: the packed weights alone pass one block's
    shared memory, so there is no plan (the wrapper then raises) and the
    descriptor's tail is zeros."""
    taps = SA._taps((1024, 32, 2, 2), (2, 2), (0, 0))
    assert SA.plan_bf16(1024, 32, 4, taps) is None
    desc = SA._descriptor((1, 4, 4, 1024), (1024, 32, 2, 2), (2, 2), (0, 0))
    assert not desc[TABLE_END:PLAN_END].any()


def test_descriptor_carries_the_grid_cap():
    """``max_blocks`` is the plan's last field; the rest of the plan does
    not depend on it."""
    shape, wshape = (2, 9, 11, 16), (16, 19, 3, 3)
    free = SA._descriptor(shape, wshape, (2, 2), (1, 1))
    capped = SA._descriptor(shape, wshape, (2, 2), (1, 1), 3)
    cap = PLAN_END - 1
    assert free[cap] == 0 and capped[cap] == 3
    assert np.array_equal(np.delete(free, cap), np.delete(capped, cap))
    assert len(SA.Plan._fields) == 14 and SA.Plan._fields[-1] == "max_blocks"


@pytest.mark.parametrize("k, p", [(2, 0), (3, 1), (4, 1), (8, 3)])
def test_pair_tables_hold_each_tap_once(k, p):
    """Each phase pair's table lists distinct offsets; every tap of its two
    phases sits at its offset with its slot exactly once, and the zero
    slot fills the rest (the kernel checks the same)."""
    taps = SA._taps((16, 19, k, k), (2, 2), (p, p))
    pairs = SA.pair_taps(taps, k * k)
    for rh in range(2):
        offsets = [(dy, dx) for dy, dx, _, _ in pairs[rh]]
        assert len(set(offsets)) == len(offsets) <= SA.MAX_PAIRS
        for rw in range(2):
            used = sorted((dy, dx, e[2 + rw]) for e in pairs[rh]
                          for dy, dx in [e[:2]] if e[2 + rw] != k * k)
            assert used == sorted(taps[2 * rh + rw])
        assert all(e[2] != k * k or e[3] != k * k for e in pairs[rh])
