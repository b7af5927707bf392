"""The spatially sharded train step on the CPU under gloo, against one
process and against the reference's spatial mesh.

- One adam + poly step of Fast-SCNN-19 at 128x128 (the envelope's least
  height: 4 rows at stride 32) with class-weighted CE, CE + OHEM and
  Lovász-Softmax, its dropout on, at (1, 2), (2, 2) and (1, 4) ranks
  (data x model), equals the port's one-process step on the same global
  batch in f64 within 1e-10 of the largest value of each kind: loss,
  gradients, BN running statistics and parameters; the OHEM threshold
  bit for bit. At (1, 2) also with two microbatches and with remat.
- A planted fault (row exchanges that give zeros) fails the first-step
  bounds chip_smoke.py holds the sharded step to on the card.
- At (2, 2) against ``esn_tpu.parallel.spatial`` on a (2, 2) JAX mesh of
  the conftest's virtual CPU devices: ENet's eval forward under the
  bounds of the reference's own spatial test
  (``tests/test_spatial_sharding.py``), and the Fast-SCNN CE + OHEM step
  from the reference's weights at the bounds of
  ``tests/test_torch_parallel_train.py``'s 4-device data mesh: in f32 the
  loss and the updated BN statistics, and the gradient summed over the
  ranks held to the reference's f64 gradient no worse than the
  reference's own f32 gradient (``jax.value_and_grad`` on the mesh); in
  f64 each leaf of the gradient strictly.

One spawn per layout (``file://`` rendezvous, one torch thread a rank,
its own time limit) runs every case of that layout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel as TP
import _torch_spatial as TS
from _torch_parity import (PLAIN_ENV, leaves, random_variables,
                           reference_dropout_off, x64)
from esn_tpu import nn as jnn
from esn_tpu.models import build_model as jax_build_model
from esn_tpu.parallel import spatial as jsp
from esn_tpu.train import losses as JL
from esn_tpu_torch import convert
from esn_tpu_torch.models import build_model
from esn_tpu_torch.parallel import launch

C = TP.CLASSES
HW = (128, 128)
LOSSES = ("ce", "ohem", "lovasz")
# (ranks, spatial): (1, 2), (2, 2), (1, 4)
LAYOUTS = ((2, 2), (4, 2), (4, 4))
F64 = 1e-10
# against the reference's mesh (tests/test_torch_parallel_train.py's
# bounds on its 4-device data mesh)
LOSS_REL, STAT_TOL, GRAD_F32, GRAD_F64, ABS = 1e-5, 1e-4, 1e-2, 1e-4, 1e-6
# ENet's forward: tests/test_spatial_sharding.py's bounds
MEAN_REL, PRED_MATCH = 1e-4, 0.995
ENET_HW = (64, 64)
LIMIT = 180.0
# chip_smoke.py's first-step bounds on the loss (relative) and the BN
# statistics' update (rel-L2), f32 against one process
GATE = {"loss_rel": 1e-5, "stats_rel": 1e-4}
FAULTS = ("none", "zero_halo")
# the step's options at (1, 2): two microbatches of one image; the
# forward recomputed during the backward (its row exchanges reissued)
OPTIONS = {"grad_accum": dict(grad_accum=2), "remat": dict(remat=True)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed, b=2, hw=HW):
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


def _reference_inputs():
    """The reference's Fast-SCNN and ENet with random weights (dropout
    off: the two packages draw differently), the port's state dicts of
    them, the step's batch and ENet's images."""
    out = {}
    for arch, hw in (("fastscnn", HW), ("enet", ENET_HW)):
        jmodel = jax_build_model(arch, C)
        reference_dropout_off(jmodel)
        shapes = jax.eval_shape(
            lambda k: jmodel.init(k, jnp.zeros((1, *hw, 3), jnp.float32)),
            jax.random.PRNGKey(0))
        variables = random_variables(shapes, np.random.RandomState(1))
        model = build_model(arch, C, device="cpu")
        state = {k: v.numpy() for k, v in
                 convert.to_state_dict(variables, model).items()}
        out[arch] = (jmodel, variables, state)
    images = np.random.RandomState(3).rand(2, 3, *ENET_HW).astype(np.float32)
    return out, _batch(2), images


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def runs(monkeypatch_module):
    for name in PLAIN_ENV:              # the reference's plain paths
        monkeypatch_module.setenv(name, "0")
    ref, (img, lab, cw), enet_images = _reference_inputs()
    b_img, b_lab, b_cw = _batch(1)
    steps = [("spatial_step_case", ("fastscnn", b_img, b_lab, b_cw),
              dict(loss=loss)) for loss in LOSSES]
    refs = [("spatial_step_case",
             ("fastscnn", img.astype(getattr(np, dt)), lab, cw),
             dict(loss="ohem", dtype=dt, state=ref["fastscnn"][2],
                  dropout=False)) for dt in ("float32", "float64")]
    refs.append(("forward_case", ("enet", ref["enet"][2], enet_images), {}))
    f_img, f_lab, f_cw = _batch(3)
    faults = [("spatial_fault_case", (fault, "fastscnn",
                                      f_img.astype(np.float32), f_lab, f_cw),
               dict(dtype="float32", dropout=False)) for fault in FAULTS]
    options = [("spatial_step_case", ("fastscnn", b_img, b_lab, b_cw),
                dict(OPTIONS[name])) for name in OPTIONS]
    got = {}
    for w, s in LAYOUTS:
        calls = steps + (refs if (w, s) == (4, 2) else []) \
            + (faults + options if (w, s) == (2, 2) else [])
        got[(w, s)] = launch.run_ranks(
            TS.many_case, w, [(c, a + (s,), k) for c, a, k in calls],
            timeout=LIMIT)
    one = {loss: TS.spatial_step_case("fastscnn", b_img, b_lab, b_cw, 1,
                                      loss=loss) for loss in LOSSES}
    one.update({name: TS.spatial_step_case("fastscnn", b_img, b_lab, b_cw, 1,
                                           **kw)
                for name, kw in OPTIONS.items()})
    return got, one, ref, (img, lab, cw), enet_images


def _scale(arrays):
    return max([1.0] + [float(np.abs(a).max()) for a in arrays])


def _close(got, want, scale, what=""):
    np.testing.assert_allclose(got, want, rtol=0, atol=F64 * scale,
                               err_msg=what)


@pytest.mark.parametrize("layout", LAYOUTS,
                         ids=["1x2", "2x2", "1x4"])
@pytest.mark.parametrize("loss", LOSSES)
def test_spatial_step_matches_one_process_f64(runs, layout, loss):
    got_all, one = runs[0][layout], runs[1][loss]
    i = LOSSES.index(loss)
    for out in got_all:
        got = out[i]
        _close(got["loss"], one["loss"], _scale([one["loss"]]), "loss")
        assert set(got["grads"]) == set(one["grads"])
        scale = _scale(one["grads"].values())
        for k, g in one["grads"].items():
            _close(got["grads"][k], g, scale, k)
        scale = _scale(one["state"].values())
        for k, v in one["state"].items():
            _close(got["state"][k], v, scale, k)
        np.testing.assert_array_equal(np.asarray(got["thresholds"]),
                                      np.asarray(one["thresholds"]))
    launch.assert_ranks_equal([o[i]["state"] for o in got_all])


@pytest.mark.parametrize("name", list(OPTIONS))
def test_spatial_step_options_match_one_process_f64(runs, name):
    got_all, one = runs[0][(2, 2)], runs[1][name]
    i = len(LOSSES) + len(FAULTS) + list(OPTIONS).index(name)
    for out in got_all:
        got = out[i]
        _close(got["loss"], one["loss"], _scale([one["loss"]]), "loss")
        scale = _scale(one["grads"].values())
        for k, g in one["grads"].items():
            _close(got["grads"][k], g, scale, k)
        scale = _scale(one["state"].values())
        for k, v in one["state"].items():
            _close(got["state"][k], v, scale, k)


def test_the_dropout_mask_matters(runs):
    """Fast-SCNN's dropout is on in these steps: a step with its rate at
    0 differs, so the f64 equality above holds the ranks' masks (each its
    block of the global draw) to the one-process mask."""
    img, lab, cw = _batch(1)
    off = TS.spatial_step_case("fastscnn", img, lab, cw, 1, dropout=False)
    assert abs(float(off["loss"]) - float(runs[1]["ce"]["loss"])) > 1e-6


def _jax_loss(cw):
    def loss(logits, labels):
        return (JL.cross_entropy(logits, labels, num_classes=C,
                                 class_weights=cw)
                + JL.ohem_cross_entropy(logits, labels, num_classes=C))
    return loss


def _spatial_mesh_grads(jmodel, variables, img, lab, cw, dtype):
    """The reference's loss, per-leaf gradient and updated BN statistics
    (paths -> arrays) of the CE + OHEM step's loss on a (2, 2) spatial
    mesh: batch over ``data``, height over ``model``."""
    smesh = jsp.make_spatial_mesh(2, 2)

    def loss(params, stats, images, labels):
        logits, new = jnn.apply(jmodel, {"params": params, "stats": stats},
                                images, train=True, mutable=True)
        return _jax_loss(jnp.asarray(cw, dtype))(logits, labels), \
            new["stats"]

    v = jsp.replicate(jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a), dtype), variables), smesh)
    batch = jsp.shard_batch_spatial(
        {"image": img.transpose(0, 2, 3, 1).astype(dtype),
         "label": lab.astype(np.int32)}, smesh)
    (value, stats), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        v["params"], v["stats"], batch["image"], batch["label"])
    as_np = lambda t: dict(leaves(jax.tree_util.tree_map(  # noqa: E731
        np.asarray, t)))
    return float(value), as_np(grads), as_np(stats)


def _port_paths(tree, kind):
    """The port's gradients (parameter names) or state (statistics) as
    reference paths."""
    model = build_model("fastscnn", C, device="cpu")
    tensors = {n: torch.from_numpy(np.asarray(g)) for n, g in tree.items()}
    if kind == "grads":
        return dict(leaves(convert.params_tree(tensors, model)))
    return dict(leaves(convert.to_variables(tensors, model)["stats"]))


@pytest.fixture(scope="module")
def reference_mesh(runs, monkeypatch_module):
    """The reference's CE + OHEM step on the (2, 2) spatial mesh: f32
    (loss, gradient, statistics) and under x64 (loss, gradient; its OHEM
    threshold from ``lax.top_k``, ``ESN_TPU_OHEM_TOPK=1``, its own
    switch: the radix select reads 32-bit patterns and does not trace
    under x64)."""
    _, _, ref, (img, lab, cw), _ = runs
    jmodel, variables, _ = ref["fastscnn"]
    out = {"f32": _spatial_mesh_grads(jmodel, variables, img, lab, cw,
                                      np.float32)}
    monkeypatch_module.setenv("ESN_TPU_OHEM_TOPK", "1")
    with x64():
        out["f64"] = _spatial_mesh_grads(jmodel, variables, img, lab, cw,
                                         np.float64)
    monkeypatch_module.delenv("ESN_TPU_OHEM_TOPK")
    return out


def _norm(a):
    return float(np.linalg.norm(np.asarray(a, np.float64)))


def test_step_at_2x2_matches_the_reference_spatial_mesh_f32(
        runs, reference_mesh):
    """f32 at this size is ill-conditioned: the reference's own f32
    gradient lies a median 1.45e-2 per leaf from its f64 one (the port's
    sharded f32 gradient 1.27e-2, read), so each leaf of the port's is
    held to the f64 reference: within GRAD_F32 of it, or no further than
    twice the reference's f32 gradient is, plus ABS; and all leaves
    together no further than twice the reference's f32 gradient."""
    got_all = runs[0][(4, 2)]
    value, grads32, stats = reference_mesh["f32"]
    _, grads64, _ = reference_mesh["f64"]
    together = [0.0, 0.0]
    for o in got_all:
        got = o[len(LOSSES)]
        assert abs(float(got["loss"]) - value) <= LOSS_REL * abs(value)
        mine = _port_paths(got["grads"], "grads")
        assert set(mine) == set(grads64)
        for path, g64 in grads64.items():
            d_port, d_ref = _norm(mine[path] - g64), _norm(grads32[path] - g64)
            assert d_port <= max(GRAD_F32 * _norm(g64), 2 * d_ref) + ABS, (
                path, d_port / _norm(g64), d_ref / _norm(g64))
            together[0] += d_port ** 2
            together[1] += d_ref ** 2
        assert together[0] <= 4 * together[1], together
        mine = _port_paths(got["state"], "stats")
        assert set(mine) == set(stats)
        for path, v in stats.items():
            np.testing.assert_allclose(mine[path], v, atol=STAT_TOL,
                                       rtol=STAT_TOL, err_msg=str(path))
        together = [0.0, 0.0]


def test_step_gradient_at_2x2_matches_the_reference_spatial_mesh_f64(
        runs, reference_mesh):
    value, grads, _ = reference_mesh["f64"]
    for o in runs[0][(4, 2)]:
        got = o[len(LOSSES) + 1]
        assert abs(float(got["loss"]) - value) <= LOSS_REL * abs(value)
        mine = _port_paths(got["grads"], "grads")
        assert set(mine) == set(grads)
        for path, ref in grads.items():
            d = _norm(mine[path] - ref)
            assert d <= GRAD_F64 * _norm(ref) + ABS, (path, d / _norm(ref))


def test_enet_forward_at_2x2_matches_the_reference_spatial_mesh(runs):
    """Dilated and stride-2 convs, the index pool and unpool, the
    transposed conv: the port's eval forward at (2, 2) ranks against the
    reference's on a (2, 2) spatial mesh."""
    got_all, _, ref, _, images = runs
    jmodel, variables, _ = ref["enet"]
    smesh = jsp.make_spatial_mesh(2, 2)
    fwd = jax.jit(lambda v, im: jnn.apply(jmodel, v, im))
    x = jax.device_put(jnp.asarray(images.transpose(0, 2, 3, 1)),
                       jsp.spatial_batch_sharding(smesh))
    want = np.asarray(fwd(jsp.replicate(variables, smesh), x))
    outs = [o[len(LOSSES) + 2] for o in got_all[(4, 2)]]
    got = _assemble(outs)
    scale = np.mean(np.abs(want)) + 1e-8
    assert np.mean(np.abs(got - want)) / scale < MEAN_REL
    match = np.mean(np.argmax(got, -1) == np.argmax(want, -1))
    assert match > PRED_MATCH, match


def _assemble(outs):
    """(2, 2) ranks' NCHW rows -> the global NHWC output: rank ``d*2 + m``
    holds image ``d``'s rows ``m``."""
    rows = [np.concatenate([outs[2 * d], outs[2 * d + 1]], axis=2)
            for d in range(2)]
    return np.concatenate(rows).transpose(0, 2, 3, 1)


def test_a_missing_halo_fails_the_first_step_bounds(runs):
    """chip_smoke.py holds the sharded step on the card to the
    data_parallel gate (GATE). The same readings here, f32 at (1, 2)
    against one process: the ranks as they are pass, and ranks whose row
    exchanges give zeros (each shard padded as if its border were the
    image's) fail the loss or the statistics bound tenfold or more. Read:
    as they are, loss 2.0e-7 and statistics 2.2e-6; zero halos, loss
    1.3e-2 and statistics 0.48."""
    img, lab, cw = _batch(3)
    one = TS.spatial_step_case("fastscnn", img.astype(np.float32), lab, cw,
                               1, dtype="float32", dropout=False)
    before = {k: v.numpy() for k, v in build_model(
        "fastscnn", C, device="cpu",
        generator=torch.Generator().manual_seed(0)).state_dict().items()}

    def update(state):
        return np.concatenate([(state[k] - before[k]).ravel()
                               for k in before if "running_" in k]
                              ).astype(np.float64)
    at = len(LOSSES)
    for i, fault in enumerate(FAULTS):
        got = runs[0][(2, 2)][0][at + i]
        r = {"loss_rel": abs(float(got["loss"]) - float(one["loss"]))
             / abs(float(one["loss"])),
             "stats_rel": float(np.linalg.norm(update(got["state"])
                                               - update(one["state"]))
                                / np.linalg.norm(update(one["state"])))}
        over = {k: v / GATE[k] for k, v in r.items() if v > GATE[k]}
        if fault == "none":
            assert not over, r
        else:
            assert max(over.values(), default=0.0) >= 10.0, (fault, r)
