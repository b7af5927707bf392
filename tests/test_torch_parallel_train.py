"""The global-batch train step and eval at 2 and 4 ranks on the CPU under
gloo, against one process and against the reference.

- One adam + poly step of Fast-SCNN-19 at 64x64 with class-weighted CE +
  OHEM, and of ENet-19 with its spatial dropout on, at 2 and 4 ranks,
  equals the port's one-process step on the same global batch in f64
  within 1e-10: loss, gradients, BN running statistics and parameters;
  the OHEM thresholds bit for bit. Then ``grad_accum = 2`` and ``remat``
  at 2 ranks.
- The same Fast-SCNN step at 4 ranks against the reference on a 4-device
  JAX data mesh (``esn_tpu.parallel.mesh``), at the tolerances of
  ``tests/test_torch_enet_train.py``: in f32 the reference's step (loss,
  BN statistics, parameters) and the per-leaf gradient of its loss
  (``jax.value_and_grad`` on the mesh), the gradient summed over the
  ranks; in f64 that gradient strictly.
- ``run_eval`` at 2 ranks with a padded tail batch equals one process
  exactly, and the reference's ``run_eval(mesh=)`` on a 2-device mesh.

One spawn per world size (``file://`` rendezvous, one torch thread a
rank, its own time limit) runs every case of that size.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel as TP
from _torch_parity import (PLAIN_ENV, leaves, random_variables,
                           reference_dropout_off, x64)
from esn_tpu import nn as jnn
from esn_tpu.models import build_model as jax_build_model
from esn_tpu.parallel import mesh as jmesh
from esn_tpu.train import evaluation as JEV
from esn_tpu.train import losses as JL
from esn_tpu.train import optimizers as JO
from esn_tpu.train import schedules as JS
from esn_tpu.train.state import TrainState
from esn_tpu.train.step import make_eval_step as jax_make_eval_step
from esn_tpu.train.step import make_train_step as jax_make_train_step
from esn_tpu_torch import convert
from esn_tpu_torch.models import build_model
from esn_tpu_torch.parallel import launch

B, HW, C = 4, (64, 64), TP.CLASSES
# f64 on both sides: only the order of the sums over the ranks differs.
# Every value within 1e-10 of the largest of its kind (the loss, the
# gradients, the state; at least 1): the train-mode BNs amplify f64
# rounding by their cancellations, so Fast-SCNN's gradients (up to ~40)
# differ by up to 3e-10 at grad_accum 2, and a BN bias feeding a
# train-mode BN, whose gradient is 0 in exact arithmetic, reads ~1e-10
# of noise on both sides
F64 = 1e-10
# against the reference on a 4-device mesh (tests/test_torch_enet_train.py):
# f32: loss within 1e-5 relative, BN statistics within 1e-4 (atol and
# rtol), parameters within 2 lr (adam's first step moves each by
# ~lr sign(g), whatever the gradient's size, so the gradient is held
# itself): each leaf's gradient summed over the ranks within GRAD_F32
# rel-L2 of the reference's f32 gradient on the mesh (Fast-SCNN's f32
# bound there; read at this size: worst leaf 2.9e-3, median 1.4e-3), plus
# ABS for the leaves whose exact gradient is 0; f64 (the port's model and
# loss in f64, the reference under x64, whose loss still computes in f32):
# the loss within LOSS_REL (read: 2.9e-7) and each leaf within GRAD_F64
# rel-L2 (read: worst 6.4e-7, median 4.7e-7)
LOSS_REL, STAT_TOL, GRAD_F32, GRAD_F64, ABS = 1e-5, 1e-4, 1e-2, 1e-4, 1e-6
# eval against the reference: the share of pixels whose class may differ
# (f32 in other orders; tests/test_torch_trainer_parity.py's CM_MISMATCH)
CM_MISMATCH = 1e-3
LIMIT = 120.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's own torch work (each rank runs
    one too): the quick tier runs six workers on a few cores, and torch's
    OpenMP teams, one a worker, spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed, b=B, hw=HW):
    """Smooth seeded images (NCHW f64) and labels with an ignored band,
    and class weights from their histogram."""
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


STEPS = {
    "fastscnn": dict(arch="fastscnn"),
    "enet": dict(arch="enet"),
    "fastscnn_accum": dict(arch="fastscnn", grad_accum=2),
    "fastscnn_remat": dict(arch="fastscnn", remat=True),
    "enet_remat": dict(arch="enet", remat=True),
}
AT = {2: ("fastscnn", "enet", "fastscnn_accum", "fastscnn_remat",
          "enet_remat"),
      4: ("fastscnn", "enet")}


# chip_smoke.py's first-step bounds (DP_BOUNDS): the loss (relative), the
# BN statistics' update (rel-L2) and the summed gradient's distance to an
# f64 step over the one-process f32 gradient's (all parameters together)
GATE = {"loss_rel": 1e-5, "stats_rel": 1e-4, "grad_to_f64_ratio": 2.0}
FAULTS = ("none", "local_normaliser", "local_bn_moments", "unsummed_grads")


def _fault_call(fault):
    img, lab, cw = _batch(3)
    return "fault_case", (fault, "fastscnn", img.astype(np.float32), lab, cw), \
        dict(loss="ce", dtype="float32", dropout=False)


def _step_call(name):
    kw = dict(STEPS[name])
    arch = kw.pop("arch")
    img, lab, cw = _batch(1)
    return "step_case", (arch, img, lab, cw), kw


def _eval_inputs():
    rng = np.random.RandomState(5)
    img = rng.randn(7, 64, 128, 3).astype(np.float32)
    lab = rng.randint(0, C, (7, 64, 128)).astype(np.int64)
    lab[:, :4] = 255
    return img, lab


def _reference_call():
    """The Fast-SCNN step at 4 ranks from the reference's weights, in f32
    and in f64."""
    jmodel = jax_build_model("fastscnn", C)
    reference_dropout_off(jmodel)       # the two packages draw differently
    shapes = jax.eval_shape(
        lambda k: jmodel.init(k, jnp.zeros((1, *HW, 3), jnp.float32)),
        jax.random.PRNGKey(0))
    variables = random_variables(shapes, np.random.RandomState(0))
    model = build_model("fastscnn", C, device="cpu")
    state = {k: v.numpy() for k, v in
             convert.to_state_dict(variables, model).items()}
    img, lab, cw = _batch(2)
    calls = [("step_case", ("fastscnn", img.astype(getattr(np, dt)), lab, cw),
              dict(dtype=dt, state=state, dropout=False))
             for dt in ("float32", "float64")]
    return jmodel, variables, (img, lab, cw), calls


@pytest.fixture(scope="module")
def ranks(monkeypatch_module):
    """Every case at 2 and at 4 ranks, two spawns."""
    for name in PLAIN_ENV:              # the reference's plain paths
        monkeypatch_module.setenv(name, "0")
    img, lab = _eval_inputs()
    ref = _reference_call()
    calls = {2: [_step_call(n) for n in AT[2]]
             + [_fault_call(f) for f in FAULTS]
             + [("eval_case", ("fastscnn", img, lab, 3), {})],
             4: [_step_call(n) for n in AT[4]] + ref[3]}
    out = {w: launch.run_ranks(TP.many_case, w, calls[w], timeout=LIMIT)
           for w in (2, 4)}
    return out, ref


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def one_process():
    return {n: getattr(TP, c)(*a, **k) for n, (c, a, k) in
            ((n, _step_call(n)) for n in STEPS)}


def _scale(arrays):
    return max([1.0] + [float(np.abs(a).max()) for a in arrays])


def _close(got, want, scale, what=""):
    np.testing.assert_allclose(got, want, rtol=0, atol=F64 * scale,
                               err_msg=what)


@pytest.mark.parametrize("w,name", [(w, n) for w in (2, 4) for n in AT[w]])
def test_step_at_w_ranks_matches_one_process_f64(ranks, one_process, w,
                                                 name):
    got_all, want = ranks[0][w], one_process[name]
    for r, out in enumerate(got_all):
        got = out[AT[w].index(name)]
        _close(got["loss"], want["loss"], _scale([want["loss"]]))
        assert set(got["grads"]) == set(want["grads"])
        scale = _scale(want["grads"].values())
        for k, g in want["grads"].items():
            _close(got["grads"][k], g, scale, k)
        scale = _scale(want["state"].values())
        for k, v in want["state"].items():
            _close(got["state"][k], v, scale, k)
        assert len(want["thresholds"]) == 1 + (name == "fastscnn_accum")
        np.testing.assert_array_equal(np.asarray(got["thresholds"]),
                                      np.asarray(want["thresholds"]))
    launch.assert_ranks_equal([o[AT[w].index(name)]["state"]
                               for o in got_all])


def test_dropout_draws_the_global_masks(one_process):
    """ENet's spatial dropout is on in these steps: the mask changes the
    step (a step with the rate set to 0 differs), so the f64 equality
    above holds the ranks' draws to the one-process draw."""
    img, lab, cw = _batch(1)
    off = TP.step_case("enet", img, lab, cw, dropout=False)
    assert abs(float(off["loss"][0]) - float(one_process["enet"]["loss"][0])
               ) > 1e-6


def _jax_loss(cw):
    def loss(logits, labels):
        return (JL.cross_entropy(logits, labels, num_classes=C,
                                 class_weights=cw)
                + JL.ohem_cross_entropy(logits, labels, num_classes=C))
    return loss


def _mesh_grads(jmodel, variables, img, lab, cw, dtype):
    """The reference's loss and per-leaf gradient (path -> array) of the
    step's loss on a 4-device data mesh: the batch sharded over the
    devices, the variables replicated, the global view's autodiff."""
    jm = jmesh.make_mesh(jax.devices()[:4])

    def loss(params, stats, images, labels):
        logits, _ = jnn.apply(jmodel, {"params": params, "stats": stats},
                              images, train=True, mutable=True)
        return _jax_loss(jnp.asarray(cw, dtype))(logits, labels)

    v = jmesh.replicate(jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a), dtype), variables), jm)
    batch = jmesh.shard_batch({"image": img.transpose(0, 2, 3, 1).astype(dtype),
                               "label": lab.astype(np.int32)}, jm)
    value, grads = jax.jit(jax.value_and_grad(loss))(
        v["params"], v["stats"], batch["image"], batch["label"])
    return float(value), dict(leaves(jax.tree_util.tree_map(np.asarray,
                                                            grads)))


def _check_grads(got, want, rel):
    """Each leaf of the ranks' summed gradient (port names) within ``rel``
    rel-L2 of the reference's (paths), plus ABS."""
    model = build_model("fastscnn", C, device="cpu")
    got = dict(leaves(convert.params_tree(
        {n: torch.from_numpy(g) for n, g in got.items()}, model)))
    assert set(got) == set(want)
    for path, ref in want.items():
        g = np.asarray(got[path], np.float64)
        assert np.linalg.norm(g - ref) <= rel * np.linalg.norm(ref) + ABS, (
            path, float(np.linalg.norm(g - ref) / np.linalg.norm(ref)))


def test_step_at_4_ranks_matches_the_reference_on_a_jax_mesh(ranks):
    out, (jmodel, variables, (img, lab, cw), _) = ranks
    jm = jmesh.make_mesh(jax.devices()[:4])
    loss = _jax_loss(jnp.asarray(cw))
    sched = JS.poly_schedule(TP.LR, TP.TOTAL)
    tx = JO.build_optimizer("adam", sched)
    step = jax_make_train_step(jmodel, loss, tx, schedule=sched,
                               donate=False)
    state = jmesh.replicate(TrainState.create(variables, tx), jm)
    batch = jmesh.shard_batch(
        {"image": img.transpose(0, 2, 3, 1).astype(np.float32),
         "label": lab.astype(np.int32)}, jm)
    new, metrics = step(state, batch, jax.random.PRNGKey(0))
    want_loss = float(metrics["loss"])
    model = build_model("fastscnn", C, device="cpu")
    ref_sd = convert.to_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": new.params, "stats": new.stats}), model)
    value, grads = _mesh_grads(jmodel, variables, img, lab, cw, np.float32)
    assert abs(value - want_loss) <= LOSS_REL * abs(want_loss)
    for o in out[4]:
        got = o[len(AT[4])]
        assert abs(float(got["loss"][0]) - want_loss) \
            <= LOSS_REL * abs(want_loss)
        _check_grads(got["grads"], grads, GRAD_F32)
        for k, v in ref_sd.items():
            v = v.numpy()
            if "running_" in k:
                np.testing.assert_allclose(got["state"][k], v, atol=STAT_TOL,
                                           rtol=STAT_TOL, err_msg=k)
            else:
                assert np.all(np.abs(got["state"][k] - v)
                              <= 2 * TP.LR + 1e-7), k


def test_step_gradient_at_4_ranks_matches_the_reference_mesh_in_f64(
        ranks, monkeypatch):
    """The f64 step at 4 ranks: its loss and each leaf of its summed
    gradient against the reference's under x64 on the 4-device mesh. The
    reference's OHEM threshold comes from ``lax.top_k`` there
    (``ESN_TPU_OHEM_TOPK=1``, its own switch, bit-identical by its tests):
    its radix select reads 32-bit patterns and does not trace under x64."""
    out, (jmodel, variables, (img, lab, cw), _) = ranks
    monkeypatch.setenv("ESN_TPU_OHEM_TOPK", "1")
    with x64():
        value, grads = _mesh_grads(jmodel, variables, img, lab, cw,
                                   np.float64)
    for o in out[4]:
        got = o[len(AT[4]) + 1]
        assert abs(float(got["loss"][0]) - value) <= LOSS_REL * abs(value)
        _check_grads(got["grads"], grads, GRAD_F64)


def _gate_readings(got, one, f64, before):
    def update(state):
        return np.concatenate([(state[k] - before[k]).ravel()
                               for k in before if "running_" in k]
                              ).astype(np.float64)

    def grad(run):
        return np.concatenate([run["grads"][k].ravel()
                               for k in sorted(run["grads"])]
                              ).astype(np.float64)
    g64 = grad(f64)
    return {"loss_rel": abs(float(got["loss"][0]) - float(one["loss"][0]))
            / abs(float(one["loss"][0])),
            "stats_rel": float(np.linalg.norm(update(got["state"])
                                              - update(one["state"]))
                               / np.linalg.norm(update(one["state"]))),
            "grad_to_f64_ratio": float(np.linalg.norm(grad(got) - g64)
                                       / np.linalg.norm(grad(one) - g64))}


def test_planted_faults_fail_the_first_step_bounds(ranks):
    """chip_smoke.py holds the two-rank step on the card to bounds on its
    first step from equal weights (GATE). The same readings here, f32 at
    2 ranks against one process, one weighted-CE adam step: the ranks as
    they are pass, and a rank that skips any one collective fails at
    least one bound tenfold or more. Read: as they are, loss 4.4e-7,
    statistics 4.1e-6, ratio 0.39; a local normaliser, loss 1.0 and ratio
    97; local BN moments, loss 6.6e-2, statistics 0.64 and ratio 2.6e2;
    unsummed gradients, ratio 64."""
    out, _ = ranks
    img, lab, cw = _batch(3)
    kw = dict(loss="ce", dropout=False)
    one = TP.step_case("fastscnn", img.astype(np.float32), lab, cw,
                       dtype="float32", **kw)
    f64 = TP.step_case("fastscnn", img, lab, cw, dtype="float64", **kw)
    before = {k: v.numpy() for k, v in build_model(
        "fastscnn", C, device="cpu",
        generator=torch.Generator().manual_seed(0)).state_dict().items()}
    at = len(AT[2])
    for i, fault in enumerate(FAULTS):
        r = _gate_readings(out[2][0][at + i], one, f64, before)
        over = {k: v / GATE[k] for k, v in r.items() if v > GATE[k]}
        if fault == "none":
            assert not over, r
        else:
            assert max(over.values(), default=0.0) >= 10.0, (fault, r)


def test_eval_at_2_ranks_with_a_padded_tail(ranks):
    """7 images in batches of 3 (3, 3, 1): padded to 4 at 2 ranks; the
    summed confusion matrix equals one process's exactly, and rank 0's
    ``per_image`` sees every real row's prediction."""
    out, _ = ranks
    img, lab = _eval_inputs()
    one = TP.eval_case("fastscnn", img, lab, 3)
    for r, o in enumerate(out[2]):
        got = o[-1]
        np.testing.assert_array_equal(got["cm"], one["cm"])
        assert int(got["cm"].sum()) == int((lab != 255).sum())
        if r == 0:
            np.testing.assert_array_equal(got["preds"], one["preds"])
        else:
            assert got["preds"].size == 0


def test_eval_at_2_ranks_matches_the_reference_run_eval_on_a_mesh(ranks):
    out, _ = ranks
    img, lab = _eval_inputs()
    model = build_model("fastscnn", C, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    variables = convert.to_variables(model.state_dict(), model)
    jmodel = jax_build_model("fastscnn", C)

    class Loader(list):
        batch_size = 3
    loader = Loader({"image": img[i:i + 3], "label": lab[i:i + 3]}
                    for i in range(0, 7, 3))
    cm = JEV.run_eval(jax_make_eval_step(jmodel, C), variables, loader,
                      jnp.asarray, C,
                      mesh=jmesh.make_mesh(jax.devices()[:2]))
    got = out[2][0][-1]["cm"]
    assert int(np.abs(got - cm).sum()) <= 2 * CM_MISMATCH * cm.sum(), (
        int(np.abs(got - cm).sum()))
