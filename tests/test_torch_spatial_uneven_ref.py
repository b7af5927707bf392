"""LEDNet-19's uneven spatial step against the reference's spatial mesh:
at 128x64 over a (2, 4) world of gloo ranks on the CPU (data x model), its
attention pyramid keeps 2 rows at 1/64 (none on model indices 0 and 2);
the reference runs the same CE + OHEM step on a (2, 4) JAX mesh of the
conftest's 8 virtual CPU devices, where XLA pads the shards.

The reference is not exact against itself at this shape: its mesh's step
read against its own one-device step (same weights and batch) a loss
2.2e-6 apart in f32 and 2.5e-6 in f64, a per-leaf gradient a median
2.4e-6 apart in f64 (rel-L2; up to 2.6 on conv biases under a train-mode
BN, whose gradients are ~1e-9, noise), and BN statistics 1.1e-8 apart in
f64. The port's sharded f64 step equals its one-process step within 1e-10
(``tests/test_torch_spatial_uneven_train.py``), so it is held to the
reference as ``tests/test_torch_spatial_train.py`` holds Fast-SCNN's even
step, with the loss bound above those readings:

- f32: the loss within LOSS_REL of the mesh's, the updated BN statistics
  within STAT_TOL of the mesh's, each leaf of the gradient summed over the
  ranks within GRAD_F32 of the reference's f64 one-device gradient or no
  further than twice the mesh's f32 gradient is, plus ABS, and all leaves
  together no further than twice the mesh's. GRAD_F32 and ABS are
  LEDNet's f32 bounds of ``tests/test_torch_lednet_esnet.py`` (train-mode
  BN over a batch of 2 makes its f32 gradient ill-conditioned). Fast-SCNN's
  1e-2 and 1e-6, taken first, broke at four leaves of ``encoder.6.1.2``
  (1.25e-2 to 1.58e-2; the reference's mesh reads 4.7e-5 there), where
  the port's one-process f32 step reads 4.3e-5, and it reads up to 1.45e-2
  at other leaves (``encoder.3.1.l3.bias``), where the sharded step reads
  5.9e-3: the f32 rounding of a step lands a leaf a percent off, wherever
  it rounds;
- f64: the loss within LOSS_REL of the mesh's and of the one-device
  step's, and each leaf within GRAD_F64 of the one-device gradient, plus
  ABS_F64.

Planted in every rank, BatchNorm counting ``h x S`` rows (``t_miscount``)
and every row exchange one row off (``shifted_halo``) each break the f32
bounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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

C = 19
HW = (128, 64)
N_DATA, N_SPATIAL = 2, 4
LOSS_REL, STAT_TOL, GRAD_F64 = 1e-5, 1e-4, 1e-4
# tests/test_torch_lednet_esnet.py's GRAD_F32["lednet"], GRAD_ABS_F32
GRAD_F32, ABS = 0.1, 1e-4
ABS_F64 = 1e-6
LIMIT = 240.0
FAULTS = ("t_miscount", "shifted_halo")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _batch(seed, hw=HW, b=N_DATA):
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


def _reference_step(jmodel, variables, img, lab, cw, dtype, smesh):
    """The reference's CE + OHEM loss, per-leaf gradient and updated BN
    statistics, on ``smesh`` (None: one device)."""
    def loss(params, stats, images, labels):
        logits, new = jnn.apply(jmodel, {"params": params, "stats": stats},
                                images, train=True, mutable=True)
        value = (JL.cross_entropy(logits, labels, num_classes=C,
                                  class_weights=jnp.asarray(cw, dtype))
                 + JL.ohem_cross_entropy(logits, labels, num_classes=C))
        return value, new["stats"]

    v = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), dtype),
                               variables)
    batch = {"image": img.transpose(0, 2, 3, 1).astype(dtype),
             "label": lab.astype(np.int32)}
    if smesh is not None:
        v, batch = jsp.replicate(v, smesh), jsp.shard_batch_spatial(batch,
                                                                    smesh)
    (value, stats), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        v["params"], v["stats"], batch["image"], batch["label"])
    as_np = lambda t: dict(leaves(jax.tree_util.tree_map(  # noqa: E731
        np.asarray, t)))
    return float(value), as_np(grads), as_np(stats)


@pytest.fixture(scope="module")
def runs(monkeypatch_module):
    for name in PLAIN_ENV:              # the reference's plain paths
        monkeypatch_module.setenv(name, "0")
    jmodel = jax_build_model("lednet", C)
    reference_dropout_off(jmodel)
    shapes = jax.eval_shape(
        lambda k: jmodel.init(k, jnp.zeros((1, *HW, 3), jnp.float32)),
        jax.random.PRNGKey(0))
    variables = random_variables(shapes, np.random.RandomState(1))
    model = build_model("lednet", C, device="cpu")
    state = {k: v.numpy() for k, v in
             convert.to_state_dict(variables, model).items()}
    img, lab, cw = _batch(2)
    kw = dict(loss="ohem", state=state, dropout=False)
    calls = [("spatial_step_case", ("lednet", img.astype(np.float32), lab,
                                    cw), dict(kw, dtype="float32")),
             ("spatial_step_case", ("lednet", img, lab, cw),
              dict(kw, dtype="float64"))]
    calls += [("spatial_fault_case", (fault, "lednet",
                                      img.astype(np.float32), lab, cw),
               dict(kw, dtype="float32")) for fault in FAULTS]
    got = launch.run_ranks(
        TS.many_case, N_DATA * N_SPATIAL,
        [(c, a + (N_SPATIAL,), k) for c, a, k in calls], timeout=LIMIT)
    smesh = jsp.make_spatial_mesh(N_DATA, N_SPATIAL)
    ref = {"mesh32": _reference_step(jmodel, variables, img, lab, cw,
                                     np.float32, smesh)}
    # its OHEM threshold from lax.top_k (ESN_TPU_OHEM_TOPK=1, its own
    # switch): the radix select reads 32-bit patterns, not traced in x64
    monkeypatch_module.setenv("ESN_TPU_OHEM_TOPK", "1")
    with x64():
        for key, m in (("mesh64", smesh), ("one64", None)):
            ref[key] = _reference_step(jmodel, variables, img, lab, cw,
                                       np.float64, m)
    monkeypatch_module.delenv("ESN_TPU_OHEM_TOPK")
    return got, ref


def _norm(a):
    return float(np.linalg.norm(np.asarray(a, np.float64)))


def _port_paths(tree, kind):
    model = build_model("lednet", C, device="cpu")
    tensors = {n: torch.from_numpy(np.asarray(g)) for n, g in tree.items()}
    if kind == "grads":
        return dict(leaves(convert.params_tree(tensors, model)))
    return dict(leaves(convert.to_variables(tensors, model)["stats"]))


def _f32_breaks(got, ref):
    """The f32 bounds ``got`` breaks (empty: it meets them all)."""
    value, grads32, stats = ref["mesh32"]
    _, grads64, _ = ref["one64"]
    broken = []
    if not abs(float(got["loss"]) - value) <= LOSS_REL * abs(value):
        broken.append("loss")
    mine = _port_paths(got["grads"], "grads")
    assert set(mine) == set(grads64)
    together = [0.0, 0.0]
    for path, g64 in grads64.items():
        d_port, d_ref = _norm(mine[path] - g64), _norm(grads32[path] - g64)
        if not d_port <= max(GRAD_F32 * _norm(g64), 2 * d_ref) + ABS:
            broken.append(("grad", path))
        together[0] += d_port ** 2
        together[1] += d_ref ** 2
    if not together[0] <= 4 * together[1]:
        broken.append("grad_together")
    mine = _port_paths(got["state"], "stats")
    assert set(mine) == set(stats)
    for path, v in stats.items():
        if not np.allclose(mine[path], v, atol=STAT_TOL, rtol=STAT_TOL):
            broken.append(("stats", path))
    return broken


def test_the_reference_mesh_against_its_own_step(runs):
    """The readings the bounds stand beside (module docstring): the
    reference's mesh is off its own one-device step, but within the
    loss bound the port is held to."""
    _, ref = runs
    (m, gm, sm), (o, go, so) = ref["mesh64"], ref["one64"]
    assert 0 < abs(m - o) / abs(o) <= LOSS_REL / 2
    rel = sorted(_norm(gm[k] - go[k]) / _norm(go[k]) for k in go)
    assert rel[len(rel) // 2] < 1e-4
    assert max(float(np.abs(sm[k] - so[k]).max()) for k in so) < STAT_TOL


def test_lednet_uneven_step_matches_the_reference_mesh_f32(runs):
    got_all, ref = runs
    for out in got_all:
        assert _f32_breaks(out[0], ref) == []


def test_lednet_uneven_step_matches_the_reference_f64(runs):
    got_all, ref = runs
    _, grads, _ = ref["one64"]
    for out in got_all:
        got = out[1]
        for key in ("mesh64", "one64"):
            value = ref[key][0]
            assert abs(float(got["loss"]) - value) <= LOSS_REL * abs(value)
        mine = _port_paths(got["grads"], "grads")
        assert set(mine) == set(grads)
        for path, g in grads.items():
            d = _norm(mine[path] - g)
            assert d <= GRAD_F64 * _norm(g) + ABS_F64, (path, d / _norm(g))


@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_breaks_the_reference_bounds(runs, fault):
    got_all, ref = runs
    for out in got_all:
        assert _f32_breaks(out[2 + FAULTS.index(fault)], ref), fault
