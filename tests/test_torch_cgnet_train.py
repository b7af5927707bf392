"""One whole CGNet-19 (M=3, N=21) train step of the port against the JAX
reference's, on the CPU, and the kernel routes of training and of a
predict after it.

Weights are drawn with numpy into the reference's variables tree,
converted with ``esn_tpu_torch.convert`` and trained one adam + poly step
with class-weighted CE through ``logits_lowres`` in both packages: the
port's composed CG blocks (train mode runs no ``fused_cgblock_pre``) and
the resize-CE kernel's plain version (a CPU tensor never reaches a CUDA
kernel); the reference's jitted step on its plain stem
(``ESN_TPU_FOLDED_STEM=0``), and its math in f64 as the oracle.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esn_tpu import nn as jnn
from esn_tpu.models import build_model as jax_build_model
from esn_tpu.ops.resize import resize_bilinear as jax_resize_bilinear
from esn_tpu.train import losses as JL
from esn_tpu.train import optimizers as JO
from esn_tpu.train import schedules as JS
from esn_tpu.train.state import TrainState
from esn_tpu.train.step import make_train_step as jax_make_train_step

from esn_tpu_torch import convert
from esn_tpu_torch.models import build_model
from esn_tpu_torch.ops import kernels as K
from esn_tpu_torch.train import losses as L
from esn_tpu_torch.train import optimizers as O
from esn_tpu_torch.train import schedules as S
from esn_tpu_torch.train.step import make_predict_step, make_train_step

CLASSES = 19
HW = (64, 128)
LR, TOTAL = 4.5e-4, 100
# One adam step (tolerances as tests/test_torch_contextnet.py): the loss
# within 1e-5 relative of the reference's f32 step and of the f64 oracle;
# per-leaf gradient rel-L2 of the port's model run in f64 (the loss, and
# the reference's BN moments, stay f32) <= GRAD_F64 and of the f32 step <=
# GRAD_F32, each plus ABS; the parameters within 2 lr and the BN
# statistics within STAT_TOL (relative, plus as much absolute) of the
# reference's f32 step. CGNet's gradient is well-conditioned at this
# size (read, the worst leaf: f32 9.8e-6, f64 4.8e-6; statistics 2.7e-8;
# ``step_readings`` returns every reading).
LOSS_REL, GRAD_F64, GRAD_F32, ABS, STAT_TOL = 1e-5, 1e-4, 1e-3, 1e-6, 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's tests, as in
    tests/test_torch_cli.py: the quick tier runs six workers on a few
    cores, and torch's OpenMP teams, one a worker, spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _plain_reference(monkeypatch):
    for name in ("ESN_TPU_FOLDED_STEM", "ESN_TPU_FOLD_DW", "ESN_TPU_FUSED_CG",
                 "ESN_TPU_SCAN_CHAIN"):
        monkeypatch.setenv(name, "0")


def _random_variables(tree, rng):
    """numpy values for every leaf of a reference variables tree: conv and
    Dense kernels ~ N(0, 2/fan_in), BN affines, running stats and PReLU
    slopes non-trivial."""
    def fill(node):
        out = {}
        for name, leaf in node.items():
            if isinstance(leaf, dict):
                out[name] = fill(leaf)
                continue
            shape = leaf.shape
            if name == "kernel":
                v = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[:-1]))
            elif name in ("scale", "var"):
                v = rng.uniform(0.5, 1.5, shape)
            elif name in ("bias", "mean"):
                v = rng.randn(*shape) * 0.1
            elif name == "alpha":
                v = rng.uniform(0.1, 0.4, shape)
            else:
                raise KeyError(name)
            out[name] = np.asarray(v, np.float32)
        return out
    return {coll: fill(tree[coll]) for coll in ("params", "stats")}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _batch(seed):
    """Seeded smooth images and labels a network can fit, with a band of
    ignored rows; the reference's class weights of their histogram."""
    rng = np.random.RandomState(seed)
    h, w = HW

    def smooth(c, f):
        low = rng.randn(2, h // f, w // f, c).astype(np.float32)
        return np.asarray(jax.image.resize(low, (2, h, w, c), "linear"))

    img = smooth(3, 32) + 0.1 * rng.randn(2, h, w, 3).astype(np.float32)
    lab = np.argmax(smooth(CLASSES, 16), -1).astype(np.int32)
    lab[:, h // 2 - 4:h // 2 + 4] = 255
    hist = np.bincount(lab[lab != 255], minlength=CLASSES).astype(np.float64)
    cw = (1.0 / np.log(1.10 + hist / hist.sum())).astype(np.float32)
    return img.astype(np.float32), lab, cw


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _oracle(jmodel, variables, img, lab, cw):
    """The reference's loss and per-leaf gradient in f64
    (``jax_enable_x64``): its train-mode ``logits_lowres`` and
    class-weighted CE on their f64 upsample."""
    def loss(params, stats, images, labels):
        z, _ = jnn.apply(jmodel, {"params": params, "stats": stats},
                         images, train=True, mutable=True,
                         method="logits_lowres")
        return JL.cross_entropy(jax_resize_bilinear(z, HW), labels,
                                num_classes=CLASSES,
                                class_weights=jnp.asarray(cw, jnp.float64))

    jax.config.update("jax_enable_x64", True)
    try:
        v = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a), jnp.float64), variables)
        value, grads = jax.jit(jax.value_and_grad(loss))(
            v["params"], v["stats"], jnp.asarray(img, jnp.float64),
            jnp.asarray(lab))
        return float(value), dict(_leaves(jax.tree_util.tree_map(
            np.asarray, grads)))
    finally:
        jax.config.update("jax_enable_x64", False)


def step_readings():
    """One adam + poly step of the port's CGNet-19 with class-weighted CE
    through ``logits_lowres`` from converted weights; the reference's own
    f32 step (its ``resize_cross_entropy``) and the f64 oracle. Returns
    the readings the test holds (call it from a scratch script to see
    them)."""
    jmodel = jax_build_model("cgnet", CLASSES)
    shapes = jax.eval_shape(
        lambda k: jmodel.init(k, jnp.zeros((1, *HW, 3), jnp.float32)),
        jax.random.PRNGKey(0))
    variables = _random_variables(shapes, np.random.RandomState(0))
    img, lab, cw = _batch(1)
    sched = JS.poly_schedule(LR, TOTAL)
    tx = JO.build_optimizer("adam", sched)
    jloss = partial(JL.resize_cross_entropy, num_classes=CLASSES,
                    class_weights=jnp.asarray(cw))
    jstep = jax_make_train_step(jmodel, jloss, tx, schedule=sched,
                                fwd_method="logits_lowres", donate=False)
    jnew, jm = jstep(TrainState.create(variables, tx),
                     {"image": jnp.asarray(img), "label": jnp.asarray(lab)},
                     jax.random.PRNGKey(0))

    def port():
        model = build_model("cgnet", CLASSES, device="cpu")
        model.load_state_dict(convert.to_state_dict(variables, model),
                              strict=True)
        return model
    model = port()
    fused, method = L.fused_resize_ce_spec(model, "ce")
    assert method == "logits_lowres"
    loss_fn = partial(fused, num_classes=CLASSES,
                      class_weights=torch.from_numpy(cw))
    step = make_train_step(model, loss_fn,
                           O.build_optimizer("adam", model.parameters()),
                           schedule=S.build_schedule("poly", LR, TOTAL),
                           fwd_method=method)
    timg = torch.from_numpy(img.transpose(0, 3, 1, 2).copy())
    tlab = torch.from_numpy(lab)
    metrics = step({"image": timg, "label": tlab})
    value, grads = _oracle(jmodel, variables, img, lab, cw)
    readings = {"loss": float(metrics["loss"]), "oracle_loss": value,
                "reference_loss": float(jm["loss"]),
                "lr": (metrics["lr"], float(jm["lr"]))}

    def grad_excess(model, rel):
        got = dict(_leaves(convert.params_tree(
            {n: p.grad for n, p in model.named_parameters()}, model)))
        assert set(got) == set(grads)
        return {"/".join(k): (float(np.linalg.norm(got[k] - g))
                              - rel * float(np.linalg.norm(g)) - ABS,
                              _rel(got[k], g)) for k, g in grads.items()}
    readings["f32"] = grad_excess(model, GRAD_F32)
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    ref_sd = convert.to_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": jnew.params, "stats": jnew.stats}), model)
    assert set(ref_sd) == set(sd)
    readings["stats"], readings["params"] = {}, {}
    for key, ref in ref_sd.items():
        d = np.abs(sd[key] - ref.numpy())
        if "running_" in key:
            readings["stats"][key] = float(np.max(d - STAT_TOL
                                                  * np.abs(ref.numpy())))
        else:
            readings["params"][key] = float(d.max())

    model = port().double().train()
    z = model.logits_lowres(timg.double())
    loss64 = loss_fn(z.permute(0, 2, 3, 1), tlab)
    loss64.backward()
    readings["loss64"] = float(loss64.detach())
    readings["f64"] = grad_excess(model, GRAD_F64)
    return readings


def test_train_step_matches_reference():
    """One adam + poly step of the whole CGNet-19 with class-weighted CE
    through ``logits_lowres``: the loss against the reference's f32 step
    and the f64 oracle (f32 and f64 runs of the port), per-leaf gradients
    (the FGlo gates' Dense layers too) against the oracle, params and BN
    running statistics against the reference's step."""
    r = step_readings()
    assert r["lr"][0] == pytest.approx(r["lr"][1], rel=1e-6)
    for key, ref in (("loss", "reference_loss"), ("loss", "oracle_loss"),
                     ("loss64", "oracle_loss")):
        assert abs(r[key] - r[ref]) <= LOSS_REL * abs(r[ref]), (
            key, ref, r[key], r[ref])
    for key in ("f32", "f64"):
        worst = max(r[key].items(), key=lambda kv: kv[1][0])
        assert worst[1][0] <= 0, (key, worst)
    assert max(r["stats"].values()) <= STAT_TOL, r["stats"]
    assert max(r["params"].values()) <= 2 * LR + 1e-7


def test_train_then_predict_take_their_kernels(monkeypatch):
    """The routes the card's launch counts confirm, seen here through the
    wrappers' calls: a weighted-CE train step calls ``resize_ce_sums`` once
    on the 1/8 logits and no ``fused_cgblock_pre`` (training runs the
    composed blocks); a predict step built before it and called after it
    puts the model in eval mode and calls ``fused_cgblock_pre`` 22 times
    (2 blocks at 1/4 with d = 2, 20 at 1/8 with d = 4) and
    ``resize_argmax`` once."""
    calls = []

    def spy(name):
        real = getattr(K, name)

        def wrapper(*args, **kw):
            scale = kw.get("d") or kw.get("r") or args[1]
            calls.append((name, tuple(args[0].shape), scale))
            return real(*args, **kw)
        monkeypatch.setattr(K, name, wrapper)
    for name in ("fused_dsconv", "resize_argmax", "resize_ce_sums",
                 "fused_cgblock_pre"):
        spy(name)
    model = build_model("cgnet", CLASSES, device="cpu")
    predict = make_predict_step(model)
    fused, method = L.fused_resize_ce_spec(model, "ce")
    step = make_train_step(model, partial(fused, num_classes=CLASSES),
                           O.build_optimizer("adam", model.parameters()),
                           fwd_method=method)
    img, lab, _ = _batch(2)
    timg = torch.from_numpy(img.transpose(0, 3, 1, 2).copy())
    step({"image": timg, "label": torch.from_numpy(lab)})
    h, w = HW
    assert calls == [("resize_ce_sums", (2, h // 8, w // 8, CLASSES), 8)]
    assert model.training
    calls.clear()
    predict(timg)
    assert not any(m.training for m in model.modules())
    assert calls == (
        [("fused_cgblock_pre", (2, h // 4, w // 4, 64), 2)] * 2
        + [("fused_cgblock_pre", (2, h // 8, w // 8, 128), 4)] * 20
        + [("resize_argmax", (2, h // 8, w // 8, CLASSES), 8)])
