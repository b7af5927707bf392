"""Shared helpers of the port-against-reference model tests of the last
six zoo models (``tests/test_torch_lednet_esnet.py``,
``tests/test_torch_fpenet.py``, ``tests/test_torch_fssnet_sqnet_unet.py``).

Weights are drawn with numpy into the reference's variables tree (its
structure from ``jax.eval_shape`` of the reference init), converted with
``esn_tpu_torch.convert`` (given the port's model, for its transposed
convs) and run through both packages on the same inputs. The reference
runs its plain paths (``PLAIN_ENV``): no lane folding, no group-major
FPE blocks, no space-to-depth, scan chains unrolled (their variables lay
out as a ``Sequential``'s, the port's plain ``nn.Sequential``); its
predict is its default, the fused subpixel or x2 head where the model has
one, as the port's. Its jitted functions stand in for eager calls (5-10x
quicker).
"""
import contextlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esn_tpu import nn as jnn
from esn_tpu.models import build_model as jax_build_model
from esn_tpu.ops import pooling as JP
from esn_tpu.ops.resize import resize_bilinear as jax_resize_bilinear
from esn_tpu.train import losses as JL
from esn_tpu.train.step import make_predict_step as jax_make_predict_step

from esn_tpu_torch import convert
from esn_tpu_torch.models import build_model
from esn_tpu_torch.nn import BatchNorm, Dropout
from esn_tpu_torch.train import losses as L
from esn_tpu_torch.train import optimizers as O
from esn_tpu_torch.train import schedules as S
from esn_tpu_torch.train.step import make_predict_step, make_train_step

CLASSES = 19
PLAIN_ENV = ("ESN_TPU_FOLD", "ESN_TPU_FPE_FOLDED", "ESN_TPU_FOLD_DW",
             "ESN_TPU_S2D_CONV", "ESN_TPU_S2D_STEM", "ESN_TPU_SCAN_CHAIN")
# One adam + poly step against the reference's math in f64 (the oracle):
# the loss within LOSS_REL (f32 and f64 runs of the port); per-leaf
# gradient rel-L2 of the port's model run in f64 (the loss stays f32)
# within GRAD_F64 plus ABS (a conv bias under a train-mode BN has gradient
# 0; its reading is noise); BN running statistics within STAT_TOL of the
# oracle's; each parameter moved by adam's first step, lr times the sign
# of its decayed gradient, within 2 lr of that step on the oracle's
# gradient and within lr/100 of it at all but SIGN_FLIPS of the elements.
# The f32 gradient's bound is each file's, beside its reading.
LR, TOTAL, WD = 4.5e-4, 100, 1e-4
LOSS_REL, GRAD_F64, ABS, STAT_TOL, SIGN_FLIPS = 1e-5, 1e-4, 3e-6, 1e-4, 1e-2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the file's tests, as in
    tests/test_torch_cli.py: the quick tier runs six workers on a few
    cores, and torch's OpenMP teams, one a worker, spin against each
    other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def plain_reference(monkeypatch):
    for name in PLAIN_ENV:
        monkeypatch.setenv(name, "0")


def random_variables(tree, rng):
    """numpy values for every leaf of a reference variables tree: kernels
    ~ N(0, 2/fan_in) (asymmetric under any flip or transpose), BN affines,
    running stats and PReLU slopes non-trivial."""
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
    return {coll: fill(tree.get(coll, {})) for coll in ("params", "stats")}


def leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def nhwc(x):
    return jnp.asarray(x.transpose(0, 2, 3, 1))


def nchw(y):
    return np.asarray(y).transpose(0, 3, 1, 2)


def init_shapes(module, *example):
    return jax.eval_shape(lambda k: module.init(k, *example),
                          jax.random.PRNGKey(0))


def reference_shapes(arch, hw, **kw):
    jmodel = jax_build_model(arch, CLASSES, **kw)
    return jmodel, init_shapes(jmodel, jnp.zeros((1, *hw, 3), jnp.float32))


def dropout_off(model):
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0


def reference_dropout_off(module, seen=None):
    """Set every dropout rate of a reference model to 0 (its modules are
    plain attribute holders)."""
    seen = set() if seen is None else seen
    if id(module) in seen:
        return
    seen.add(id(module))
    if isinstance(module, (jnn.Dropout, jnn.SpatialDropout)):
        module.rate = 0.0
    children = (module if isinstance(module, (list, tuple))
                else vars(module).values() if isinstance(module, jnn.Module)
                else ())
    for child in children:
        if isinstance(child, (jnn.Module, list, tuple)):
            reference_dropout_off(child, seen)


def _global_avg_pool_in_dtype(x, keepdims=True):
    return jnp.mean(x, axis=(1, 2), keepdims=keepdims)


def _dense_in_dtype(self, scope, x):
    w = scope.param("kernel", None, (self.in_features, self.out_features))
    y = jnp.dot(x, w.astype(x.dtype))
    if self.use_bias:
        y = y + scope.param("bias", None, (self.out_features,)).astype(
            y.dtype)
    return y


@contextlib.contextmanager
def x64(*patches):
    """``jax_enable_x64`` on, and the places where the reference rounds
    to f32 whatever its input taken off the f64 runs' path: its global
    average pool and its ``Dense`` (the SE gate) in x's dtype, as the
    port's run an f64 input; ``patches`` are more ``(owner, name, value)``
    swaps of a file's own."""
    swaps = [(JP, "global_avg_pool", _global_avg_pool_in_dtype),
             (jnn.Dense, "__call__", _dense_in_dtype), *patches]
    real = [getattr(owner, name) for owner, name, _ in swaps]
    jax.config.update("jax_enable_x64", True)
    for owner, name, value in swaps:
        setattr(owner, name, value)
    try:
        yield
    finally:
        for (owner, name, _), value in zip(swaps, real):
            setattr(owner, name, value)
        jax.config.update("jax_enable_x64", False)


def as_f64(variables):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a), jnp.float64), variables)


# --- blocks ------------------------------------------------------------------

def check_block(jblock, block, ch, train, hw=(12, 16), tol=1e-5, seed=4):
    """A block on converted weights against the reference's, eval or
    train mode: the output and, in train mode, the updated BN running
    statistics (atol = rtol = ``tol``)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(2, ch, *hw).astype(np.float32) * 2 + 0.3
    variables = random_variables(init_shapes(jblock, nhwc(x)), rng)
    block.load_state_dict(convert.to_state_dict(variables, block),
                          strict=True)
    want = jnn.apply(jblock, variables, nhwc(x), train=train, mutable=train)
    if train:
        want, new_vars = want
    block.train(train)
    with torch.no_grad():
        got = block(torch.from_numpy(x).contiguous(
            memory_format=torch.channels_last))
    assert got.shape == nchw(want).shape
    np.testing.assert_allclose(got.numpy(), nchw(want), atol=tol, rtol=tol)
    if train:
        stats = dict(leaves(convert.to_variables(block.state_dict(),
                                                 block)["stats"]))
        for path, ref in leaves(new_vars["stats"]):
            np.testing.assert_allclose(stats[path], np.asarray(ref),
                                       atol=tol, rtol=tol)


# --- models ------------------------------------------------------------------

def calibrated_pair(arch, shapes, hw, seed=0, **kw):
    """(numpy variables, port model with those weights); BN running stats
    from one momentum-1 train pass of the port over seeded images
    (dropout off), so eval-mode features vary."""
    variables = random_variables(shapes, np.random.RandomState(seed))
    model = build_model(arch, CLASSES, device="cpu", **kw)
    model.load_state_dict(convert.to_state_dict(variables, model),
                          strict=True)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    rates = {m: m.rate for m in model.modules() if isinstance(m, Dropout)}
    for bn in bns:
        bn.momentum = 1.0
    dropout_off(model)
    calib = np.random.RandomState(5).randn(2, 3, *hw).astype(np.float32)
    with torch.no_grad():
        model.train()(torch.from_numpy(calib))
    for bn in bns:
        bn.momentum = 0.1
    for drop, rate in rates.items():
        drop.rate = rate
    model.eval()
    return convert.to_variables(model.state_dict(), model), model


def round_trip(variables, model):
    """reference tree -> state_dict -> port model -> state_dict -> tree,
    bit for bit; returns the state_dict."""
    sd = convert.to_state_dict(variables, model)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    back = dict(leaves(convert.to_variables(model.state_dict(), model)))
    want = dict(leaves(variables))
    assert set(back) == set(want)
    for path, v in want.items():
        assert back[path].dtype == v.dtype
        np.testing.assert_array_equal(back[path], v, err_msg="/".join(path))
    return sd


def reference_logits(jmodel, variables, images, dtype, method=None,
                     patches=()):
    """The reference's jitted eval logits in ``dtype`` (f64 under
    ``x64(*patches)``), NHWC."""
    if dtype == np.float32:
        return np.asarray(jax.jit(partial(jnn.apply, jmodel, method=method))(
            variables, nhwc(images)))
    with x64(*patches):
        return np.asarray(jax.jit(partial(jnn.apply, jmodel, method=method))(
            as_f64(variables), jnp.asarray(images.transpose(0, 2, 3, 1),
                                           jnp.float64)))


def port_logits(model, images, dtype, method=None):
    m = model.to(getattr(torch, np.dtype(dtype).name))
    try:
        with torch.no_grad():
            out = m.run(torch.from_numpy(images.astype(dtype)), method)
        return out.permute(0, 2, 3, 1).numpy()
    finally:
        model.float()


def check_predict(jmodel, variables, model, images, tol):
    """The port's predict against the reference's (its default: the fused
    head where the model has one), f32: mismatch rate <= 1e-4, and only
    at near-ties, where the reference's f32 logits of the two classes lie
    within ``tol`` (relative to max(1, |logit|)) of each other."""
    want = np.asarray(jax_make_predict_step(jmodel)(variables, nhwc(images)))
    got = make_predict_step(model)(torch.from_numpy(images)).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape
    assert len(np.unique(want)) > 5
    diff = got != want
    assert diff.mean() <= 1e-4, diff.mean()
    if diff.any():
        logits = reference_logits(jmodel, variables, images, np.float32)[diff]
        a = np.take_along_axis(logits, got[diff][:, None], -1)
        b = np.take_along_axis(logits, want[diff][:, None], -1)
        assert np.all(np.abs(a - b) <= tol * np.maximum(1, np.abs(b)))


# --- one train step ----------------------------------------------------------

def batch(seed, hw):
    """Seeded smooth images and labels a network can fit, with a band of
    ignored rows; the reference's class weights of their histogram."""
    rng = np.random.RandomState(seed)
    h, w = hw

    def smooth(c, f):
        low = rng.randn(2, h // f, w // f, c).astype(np.float32)
        return np.asarray(jax.image.resize(low, (2, h, w, c), "linear"))

    img = smooth(3, 32) + 0.1 * rng.randn(2, h, w, 3).astype(np.float32)
    lab = np.argmax(smooth(CLASSES, 16), -1).astype(np.int32)
    lab[:, h // 2 - 4:h // 2 + 4] = 255
    hist = np.bincount(lab[lab != 255], minlength=CLASSES).astype(np.float64)
    cw = (1.0 / np.log(1.10 + hist / hist.sum())).astype(np.float32)
    return img.astype(np.float32), lab, cw


def rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def oracle(jmodel, variables, img, lab, cw, method, hw, patches=()):
    """The reference's loss, per-leaf gradient and updated BN statistics
    in f64: class-weighted CE on the full-resolution logits, or on the f64
    upsample of ``logits_lowres``."""
    def loss(params, stats, images, labels):
        out, new = jnn.apply(jmodel, {"params": params, "stats": stats},
                             images, train=True, mutable=True, method=method)
        if method is not None:
            out = jax_resize_bilinear(out, hw)
        return JL.cross_entropy(out, labels, num_classes=CLASSES,
                                class_weights=jnp.asarray(cw, jnp.float64)
                                ), new["stats"]

    with x64(*patches):
        v = as_f64(variables)
        (value, stats), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(v["params"], v["stats"],
                                 jnp.asarray(img, jnp.float64),
                                 jnp.asarray(lab))
        as_np = partial(jax.tree_util.tree_map, np.asarray)
        return float(value), dict(leaves(as_np(grads))), as_np(stats)


def step_readings(arch, hw, grad_f32, abs_f32=ABS, patches=(), seed=0,
                  **kw):
    """One adam + poly step of the port (class-weighted CE: through
    ``logits_lowres`` and the resize-CE kernel's plain version on a model
    that has it, on the full logits otherwise; dropout off) from converted
    weights, against the oracle. Returns the readings the tests hold (call
    it from a scratch script to see them): ``f32``/``f64`` map each leaf to
    (excess over its bound, rel-L2); the f32 bound is ``grad_f32`` times
    the oracle's norm plus ``abs_f32``."""
    jmodel = jax_build_model(arch, CLASSES, **kw)
    reference_dropout_off(jmodel)
    shapes = init_shapes(jmodel, jnp.zeros((1, *hw, 3), jnp.float32))
    variables = random_variables(shapes, np.random.RandomState(seed))
    img, lab, cw = batch(1, hw)

    def port():
        model = build_model(arch, CLASSES, device="cpu", **kw)
        dropout_off(model)
        model.load_state_dict(convert.to_state_dict(variables, model),
                              strict=True)
        return model
    model = port()
    fused, method = L.fused_resize_ce_spec(model, "ce")
    loss_fn = partial(fused or L.cross_entropy, num_classes=CLASSES,
                      class_weights=torch.from_numpy(cw))
    step = make_train_step(model, loss_fn,
                           O.build_optimizer("adam", model.parameters()),
                           schedule=S.build_schedule("poly", LR, TOTAL),
                           fwd_method=method)
    timg = torch.from_numpy(img.transpose(0, 3, 1, 2).copy())
    tlab = torch.from_numpy(lab)
    loss = float(step({"image": timg, "label": tlab})["loss"])
    value, grads, stats = oracle(jmodel, variables, img, lab, cw, method, hw,
                                 patches)
    readings = {"method": method, "loss": loss, "oracle_loss": value}

    def grad_excess(model, bound, abs_):
        got = dict(leaves(convert.params_tree(
            {n: p.grad for n, p in model.named_parameters()}, model)))
        assert set(got) == set(grads)
        return {"/".join(k): (float(np.linalg.norm(got[k] - g))
                              - bound * float(np.linalg.norm(g)) - abs_,
                              rel(got[k], g)) for k, g in grads.items()}
    readings["f32"] = grad_excess(model, grad_f32, abs_f32)
    after = dict(leaves(convert.to_variables(model.state_dict(), model)))
    before = dict(leaves(variables))
    readings["stats"] = {
        "/".join(k): float(np.max(np.abs(after[("stats",) + k] - v)
                                  - STAT_TOL * np.abs(v)))
        for k, v in leaves(stats)}
    flips, n = 0, 0
    readings["params"] = {}
    for k, g in grads.items():
        p0 = before[("params",) + k].astype(np.float64)
        gt = g + WD * p0
        d = np.abs(after[("params",) + k] - (p0 - LR * gt / (np.abs(gt)
                                                            + 1e-8)))
        readings["params"]["/".join(k)] = float(d.max())
        flips, n = flips + int((d > 1e-2 * LR).sum()), n + d.size
    readings["sign_flips"] = flips / n

    model = port().double().train()
    out = model.run(timg.double(), method)
    loss64 = loss_fn(out.permute(0, 2, 3, 1), tlab)
    loss64.backward()
    readings["loss64"] = float(loss64.detach())
    readings["f64"] = grad_excess(model, GRAD_F64, ABS)
    return readings


def check_step(r):
    """Hold ``step_readings``: the loss (f32 and f64 runs), per-leaf
    gradients, the BN statistics and the parameters after the step."""
    for key in ("loss", "loss64"):
        assert abs(r[key] - r["oracle_loss"]) <= LOSS_REL * abs(
            r["oracle_loss"]), (key, r[key], r["oracle_loss"])
    for key in ("f32", "f64"):
        worst = max(r[key].items(), key=lambda kv: kv[1][0])
        assert worst[1][0] <= 0, (key, worst)
    if r["stats"]:
        assert max(r["stats"].values()) <= STAT_TOL, r["stats"]
    assert max(r["params"].values()) <= 2 * LR + 1e-7
    assert r["sign_flips"] <= SIGN_FLIPS, r["sign_flips"]
