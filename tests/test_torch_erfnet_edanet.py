"""The port's ERFNet and EDANet (staged config 3) and their blocks against
the JAX reference, on the CPU.

Weights are drawn with numpy into the reference's variables tree (its
structure from ``jax.eval_shape`` of the reference init), converted with
``esn_tpu_torch.convert`` (given the port's model: ERFNet has transposed
convs) and run through both packages: the same inputs, f32, tolerances
stated per test. The reference runs on its plain paths: no lane folding
(``ESN_TPU_FOLD=0``), no space-to-depth stem, its scan chains unrolled
(their variables lay out as a ``Sequential``'s, the port's plain
``nn.Sequential``). ERFNet launches no kernel; EDANet's predict ends in
the fused upsample + argmax and its CE trains through ``logits_lowres``
(plain versions here: a CPU tensor never reaches a CUDA kernel).
"""
import copy
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esn_tpu import nn as jnn
from esn_tpu.models import blocks as JB
from esn_tpu.models import build_model as jax_build_model
from esn_tpu.models import edanet as JE
from esn_tpu.ops.resize import resize_bilinear as jax_resize_bilinear
from esn_tpu.train import losses as JL
from esn_tpu.train.step import make_predict_step as jax_make_predict_step

from esn_tpu_torch import convert
from esn_tpu_torch.models import build_model
from esn_tpu_torch.models import blocks as B
from esn_tpu_torch.models import edanet as E
from esn_tpu_torch.nn import BatchNorm, Dropout
from esn_tpu_torch.ops import kernels as K
from esn_tpu_torch.train import losses as L
from esn_tpu_torch.train import optimizers as O
from esn_tpu_torch.train import schedules as S
from esn_tpu_torch.train.step import make_predict_step, make_train_step
from esn_tpu_torch.utils import count_params

CLASSES = 19
HW = (64, 128)
N_PARAMS = {"erfnet": 2_064_191, "edanet": 688_445}
LR, TOTAL = 4.5e-4, 100
# Logits against the reference's: in f64 (both packages) atol = rtol =
# 1e-8 (read: 1.9e-12 ERFNet); in f32 atol = rtol = LOGIT_TOL. EDANet's
# f32 logits hold 1e-4. ERFNet's eval network at these weights amplifies
# rounding ~1e4-fold (its residual stacks): the reference's own f32 logits
# lie up to 1.1e-3 from its f64 logits, the port's 1.0e-3, and the two
# f32 runs 9.9e-4 from each other.
LOGIT_TOL = {"erfnet": 2e-3, "edanet": 1e-4}
# One adam step, f32, against the reference's math in f64 (the oracle):
# the loss within 1e-5 relative; per-leaf gradient rel-L2 of the f32 step
# <= GRAD_F32 and of the port's model run in f64 (the loss stays f32) <=
# GRAD_F64, each plus ABS; the BN running statistics after the step
# within 1e-4 of the oracle's; each parameter moved by adam's first step,
# lr times the sign of its decayed gradient, within 2*lr of that step on
# the oracle's gradient (f32 gets small gradients' signs wrong), and
# within lr/100 of it at all but SIGN_FLIPS of the elements (read: 6.3e-3
# ERFNet, 1.5e-5 EDANet). Readings of the gradients (largest per-leaf
# rel-L2 over the leaves whose gradient is not 0 in exact arithmetic):
# - ERFNet's f32 gradient is ill-conditioned at this size, as ENet's
#   (tests/test_torch_enet_train.py): 2.97e-2; in f64 4.3e-6 (median). A
#   conv bias feeding a train-mode BN has gradient 0; its f32 reading is
#   noise up to 1.5e-6 (ERFNet's stem), hence ABS.
# - EDANet's is well-conditioned: f32 1.0e-5, f64 4.2e-6 (median).
LOSS_REL, GRAD_F64, ABS, STAT_TOL = 1e-5, 1e-4, 3e-6, 1e-4
WD, SIGN_FLIPS = 1e-4, 1e-2
GRAD_F32 = {"erfnet": 6e-2, "edanet": 1e-4}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's tests, as in
    tests/test_torch_cli.py: the quick tier runs six workers on a few
    cores, and torch's OpenMP teams, one a worker, spin against each other
    (this file's f64 runs took 10x longer so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _plain_reference(monkeypatch):
    for name in ("ESN_TPU_S2D_CONV", "ESN_TPU_S2D_STEM", "ESN_TPU_FOLD",
                 "ESN_TPU_SCAN_CHAIN"):
        monkeypatch.setenv(name, "0")


def _random_variables(tree, rng):
    """numpy values for every leaf of a reference variables tree: kernels
    ~ N(0, 2/fan_in) (every one asymmetric under a spatial flip), BN
    affines and running stats non-trivial."""
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
            else:
                raise KeyError(name)
            out[name] = np.asarray(v, np.float32)
        return out
    return {coll: fill(tree.get(coll, {})) for coll in ("params", "stats")}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _nhwc(x):
    return jnp.asarray(x.transpose(0, 2, 3, 1))


def _nchw(y):
    return np.asarray(y).transpose(0, 3, 1, 2)


def _init_shapes(module, *example):
    return jax.eval_shape(lambda k: module.init(k, *example),
                          jax.random.PRNGKey(0))


def _dropout_off(model):
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0


def _reference_dropout_off(module, seen=None):
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
            _reference_dropout_off(child, seen)


# --- the blocks --------------------------------------------------------------

BLOCKS = {
    "downsampler_concat": (lambda: JB.DownsamplerConcat(3, 16),
                           lambda: B.DownsamplerConcat(3, 16), 3),
    "downsampler_plain": (lambda: JB.DownsamplerConcat(16, 8),
                          lambda: B.DownsamplerConcat(16, 8), 16),
    "non_bottleneck": (lambda: JB.NonBottleneck1d(8),
                       lambda: B.NonBottleneck1d(8), 8),
    "non_bottleneck_d4": (lambda: JB.NonBottleneck1d(8, dilation=4),
                          lambda: B.NonBottleneck1d(8, dilation=4), 8),
    "upsampler": (lambda: JB.UpsamplerBlock(8, 4),
                  lambda: B.UpsamplerBlock(8, 4), 8),
    "eda_down_concat": (lambda: JE.DownsamplingBlock(3, 15),
                        lambda: E.DownsamplingBlock(3, 15), 3),
    "eda_down_plain": (lambda: JE.DownsamplingBlock(20, 10),
                       lambda: E.DownsamplingBlock(20, 10), 20),
    "eda_module": (lambda: JE.EDAModule(12, 8, 2, dropout=0.0),
                   lambda: E.EDAModule(12, 8, 2, dropout=0.0), 12),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_matches_reference(kind, train):
    """Each block on converted weights (biased convs, BN eps 1e-3, the
    upsampler's transposed conv flipped by ``convert``), eval and train
    mode: the output and in train mode the updated BN running statistics
    (atol = rtol = 1e-5)."""
    make_j, make_t, ch = BLOCKS[kind]
    jblock, block = make_j(), make_t()
    rng = np.random.RandomState(4)
    x = rng.randn(2, ch, 12, 16).astype(np.float32) * 2 + 0.3
    variables = _random_variables(_init_shapes(jblock, _nhwc(x)), rng)
    block.load_state_dict(convert.to_state_dict(variables, block),
                          strict=True)
    want = jnn.apply(jblock, variables, _nhwc(x), train=train, mutable=train)
    if train:
        want, new_vars = want
    block.train(train)
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    assert got.shape == _nchw(want).shape
    np.testing.assert_allclose(got, _nchw(want), atol=1e-5, rtol=1e-5)
    if train:
        stats = dict(_leaves(convert.to_variables(block.state_dict(),
                                                  block)["stats"]))
        for path, ref in _leaves(new_vars["stats"]):
            np.testing.assert_allclose(stats[path], np.asarray(ref),
                                       atol=1e-5, rtol=1e-5)


# --- the two models, full width and depth ------------------------------------

@pytest.fixture(scope="module", params=["erfnet", "edanet"])
def arch(request):
    return request.param


@pytest.fixture(scope="module")
def reference(arch):
    jmodel = jax_build_model(arch, CLASSES)
    return jmodel, _init_shapes(jmodel, jnp.zeros((1, *HW, 3), jnp.float32))


@pytest.fixture(scope="module")
def pair(arch, reference):
    """(JAX model, numpy variables, port model with those weights); BN
    running stats from one momentum-1 train pass of the port over seeded
    images (dropout off), so eval-mode features vary."""
    jmodel, shapes = reference
    variables = _random_variables(shapes, np.random.RandomState(0))
    model = build_model(arch, CLASSES, device="cpu")
    model.load_state_dict(convert.to_state_dict(variables, model),
                          strict=True)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    rates = {m: m.rate for m in model.modules() if isinstance(m, Dropout)}
    for bn in bns:
        bn.momentum = 1.0
    _dropout_off(model)
    calib = np.random.RandomState(5).randn(2, 3, *HW).astype(np.float32)
    with torch.no_grad():
        model.train()(torch.from_numpy(calib))
    for bn in bns:
        bn.momentum = 0.1
    for drop, rate in rates.items():
        drop.rate = rate
    model.eval()
    return jmodel, convert.to_variables(model.state_dict(), model), model


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(1).randn(2, 3, *HW).astype(np.float32)


def test_registry_and_param_count(arch, reference):
    """Registered as in the reference; its parameter count, tail and
    dropout rates (ERFNet's two from its constructor)."""
    model = build_model(arch.upper(), CLASSES, device="cpu")
    params = reference[1]["params"]
    assert count_params(model) == N_PARAMS[arch] == sum(
        int(np.prod(v.shape)) for _, v in _leaves(params))
    rates = sorted({m.rate for m in model.modules() if isinstance(m, Dropout)})
    if arch == "erfnet":
        assert model.LOGITS_TAIL == "conv" and rates == [0.0, 0.03, 0.3]
        quiet = build_model(arch, CLASSES, device="cpu", dropout_1=0.0,
                            dropout_2=0.0)
        assert {m.rate for m in quiet.modules()
                if isinstance(m, Dropout)} == {0.0}
    else:
        assert model.LOGITS_TAIL == "resize" and rates == [0.02]


def test_convert_round_trip_is_bit_exact(arch, reference):
    """reference tree -> state_dict -> port model -> state_dict -> tree;
    the keys are the reference's variable paths (ERFNet's scan chains as
    Sequentials); the transposed convs' kernels flipped on the way in and
    back."""
    variables = _random_variables(reference[1], np.random.RandomState(7))
    model = build_model(arch, CLASSES, device="cpu")
    sd = convert.to_state_dict(variables, model)
    assert set(sd) == set(model.state_dict())
    keys = {"erfnet": ("encoder.0.conv.bias", "encoder.2.4.p2b.weight",
                       "encoder.4.1.3.p2a.weight", "encoder.3.post.bn.weight",
                       "decoder.3.deconv.weight", "head.weight", "head.bias"),
            "edanet": ("down1.conv.bias", "block1.4.b2.weight",
                       "block2.7.bn2.running_var", "down3.conv.weight",
                       "head.bias")}[arch]
    for key in keys:
        assert key in sd
    model.load_state_dict(sd, strict=True)
    if arch == "erfnet":
        p = variables["params"]
        for name, k in (("head", p["head"]["kernel"]),
                        ("decoder.0.deconv",
                         p["decoder"]["0"]["deconv"]["kernel"])):
            np.testing.assert_array_equal(
                sd[name + ".weight"].numpy(),
                k[::-1, ::-1].transpose(2, 3, 0, 1))
    back = dict(_leaves(convert.to_variables(model.state_dict(), model)))
    leaves = dict(_leaves(variables))
    assert set(back) == set(leaves)
    for path, want in leaves.items():
        assert back[path].dtype == want.dtype
        np.testing.assert_array_equal(back[path], want, err_msg="/".join(path))


def _reference_logits(jmodel, variables, images, dtype, method=None):
    """The reference's logits in ``dtype`` (f64 under ``jax_enable_x64``)."""
    if dtype == np.float32:
        return np.asarray(jnn.apply(jmodel, variables, _nhwc(images),
                                    method=method))
    jax.config.update("jax_enable_x64", True)
    try:
        v = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a), jnp.float64), variables)
        return np.asarray(jnn.apply(jmodel, v, jnp.asarray(
            images.transpose(0, 2, 3, 1), jnp.float64), method=method))
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_logits_match_reference(pair, images, dtype):
    """Logits at 2x3x64x128 on converted, calibrated weights (EDANet's 1/8
    logits too): f32 within LOGIT_TOL, f64 within 1e-8 (EDANet's 1/8
    logits only: both packages upsample in f32)."""
    jmodel, variables, model = pair
    tol = LOGIT_TOL[type(model).__name__.lower()] if dtype == np.float32 \
        else 1e-8
    m = copy.deepcopy(model).to(getattr(torch, np.dtype(dtype).name))
    methods = [None] if model.LOGITS_TAIL == "conv" else (
        ["logits_lowres"] if dtype == np.float64 else [None, "logits_lowres"])
    for method in methods:
        want = _reference_logits(jmodel, variables, images, dtype, method)
        with torch.no_grad():
            got = m.run(torch.from_numpy(images.astype(dtype)), method)
        got = got.permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape
        assert want.std() > 0.05      # the weights make non-trivial logits
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def test_predict_step_matches_reference(pair, images, monkeypatch):
    """The port's predict (ERFNet: the fused subpixel head; EDANet: the
    fused upsample + argmax, one ``resize_argmax`` call at r = 8) against
    the reference's (ERFNet's fused subpixel head), f32: mismatch rate <=
    1e-4, and only at near-ties, where the reference's f32 logits of the
    two classes lie within twice LOGIT_TOL (relative) of each other."""
    jmodel, variables, model = pair
    calls = []
    real = K.resize_argmax
    monkeypatch.setattr(K, "resize_argmax", lambda y, r: calls.append(
        (tuple(y.shape), r)) or real(y, r))
    x = _nhwc(images)
    want = np.asarray(jax_make_predict_step(jmodel)(variables, x))
    got = make_predict_step(model)(torch.from_numpy(images)).numpy()
    h, w = HW
    assert calls == ([((2, h // 8, w // 8, CLASSES), 8)]
                     if model.LOGITS_TAIL == "resize" else [])
    assert got.dtype == np.int32 and got.shape == want.shape == (2, *HW)
    assert len(np.unique(want)) > 5
    diff = got != want
    assert diff.mean() <= 1e-4, diff.mean()
    if diff.any():
        gap = 2 * LOGIT_TOL[type(model).__name__.lower()]
        logits = np.asarray(jnn.apply(jmodel, variables, x))[diff]
        a = np.take_along_axis(logits, got[diff][:, None], -1)
        b = np.take_along_axis(logits, want[diff][:, None], -1)
        assert np.all(np.abs(a - b) <= gap * np.maximum(1, np.abs(b)))


# --- one train step ------------------------------------------------------------

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


def _oracle(jmodel, variables, img, lab, cw, method):
    """The reference's loss, per-leaf gradient and updated BN statistics
    in f64 (``jax_enable_x64``): class-weighted CE on the full-resolution
    logits, or on the f64 upsample of ``logits_lowres``."""
    def loss(params, stats, images, labels):
        out, new = jnn.apply(jmodel, {"params": params, "stats": stats},
                             images, train=True, mutable=True, method=method)
        if method is not None:
            out = jax_resize_bilinear(out, HW)
        return JL.cross_entropy(out, labels, num_classes=CLASSES,
                                class_weights=jnp.asarray(cw, jnp.float64)
                                ), new["stats"]

    jax.config.update("jax_enable_x64", True)
    try:
        v = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a), jnp.float64), variables)
        (value, stats), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(v["params"], v["stats"],
                                 jnp.asarray(img, jnp.float64),
                                 jnp.asarray(lab))
        as_np = partial(jax.tree_util.tree_map, np.asarray)
        return float(value), dict(_leaves(as_np(grads))), as_np(stats)
    finally:
        jax.config.update("jax_enable_x64", False)


def step_readings(arch):
    """One adam + poly step of the port (class-weighted CE: EDANet through
    ``logits_lowres`` and the resize-CE kernel's plain version, ERFNet on
    its full logits; dropout off) from converted weights, against the
    oracle. Returns the readings the test holds."""
    jmodel = jax_build_model(arch, CLASSES)
    _reference_dropout_off(jmodel)
    shapes = _init_shapes(jmodel, jnp.zeros((1, *HW, 3), jnp.float32))
    variables = _random_variables(shapes, np.random.RandomState(0))
    img, lab, cw = _batch(1)

    def port():
        model = build_model(arch, CLASSES, device="cpu")
        _dropout_off(model)
        model.load_state_dict(convert.to_state_dict(variables, model),
                              strict=True)
        return model
    model = port()
    fused, method = L.fused_resize_ce_spec(model, "ce")
    assert method == ("logits_lowres" if arch == "edanet" else None)
    loss_fn = partial(fused or L.cross_entropy, num_classes=CLASSES,
                      class_weights=torch.from_numpy(cw))
    step = make_train_step(model, loss_fn,
                           O.build_optimizer("adam", model.parameters()),
                           schedule=S.build_schedule("poly", LR, TOTAL),
                           fwd_method=method)
    timg = torch.from_numpy(img.transpose(0, 3, 1, 2).copy())
    tlab = torch.from_numpy(lab)
    loss = float(step({"image": timg, "label": tlab})["loss"])
    value, grads, stats = _oracle(jmodel, variables, img, lab, cw, method)
    readings = {"loss": loss, "oracle_loss": value}

    def grad_excess(model, rel):
        got = dict(_leaves(convert.params_tree(
            {n: p.grad for n, p in model.named_parameters()}, model)))
        assert set(got) == set(grads)
        return {"/".join(k): (float(np.linalg.norm(got[k] - g))
                              - rel * float(np.linalg.norm(g)) - ABS,
                              _rel(got[k], g)) for k, g in grads.items()}
    readings["f32"] = grad_excess(model, GRAD_F32[arch])
    after = dict(_leaves(convert.to_variables(model.state_dict(), model)))
    before = dict(_leaves(variables))
    readings["stats"] = {
        "/".join(k): float(np.max(np.abs(after[("stats",) + k] - v)
                                  - STAT_TOL * np.abs(v)))
        for k, v in _leaves(stats)}
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
    readings["f64"] = grad_excess(model, GRAD_F64)
    return readings


def test_train_step_matches_reference(arch):
    """One adam + poly step on converted weights against the reference's
    math in f64: the loss (f32 and f64 runs), per-leaf gradients, the BN
    statistics and the parameters after the step."""
    r = step_readings(arch)
    for key in ("loss", "loss64"):
        assert abs(r[key] - r["oracle_loss"]) <= LOSS_REL * abs(
            r["oracle_loss"]), (key, r[key], r["oracle_loss"])
    for key in ("f32", "f64"):
        worst = max(r[key].items(), key=lambda kv: kv[1][0])
        assert worst[1][0] <= 0, (key, worst)
    assert max(r["stats"].values()) <= STAT_TOL, r["stats"]
    assert max(r["params"].values()) <= 2 * LR + 1e-7
    assert r["sign_flips"] <= SIGN_FLIPS, r["sign_flips"]
