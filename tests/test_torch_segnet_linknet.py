"""The port's SegNet and LinkNet (staged config 2, CamVid's 11 classes)
and LinkNet's blocks against the JAX reference, on the CPU.

Weights are drawn with numpy into the reference's variables tree (its
structure from ``jax.eval_shape`` of the reference init), converted with
``esn_tpu_torch.convert`` (given the port's model: LinkNet has transposed
convs, among them a 2x2 stride-2 head) and run through both packages: the
same inputs, f32, tolerances stated per test. No kernel lies on either
path. SegNet's five index pools hand their window positions to the
unpools: on the CPU both packages break ties to the first position, so
the maps agree. Both models need H and W to be multiples of 32, in the
reference and here (CamVid's 360x480 runs at 352x480).
"""
import copy
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esn_tpu import nn as jnn
from esn_tpu.models import build_model as jax_build_model
from esn_tpu.models import linknet as JLk
from esn_tpu.train import losses as JL
from esn_tpu.train.step import make_predict_step as jax_make_predict_step

from esn_tpu_torch import convert
from esn_tpu_torch.models import build_model
from esn_tpu_torch.models import linknet as Lk
from esn_tpu_torch.nn import BatchNorm, Dropout
from esn_tpu_torch.train import losses as L
from esn_tpu_torch.train import optimizers as O
from esn_tpu_torch.train import schedules as S
from esn_tpu_torch.train.step import make_predict_step, make_train_step
from esn_tpu_torch.utils import count_params

CLASSES = 11
HW = (64, 96)
N_PARAMS = {"segnet": 29_478_411, "linknet": 11_534_603}
# Logits against the reference's: in f64 (both packages) atol = rtol =
# 1e-8 (read: 4.0e-13 SegNet, 4.8e-14 LinkNet); in f32 atol = rtol =
# LOGIT_TOL. LinkNet's f32 logits hold 1e-4 (read 5.7e-5). SegNet's 26
# convs of up to 4608 terms make its f32 logits ill-conditioned: the
# reference's own lie up to 2.0e-4 from its f64 logits, the port's 4.0e-4,
# and the two f32 runs 3.7e-4 from each other.
LOGIT_TOL = {"segnet": 5e-4, "linknet": 1e-4}
LR, TOTAL = 4.5e-4, 100
# One adam step, f32, against the reference's math in f64 (the oracle):
# the loss within 1e-5 relative; per-leaf gradient rel-L2 of the f32 step
# <= GRAD_F32 and of the port's model run in f64 (the loss stays f32) <=
# GRAD_F64, each plus 1e-6 absolute; the BN running statistics after the
# step within 1e-4 of the oracle's; each parameter moved by adam's first
# step, lr times the sign of its decayed gradient, within 2*lr of that
# step on the oracle's gradient (f32 gets small gradients' signs wrong),
# and within lr/100 of it at all but SIGN_FLIPS of the elements (read:
# 2.5e-3 SegNet, 6.9e-4 LinkNet). Readings of the gradients (largest
# per-leaf rel-L2): SegNet f32 7.6e-3, f64 1.6e-6; LinkNet f32 2.2e-4,
# f64 1.7e-6.
LOSS_REL, GRAD_F64, ABS, STAT_TOL = 1e-5, 1e-4, 1e-6, 1e-4
WD, SIGN_FLIPS = 1e-4, 1e-2
GRAD_F32 = {"segnet": 2e-2, "linknet": 2e-3}


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


# --- LinkNet's blocks -----------------------------------------------------------

BLOCKS = {
    "basic": (lambda: JLk.BasicBlock(8, 8), lambda: Lk.BasicBlock(8, 8), 8),
    "basic_down": (lambda: JLk.BasicBlock(8, 16, 2),
                   lambda: Lk.BasicBlock(8, 16, 2), 8),
    "decoder_up": (lambda: JLk.DecoderBlock(16, 8),
                   lambda: Lk.DecoderBlock(16, 8), 16),
    "decoder_flat": (lambda: JLk.DecoderBlock(16, 16, upsample=False),
                     lambda: Lk.DecoderBlock(16, 16, upsample=False), 16),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_matches_reference(kind, train):
    """Each block on converted weights (the decoder's 3x3 s2 op1
    transposed conv flipped by ``convert``), eval and train mode: the
    output and in train mode the updated BN running statistics (atol =
    rtol = 1e-5)."""
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

@pytest.fixture(scope="module", params=["segnet", "linknet"])
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
    images, so eval-mode features vary."""
    jmodel, shapes = reference
    variables = _random_variables(shapes, np.random.RandomState(0))
    model = build_model(arch, CLASSES, device="cpu")
    model.load_state_dict(convert.to_state_dict(variables, model),
                          strict=True)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.momentum = 1.0
    calib = np.random.RandomState(5).randn(2, 3, *HW).astype(np.float32)
    with torch.no_grad():
        model.train()(torch.from_numpy(calib))
    for bn in bns:
        bn.momentum = 0.1
    model.eval()
    return jmodel, convert.to_variables(model.state_dict(), model), model


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(1).randn(2, 3, *HW).astype(np.float32)


def test_registry_and_param_count(arch, reference):
    """Registered as in the reference; its parameter count; a conv tail,
    no dropout."""
    model = build_model(arch.upper(), CLASSES, device="cpu")
    params = reference[1]["params"]
    assert count_params(model) == N_PARAMS[arch] == sum(
        int(np.prod(v.shape)) for _, v in _leaves(params))
    assert model.LOGITS_TAIL == "conv"
    assert not any(isinstance(m, Dropout) for m in model.modules())


def test_convert_round_trip_is_bit_exact(arch, reference):
    """reference tree -> state_dict -> port model -> state_dict -> tree;
    the keys are the reference's variable paths; LinkNet's transposed
    convs' kernels (3x3 s2 op1 and the 2x2 head) flipped on the way in and
    back."""
    variables = _random_variables(reference[1], np.random.RandomState(7))
    model = build_model(arch, CLASSES, device="cpu")
    sd = convert.to_state_dict(variables, model)
    assert set(sd) == set(model.state_dict())
    keys = {"segnet": ("enc0.0.conv.weight", "enc4.2.bn.running_var",
                       "dec0.2.conv.weight", "dec4.1.bn.bias", "head.bias"),
            "linknet": ("stem.conv.weight", "enc1.0.down.conv.weight",
                        "enc3.1.c2.bn.weight", "dec0.up.weight",
                        "dec3.up.weight", "final_up.weight", "head.bias")}[arch]
    for key in keys:
        assert key in sd
    model.load_state_dict(sd, strict=True)
    if arch == "linknet":
        p = variables["params"]
        for name, k in (("head", p["head"]["kernel"]),
                        ("final_up", p["final_up"]["kernel"]),
                        ("dec1.up", p["dec1"]["up"]["kernel"])):
            np.testing.assert_array_equal(
                sd[name + ".weight"].numpy(),
                k[::-1, ::-1].transpose(2, 3, 0, 1))
        # dec3's 3x3 is a plain conv: the conv layout, no flip
        np.testing.assert_array_equal(
            sd["dec3.up.weight"].numpy(),
            p["dec3"]["up"]["kernel"].transpose(3, 2, 0, 1))
    back = dict(_leaves(convert.to_variables(model.state_dict(), model)))
    leaves = dict(_leaves(variables))
    assert set(back) == set(leaves)
    for path, want in leaves.items():
        assert back[path].dtype == want.dtype
        np.testing.assert_array_equal(back[path], want, err_msg="/".join(path))


def _reference_logits(jmodel, variables, images, dtype):
    """The reference's logits in ``dtype`` (f64 under ``jax_enable_x64``)."""
    if dtype == np.float32:
        return np.asarray(jnn.apply(jmodel, variables, _nhwc(images)))
    jax.config.update("jax_enable_x64", True)
    try:
        v = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a), jnp.float64), variables)
        return np.asarray(jnn.apply(jmodel, v, jnp.asarray(
            images.transpose(0, 2, 3, 1), jnp.float64)))
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_logits_match_reference(pair, images, dtype):
    """Logits at 2x3x64x96 on converted, calibrated weights: f32 within
    LOGIT_TOL, f64 (the first image) within 1e-8."""
    jmodel, variables, model = pair
    arch = type(model).__name__.lower()
    if dtype == np.float64:
        images = images[:1]           # f64 convs are slow on the CPU
    want = _reference_logits(jmodel, variables, images, dtype)
    m = copy.deepcopy(model).to(getattr(torch, np.dtype(dtype).name))
    with torch.no_grad():
        got = m(torch.from_numpy(images.astype(dtype)))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (len(images), *HW, CLASSES)
    assert want.std() > 0.05      # the weights make non-trivial logits
    tol = LOGIT_TOL[arch] if dtype == np.float32 else 1e-8
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def test_predict_step_matches_reference(pair, images):
    """The port's predict (LinkNet's fused subpixel head, SegNet's argmax
    of the full logits) against the reference's (the same), f32:
    mismatch rate <= 1e-4, and only at near-ties, where the reference's
    f32 logits of the two classes lie within twice LOGIT_TOL (relative)
    of each other."""
    jmodel, variables, model = pair
    x = _nhwc(images)
    want = np.asarray(jax_make_predict_step(jmodel)(variables, x))
    got = make_predict_step(model)(torch.from_numpy(images)).numpy()
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


def test_sides_not_multiples_of_32_fail_as_in_reference(arch, pair):
    """At 72x96 (72 is no multiple of 32) SegNet's unpool meets indices of
    another size and LinkNet's skip add tensors of other sizes, in the
    reference and in the port alike: the port adds no repair."""
    jmodel, variables, model = pair
    x = np.zeros((1, 3, 72, 96), np.float32)
    with pytest.raises((TypeError, ValueError)):
        jnn.apply(jmodel, variables, _nhwc(x))
    with pytest.raises(RuntimeError):
        with torch.no_grad():
            model(torch.from_numpy(x))


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


def _oracle(jmodel, variables, img, lab, cw):
    """The reference's loss, per-leaf gradient and updated BN statistics
    in f64 (``jax_enable_x64``): class-weighted CE on the logits."""
    def loss(params, stats, images, labels):
        out, new = jnn.apply(jmodel, {"params": params, "stats": stats},
                             images, train=True, mutable=True)
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
    """One adam + poly step of the port (class-weighted CE on the full
    logits) from converted weights, against the oracle. Returns the
    readings the test holds."""
    jmodel = jax_build_model(arch, CLASSES)
    shapes = _init_shapes(jmodel, jnp.zeros((1, *HW, 3), jnp.float32))
    variables = _random_variables(shapes, np.random.RandomState(0))
    img, lab, cw = _batch(1)

    def port():
        model = build_model(arch, CLASSES, device="cpu")
        model.load_state_dict(convert.to_state_dict(variables, model),
                              strict=True)
        return model
    model = port()
    assert L.fused_resize_ce_spec(model, "ce") == (None, None)
    loss_fn = partial(L.cross_entropy, num_classes=CLASSES,
                      class_weights=torch.from_numpy(cw))
    step = make_train_step(model, loss_fn,
                           O.build_optimizer("adam", model.parameters()),
                           schedule=S.build_schedule("poly", LR, TOTAL))
    timg = torch.from_numpy(img.transpose(0, 3, 1, 2).copy())
    tlab = torch.from_numpy(lab)
    loss = float(step({"image": timg, "label": tlab})["loss"])
    value, grads, stats = _oracle(jmodel, variables, img, lab, cw)
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
    out = model(timg.double())
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
