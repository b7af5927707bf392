"""The port's ContextNet, the bilinear downscale of its input and the
``ConvBNAct`` options it and the config-2/3 models pass, against the JAX
reference, on the CPU.

Weights are drawn with numpy into the reference's variables tree (its
structure from ``jax.eval_shape`` of the reference init), converted with
``esn_tpu_torch.convert`` and run through both packages: the same inputs,
f32, tolerances stated per test. The reference runs un-jitted on its
plain paths (``ESN_TPU_S2D_CONV=0`` turns off its W-folded stem, the
other switches its other layout paths); the port runs the plain versions
of its kernels (a CPU tensor never reaches a CUDA kernel).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esn_tpu import nn as jnn
from esn_tpu.models import blocks as JB
from esn_tpu.models import build_model as jax_build_model
from esn_tpu.ops.resize import resize_bilinear as jax_resize_bilinear
from esn_tpu.train import losses as JL
from esn_tpu.train import optimizers as JO
from esn_tpu.train import schedules as JS
from esn_tpu.train.state import TrainState
from esn_tpu.train.step import make_predict_step as jax_make_predict_step
from esn_tpu.train.step import make_train_step as jax_make_train_step

from esn_tpu_torch import convert
from esn_tpu_torch.models import available_models, build_model
from esn_tpu_torch.models import blocks as B
from esn_tpu_torch.nn import BatchNorm, Dropout
from esn_tpu_torch.ops import kernels as K
from esn_tpu_torch.ops.resize import resize_bilinear
from esn_tpu_torch.train import losses as L
from esn_tpu_torch.train import optimizers as O
from esn_tpu_torch.train import schedules as S
from esn_tpu_torch.train.step import make_predict_step, make_train_step
from esn_tpu_torch.utils import count_params

CLASSES = 19
HW = (128, 256)
N_PARAMS = 891_859
ATOL = RTOL = 1e-4        # f32 re-association (convs, BN, folded DSConvs)
LR, TOTAL = 4.5e-4, 100
# One adam step, f32 (tolerances as tests/test_torch_enet_train.py, for
# its reasons): loss 1e-5 relative against the reference's step and the
# f64 oracle; per-leaf gradient rel-L2 of the port's model run in f64 (BN
# moments and the loss stay f32) <= GRAD_F64 against the oracle (read:
# 1.8e-6, the median over the leaves), of the f32 step <= GRAD_F32 (read:
# 8.6e-3 at most), each plus 1e-6 absolute; params within 2*lr; BN
# statistics 1e-4.
LOSS_REL, GRAD_F64, GRAD_F32, ABS, STAT_TOL = 1e-5, 1e-4, 3e-2, 1e-6, 1e-4


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
    ~ N(0, 2/fan_in), BN affines, running stats and PReLU slopes
    non-trivial."""
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


def _shapes(jmodel, hw):
    return jax.eval_shape(
        lambda k: jmodel.init(k, jnp.zeros((1, *hw, 3), jnp.float32)),
        jax.random.PRNGKey(0))


def _dropout_off(model):
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0


# --- the input's bilinear downscale ----------------------------------------

@pytest.mark.parametrize("src, dst", [((128, 256), (32, 64)),
                                      ((37, 53), (9, 13)),
                                      ((64, 96), (24, 40)),
                                      ((16, 24), (128, 192))])
def test_resize_bilinear_matches_reference(src, dst):
    """Downscales (x4 as ContextNet's input, odd, non-integer) and an
    upscale, f32: the plain 2-tap half-pixel kernel on both sides (no
    antialias), |d| <= 1e-6. With antialias the x4 downscale lies ~1 off."""
    x = np.random.RandomState(0).randn(2, 3, *src).astype(np.float32)
    want = _nchw(jax_resize_bilinear(_nhwc(x), dst))
    got = resize_bilinear(torch.from_numpy(x), dst).numpy()
    assert got.shape == want.shape == (2, 3, *dst)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    if dst[0] < src[0] and src[0] % dst[0] == 0:
        wide = np.asarray(jax.image.resize(_nhwc(x), (2, *dst, 3), "bilinear"))
        assert np.abs(_nchw(wide) - want).max() > 0.3


# --- ConvBNAct's padding, dilation, bias and bn ------------------------------

CONV_BN_ACT = {
    # ContextNet's fusion depthwise: dilation 4, "same" padding 4
    "dilated_dw": (dict(in_ch=8, out_ch=8, kernel=3, groups=8, dilation=4,
                        act="none"), 8),
    # LinkNet's stem: 7x7 stride 2, padding 3 given
    "stem_7x7": (dict(in_ch=3, out_ch=8, kernel=7, stride=2, padding=3,
                      act="relu"), 3),
    "no_bn": (dict(in_ch=4, out_ch=6, kernel=3, bn=False, act="prelu"), 4),
    "bn_and_bias": (dict(in_ch=4, out_ch=6, kernel=1, bias=True,
                         act="relu6"), 4),
    "asymmetric": (dict(in_ch=4, out_ch=4, kernel=(3, 1),
                        dilation=(2, 1), act="prelu1", bn_eps=1e-3), 4),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind", sorted(CONV_BN_ACT))
def test_conv_bn_act_options_match_reference(kind, train):
    """Each option of ``ConvBNAct`` against the reference's block: its
    variables convert key for key, the output matches (atol = rtol =
    1e-5), in train mode the BN statistics too."""
    kw, ch = CONV_BN_ACT[kind]
    kw = dict(kw)
    args = (kw.pop("in_ch"), kw.pop("out_ch"), kw.pop("kernel"))
    jblock, block = JB.ConvBNAct(*args, **kw), B.ConvBNAct(*args, **kw)
    rng = np.random.RandomState(1)
    x = rng.randn(2, ch, 13, 18).astype(np.float32)
    variables = _random_variables(jax.eval_shape(
        lambda k: jblock.init(k, _nhwc(x)), jax.random.PRNGKey(0)), rng)
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
    if train and "bn" not in kw:
        stats = dict(_leaves(convert.to_variables(block.state_dict(),
                                                  block)["stats"]))
        for path, ref in _leaves(new_vars["stats"]):
            np.testing.assert_allclose(stats[path], ref, atol=1e-5,
                                       rtol=1e-5)


# --- ContextNet-19, full width and depth -----------------------------------

@pytest.fixture(scope="module")
def jax_model_and_shapes():
    jmodel = jax_build_model("contextnet", CLASSES)
    return jmodel, _shapes(jmodel, HW)


@pytest.fixture(scope="module")
def pair(jax_model_and_shapes):
    """(JAX model, numpy variables, port model with those weights); BN
    running stats from one momentum-1 train pass of the port over seeded
    images (dropout off), so eval-mode features vary."""
    jmodel, shapes = jax_model_and_shapes
    variables = _random_variables(shapes, np.random.RandomState(0))
    model = build_model("contextnet", CLASSES, device="cpu")
    model.load_state_dict(convert.to_state_dict(variables, model),
                          strict=True)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.momentum = 1.0
    model.drop.rate = 0.0
    calib = np.random.RandomState(5).randn(2, 3, *HW).astype(np.float32)
    with torch.no_grad():
        model.train()(torch.from_numpy(calib))
    for bn in bns:
        bn.momentum = 0.1
    model.drop.rate = 0.1
    model.eval()
    return jmodel, convert.to_variables(model.state_dict(), model), model


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(1).randn(2, 3, *HW).astype(np.float32)


def test_registry_and_param_count(jax_model_and_shapes):
    """``contextnet`` and its alias; the reference's parameter count,
    tail and dropout rate."""
    assert {"contextnet", "edanet", "erfnet", "segnet", "linknet"} \
        <= set(available_models())
    for name in ("ContextNet", "context_net"):
        model = build_model(name, CLASSES, device="cpu")
        assert type(model).__name__ == "ContextNet"
    assert model.LOGITS_TAIL == "resize" and model.drop.rate == 0.1
    params = jax_model_and_shapes[1]["params"]
    assert count_params(model) == N_PARAMS == sum(
        int(np.prod(v.shape)) for _, v in _leaves(params))


def test_convert_round_trip_is_bit_exact(jax_model_and_shapes):
    """reference tree -> state_dict -> port model -> state_dict -> tree;
    the keys are the reference's variable paths."""
    variables = _random_variables(jax_model_and_shapes[1],
                                  np.random.RandomState(7))
    model = build_model("contextnet", CLASSES, device="cpu")
    sd = convert.to_state_dict(variables, model)
    assert set(sd) == set(model.state_dict())
    for key in ("shallow.ds1.dw.conv.weight", "deep.stages.0.0.dw.bn.weight",
                "deep.stages.2.2.expand.conv.weight", "deep.tail.bn.running_var",
                "fusion.low_dw.conv.weight", "ds2.pw.bn.bias", "head.bias"):
        assert key in sd
    assert "deep.stages.0.0.expand.conv.weight" not in sd     # t = 1
    model.load_state_dict(sd, strict=True)
    back = dict(_leaves(convert.to_variables(model.state_dict(), model)))
    leaves = dict(_leaves(variables))
    assert set(back) == set(leaves)
    for path, want in leaves.items():
        assert back[path].dtype == want.dtype
        np.testing.assert_array_equal(back[path], want, err_msg="/".join(path))


@pytest.mark.parametrize("method", ["logits_lowres", "forward"])
def test_logits_match_reference(pair, images, method):
    """f32 logits of ContextNet-19 at 2x3x128x256 on converted, calibrated
    weights (eval: the five DSConvs fused): atol = rtol = 1e-4."""
    jmodel, variables, model = pair
    want = np.asarray(jnn.apply(jmodel, variables, _nhwc(images),
                                method=None if method == "forward" else method))
    with torch.no_grad():
        got = getattr(model, method)(torch.from_numpy(images))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert want.std() > 0.05      # the weights make non-trivial logits
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_predict_step_matches_reference(pair, images):
    """Mismatch rate <= 1e-4, and only at near-ties: where the class maps
    differ, the reference's f32 full-res logits of the two classes lie
    within 1e-4 (relative) of each other."""
    jmodel, variables, model = pair
    x = _nhwc(images)
    want = np.asarray(jax_make_predict_step(jmodel)(variables, x))
    got = make_predict_step(model)(torch.from_numpy(images)).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape == (2, *HW)
    assert len(np.unique(want)) > 5
    diff = got != want
    assert diff.mean() <= 1e-4, diff.mean()
    if diff.any():
        logits = np.asarray(jnn.apply(jmodel, variables, x))[diff]
        a = np.take_along_axis(logits, got[diff][:, None], -1)
        b = np.take_along_axis(logits, want[diff][:, None], -1)
        assert np.all(np.abs(a - b) <= 1e-4 * np.maximum(1, np.abs(b)))


def test_paths_take_the_kernels(pair, images, monkeypatch):
    """The routes the card's launch counts confirm, seen here through the
    wrappers' calls: an eval forward calls ``fused_dsconv`` five times
    (strides 2, 2, 1 in the shallow branch, 1, 1 in the classifier), a
    predict adds one ``resize_argmax`` of the 1/8 logits at r = 8, and a
    train step with CE calls ``resize_ce_sums`` once on ``logits_lowres``
    and no ``fused_dsconv`` (training runs the composed DSConv)."""
    _, _, model = pair
    calls = []

    def spy(name):
        real = getattr(K, name)

        def wrapper(*args, **kw):
            scale = kw.get("stride") or kw.get("r") or args[1]
            calls.append((name, tuple(args[0].shape), scale))
            return real(*args, **kw)
        monkeypatch.setattr(K, name, wrapper)
    for name in ("fused_dsconv", "resize_argmax", "resize_ce_sums"):
        spy(name)
    make_predict_step(model)(torch.from_numpy(images))
    h, w = HW
    assert calls == [
        ("fused_dsconv", (2, h // 2, w // 2, 32), 2),
        ("fused_dsconv", (2, h // 4, w // 4, 64), 2),
        ("fused_dsconv", (2, h // 8, w // 8, 128), 1),
        ("fused_dsconv", (2, h // 8, w // 8, 128), 1),
        ("fused_dsconv", (2, h // 8, w // 8, 128), 1),
        ("resize_argmax", (2, h // 8, w // 8, CLASSES), 8)]
    calls.clear()
    fused, method = L.fused_resize_ce_spec(model, "ce")
    assert method == "logits_lowres" and fused.func is L.resize_cross_entropy
    trained = build_model("contextnet", CLASSES, device="cpu")
    step = make_train_step(
        trained, partial(fused, num_classes=CLASSES),
        O.build_optimizer("adam", trained.parameters()), fwd_method=method,
        generator=torch.Generator().manual_seed(0))
    step({"image": torch.from_numpy(images),
          "label": torch.zeros((2, *HW), dtype=torch.int32)})
    assert calls == [("resize_ce_sums", (2, h // 8, w // 8, CLASSES), 8)]


# --- one train step: weighted CE through logits_lowres ---------------------

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
    in f64 (``jax_enable_x64``): its train-mode ``logits_lowres``, and
    class-weighted CE on their f64 upsample."""
    def loss(params, stats, images, labels):
        z, new = jnn.apply(jmodel, {"params": params, "stats": stats},
                           images, train=True, mutable=True,
                           method="logits_lowres")
        return JL.cross_entropy(jax_resize_bilinear(z, HW), labels,
                                num_classes=CLASSES,
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


def step_readings(arch="contextnet"):
    """One adam + poly step of the port with class-weighted CE through
    ``logits_lowres`` (the resize-CE kernel's plain version here), dropout
    off, from converted weights; the reference's own f32 step (its
    ``resize_cross_entropy``) and the f64 oracle. Returns the readings the
    test holds."""
    jmodel = jax_build_model(arch, CLASSES)
    jmodel.drop.rate = 0.0
    variables = _random_variables(_shapes(jmodel, HW),
                                  np.random.RandomState(0))
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
        model = build_model(arch, CLASSES, device="cpu")
        _dropout_off(model)
        model.load_state_dict(convert.to_state_dict(variables, model),
                              strict=True)
        return model
    model = port()
    fused, method = L.fused_resize_ce_spec(model, "ce")
    loss_fn = partial(fused, num_classes=CLASSES,
                      class_weights=torch.from_numpy(cw))
    step = make_train_step(model, loss_fn,
                           O.build_optimizer("adam", model.parameters()),
                           schedule=S.build_schedule("poly", LR, TOTAL),
                           fwd_method=method)
    timg = torch.from_numpy(img.transpose(0, 3, 1, 2).copy())
    tlab = torch.from_numpy(lab)
    metrics = step({"image": timg, "label": tlab})
    value, grads, _ = _oracle(jmodel, variables, img, lab, cw)
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
    # params and BN statistics against the reference's own f32 step
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
    """One adam + poly step with class-weighted CE through
    ``logits_lowres`` from converted weights: the loss against the
    reference's f32 step and the f64 oracle (f32 and f64 runs of the
    port), per-leaf gradients against the oracle, params and BN running
    statistics against the reference's step."""
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
