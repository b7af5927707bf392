"""The port's ESPNet-C and ESPNet, their ESP module and ``load_encoder``
against the JAX reference, on the CPU.

Weights are drawn with numpy into the reference's variables tree (its
structure from ``jax.eval_shape`` of the reference init), converted with
``esn_tpu_torch.convert`` (given the port's model: ESPNet's decoder has
transposed convs) and run through both packages: the same inputs,
tolerances stated per test. The reference's scan chains run unrolled
(their variables lay out as a ``Sequential``'s). Its default re-associates
the ESP module's fusion into dense kernels (``ESN_TPU_ESP_FUSED_HFF``);
the port runs the plain fusion, held strictly against the reference's
plain path (``ESN_TPU_ESP_FUSED_HFF=0``) and within f32 rounding against
its default. ESPNet-C's predict ends in the fused upsample + argmax and
its CE trains through ``logits_lowres`` (plain versions here: a CPU tensor
never reaches a CUDA kernel); ESPNet reaches no kernel.
"""
import contextlib
import copy
from functools import partial

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esn_tpu import nn as jnn
from esn_tpu.models import build_model as jax_build_model
from esn_tpu.models import espnet as JE
from esn_tpu.ops import pooling as JP
from esn_tpu.ops.resize import resize_bilinear as jax_resize_bilinear
from esn_tpu.train import checkpoint as jax_ckpt
from esn_tpu.train import losses as JL
from esn_tpu.train import optimizers as JO
from esn_tpu.train import schedules as JS
from esn_tpu.train.state import TrainState as JaxTrainState
from esn_tpu.train.step import make_predict_step as jax_make_predict_step
from esn_tpu.train.step import make_train_step as jax_make_train_step

from esn_tpu_torch import convert
from esn_tpu_torch.models import available_models, build_model
from esn_tpu_torch.models import espnet as E
from esn_tpu_torch.nn import BatchNorm
from esn_tpu_torch.ops import kernels as K
from esn_tpu_torch.train import checkpoint as ckpt
from esn_tpu_torch.train import losses as L
from esn_tpu_torch.train import optimizers as O
from esn_tpu_torch.train import schedules as S
from esn_tpu_torch.train.state import TrainState
from esn_tpu_torch.train.step import make_predict_step, make_train_step
from esn_tpu_torch.utils import count_params

CLASSES = 19
HW = (64, 128)
N_PARAMS = {"espnet_c": 349_193, "espnet": 368_079}
# Logits against the reference's plain path, f32: atol = rtol = LOGIT_TOL
# (read, the largest difference relative to max(1, |logit|): the port's
# 1/8 logits of ESPNet-C lie 1.2e-5 from the reference's, ESPNet's full
# logits 4.8e-6; the reference's own f32 logits lie 7.9e-6 and 4.3e-6 from
# its f64 ones: well-conditioned); against the reference's default (fused)
# path within FUSED_TOL (read: the same as against its plain path, whose
# result the fused kernels give bit for bit on the CPU: they add the
# branch terms in the plain fusion's order, and their zero blocks add
# exact zeros); f64 atol = rtol = 1e-8 (read: 1.8e-14 and 7.0e-15).
LOGIT_TOL, FUSED_TOL = 1e-4, 1e-4
# One adam step (tolerances as tests/test_torch_contextnet.py): the loss
# within 1e-5 relative of the reference's f32 step (its default, fused
# path) and of the f64 oracle; per-leaf gradient rel-L2 of the f32 step
# <= GRAD_F32 and of the port's model run in f64 (the loss, and the
# reference's BN moments, stay f32) <= GRAD_F64, each plus ABS; the
# parameters within 2 lr and the BN statistics within STAT_TOL (relative,
# plus as much absolute) of the reference's step. Read, the worst leaf:
# ESPNet-C f32 9.6e-6, f64 4.4e-6, statistics 1.7e-8; ESPNet f64 4.3e-6,
# statistics 8.8e-9, and its f32 gradient is ill-conditioned at this
# size: 2.2e-2 (enc/level3/0/d4/kernel), where the reference's own f32
# step lies 2.2e-2 from the oracle too.
GRAD_F32 = {"espnet_c": 1e-3, "espnet": 5e-2}
LOSS_REL, GRAD_F64, ABS, STAT_TOL = 1e-5, 1e-4, 1e-6, 1e-4
LR, TOTAL = 4.5e-4, 100


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
    for name in ("ESN_TPU_SCAN_CHAIN", "ESN_TPU_ESP_FOLD_REDUCE",
                 "ESN_TPU_ESPNET_PIECES", "ESN_TPU_FUSED_PREDICT"):
        monkeypatch.setenv(name, "0")
    monkeypatch.delenv("ESN_TPU_ESP_FUSED_HFF", raising=False)


def _random_variables(tree, rng):
    """numpy values for every leaf of a reference variables tree: kernels
    ~ N(0, 2/fan_in) (asymmetric under any flip), BN affines, running stats
    and PReLU slopes non-trivial."""
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


def _init_shapes(module, *example):
    return jax.eval_shape(lambda k: module.init(k, *example),
                          jax.random.PRNGKey(0))


def _avg_pool2d_in_dtype(x, window, stride=None, padding=0,
                         count_include_pad=True):
    """The reference's average pool with its sums in x's dtype (it takes
    them in f32 whatever the input): what the f64 runs below stand on."""
    assert count_include_pad
    (kh, kw), (ph, pw) = JP._pair(window), JP._pair(padding)
    sh, sw = JP._pair(stride if stride is not None else window)
    return jax.lax.reduce_window(
        x, 0.0, jax.lax.add, (1, kh, kw, 1), (1, sh, sw, 1),
        ((0, 0), (ph, ph), (pw, pw), (0, 0))) / (kh * kw)


def _conv_of_concat(self, scope, pieces):
    """The reference's conv over a virtual concat as the conv of the
    concat (the same function; its own sums the pieces' terms in f32)."""
    return self(scope, jnp.concatenate(pieces, axis=-1))


@contextlib.contextmanager
def _x64():
    """``jax_enable_x64`` on, and the two places where the reference
    rounds to f32 whatever its input taken off the f64 runs' path: its
    average pools (the raw-input injections) sum in x's dtype, as the
    port's do, and the down modules' reduce convs over virtual concats are
    convs of the concat."""
    real = JP.avg_pool2d, jnn.Conv.pieces_apply
    jax.config.update("jax_enable_x64", True)
    JP.avg_pool2d, jnn.Conv.pieces_apply = (_avg_pool2d_in_dtype,
                                            _conv_of_concat)
    try:
        yield
    finally:
        JP.avg_pool2d, jnn.Conv.pieces_apply = real
        jax.config.update("jax_enable_x64", False)


# --- the ESP module --------------------------------------------------------

MODULES = {
    # k = 5: d = 2, the first branch takes the remainder (4); residual
    "esp": (dict(in_ch=12, out_ch=12), 12),
    # the 3x3 s2 reduce, at an odd extent; no residual
    "esp_s2": (dict(in_ch=7, out_ch=12, stride=2, residual=False), 7),
    # ESPNet's mix2: k = 4 without residual
    "esp_k4": (dict(in_ch=10, out_ch=10, k=4, residual=False), 10),
}


@pytest.mark.parametrize("hff", ["0", "1"], ids=["plain", "fused"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind", sorted(MODULES))
def test_esp_module_matches_reference(kind, train, hff, monkeypatch):
    """The ESP module on converted weights at 13x15, eval and train: the
    output and in train mode the updated BN statistics, against the
    reference's plain fusion (atol = rtol = 1e-5) and its fused dense
    kernels (``ESN_TPU_ESP_FUSED_HFF=1``, f32 re-association: 1e-4)."""
    monkeypatch.setenv("ESN_TPU_ESP_FUSED_HFF", hff)
    kw, ch = MODULES[kind]
    jblock, block = JE.ESPModule(**kw), E.ESPModule(**kw)
    rng = np.random.RandomState(4)
    x = rng.randn(2, ch, 13, 15).astype(np.float32) * 2 + 0.3
    variables = _random_variables(_init_shapes(jblock, _nhwc(x)), rng)
    block.load_state_dict(convert.to_state_dict(variables, block),
                          strict=True)
    want = jnn.apply(jblock, variables, _nhwc(x), train=train, mutable=train)
    if train:
        want, new_vars = want
    block.train(train)
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    tol = 1e-5 if hff == "0" else 1e-4
    assert got.shape == _nchw(want).shape
    np.testing.assert_allclose(got, _nchw(want), atol=tol, rtol=tol)
    if train:
        stats = dict(_leaves(convert.to_variables(block.state_dict(),
                                                  block)["stats"]))
        for path, ref in _leaves(new_vars["stats"]):
            np.testing.assert_allclose(stats[path], np.asarray(ref),
                                       atol=tol, rtol=tol)


# --- the two models, full width and depth ------------------------------------

@pytest.fixture(scope="module", params=["espnet_c", "espnet"])
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
    """Registered under the reference's names; its parameter count (no
    classifier in ESPNet's encoder) and tail."""
    assert arch in available_models()
    if arch == "espnet_c":
        assert type(build_model("ESPNetC", 3, device="cpu")) is E.ESPNetC
    model = build_model(arch, CLASSES, device="cpu")
    params = reference[1]["params"]
    assert count_params(model) == N_PARAMS[arch] == sum(
        int(np.prod(v.shape)) for _, v in _leaves(params))
    assert model.LOGITS_TAIL == {"espnet_c": "resize",
                                 "espnet": "conv"}[arch]


def test_convert_round_trip_is_bit_exact(arch, reference):
    """reference tree -> state_dict -> port model -> state_dict -> tree;
    the keys are the reference's variable paths (scan chains as
    Sequentials, ESPNet's encoder under ``enc``), the transposed convs'
    kernels flipped on the way in and back."""
    variables = _random_variables(reference[1], np.random.RandomState(7))
    model = build_model(arch, CLASSES, device="cpu")
    sd = convert.to_state_dict(variables, model)
    assert set(sd) == set(model.state_dict())
    pre = "enc." if arch == "espnet" else ""
    for key in ("down1.reduce.weight", "level2.1.d4.weight",
                "level3.7.post.bn.running_var", "b2.act.weight"):
        assert pre + key in sd
    if arch == "espnet":
        assert "enc.head.weight" not in sd
        for name in ("up1", "up3"):
            np.testing.assert_array_equal(
                sd[name + ".weight"].numpy(),
                variables["params"][name]["kernel"][::-1, ::-1]
                .transpose(2, 3, 0, 1))
    model.load_state_dict(sd, strict=True)
    back = dict(_leaves(convert.to_variables(model.state_dict(), model)))
    leaves = dict(_leaves(variables))
    assert set(back) == set(leaves)
    for path, want in leaves.items():
        assert back[path].dtype == want.dtype
        np.testing.assert_array_equal(back[path], want, err_msg="/".join(path))


def _method(model):
    return "logits_lowres" if model.LOGITS_TAIL == "resize" else None


def _reference_logits(jmodel, variables, images, dtype, method=None):
    """The reference's logits in ``dtype`` (f64 under ``jax_enable_x64``)."""
    apply = jax.jit(partial(jnn.apply, jmodel, method=method))
    if dtype == np.float32:
        return np.asarray(apply(variables, _nhwc(images)))
    with _x64():
        v = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a), jnp.float64), variables)
        return np.asarray(apply(v, jnp.asarray(images.transpose(0, 2, 3, 1),
                                               jnp.float64)))


@pytest.mark.parametrize("dtype, hff", [(np.float32, "0"), (np.float32, "1"),
                                        (np.float64, "0")],
                         ids=["f32-plain", "f32-fused", "f64-plain"])
def test_logits_match_reference(pair, images, dtype, hff, monkeypatch):
    """Logits at 2x3x64x128 on converted, calibrated weights (ESPNet-C's 1/8
    logits, ESPNet's full ones): f32 against the reference's plain fusion
    within LOGIT_TOL and its fused default within FUSED_TOL, f64 against
    its plain fusion within 1e-8."""
    monkeypatch.setenv("ESN_TPU_ESP_FUSED_HFF", hff)
    jmodel, variables, model = pair
    tol = 1e-8 if dtype == np.float64 else (LOGIT_TOL if hff == "0"
                                             else FUSED_TOL)
    m = copy.deepcopy(model).to(getattr(torch, np.dtype(dtype).name))
    want = _reference_logits(jmodel, variables, images, dtype, _method(model))
    with torch.no_grad():
        got = m.run(torch.from_numpy(images.astype(dtype)), _method(model))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert want.std() > 0.05      # the weights make non-trivial logits
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def test_predict_step_matches_reference(pair, images):
    """The port's predict (ESPNet-C: the fused upsample + argmax; ESPNet:
    the fused subpixel head on ``up1``) against the reference's default
    (ESPNet's subpixel head, ``ESN_TPU_FUSED_PREDICT=1``), f32: mismatch
    rate <= 1e-4, and only at near-ties, where the reference's f32 logits
    of the two classes lie within twice FUSED_TOL (relative) of each
    other."""
    jmodel, variables, model = pair
    x = _nhwc(images)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ESN_TPU_FUSED_PREDICT", "1")
        want = np.asarray(jax_make_predict_step(jmodel)(variables, x))
    got = make_predict_step(model)(torch.from_numpy(images)).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape == (2, *HW)
    assert len(np.unique(want)) > 5
    diff = got != want
    assert diff.mean() <= 1e-4, diff.mean()
    if diff.any():
        logits = np.asarray(jax.jit(partial(jnn.apply, jmodel))(
            variables, x))[diff]
        a = np.take_along_axis(logits, got[diff][:, None], -1)
        b = np.take_along_axis(logits, want[diff][:, None], -1)
        assert np.all(np.abs(a - b) <= 2 * FUSED_TOL * np.maximum(1, np.abs(b)))


def test_paths_take_the_kernels(arch, images, monkeypatch):
    """The routes the card's launch counts confirm, seen here through the
    wrappers' calls: ESPNet-C's predict calls ``resize_argmax`` once on the
    1/8 logits at r = 8 and its weighted-CE step ``resize_ce_sums`` once
    on ``logits_lowres``; ESPNet's predict calls ``subpixel_argmax`` once
    on the 1/2-resolution features under ``up1`` (stride 2), its CE step
    no kernel."""
    calls = []

    def spy(name):
        real = getattr(K, name)

        def wrapper(*args, **kw):
            calls.append((name, tuple(args[0].shape),
                          kw.get("r") or kw.get("stride") or args[1]))
            return real(*args, **kw)
        monkeypatch.setattr(K, name, wrapper)
    for name in ("fused_dsconv", "resize_argmax", "resize_ce_sums",
                 "fused_cgblock_pre", "subpixel_argmax"):
        spy(name)
    model = build_model(arch, CLASSES, device="cpu")
    make_predict_step(model)(torch.from_numpy(images))
    h, w = HW
    low = (2, h // 8, w // 8, CLASSES)
    resize = arch == "espnet_c"
    assert calls == ([("resize_argmax", low, 8)] if resize else
                     [("subpixel_argmax", (2, h // 2, w // 2, CLASSES),
                       (2, 2))])
    calls.clear()
    fused, method = L.fused_resize_ce_spec(model, "ce")
    assert method == ("logits_lowres" if resize else None)
    step = make_train_step(model, partial(fused or L.cross_entropy,
                                          num_classes=CLASSES),
                           O.build_optimizer("adam", model.parameters()),
                           fwd_method=method)
    step({"image": torch.from_numpy(images),
          "label": torch.zeros((2, *HW), dtype=torch.int32)})
    assert calls == ([("resize_ce_sums", low, 8)] if resize else [])


# --- one train step -----------------------------------------------------------

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
    """The reference's loss and per-leaf gradient in f64 on its plain
    fusion: class-weighted CE on its full logits, or on the f64 upsample of
    ``logits_lowres``."""
    def loss(params, stats, images, labels):
        out, _ = jnn.apply(jmodel, {"params": params, "stats": stats},
                           images, train=True, mutable=True, method=method)
        if method is not None:
            out = jax_resize_bilinear(out, HW)
        return JL.cross_entropy(out, labels, num_classes=CLASSES,
                                class_weights=jnp.asarray(cw, jnp.float64))

    with pytest.MonkeyPatch.context() as mp, _x64():
        mp.setenv("ESN_TPU_ESP_FUSED_HFF", "0")
        v = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a), jnp.float64), variables)
        value, grads = jax.jit(jax.value_and_grad(loss))(
            v["params"], v["stats"], jnp.asarray(img, jnp.float64),
            jnp.asarray(lab))
        return float(value), dict(_leaves(jax.tree_util.tree_map(
            np.asarray, grads)))


def step_readings(arch):
    """One adam + poly step of the port with class-weighted CE (ESPNet-C
    through ``logits_lowres`` and the resize-CE kernel's plain version,
    ESPNet on its full logits) from converted weights; the reference's own
    f32 step and the f64 oracle. Returns the readings the test holds (call
    it from a scratch script to see them)."""
    jmodel = jax_build_model(arch, CLASSES)
    variables = _random_variables(
        _init_shapes(jmodel, jnp.zeros((1, *HW, 3), jnp.float32)),
        np.random.RandomState(0))
    img, lab, cw = _batch(1)
    method = "logits_lowres" if arch == "espnet_c" else None
    sched = JS.poly_schedule(LR, TOTAL)
    tx = JO.build_optimizer("adam", sched)
    jloss = partial(JL.resize_cross_entropy if method else JL.cross_entropy,
                    num_classes=CLASSES, class_weights=jnp.asarray(cw))
    jstep = jax_make_train_step(jmodel, jloss, tx, schedule=sched,
                                fwd_method=method, donate=False)
    jnew, jm = jstep(JaxTrainState.create(variables, tx),
                     {"image": jnp.asarray(img), "label": jnp.asarray(lab)},
                     jax.random.PRNGKey(0))

    def port():
        model = build_model(arch, CLASSES, device="cpu")
        model.load_state_dict(convert.to_state_dict(variables, model),
                              strict=True)
        return model
    model = port()
    fused, fwd = L.fused_resize_ce_spec(model, "ce")
    assert fwd == method
    loss_fn = partial(fused or L.cross_entropy, num_classes=CLASSES,
                      class_weights=torch.from_numpy(cw))
    step = make_train_step(model, loss_fn,
                           O.build_optimizer("adam", model.parameters()),
                           schedule=S.build_schedule("poly", LR, TOTAL),
                           fwd_method=method)
    timg = torch.from_numpy(img.transpose(0, 3, 1, 2).copy())
    tlab = torch.from_numpy(lab)
    metrics = step({"image": timg, "label": tlab})
    value, grads = _oracle(jmodel, variables, img, lab, cw, method)
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
    readings["f32"] = grad_excess(model, GRAD_F32[arch])
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
    out = model.run(timg.double(), method)
    loss64 = loss_fn(out.permute(0, 2, 3, 1), tlab)
    loss64.backward()
    readings["loss64"] = float(loss64.detach())
    readings["f64"] = grad_excess(model, GRAD_F64)
    return readings


def test_train_step_matches_reference(arch):
    """One adam + poly step with class-weighted CE from converted weights:
    the loss against the reference's f32 step and the f64 oracle (f32 and
    f64 runs of the port), per-leaf gradients against the oracle, params
    and BN running statistics against the reference's step."""
    r = step_readings(arch)
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


# --- load_encoder ----------------------------------------------------------

def _donor(seed=3):
    """A port ESPNet-C with seeded weights and BN statistics."""
    model = build_model("espnet_c", CLASSES, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, buf in model.named_buffers():
            buf.copy_(torch.rand(buf.shape,
                                 generator=torch.Generator().manual_seed(
                                     len(name))) + 0.5)
    return model


def _port_checkpoint(tmp_path, model):
    return ckpt.save_checkpoint(
        str(tmp_path), 7, TrainState(model, O.build_optimizer(
            "adam", model.parameters()), step=3), {"mIoU": 0.25})


def _jax_checkpoint(tmp_path, model):
    """The reference's own ``save_checkpoint`` of a TrainState holding
    ``model``'s variables and an adam state."""
    variables = convert.to_variables(model.state_dict(), model)
    tx = JO.build_optimizer("adam", 1e-3)
    return jax_ckpt.save_checkpoint(
        str(tmp_path), 7, JaxTrainState.create(variables, tx),
        {"mIoU": 0.25})


def _enc_state(model):
    return {k[len("enc."):]: v for k, v in model.state_dict().items()
            if k.startswith("enc.")}


@pytest.mark.parametrize("fmt", ["port", "jax"])
def test_load_encoder_grafts_the_encoder(tmp_path, fmt):
    """ESPNet-C's checkpoint of either package into ESPNet's ``enc``:
    every encoder parameter and BN statistic equals the donor's bit for
    bit, the donor's classifier is left out, the decoder is untouched, the
    donor's meta comes back; the same graft as the reference's
    ``load_encoder`` on the same variables."""
    donor = _donor()
    path = (_port_checkpoint if fmt == "port" else _jax_checkpoint)(
        tmp_path, donor)
    model = build_model("espnet", CLASSES, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    reference_vars = convert.to_variables(model.state_dict(), model)
    meta = ckpt.load_encoder(path, model)
    assert meta["epoch"] == 7 and meta["mIoU"] == 0.25
    donor_sd = donor.state_dict()
    enc = _enc_state(model)
    assert set(enc) == set(donor_sd) - {"head.weight"}
    for key, value in enc.items():
        assert torch.equal(value, donor_sd[key]), key
    for key, value in model.state_dict().items():
        if not key.startswith("enc."):
            assert torch.equal(value, before[key]), key
    grafted, ref_meta = jax_ckpt.load_encoder(_jax_checkpoint(
        tmp_path / "ref", donor), reference_vars)
    assert ref_meta["epoch"] == 7
    want = convert.to_state_dict(grafted, model)
    for key, value in model.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), want[key].numpy(),
                                      err_msg=key)


def _write_payload(path, fmt, params, stats):
    """A checkpoint file of ``fmt`` holding only the model's variables."""
    if fmt == "port":
        sd = convert.to_state_dict({"params": params, "stats": stats})
        torch.save({"state": {"model": sd}, "meta": {"epoch": 1}}, path)
    else:
        with open(path, "wb") as f:
            f.write(flax.serialization.msgpack_serialize(
                {"state": {"params": params, "stats": stats},
                 "meta": {"epoch": 1}}))
    return str(path)


@pytest.mark.parametrize("fmt", ["port", "jax"])
def test_load_encoder_rejects_a_missing_or_misshapen_leaf(tmp_path, fmt):
    """A donor without one of the encoder's leaves raises ``KeyError``
    naming it; one whose leaf has another shape raises ``ValueError``; the
    model is left as it was."""
    variables = convert.to_variables(_donor().state_dict())
    model = build_model("espnet", CLASSES, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    params, stats = copy.deepcopy(variables["params"]), variables["stats"]
    del params["level3"]["7"]["d4"]
    with pytest.raises(KeyError, match=r"level3\.7\.d4\.weight"):
        ckpt.load_encoder(_write_payload(tmp_path / "a", fmt, params, stats),
                          model)
    params = copy.deepcopy(variables["params"])
    params["b3"]["act"]["alpha"] = np.zeros(255, np.float32)
    with pytest.raises(ValueError, match=r"enc\.b3\.act\.weight"):
        ckpt.load_encoder(_write_payload(tmp_path / "b", fmt, params, stats),
                          model)
    for key, value in model.state_dict().items():
        assert torch.equal(value, before[key]), key
