"""The port's ESPNetv2 and DABNet (staged config 4) and their blocks against
the JAX reference, on the CPU.

Weights are drawn with numpy into the reference's variables tree (its
structure from ``jax.eval_shape`` of the reference init), converted with
``esn_tpu_torch.convert`` and run through both packages: the same inputs,
tolerances stated per test. The reference runs its plain paths: no lane
folding (``ESN_TPU_FOLD_DW=0``, its default), its scan chains unrolled
(their variables lay out as a ``Sequential``'s, the port's plain
``nn.Sequential``). Both models end in the bilinear resize tail: their
predict ends in the fused upsample + argmax and their CE trains through
``logits_lowres`` (the kernels' plain versions here: a CPU tensor never
reaches a CUDA kernel). The input is 96x192, so ESPNetv2's 1/16 level
(6x12) holds every bin of its pyramid pooling.
"""
import contextlib
import copy
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esn_tpu import nn as jnn
from esn_tpu.models import build_model as jax_build_model
from esn_tpu.models import dabnet as JD
from esn_tpu.models import espnetv2 as JV
from esn_tpu.ops import pooling as JP
from esn_tpu.ops.resize import resize_bilinear as jax_resize_bilinear
from esn_tpu.train import losses as JL
from esn_tpu.train import optimizers as JO
from esn_tpu.train import schedules as JS
from esn_tpu.train.state import TrainState
from esn_tpu.train.step import make_predict_step as jax_make_predict_step
from esn_tpu.train.step import make_train_step as jax_make_train_step

from esn_tpu_torch import convert
from esn_tpu_torch.models import available_models, build_model
from esn_tpu_torch.models import dabnet as D
from esn_tpu_torch.models import espnetv2 as V
from esn_tpu_torch.nn import BatchNorm, Conv
from esn_tpu_torch.ops import kernels as K
from esn_tpu_torch.train import losses as L
from esn_tpu_torch.train import optimizers as O
from esn_tpu_torch.train import schedules as S
from esn_tpu_torch.train.step import make_predict_step, make_train_step
from esn_tpu_torch.utils import count_params

CLASSES = 19
HW = (96, 192)
N_PARAMS = {"espnetv2": 943_446, "dabnet": 752_480}
ALIASES = {"espnetv2": ("ESPNetv2", "espnet_v2", "eespnet_seg"),
           "dabnet": ("DABNet",)}
# Logits against the reference's: f32 atol = rtol = LOGIT_TOL (read, the
# largest difference relative to max(1, |logit|) of the 1/8 logits: the
# port's lie 2.3e-5 (ESPNetv2) and 1.2e-5 (DABNet) from the reference's,
# which lie 2.0e-5 and 1.0e-5 from its own f64 logits: well-conditioned);
# f64 atol = rtol = 1e-8 (read: 3.5e-14 and 2.6e-14).
LOGIT_TOL = 1e-4
# One adam step (tolerances as tests/test_torch_contextnet.py): the loss
# within 1e-5 relative of the reference's f32 step and of the f64 oracle;
# per-leaf gradient rel-L2 of the port's model run in f64 (BN moments and
# the loss stay f32 in the reference) <= GRAD_F64 (read: 2.7e-5 ESPNetv2,
# 3.7e-6 DABNet at most) and of the f32 step <= GRAD_F32, each plus ABS (a
# conv bias under a train-mode BN has gradient 0: DABNet's down-sampling
# biases read ~1e-9 of noise); the parameters within 2 lr and the BN
# statistics within STAT_TOL (relative, plus as much absolute) of the
# reference's f32 step. ESPNetv2's f32 gradient is ill-conditioned at
# this size: the 1x1 bin of its pyramid pooling normalises 2 values a
# channel in train mode at batch 2, and the raw-image projections' BNs
# see a smooth image; the reference's own f32 gradient lies up to 0.195
# from the oracle (down1/img_conv/0/bn/scale), the port's 8.6e-2, and
# the pooling's fuse BN statistics of the two f32 steps 2.3e-4 apart.
# DABNet's is well-conditioned: f32 3.4e-3 at most, statistics 3.8e-8.
GRAD_F32 = {"espnetv2": 0.15, "dabnet": 1e-2}
STAT_TOL = {"espnetv2": 1e-3, "dabnet": 1e-4}
LOSS_REL, GRAD_F64, ABS = 1e-5, 1e-4, 1e-6
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
    for name in ("ESN_TPU_FOLD_DW", "ESN_TPU_FOLD", "ESN_TPU_SCAN_CHAIN"):
        monkeypatch.setenv(name, "0")


def _random_variables(tree, rng):
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
        x, 0.0, jax.lax.add, (1, kh, kw, 1),
        (1, sh, sw, 1), ((0, 0), (ph, ph), (pw, pw), (0, 0))) / (kh * kw)


def _conv_of_concat(self, scope, pieces):
    """The reference's conv over a virtual concat as the conv of the
    concat (the same function; its own sums the pieces' terms in f32)."""
    return self(scope, jnp.concatenate(pieces, axis=-1))


@contextlib.contextmanager
def _x64():
    """``jax_enable_x64`` on, and the two places where the reference
    rounds to f32 whatever its input taken off the f64 runs' path: its
    average pools (the stride-2 EESP's, the raw-image injections', the
    pyramid pooling's, whose bins all divide the 1/16 level here) sum in
    x's dtype, as the port's do, and DABNet's convs over virtual concats
    are convs of the concat."""
    real = JP.avg_pool2d, jnn.Conv.pieces_apply
    jax.config.update("jax_enable_x64", True)
    JP.avg_pool2d, jnn.Conv.pieces_apply = (_avg_pool2d_in_dtype,
                                            _conv_of_concat)
    try:
        yield
    finally:
        JP.avg_pool2d, jnn.Conv.pieces_apply = real
        jax.config.update("jax_enable_x64", False)


# --- grouped convs ----------------------------------------------------------

@pytest.mark.parametrize("dense", ["0", "1"])
@pytest.mark.parametrize("kernel, groups", [(1, 4), (3, 2), (3, 8)])
def test_grouped_conv_matches_reference(kernel, groups, dense, monkeypatch):
    """A grouped conv (EESP's reduce and expand; groups = channels is a
    depthwise conv with a channel multiplier of 2) on an asymmetric kernel:
    the reference stores ``(kh, kw, in/g, out)`` whether it runs the native
    grouped conv (``ESN_TPU_DENSE_GROUPED=0``) or a block-diagonal dense
    kernel (``=1``), and ``convert``'s HWIO -> OIHW transpose gives the
    port's ``(out, in/g, kh, kw)``: atol = rtol = 1e-5."""
    monkeypatch.setenv("ESN_TPU_DENSE_GROUPED", dense)
    jconv = jnn.Conv(8, 16, kernel, padding=kernel // 2, groups=groups)
    conv = Conv(8, 16, kernel, padding=kernel // 2, groups=groups)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 9, 11).astype(np.float32)
    variables = _random_variables(_init_shapes(jconv, _nhwc(x)), rng)
    k = variables["params"]["kernel"]
    assert k.shape == (kernel, kernel, 8 // groups, 16)
    sd = convert.to_state_dict(variables, conv)
    np.testing.assert_array_equal(sd["weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    conv.load_state_dict(sd, strict=True)
    want = _nchw(jnn.apply(jconv, variables, _nhwc(x)))
    with torch.no_grad():
        got = conv(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    back = convert.to_variables(conv.state_dict(), conv)["params"]["kernel"]
    np.testing.assert_array_equal(back, k)


# --- the blocks --------------------------------------------------------------

BLOCKS = {
    # residual EESP, groups 4 in the reduce and the expand
    "eesp": (lambda: JV.EESP(16, 16), lambda: V.EESP(16, 16), (16,)),
    # stride 2 (the reduced input average-pooled, odd extent), no residual
    "eesp_s2": (lambda: JV.EESP(8, 12, stride=2, residual=False),
                lambda: V.EESP(8, 12, stride=2, residual=False), (8,)),
    # out 5 = 3 x 1 + 2: the last branch has 2 channels from 1, the fusion
    # broadcasts, groups 1 everywhere
    "eesp_rem": (lambda: JV.EESP(6, 5), lambda: V.EESP(6, 5), (6,)),
    "strided_eesp": (lambda: JV.StridedEESP(8, 20),
                     lambda: V.StridedEESP(8, 20), (8, 3)),
    "dab_module": (lambda: JD.DABModule(12, 3),
                   lambda: D.DABModule(12, 3), (12,)),
    # the 2x2 max pool and the 3x3 s2 conv agree in size on even extents
    "dab_down_concat": (lambda: JD.DownSamplingBlock(5, 12),
                        lambda: D.DownSamplingBlock(5, 12), (5,), (14, 16)),
    "dab_down_plain": (lambda: JD.DownSamplingBlock(12, 8),
                       lambda: D.DownSamplingBlock(12, 8), (12,)),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_matches_reference(kind, train):
    """Each block on converted weights, eval and train mode, at an odd
    extent (13x15; the strided EESP's raw image at 26x30, downscaled to its
    7x8 output) where the reference takes one: the output and in train mode the updated BN running
    statistics (atol = rtol = 1e-5)."""
    make_j, make_t, chs, *hw = BLOCKS[kind]
    h, w = hw[0] if hw else (13, 15)
    jblock, block = make_j(), make_t()
    rng = np.random.RandomState(4)
    xs = [rng.randn(2, ch, h * (i + 1), w * (i + 1)).astype(np.float32)
          * 2 + 0.3 for i, ch in enumerate(chs)]
    jx = [_nhwc(x) for x in xs]
    variables = _random_variables(_init_shapes(jblock, *jx), rng)
    block.load_state_dict(convert.to_state_dict(variables, block),
                          strict=True)
    want = jnn.apply(jblock, variables, *jx, train=train, mutable=train)
    if train:
        want, new_vars = want
    block.train(train)
    with torch.no_grad():
        got = block(*map(torch.from_numpy, xs)).numpy()
    assert got.shape == _nchw(want).shape
    np.testing.assert_allclose(got, _nchw(want), atol=1e-5, rtol=1e-5)
    if train:
        stats = dict(_leaves(convert.to_variables(block.state_dict(),
                                                  block)["stats"]))
        for path, ref in _leaves(new_vars["stats"]):
            np.testing.assert_allclose(stats[path], np.asarray(ref),
                                       atol=1e-5, rtol=1e-5)


# --- the two models, full width and depth ------------------------------------

@pytest.fixture(scope="module", params=["espnetv2", "dabnet"])
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
    """Registered under the reference's names; its parameter count and
    tail."""
    assert arch in available_models()
    for name in ALIASES[arch]:
        assert type(build_model(name, 3, device="cpu")) is type(
            build_model(arch, 3, device="cpu"))
    model = build_model(arch, CLASSES, device="cpu")
    params = reference[1]["params"]
    assert count_params(model) == N_PARAMS[arch] == sum(
        int(np.prod(v.shape)) for _, v in _leaves(params))
    assert model.LOGITS_TAIL == "resize"


def test_convert_round_trip_is_bit_exact(arch, reference):
    """reference tree -> state_dict -> port model -> state_dict -> tree;
    the keys are the reference's variable paths (scan chains as
    Sequentials, DABNet's block2 a Sequential of pairs); grouped kernels
    keep their ``in/g`` axis."""
    variables = _random_variables(reference[1], np.random.RandomState(7))
    model = build_model(arch, CLASSES, device="cpu")
    sd = convert.to_state_dict(variables, model)
    assert set(sd) == set(model.state_dict())
    keys = {"espnetv2": ("down1.eesp.d3.weight", "level2.6.expand.conv.weight",
                         "down3.img_conv.1.bn.running_var",
                         "psp.reduce3.conv.weight", "fuse.concat_bn.act.weight",
                         "head.weight"),
            "dabnet": ("stem.2.conv.weight", "block1.2.b2.weight",
                       "block2.0.0.a1.weight", "block2.2.1.expand.weight",
                       "down2.conv.bias", "b3.act.weight", "head.weight")}[arch]
    for key in keys:
        assert key in sd
    if arch == "espnetv2":
        k = variables["params"]["level1"]["0"]["reduce"]["conv"]["kernel"]
        assert k.shape == (1, 1, 128 // 4, 32)
        np.testing.assert_array_equal(sd["level1.0.reduce.conv.weight"]
                                      .numpy(), k.transpose(3, 2, 0, 1))
    model.load_state_dict(sd, strict=True)
    back = dict(_leaves(convert.to_variables(model.state_dict(), model)))
    leaves = dict(_leaves(variables))
    assert set(back) == set(leaves)
    for path, want in leaves.items():
        assert back[path].dtype == want.dtype
        np.testing.assert_array_equal(back[path], want, err_msg="/".join(path))


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


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_logits_match_reference(pair, images, dtype):
    """Logits at 2x3x96x192 on converted, calibrated weights: the 1/8
    logits and (f32) the full-resolution ones, f32 within LOGIT_TOL, f64
    within 1e-8 (1/8 only: both packages upsample in f32)."""
    jmodel, variables, model = pair
    tol = LOGIT_TOL if dtype == np.float32 else 1e-8
    m = copy.deepcopy(model).to(getattr(torch, np.dtype(dtype).name))
    methods = ["logits_lowres"] + ([None] if dtype == np.float32 else [])
    for method in methods:
        want = _reference_logits(jmodel, variables, images, dtype, method)
        with torch.no_grad():
            got = m.run(torch.from_numpy(images.astype(dtype)), method)
        got = got.permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape
        assert want.std() > 0.05      # the weights make non-trivial logits
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def test_predict_step_matches_reference(pair, images):
    """The port's predict (the fused upsample + argmax) against the
    reference's, f32: mismatch rate <= 1e-4, and only at near-ties, where
    the reference's f32 logits of the two classes lie within twice
    LOGIT_TOL (relative) of each other."""
    jmodel, variables, model = pair
    x = _nhwc(images)
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
        assert np.all(np.abs(a - b) <= 2 * LOGIT_TOL * np.maximum(1, np.abs(b)))


def test_paths_take_the_kernels(arch, images, monkeypatch):
    """The routes the card's launch counts confirm, seen here through the
    wrappers' calls: a predict calls ``resize_argmax`` once on the 1/8
    logits at r = 8, a weighted-CE train step ``resize_ce_sums`` once on
    ``logits_lowres``; nothing else."""
    calls = []

    def spy(name):
        real = getattr(K, name)

        def wrapper(*args, **kw):
            calls.append((name, tuple(args[0].shape), kw.get("r") or args[1]))
            return real(*args, **kw)
        monkeypatch.setattr(K, name, wrapper)
    for name in ("fused_dsconv", "resize_argmax", "resize_ce_sums",
                 "fused_cgblock_pre"):
        spy(name)
    model = build_model(arch, CLASSES, device="cpu")
    make_predict_step(model)(torch.from_numpy(images))
    h, w = HW
    low = (2, h // 8, w // 8, CLASSES)
    assert calls == [("resize_argmax", low, 8)]
    calls.clear()
    fused, method = L.fused_resize_ce_spec(model, "ce")
    assert method == "logits_lowres" and fused.func is L.resize_cross_entropy
    step = make_train_step(model, partial(fused, num_classes=CLASSES),
                           O.build_optimizer("adam", model.parameters()),
                           fwd_method=method)
    step({"image": torch.from_numpy(images),
          "label": torch.zeros((2, *HW), dtype=torch.int32)})
    assert calls == [("resize_ce_sums", low, 8)]


# --- one train step: weighted CE through logits_lowres ----------------------

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
    (``jax_enable_x64``): its train-mode ``logits_lowres``, and
    class-weighted CE on their f64 upsample."""
    def loss(params, stats, images, labels):
        z, _ = jnn.apply(jmodel, {"params": params, "stats": stats},
                         images, train=True, mutable=True,
                         method="logits_lowres")
        return JL.cross_entropy(jax_resize_bilinear(z, HW), labels,
                                num_classes=CLASSES,
                                class_weights=jnp.asarray(cw, jnp.float64))

    with _x64():
        v = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a), jnp.float64), variables)
        value, grads = jax.jit(jax.value_and_grad(loss))(
            v["params"], v["stats"], jnp.asarray(img, jnp.float64),
            jnp.asarray(lab))
        return float(value), dict(_leaves(jax.tree_util.tree_map(
            np.asarray, grads)))


def step_readings(arch):
    """One adam + poly step of the port with class-weighted CE through
    ``logits_lowres`` (the resize-CE kernel's plain version here) from
    converted weights; the reference's own f32 step (its
    ``resize_cross_entropy``) and the f64 oracle. Returns the readings the
    test holds (call it from a scratch script to see them)."""
    jmodel = jax_build_model(arch, CLASSES)
    variables = _random_variables(
        _init_shapes(jmodel, jnp.zeros((1, *HW, 3), jnp.float32)),
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
    readings["f32"] = grad_excess(model, GRAD_F32[arch])
    # params and BN statistics against the reference's own f32 step
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    ref_sd = convert.to_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": jnew.params, "stats": jnew.stats}), model)
    assert set(ref_sd) == set(sd)
    readings["stats"], readings["params"] = {}, {}
    for key, ref in ref_sd.items():
        d = np.abs(sd[key] - ref.numpy())
        if "running_" in key:
            readings["stats"][key] = float(np.max(d - STAT_TOL[arch]
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


def test_train_step_matches_reference(arch):
    """One adam + poly step with class-weighted CE through
    ``logits_lowres`` from converted weights: the loss against the
    reference's f32 step and the f64 oracle (f32 and f64 runs of the
    port), per-leaf gradients against the oracle, params and BN running
    statistics against the reference's step."""
    r = step_readings(arch)
    assert r["lr"][0] == pytest.approx(r["lr"][1], rel=1e-6)
    for key, ref in (("loss", "reference_loss"), ("loss", "oracle_loss"),
                     ("loss64", "oracle_loss")):
        assert abs(r[key] - r[ref]) <= LOSS_REL * abs(r[ref]), (
            key, ref, r[key], r[ref])
    for key in ("f32", "f64"):
        worst = max(r[key].items(), key=lambda kv: kv[1][0])
        assert worst[1][0] <= 0, (key, worst)
    assert max(r["stats"].values()) <= STAT_TOL[arch], r["stats"]
    assert max(r["params"].values()) <= 2 * LR + 1e-7
