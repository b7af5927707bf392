"""The port's ENet, its blocks, ``ConvTranspose`` and the index
pool/unpool pair against the JAX reference, on the CPU.

Weights are drawn with numpy into the reference's variables tree (its
structure from ``jax.eval_shape`` of the reference init), converted with
``esn_tpu_torch.convert`` (given the port's model, which says where the
transposed convs are) and run through both packages: the same inputs,
f32, tolerances stated per test. The reference runs un-jitted with its
plain stem; nothing on ENet's path reaches a Pallas kernel.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esn_tpu import nn as jnn
from esn_tpu.models import build_model as jax_build_model
from esn_tpu.models import enet as JE
from esn_tpu.ops import pooling as JP

from esn_tpu_torch import convert
from esn_tpu_torch.models import available_models, build_model
from esn_tpu_torch.models import enet as E
from esn_tpu_torch.nn import BatchNorm, ConvTranspose, SpatialDropout
from esn_tpu_torch.ops import pooling as P
from esn_tpu_torch.train.step import make_predict_step
from esn_tpu_torch.utils import count_params

CLASSES = 19
ATOL = RTOL = 1e-4        # f32 re-association (convs, BN)


def _random_variables(tree, rng):
    """numpy values for every leaf of a reference variables tree: conv
    kernels ~ N(0, 2/fan_in) (every one asymmetric under a spatial flip),
    BN affines and running stats and PReLU slopes non-trivial."""
    def fill(node):
        out = {}
        for name, leaf in node.items():
            if isinstance(leaf, dict):
                out[name] = fill(leaf)
                continue
            shape = leaf.shape
            if name == "kernel":
                fan_in = int(np.prod(shape[:-1]))
                v = rng.randn(*shape) * np.sqrt(2.0 / fan_in)
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


def _jax_variables(module, rng, *example):
    shapes = jax.eval_shape(lambda k: module.init(k, *example),
                            jax.random.PRNGKey(0))
    return _random_variables(shapes, rng)


def _nhwc(x):
    return jnp.asarray(x.transpose(0, 2, 3, 1))


def _nchw(y):
    return np.asarray(y).transpose(0, 3, 1, 2)


def _window_positions(idx):
    """The port's pool indices (flat offsets in the (2h, 2w) plane) as the
    reference's window positions ``di * 2 + dj``."""
    idx = idx.numpy()
    h, w = idx.shape[2:]
    row, col = idx // (2 * w), idx % (2 * w)
    di = row - 2 * np.arange(h)[:, None]
    dj = col - 2 * np.arange(w)[None, :]
    assert ((di >= 0) & (di < 2) & (dj >= 0) & (dj < 2)).all()
    return (di * 2 + dj).astype(np.int32)


def _flat_indices(pos):
    """The reference's window positions (N, C, h, w) as the port's flat
    indices."""
    h, w = pos.shape[2:]
    row = 2 * np.arange(h)[:, None] + pos // 2
    col = 2 * np.arange(w)[None, :] + pos % 2
    return torch.from_numpy((row * (2 * w) + col).astype(np.int64))


# --- ConvTranspose -----------------------------------------------------------

@pytest.mark.parametrize("k, s, p, op", [(3, 2, 1, 1), (2, 2, 0, 0),
                                         (4, 2, 1, 0), (3, 1, 1, 0)])
def test_conv_transpose_matches_reference(k, s, p, op):
    """A random (so asymmetric) kernel and a bias through the reference's
    layer and, converted, through the port's: rtol = atol = 1e-4 in f32.
    Converted as a conv's kernel (no model given) the weight has another
    layout, and a transposition without the flip is far off."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 4, 9, 11).astype(np.float32)
    jlayer = jnn.ConvTranspose(4, 6, k, stride=s, padding=p,
                               output_padding=op, bias=True)
    variables = _jax_variables(jlayer, rng, jnp.zeros((1, 9, 11, 4)))
    want = _nchw(jnn.apply(jlayer, variables, _nhwc(x)))
    layer = ConvTranspose(4, 6, k, stride=s, padding=p, output_padding=op)
    sd = convert.to_state_dict(variables, layer)
    assert tuple(sd["weight"].shape) == (4, 6, k, k)
    layer.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    back = convert.to_variables(layer.state_dict(), layer)
    np.testing.assert_array_equal(back["params"]["kernel"],
                                  variables["params"]["kernel"])
    # the flip matters: the same kernel transposed but not flipped
    with torch.no_grad():
        layer.weight.copy_(layer.weight.flip(2, 3))
        unflipped = layer(torch.from_numpy(x)).numpy()
    assert np.abs(unflipped - want).max() > 0.1
    assert tuple(convert.to_state_dict(variables)["weight"].shape) \
        == (6, 4, k, k)


def test_conv_transpose_init_and_dtype():
    """Kaiming fan-out: std = sqrt(2 / (kh*kw*out)); the bias bound is
    1/sqrt(kh*kw*in); bf16 activations meet the f32 weight in bf16."""
    layer = ConvTranspose(64, 32, 3, stride=2, padding=1, output_padding=1)
    layer.reset_parameters(torch.Generator().manual_seed(0))
    assert tuple(layer.weight.shape) == (64, 32, 3, 3)
    std = float(layer.weight.detach().std())
    assert abs(std - (2.0 / (9 * 32)) ** 0.5) < 0.05 * std
    bound = 1.0 / (9 * 64) ** 0.5
    top = float(layer.bias.detach().abs().max())
    assert 0.5 * bound < top <= bound
    y = layer(torch.zeros(1, 64, 4, 5, dtype=torch.bfloat16))
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (1, 32, 8, 10)


# --- the pools ---------------------------------------------------------------

def _tied_input(rng, shape, dtype):
    """Random values with planted ties: a constant block, a block of two
    alternating values, and (bf16) values that round to a tie."""
    x = rng.randn(*shape).astype(np.float32)
    x[:, :, 2:6, 2:8] = 0.75
    x[:, :, 6:8, 0:4] = np.array([[-1.0, 2.0, 2.0, -1.0],
                                  [2.0, 2.0, -3.0, 2.0]], np.float32)
    if dtype == "bfloat16":
        x[:, :, 0:2, 8:10] = np.array([[1.0, 1.001], [1.002, 0.999]],
                                      np.float32)
    return x


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("hw", [(8, 12), (9, 13)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_unpool_match_reference(dtype, hw, channels_last):
    """Values, the window positions the indices stand for (ties to the
    first position), and the unpool (plain, and padded or cropped with
    ``output_size``): equal bit for bit."""
    rng = np.random.RandomState(1)
    x = _tied_input(rng, (2, 5, *hw), dtype)
    xj = _nhwc(x).astype(dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    if channels_last:
        xt = xt.contiguous(memory_format=torch.channels_last)
    want_v, want_i = JP.max_pool2d_with_indices_2x2(xj)
    got_v, got_i = P.max_pool2d_with_indices_2x2(xt)
    assert got_v.dtype == xt.dtype and got_i.dtype == torch.int64
    np.testing.assert_array_equal(got_v.float().numpy(),
                                  _nchw(want_v.astype(jnp.float32)))
    pos = _window_positions(got_i)
    np.testing.assert_array_equal(pos, _nchw(want_i))
    assert (pos[:, :, 1:3, 1:4] == 0).all()          # the constant block
    np.testing.assert_array_equal(pos[0, 0, 3, 0:2], [1, 0])
    for size in (None, hw, (hw[0] + 2, hw[1] - 3)):
        want = JP.max_unpool2d_2x2(want_v, want_i, size)
        got = P.max_unpool2d_2x2(got_v, got_i, size)
        assert got.dtype == xt.dtype
        if size is None:          # a crop is a view of such a tensor
            assert got.is_contiguous(memory_format=torch.channels_last
                                     if channels_last
                                     else torch.contiguous_format)
        np.testing.assert_array_equal(got.float().numpy(),
                                      _nchw(want.astype(jnp.float32)))


def test_pool_and_unpool_gradients_match_reference():
    """Without ties the pool's gradient equals the reference's. At a tie
    the reference's ``jnp.max`` splits the gradient evenly among the tied
    elements; the port's reaches only the remembered (first) position,
    with the same sum per window. The unpool's gradient is the gather,
    equal to the reference's."""
    rng = np.random.RandomState(2)
    gv = rng.randn(2, 3, 4, 6).astype(np.float32)
    gu = rng.randn(2, 3, 9, 12).astype(np.float32)

    def pooled(xx):
        return jnp.sum(JP.max_pool2d_with_indices_2x2(xx)[0] * _nhwc(gv))

    def port_grad(x):
        xt = torch.from_numpy(x).requires_grad_()
        v, idx = P.max_pool2d_with_indices_2x2(xt)
        (v * torch.from_numpy(gv)).sum().backward()
        return xt.grad.numpy(), idx

    plain = rng.randn(2, 3, 9, 12).astype(np.float32)
    got, _ = port_grad(plain)
    np.testing.assert_array_equal(got, _nchw(jax.grad(pooled)(_nhwc(plain))))
    assert (got[:, :, 8] == 0).all()              # the dropped odd row

    x = _tied_input(rng, (2, 3, 9, 12), "float32")
    got, idx = port_grad(x)
    want = np.zeros((2, 3, 8 * 12), np.float32)
    np.put_along_axis(want, idx.numpy().reshape(2, 3, -1),
                      gv.reshape(2, 3, -1), axis=-1)
    np.testing.assert_array_equal(got[:, :, :8].reshape(2, 3, -1), want)
    ref = _nchw(jax.grad(pooled)(_nhwc(x)))
    assert not np.array_equal(got, ref)           # the reference splits
    windows = lambda g: g[:, :, :8].reshape(2, 3, 4, 2, 6, 2).sum((3, 5))  # noqa: E731
    np.testing.assert_allclose(windows(got), windows(ref), atol=1e-6)

    _, jidx = JP.max_pool2d_with_indices_2x2(_nhwc(x))
    y = rng.randn(2, 3, 4, 6).astype(np.float32)

    def unpooled(yy):
        return jnp.sum(JP.max_unpool2d_2x2(yy, jidx, (9, 12)) * _nhwc(gu))
    want_dy = _nchw(jax.grad(unpooled)(_nhwc(y)))
    yt = torch.from_numpy(y).requires_grad_()
    (P.max_unpool2d_2x2(yt, idx, (9, 12)) * torch.from_numpy(gu)).sum() \
        .backward()
    np.testing.assert_array_equal(yt.grad.numpy(), want_dy)


@pytest.mark.parametrize("window, stride, padding", [(2, 2, 0), (3, 2, 1),
                                                     ((2, 3), None, 0)])
def test_max_pool2d_matches_reference(window, stride, padding):
    x = np.random.RandomState(3).randn(2, 4, 11, 14).astype(np.float32)
    want = _nchw(JP.max_pool2d(_nhwc(x), window, stride, padding))
    got = P.max_pool2d(torch.from_numpy(x), window, stride, padding).numpy()
    np.testing.assert_array_equal(got, want)


# --- the four blocks ---------------------------------------------------------

def _no_dropout(module):
    for sub in module.modules():
        if isinstance(sub, SpatialDropout):
            sub.rate = 0.0


BLOCKS = {
    "initial": (lambda: JE.InitialBlock(3, 16), lambda: E.InitialBlock(3, 16),
                3),
    "regular": (lambda: JE.RegularBottleneck(16),
                lambda: E.RegularBottleneck(16), 16),
    "regular_relu": (lambda: JE.RegularBottleneck(16, relu=True),
                     lambda: E.RegularBottleneck(16, relu=True), 16),
    "dilated": (lambda: JE.RegularBottleneck(16, dilation=4),
                lambda: E.RegularBottleneck(16, dilation=4), 16),
    "asymmetric": (lambda: JE.RegularBottleneck(16, asymmetric=True),
                   lambda: E.RegularBottleneck(16, asymmetric=True), 16),
    "down": (lambda: JE.DownsamplingBottleneck(8, 24),
             lambda: E.DownsamplingBottleneck(8, 24), 8),
    "up": (lambda: JE.UpsamplingBottleneck(16, 8),
           lambda: E.UpsamplingBottleneck(16, 8), 16),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_matches_reference(kind, train, monkeypatch):
    """Each ENet block on converted weights, eval and train mode (dropout
    off, the reference's plain stem): the output, the pool positions a
    downsampling block hands on, and in train mode the updated BN running
    statistics (atol = rtol = 1e-5)."""
    monkeypatch.setenv("ESN_TPU_S2D_STEM", "0")
    rng = np.random.RandomState(4)
    make_j, make_t, ch = BLOCKS[kind]
    jblock, block = make_j(), make_t()
    if kind != "initial":
        jblock.drop.rate = 0.0
        _no_dropout(block)
    x = rng.randn(2, ch, 12, 16).astype(np.float32) * 2 + 0.3
    jargs, targs = [_nhwc(x)], [torch.from_numpy(x)]
    if kind == "up":
        pos = rng.randint(0, 4, (2, 8, 12, 16)).astype(np.int32)
        jargs.append(jnp.asarray(pos.transpose(0, 2, 3, 1)))
        targs.append(_flat_indices(pos))
    variables = _jax_variables(jblock, rng, *jargs)
    block.load_state_dict(convert.to_state_dict(variables, block),
                          strict=True)
    want = jnn.apply(jblock, variables, *jargs, train=train, mutable=train)
    if train:
        want, new_vars = want
    block.train(train)
    with torch.no_grad():
        got = block(*targs)
    if kind == "down":
        (got, idx), (want, want_idx) = got, want
        np.testing.assert_array_equal(_window_positions(idx),
                                      _nchw(want_idx))
    assert got.shape == _nchw(want).shape
    np.testing.assert_allclose(got.numpy(), _nchw(want), atol=ATOL,
                               rtol=RTOL)
    if train:
        stats = dict(_leaves(
            convert.to_variables(block.state_dict(), block)["stats"]))
        for path, ref in _leaves(new_vars["stats"]):
            np.testing.assert_allclose(stats[path], np.asarray(ref),
                                       atol=1e-5, rtol=1e-5)


# --- the whole network, full width and depth ---------------------------------

@pytest.fixture(scope="module")
def jax_model_and_shapes():
    jmodel = jax_build_model("enet", CLASSES)
    shapes = jax.eval_shape(
        lambda k: jmodel.init(k, jnp.zeros((1, 64, 128, 3), jnp.float32)),
        jax.random.PRNGKey(0))
    return jmodel, shapes


@pytest.fixture(scope="module")
def pair(jax_model_and_shapes):
    """(JAX model, numpy variables, port model with those weights); BN
    running stats from one momentum-1 train pass of the port over seeded
    images (dropout off), so eval-mode features vary."""
    jmodel, shapes = jax_model_and_shapes
    variables = _random_variables(shapes, np.random.RandomState(0))
    model = build_model("enet", CLASSES, device="cpu")
    model.load_state_dict(convert.to_state_dict(variables, model),
                          strict=True)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    rates = {m: m.rate for m in model.modules()
             if isinstance(m, SpatialDropout)}
    for bn in bns:
        bn.momentum = 1.0
    for drop in rates:
        drop.rate = 0.0
    calib = np.random.RandomState(5).randn(2, 3, 64, 128).astype(np.float32)
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
    return np.random.RandomState(1).randn(2, 3, 64, 128).astype(np.float32)


def test_registry_and_param_count(jax_model_and_shapes):
    """``enet`` is registered without an alias, as in the reference; the
    parameter count and the dropout rates are the reference's."""
    assert "enet" in available_models()
    model = build_model("ENet", CLASSES, device="cpu")
    assert type(model).__name__ == "ENet" and model.LOGITS_TAIL == "conv"
    params = jax_model_and_shapes[1]["params"]
    n_params = sum(int(np.prod(v.shape)) for _, v in _leaves(params))
    assert count_params(model) == n_params
    jmodel = jax_model_and_shapes[0]
    assert model.down1.drop.rate == jmodel.down1.drop.rate == 0.01
    assert model.stage1[3].drop.rate == 0.01
    assert model.stage3[7].drop.rate == jmodel.stage3.layers[7].drop.rate \
        == 0.1
    if not torch.cuda.is_available():     # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            build_model("enet", CLASSES)


def test_convert_round_trip_is_bit_exact(jax_model_and_shapes):
    """reference tree -> state_dict -> port model -> state_dict -> tree;
    the state_dict keys are the reference's variable paths; the
    transposed convs' kernels are flipped on the way in and back."""
    variables = _random_variables(jax_model_and_shapes[1],
                                  np.random.RandomState(7))
    leaves = dict(_leaves(variables))
    model = build_model("enet", CLASSES, device="cpu")
    sd = convert.to_state_dict(variables, model)
    assert set(sd) == set(model.state_dict())
    for key in ("initial.conv.weight", "down1.reduce.0.weight",
                "stage2.3.core.0.weight", "stage2.2.core.1.weight",
                "up4.up.0.weight", "up5.skip_conv.1.running_var",
                "stage1.0.out_act.weight", "fullconv.weight"):
        assert key in sd
    model.load_state_dict(sd, strict=True)
    for name, ref in (("up4.up.0", variables["params"]["up4"]["up"]["0"]),
                      ("up5.up.0", variables["params"]["up5"]["up"]["0"]),
                      ("fullconv", variables["params"]["fullconv"])):
        k = ref["kernel"]                                # (kh, kw, in, out)
        w = sd[name + ".weight"].numpy()                 # (in, out, kh, kw)
        assert w.shape == (k.shape[2], k.shape[3], 3, 3)
        np.testing.assert_array_equal(
            w, k[::-1, ::-1].transpose(2, 3, 0, 1))
    # a square conv kernel beside them keeps the conv layout
    k = variables["params"]["stage4"]["0"]["core"]["0"]["kernel"]
    np.testing.assert_array_equal(sd["stage4.0.core.0.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    back = dict(_leaves(convert.to_variables(model.state_dict(), model)))
    assert set(back) == set(leaves)
    for path, want in leaves.items():
        got = back[path]
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg="/".join(path))
    # gradients and moments cross by the same rules
    named = {n: p.detach() for n, p in model.named_parameters()}
    tree = dict(_leaves(convert.params_tree(named, model)))
    for path, want in _leaves(variables["params"]):
        np.testing.assert_array_equal(tree[path], want)
    again = convert.params_state_dict(variables["params"], model)
    for name, p in named.items():
        assert torch.equal(again[name], p), name


def test_logits_match_reference(pair, images):
    """f32 logits of the full-depth ENet-19 at 2x3x64x128 on converted,
    calibrated weights: |d| <= 1e-4 of the logits' std + 1e-4 |ref| (f32
    sums in other orders through ~100 convs; measured 2e-6 of the std)."""
    jmodel, variables, model = pair
    want = _nchw(jnn.apply(jmodel, variables, _nhwc(images)))
    with torch.no_grad():
        got = model(torch.from_numpy(images)).numpy()
    assert got.shape == want.shape == (2, CLASSES, 64, 128)
    std = float(want.std())
    assert std > 0.05             # the weights make non-trivial logits
    np.testing.assert_allclose(got, want, atol=1e-4 * std, rtol=1e-4)


def test_predict_step_matches_reference(pair, images):
    """The port's argmax of the full-resolution logits against the
    reference's ``method="predict"`` (its fused subpixel head): mismatch
    rate <= 1e-4, and only at near-ties, where the reference's f32 logits
    of the two classes lie within 1e-4 (relative) of each other."""
    jmodel, variables, model = pair
    x = _nhwc(images)
    want = np.asarray(jnn.apply(jmodel, variables, x, method="predict"))
    got = make_predict_step(model)(torch.from_numpy(images)).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape == (2, 64, 128)
    assert len(np.unique(want)) > 5
    diff = got != want
    assert diff.mean() <= 1e-4, diff.mean()
    if diff.any():
        logits = np.asarray(jnn.apply(jmodel, variables, x))[diff]
        a = np.take_along_axis(logits, got[diff][:, None], -1)
        b = np.take_along_axis(logits, want[diff][:, None], -1)
        assert np.all(np.abs(a - b) <= 1e-4 * np.maximum(1, np.abs(b)))
