"""The port's CGNet and its blocks against the JAX reference, on the CPU.

Weights are drawn with numpy into the reference's variables tree (its
structure from ``jax.eval_shape`` of the reference init), converted with
``esn_tpu_torch.convert`` and run through both packages: the same inputs,
f32, tolerances stated per test. The reference runs its plain XLA path
(and, where a test says so, its fused eval path through the plain
``cgblock_pre_ref``); the port runs the plain versions of its kernels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esn_tpu import nn as jnn
from esn_tpu.models import blocks as JB
from esn_tpu.models import build_model as jax_build_model
from esn_tpu.models import cgnet as JCG
from esn_tpu.train.step import make_predict_step as jax_make_predict_step

from esn_tpu_torch import convert
from esn_tpu_torch.models import available_models, build_model
from esn_tpu_torch.models import blocks as B
from esn_tpu_torch.models.cgnet import CGBlock
from esn_tpu_torch.nn import (BatchNorm, Dense, SpatialDropout,
                              set_dropout_generator)
from esn_tpu_torch.ops import kernels as K
from esn_tpu_torch.train.step import make_predict_step
from esn_tpu_torch.utils import count_params

CLASSES = 19
N_PARAMS = 496_306        # CGNet-19, M=3, N=21
ATOL = RTOL = 1e-4        # f32 re-association (convs, folded BN, the GAP)


def _random_variables(tree, rng):
    """numpy values for every leaf of a reference variables tree: conv and
    Dense kernels ~ N(0, 2/fan_in), BN affines and running stats and PReLU
    slopes non-trivial."""
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
    return {coll: fill(tree[coll]) for coll in ("params", "stats")}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _jax_variables(module, shape, rng):
    shapes = jax.eval_shape(lambda k: module.init(k, jnp.zeros(shape)),
                            jax.random.PRNGKey(0))
    return _random_variables(shapes, rng)


def _nhwc(x):
    return jnp.asarray(x.transpose(0, 2, 3, 1))


# --- layers and blocks -----------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_matches_reference(dtype):
    """The kernel cast to x's dtype, an f32 product rounded to x's dtype,
    the bias added in x's dtype: equal to the reference to f32
    association (bf16: to one rounding, 2^-8 relative, of the result)."""
    rng = np.random.RandomState(0)
    x = rng.randn(3, 16).astype(np.float32)
    jd = jnn.Dense(16, 4)
    variables = _jax_variables(jd, (1, 16), rng)
    want = np.asarray(jnn.apply(jd, variables,
                                jnp.asarray(x).astype(dtype)), np.float32)
    d = Dense(16, 4)
    d.load_state_dict(convert.to_state_dict(variables), strict=True)
    got = d(torch.from_numpy(x).to(getattr(torch, dtype))).float()
    tol = 1e-6 if dtype == "float32" else 2.0 ** -8
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol,
                               rtol=tol)


def test_spatial_dropout_drops_whole_channels():
    x = torch.ones((2, 6, 5, 7))
    drop = SpatialDropout(0.5)
    assert torch.equal(drop.eval()(x), x)
    drop.train()
    with pytest.raises(RuntimeError, match="generator"):
        drop(x)
    model = torch.nn.Sequential(drop)
    set_dropout_generator(model, torch.Generator().manual_seed(0))
    y = drop(x)
    per_map = y.flatten(2)
    assert torch.all((per_map == 0).all(-1) | (per_map == 2.0).all(-1))
    assert 0 < int((per_map[..., 0] == 0).sum()) < 12
    set_dropout_generator(model, torch.Generator().manual_seed(0))
    assert torch.equal(drop(x), y)


@pytest.mark.parametrize("kind", ["conv_bn_act", "input_injection"])
def test_new_blocks_match_reference(kind):
    """ConvBNAct with BN eps 1e-3 (eval and train) and InputInjection's
    cascaded 3x3/s2 average pools."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 13, 15).astype(np.float32)
    if kind == "input_injection":
        want = jnn.apply(JB.InputInjection(2), {}, _nhwc(x))
        got = B.InputInjection(2)(torch.from_numpy(x))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), atol=1e-6, rtol=1e-6)
        return
    jblock = JB.ConvBNAct(8, 6, 3, act="prelu", bn_eps=1e-3)
    variables = _jax_variables(jblock, (1, 13, 15, 8), rng)
    block = B.ConvBNAct(8, 6, 3, act="prelu", bn_eps=1e-3)
    block.load_state_dict(convert.to_state_dict(variables), strict=True)
    assert block.conv.padding == 1 and block.bn.eps == 1e-3
    for train in (False, True):
        want = jnn.apply(jblock, variables, _nhwc(x), train=train,
                         mutable=train)
        want = want[0] if train else want
        block.train(train)
        with torch.no_grad():
            got = block(torch.from_numpy(x))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), atol=ATOL, rtol=RTOL)


def _cgblock_pair(ch, d, red, rng, hw=(12, 16)):
    jblock = JCG.CGBlock(ch, d, red)
    variables = _jax_variables(jblock, (1, *hw, ch), rng)
    block = CGBlock(ch, d, red)
    block.load_state_dict(convert.to_state_dict(variables), strict=True)
    return jblock, variables, block


@pytest.mark.parametrize("fused_env", ["0", "1"])
@pytest.mark.parametrize("ch, d, red", [(64, 2, 8), (128, 4, 16)])
def test_cgblock_eval_matches_reference(ch, d, red, fused_env, monkeypatch):
    """Eval: the port's block (one fused_cgblock_pre call, its plain
    version on the CPU, then the gate) against the reference's plain
    block (ESN_TPU_FUSED_CG=0) and its fused eval path (=1), perturbed BN
    statistics and affines, f32."""
    monkeypatch.setenv("ESN_TPU_FUSED_CG", fused_env)
    rng = np.random.RandomState(2)
    jblock, variables, block = _cgblock_pair(ch, d, red, rng)
    x = rng.randn(2, ch, 12, 16).astype(np.float32)
    want = np.asarray(jnn.apply(jblock, variables, _nhwc(x)))
    before = dict(K.LAUNCHES)
    with torch.no_grad():
        got = block.eval()(torch.from_numpy(x))
        composed = block.forward_composed(torch.from_numpy(x))
    assert K.LAUNCHES == before
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(composed.numpy(), got.numpy(), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("ch, d, red", [(64, 2, 8), (128, 4, 16)])
def test_cgblock_train_matches_reference(ch, d, red):
    """Train mode: the composed path with batch-stat BN; the output and
    the updated running stats against the reference's train apply."""
    rng = np.random.RandomState(3)
    jblock, variables, block = _cgblock_pair(ch, d, red, rng)
    x = rng.randn(2, ch, 12, 16).astype(np.float32) * 2 + 0.5
    want, new_vars = jnn.apply(jblock, variables, _nhwc(x), train=True,
                               mutable=True)
    with torch.no_grad():
        got = block.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=ATOL, rtol=RTOL)
    stats = dict(_leaves(convert.to_variables(block.state_dict())["stats"]))
    for path, ref in _leaves(new_vars["stats"]):
        np.testing.assert_allclose(stats[path], np.asarray(ref), atol=1e-5,
                                   rtol=1e-5)


# --- the whole network, full width and depth -----------------------------

@pytest.fixture(scope="module")
def jax_model_and_shapes():
    jmodel = jax_build_model("cgnet", CLASSES)
    shapes = jax.eval_shape(
        lambda k: jmodel.init(k, jnp.zeros((1, 64, 128, 3), jnp.float32)),
        jax.random.PRNGKey(0))
    return jmodel, shapes


@pytest.fixture(scope="module")
def pair(jax_model_and_shapes):
    """(JAX model, numpy variables, port model with those weights); BN
    running stats from one momentum-1 train pass of the port over seeded
    images, so eval-mode features vary."""
    jmodel, shapes = jax_model_and_shapes
    variables = _random_variables(shapes, np.random.RandomState(0))
    model = build_model("cgnet", CLASSES, device="cpu")
    model.load_state_dict(convert.to_state_dict(variables), strict=True)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.momentum = 1.0
    calib = np.random.RandomState(5).randn(2, 3, 64, 128).astype(np.float32)
    with torch.no_grad():
        model.train()(torch.from_numpy(calib))
    for bn in bns:
        bn.momentum = 0.1
    model.eval()
    return jmodel, convert.to_variables(model.state_dict()), model


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(1).randn(2, 3, 64, 128).astype(np.float32)


def test_registry_and_param_count(jax_model_and_shapes):
    assert "cgnet" in available_models()
    for name in ("CGNet", "context_guided_network"):
        assert type(build_model(name, 3, device="cpu")).__name__ == "CGNet"
    model = build_model("cgnet", CLASSES, device="cpu")
    assert count_params(model) == N_PARAMS
    params = jax_model_and_shapes[1]["params"]
    assert sum(int(np.prod(v.shape)) for _, v in _leaves(params)) == N_PARAMS


def test_convert_round_trip_is_bit_exact(jax_model_and_shapes):
    """reference tree -> state_dict -> port model -> state_dict -> tree,
    Dense kernels (in, out) <-> (out, in) included."""
    variables = _random_variables(jax_model_and_shapes[1],
                                  np.random.RandomState(7))
    leaves = dict(_leaves(variables))
    model = build_model("cgnet", CLASSES, device="cpu")
    sd = convert.to_state_dict(variables)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    fc1 = variables["params"]["stage3"]["19"]["glo"]["fc1"]["kernel"]
    assert fc1.shape == (128, 8)
    np.testing.assert_array_equal(sd["stage3.19.glo.fc1.weight"].numpy(),
                                  fc1.T)
    back = dict(_leaves(convert.to_variables(model.state_dict())))
    assert set(back) == set(leaves)
    for path, want in leaves.items():
        got = back[path]
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg="/".join(path))


@pytest.mark.parametrize("method", ["logits_lowres", "forward"])
def test_logits_match_reference(pair, images, method, monkeypatch):
    """f32 logits of the full-depth network on converted, calibrated
    weights against the reference with its plain stem
    (ESN_TPU_FOLDED_STEM=0): atol = rtol = 1e-4."""
    monkeypatch.setenv("ESN_TPU_FOLDED_STEM", "0")
    jmodel, variables, model = pair
    want = np.asarray(jnn.apply(
        jmodel, variables, _nhwc(images),
        method=None if method == "forward" else method))
    with torch.no_grad():
        got = getattr(model, method)(torch.from_numpy(images))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert want.std() > 0.05      # the weights make non-trivial logits
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_predict_step_matches_reference(pair, images, monkeypatch):
    """Mismatch rate <= 1e-4, and only at near-ties: where the class maps
    differ, the reference's f32 full-res logits of the two classes lie
    within 1e-4 (relative) of each other."""
    monkeypatch.setenv("ESN_TPU_FOLDED_STEM", "0")
    jmodel, variables, model = pair
    x = _nhwc(images)
    want = np.asarray(jax_make_predict_step(jmodel)(variables, x))
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
