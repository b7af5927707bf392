"""The PyTorch port's Fast-SCNN against the JAX reference, on the CPU.

Weights are drawn with numpy into the reference's variables tree (its
structure from ``jax.eval_shape`` of the reference init), converted with
``esn_tpu_torch.convert`` and run through both packages: the same inputs,
f32, tolerances stated per test. The reference runs its plain XLA path
here (its Pallas kernels are TPU-only); the port runs the plain versions
of its kernels (a CPU tensor never reaches a CUDA kernel).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esn_tpu import nn as jnn
from esn_tpu.models import build_model as jax_build_model
from esn_tpu.train.step import make_predict_step as jax_make_predict_step

from esn_tpu_torch import convert
from esn_tpu_torch.models import available_models, build_model
from esn_tpu_torch.models.blocks import DSConv
from esn_tpu_torch.nn import BatchNorm, set_dropout_generator
from esn_tpu_torch.train.step import make_predict_step
from esn_tpu_torch.utils import count_params

CLASSES = 19
N_LEAVES = 222            # Fast-SCNN-19: params + BN running stats
N_PARAMS = 1_137_795


def _random_variables(tree, rng):
    """numpy values for every leaf of a reference variables tree: convs
    ~ N(0, 2/fan_in), BN affines and running stats non-trivial."""
    def fill(node, coll):
        out = {}
        for name, leaf in node.items():
            if isinstance(leaf, dict):
                out[name] = fill(leaf, coll)
                continue
            shape = leaf.shape
            if name == "kernel":
                fan_in = int(np.prod(shape[:-1]))
                v = rng.randn(*shape) * np.sqrt(2.0 / fan_in)
            elif name == "scale":
                v = rng.uniform(0.5, 1.5, shape)
            elif name in ("bias", "mean"):
                v = rng.randn(*shape) * 0.1
            elif name == "var":
                v = rng.uniform(0.5, 1.5, shape)
            else:
                raise KeyError(name)
            out[name] = np.asarray(v, np.float32)
        return out
    return {coll: fill(tree[coll], coll) for coll in ("params", "stats")}


def _calibrate_bn(model, images):
    """Running stats := the batch stats of ``images`` (one train pass at
    momentum 1), so eval-mode features vary and predictions are diverse."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.momentum = 1.0
    set_dropout_generator(model, torch.Generator().manual_seed(0))
    model.train()
    with torch.no_grad():
        model(images)
    for bn in bns:
        bn.momentum = 0.1
    return model.eval()


@pytest.fixture(scope="module")
def jax_model_and_shapes():
    jmodel = jax_build_model("fastscnn", CLASSES)
    shapes = jax.eval_shape(
        lambda k: jmodel.init(k, jnp.zeros((1, 64, 128, 3), jnp.float32)),
        jax.random.PRNGKey(0))
    return jmodel, shapes


@pytest.fixture(scope="module")
def pair(jax_model_and_shapes):
    """(JAX model, numpy variables, port model with those weights)."""
    jmodel, shapes = jax_model_and_shapes
    variables = _random_variables(shapes, np.random.RandomState(0))
    model = build_model("fastscnn", CLASSES, device="cpu")
    model.load_state_dict(convert.to_state_dict(variables), strict=True)
    calib = np.random.RandomState(5).randn(2, 3, 128, 256).astype(np.float32)
    _calibrate_bn(model, torch.from_numpy(calib))
    variables = convert.to_variables(model.state_dict())
    return jmodel, variables, model


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(1).randn(2, 3, 128, 256).astype(np.float32)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_registry_aliases():
    assert "fastscnn" in available_models()
    for name in ("FastSCNN", "fast_scnn", "fast-scnn"):
        assert type(build_model(name, 3, device="cpu")).__name__ == "FastSCNN"
    with pytest.raises(KeyError):
        build_model("no_such_model", 3)


def test_build_model_defaults_to_the_card(monkeypatch):
    """No device: the CUDA device, and on a machine without one a raise,
    never a quiet CPU build; ``device="cpu"`` builds on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("fastscnn", CLASSES)
    model = build_model("fastscnn", CLASSES, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}


def test_count_params():
    model = build_model("fastscnn", CLASSES, device="cpu")
    assert count_params(model) == N_PARAMS


def test_init_is_seeded():
    def g(s):
        return build_model("fastscnn", CLASSES, device="cpu",
                           generator=torch.Generator().manual_seed(s))
    a, b, c = (g(s).state_dict() for s in (3, 3, 4))
    key = "ltd.conv.conv.weight"
    assert torch.equal(a[key], b[key]) and not torch.equal(a[key], c[key])


def test_convert_round_trip_is_bit_exact(jax_model_and_shapes):
    """reference tree -> state_dict -> port model -> state_dict -> tree."""
    variables = _random_variables(jax_model_and_shapes[1],
                                  np.random.RandomState(7))
    leaves = dict(_leaves(variables))
    assert len(leaves) == N_LEAVES
    model = build_model("fastscnn", CLASSES, device="cpu")
    sd = convert.to_state_dict(variables)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    back = dict(_leaves(convert.to_variables(model.state_dict())))
    assert set(back) == set(leaves)
    for path, want in leaves.items():
        got = back[path]
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg="/".join(path))


def test_convert_layouts(pair):
    _, variables, _ = pair
    sd = convert.to_state_dict(variables)
    p = variables["params"]
    dw = p["ltd"]["ds1"]["dw"]["conv"]["kernel"]            # (3, 3, 1, 32)
    np.testing.assert_array_equal(
        sd["ltd.ds1.dw.conv.weight"].numpy(), dw.transpose(3, 2, 0, 1))
    assert tuple(sd["ltd.ds1.dw.conv.weight"].shape) == (32, 1, 3, 3)
    np.testing.assert_array_equal(sd["gfe.ppm.reduce2.bn.weight"].numpy(),
                                  p["gfe"]["ppm"]["reduce2"]["bn"]["scale"])
    np.testing.assert_array_equal(
        sd["gfe.s1.0.expand.bn.running_var"].numpy(),
        variables["stats"]["gfe"]["s1"]["0"]["expand"]["bn"]["var"])


@pytest.mark.parametrize("method", ["logits_lowres", "forward"])
def test_logits_match_reference(pair, images, method):
    """fp32 logits on converted weights: atol 1e-4, rtol 1e-4 (f32
    re-association of convs and of the fused dsconv's folded BN)."""
    jmodel, variables, model = pair
    x = jnp.asarray(images.transpose(0, 2, 3, 1))
    want = np.asarray(jnn.apply(
        jmodel, variables, x,
        method=None if method == "forward" else method))
    with torch.no_grad():
        got = getattr(model, method)(torch.from_numpy(images))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert want.std() > 0.05      # the weights make non-trivial logits
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


# bf16: both packages round activations and weights to bf16 (unit
# roundoff u = 2^-9) at their own points and sum in f32, so neither equals
# the other; what each package's bf16 rounding does at this size is its
# distance from the f32 function, and the reference's own reading of it is
# the yardstick: the port's bf16 logits lie no further from the reference's
# f32 logits than BF16_TO_F32_RATIO times the reference's bf16 logits do.
# Random weights amplify the rounding ~100x here (readings while writing
# this test, rel-L2 to the f32 logits: reference 0.234 / 0.201, port 0.184
# / 0.159 for logits_lowres / forward; port to reference bf16 0.220 /
# 0.189). A port that skipped the rounding (f32 throughout) would lie
# ~1e-5 away: the test also asks for at least 2^-9.
BF16_TO_F32_RATIO = 1.25


@pytest.mark.parametrize("method", ["logits_lowres", "forward"])
def test_bf16_logits_as_close_to_f32_as_the_reference(pair, images, method):
    jmodel, variables, model = pair
    x = jnp.asarray(images.transpose(0, 2, 3, 1))
    m = None if method == "forward" else method
    f32 = np.asarray(jnn.apply(jmodel, variables, x, method=m), np.float64)
    ref = np.asarray(jnn.apply(jmodel, variables, x.astype(jnp.bfloat16),
                               method=m).astype(jnp.float32), np.float64)
    xb = torch.from_numpy(images).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        got = getattr(model, method)(xb)
    assert got.dtype == torch.bfloat16
    got = got.float().permute(0, 2, 3, 1).numpy().astype(np.float64)

    def rel(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    assert got.shape == ref.shape == f32.shape
    assert 2.0 ** -9 <= rel(got, f32) <= BF16_TO_F32_RATIO * rel(ref, f32), \
        (rel(got, f32), rel(ref, f32))


def test_predict_step_matches_reference(pair, images):
    """Mismatch rate <= 1e-4, and only at near-ties: where the class maps
    differ, the reference's f32 full-res logits of the two classes lie
    within 1e-4 (relative) of each other."""
    jmodel, variables, model = pair
    x = jnp.asarray(images.transpose(0, 2, 3, 1))
    want = np.asarray(jax_make_predict_step(jmodel)(variables, x))
    got = make_predict_step(model)(torch.from_numpy(images)).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape == (2, 128, 256)
    assert len(np.unique(want)) > 10
    diff = got != want
    assert diff.mean() <= 1e-4, diff.mean()
    if diff.any():
        logits = np.asarray(jnn.apply(jmodel, variables, x))[diff]
        a = np.take_along_axis(logits, got[diff][:, None], -1)
        b = np.take_along_axis(logits, want[diff][:, None], -1)
        assert np.all(np.abs(a - b) <= 1e-4 * np.maximum(1, np.abs(b)))


def test_predict_output_size_branch(pair, images):
    jmodel, variables, model = pair
    x = jnp.asarray(images.transpose(0, 2, 3, 1))
    want = np.asarray(jax_make_predict_step(jmodel, output_size=(96, 200))(
        variables, x))
    got = make_predict_step(model, output_size=(96, 200))(
        torch.from_numpy(images)).numpy()
    assert got.shape == want.shape == (2, 96, 200)
    assert (got != want).mean() <= 1e-4


@pytest.mark.parametrize("stride", [1, 2])
def test_dsconv_block_train_mode_matches_reference(stride):
    """Train mode: the composed dw -> pw path with batch-stat BN; output
    and the updated running stats against the reference's train apply."""
    from esn_tpu.models.blocks import DSConv as JDSConv
    rng = np.random.RandomState(2)
    x = rng.randn(2, 6, 11, 13).astype(np.float32) * 2 + 0.5
    jblock = JDSConv(6, 12, stride=stride)
    shapes = jax.eval_shape(
        lambda k: jblock.init(k, jnp.zeros((1, 11, 13, 6))),
        jax.random.PRNGKey(0))
    variables = _random_variables(shapes, rng)
    want, new_vars = jnn.apply(jblock, variables,
                               jnp.asarray(x.transpose(0, 2, 3, 1)),
                               train=True, mutable=True)
    block = DSConv(6, 12, stride=stride)
    block.load_state_dict(convert.to_state_dict(variables), strict=True)
    block.train()
    with torch.no_grad():
        got = block(torch.from_numpy(x))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-4, rtol=1e-4)
    stats = dict(_leaves(convert.to_variables(block.state_dict())["stats"]))
    for path, ref in _leaves(new_vars["stats"]):
        np.testing.assert_allclose(stats[path], np.asarray(ref),
                                   atol=1e-5, rtol=1e-5)


def test_dsconv_block_eval_fused_matches_composed():
    """Eval: the fused call (folded BN, plain version on the CPU) equals
    the composed dw -> pw path of the same block."""
    rng = np.random.RandomState(3)
    block = DSConv(8, 12, stride=2).eval()
    sd = block.state_dict()
    for k, v in sd.items():
        if k.endswith("running_var") or k.endswith("bn.weight"):
            sd[k] = torch.from_numpy(rng.uniform(0.5, 1.5, v.shape)).float()
        else:
            sd[k] = torch.from_numpy(rng.randn(*v.shape) * 0.3).float()
    block.load_state_dict(sd)
    x = torch.from_numpy(rng.randn(2, 8, 15, 17).astype(np.float32))
    with torch.no_grad():
        fused = block(x)
        composed = block.forward_composed(x)
    np.testing.assert_allclose(fused.numpy(), composed.numpy(),
                               atol=1e-5, rtol=1e-5)
