"""Train steps with the config-5 loss (class-weighted CE + OHEM on the
full-resolution logits) against the JAX reference, on the CPU: ENet-19
and Fast-SCNN-19 through ``make_train_step`` with ``fwd_method=None``
(OHEM needs full-resolution logits, so Fast-SCNN's step leaves the fused
resize-CE route for the model's own bilinear tail).

The same numpy weights, converted with ``esn_tpu_torch.convert`` (given
the port's model: ENet has transposed convs), f32, adam + poly. Dropout
is off (rate 0) on both sides: the two draw different masks. The
reference runs with its plain stem (``ESN_TPU_S2D_STEM=0``).
Gradients are held against the reference's own math in f64
(``jax_enable_x64``), as ``tests/test_torch_train.py`` does and for its
reasons: loosely for the f32 step, strictly for the port's model run in
f64. Tolerances are stated below.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from esn_tpu import nn as jnn
from esn_tpu.models import build_model as jax_build_model
from esn_tpu.train import losses as JL
from esn_tpu.train import optimizers as JO
from esn_tpu.train import schedules as JS
from esn_tpu.train.state import TrainState
from esn_tpu.train.step import make_train_step as jax_make_train_step

from esn_tpu_torch import convert
from esn_tpu_torch.models import build_model
from esn_tpu_torch.nn import Dropout
from esn_tpu_torch.train import losses as L
from esn_tpu_torch.train import optimizers as O
from esn_tpu_torch.train import schedules as S
from esn_tpu_torch.train.step import make_train_step

CLASSES = 19
BATCH = 2
SIZES = {"enet": (64, 128), "fastscnn": (128, 256)}
LR, TOTAL = 4.5e-4, 100
# Tolerances (f32 on both sides unless said otherwise). At this size BN
# sees few values a channel and the gradient is ill-conditioned in f32:
# the port's f32 gradient of ENet moves by 3e-3 (median over leaves) and
# up to 1.6e-2 when the two images of the batch swap places, and lies
# 8.7e-3 (median) and up to 3.9e-2 from an f64 run of the reference's
# math, where the port's own math in f64 lies within 6e-6 of it. So:
# - loss: |d| <= 1e-5 relative, against the reference's f32 step and the
#   f64 oracle;
# - gradients, the strict check: the port's model in f64 (the loss stays
#   f32) against the oracle, per-leaf rel-L2 <= 1e-4, plus
#   an absolute 1e-6 for leaves whose true gradient is ~0;
# - gradients of the f32 step against the oracle: per-leaf rel-L2 <=
#   GRAD_F32 (Fast-SCNN 1e-2, as tests/test_torch_train.py; ENet 8e-2,
#   twice the largest reading above), plus the absolute 1e-6;
# - Adam moments after the step against the reference's update rule on
#   the step's own gradient (mu = (1-b1)(g + wd p), nu alike with the
#   square): rel-L2 <= 1e-5;
# - params: |d| <= 2*lr against the reference's step (Adam moves each
#   element by ~lr*sign(g));
# - BN running stats: atol = rtol = 1e-4.
LOSS_REL, GRAD_F64, ABS, STAT_TOL = 1e-5, 1e-4, 1e-6, 1e-4
GRAD_F32 = {"enet": 8e-2, "fastscnn": 1e-2}
B1, B2, WD = 0.9, 0.999, 1e-4


@pytest.fixture(autouse=True)
def _plain_stem(monkeypatch):
    monkeypatch.setenv("ESN_TPU_S2D_STEM", "0")


def _random_variables(tree, rng):
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
            elif name == "alpha":
                v = rng.uniform(0.1, 0.4, shape)
            else:
                v = rng.randn(*shape) * 0.1
            out[name] = np.asarray(v, np.float32)
        return out
    return {coll: fill(tree[coll]) for coll in ("params", "stats")}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


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


def _batch(seed, hw):
    """Seeded smooth images and labels a network can fit (the argmax of a
    smooth random 19-class field) with a band of ignored rows; the
    reference's class weights from their histogram."""
    rng = np.random.RandomState(seed)
    h, w = hw

    def smooth(c, f):
        low = rng.randn(BATCH, h // f, w // f, c).astype(np.float32)
        return np.asarray(jax.image.resize(low, (BATCH, h, w, c), "linear"))

    img = smooth(3, 32) + 0.1 * rng.randn(BATCH, h, w, 3).astype(np.float32)
    lab = np.argmax(smooth(CLASSES, 16), -1).astype(np.int32)
    lab[:, h // 2 - 4:h // 2 + 4] = 255
    hist = np.bincount(lab[lab != 255], minlength=CLASSES).astype(np.float64)
    cw = (1.0 / np.log(1.10 + hist / hist.sum())).astype(np.float32)
    return img.astype(np.float32), lab, cw


def _jax_loss(cw):
    def loss(logits, labels):
        return (JL.cross_entropy(logits, labels, num_classes=CLASSES,
                                 class_weights=cw)
                + JL.ohem_cross_entropy(logits, labels, num_classes=CLASSES))
    return loss


def _port_loss(cw):
    def loss(logits, labels):
        return (L.cross_entropy(logits, labels, num_classes=CLASSES,
                                class_weights=cw)
                + L.ohem_cross_entropy(logits, labels, num_classes=CLASSES))
    return loss


@pytest.fixture(scope="module", params=["enet", "fastscnn"])
def setup(request):
    """Reference model (dropout off) with numpy variables, its adam + poly
    train step with CE + OHEM on the full-resolution logits, and the
    batch."""
    arch = request.param
    hw = SIZES[arch]
    jmodel = jax_build_model(arch, CLASSES)
    _reference_dropout_off(jmodel)
    shapes = jax.eval_shape(
        lambda k: jmodel.init(k, jnp.zeros((1, *hw, 3), jnp.float32)),
        jax.random.PRNGKey(0))
    variables = _random_variables(shapes, np.random.RandomState(0))
    img, lab, cw = _batch(1, hw)
    sched = JS.poly_schedule(LR, TOTAL)
    tx = JO.build_optimizer("adam", sched)
    step = jax_make_train_step(jmodel, _jax_loss(jnp.asarray(cw)), tx,
                               schedule=sched, donate=False)
    return dict(arch=arch, jmodel=jmodel, variables=variables, tx=tx,
                step=step, img=img, lab=lab, cw=cw,
                batch={"image": jnp.asarray(img), "label": jnp.asarray(lab)})


def _port(s):
    model = build_model(s["arch"], CLASSES, device="cpu")
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    model.load_state_dict(convert.to_state_dict(s["variables"], model),
                          strict=True)
    opt = O.build_optimizer("adam", model.parameters())
    assert L.fused_resize_ce_spec(model, "ohem") == (None, None)
    step = make_train_step(model, _port_loss(torch.from_numpy(s["cw"])), opt,
                           schedule=S.build_schedule("poly", LR, TOTAL),
                           fwd_method=None)
    return model, opt, step


def _oracle(s, monkeypatch):
    """The reference's loss and per-leaf gradient in f64. Its OHEM
    threshold comes from ``lax.top_k`` here (``ESN_TPU_OHEM_TOPK=1``, the
    reference's own switch, bit-identical by its tests): the radix select
    reads 32-bit patterns and does not trace under x64."""
    monkeypatch.setenv("ESN_TPU_OHEM_TOPK", "1")
    def loss(params, stats, images, labels):
        logits, _ = jnn.apply(s["jmodel"], {"params": params, "stats": stats},
                              images, train=True, mutable=True)
        return _jax_loss(jnp.asarray(s["cw"], jnp.float64))(logits, labels)

    jax.config.update("jax_enable_x64", True)
    try:
        v = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a), jnp.float64),
            s["variables"])
        value, grads = jax.jit(jax.value_and_grad(loss))(
            v["params"], v["stats"], jnp.asarray(s["img"], jnp.float64),
            jnp.asarray(s["lab"]))
        return float(value), dict(_leaves(jax.tree_util.tree_map(
            np.asarray, grads)))
    finally:
        jax.config.update("jax_enable_x64", False)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _close(got, ref, rel, atol=ABS):
    return np.linalg.norm(got - ref) <= rel * np.linalg.norm(ref) + atol


def test_ce_ohem_step_matches_reference(setup, monkeypatch):
    """One adam + poly step with CE + OHEM from converted weights: the
    loss, per-leaf gradients, Adam moments, params and BN running stats
    after the step."""
    s = setup
    jstate = TrainState.create(s["variables"], s["tx"])
    jnew, jm = s["step"](jstate, s["batch"], jax.random.PRNGKey(0))
    model, opt, step = _port(s)
    metrics = step({
        "image": torch.from_numpy(s["img"].transpose(0, 3, 1, 2).copy()),
        "label": torch.from_numpy(s["lab"])})
    assert step.count == 1
    assert metrics["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    loss, want = float(metrics["loss"]), float(jm["loss"])
    assert abs(loss - want) <= LOSS_REL * abs(want), (loss, want)
    value, grads = _oracle(s, monkeypatch)
    assert abs(loss - value) <= LOSS_REL * abs(value), (loss, value)

    named = {n: p.grad for n, p in model.named_parameters()}
    assert all(g is not None and bool(torch.isfinite(g).all())
               for g in named.values())
    got = dict(_leaves(convert.params_tree(named, model)))
    assert set(got) == set(grads)
    for path, ref in grads.items():
        assert _close(got[path].astype(np.float64), ref,
                      GRAD_F32[s["arch"]]), (path, _rel(got[path], ref))

    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    ref_sd = convert.to_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": jnew.params, "stats": jnew.stats}), model)
    assert set(ref_sd) == set(sd)
    for key, ref in ref_sd.items():
        ref = ref.numpy()
        if "running_" in key:
            np.testing.assert_allclose(sd[key], ref, atol=STAT_TOL,
                                       rtol=STAT_TOL, err_msg=key)
        else:
            assert np.all(np.abs(sd[key] - ref) <= 2 * LR + 1e-7), key
    count, mu, nu = convert.adam_state(opt, model)
    assert count == int(convert._find_adam(jnew.opt_state).count) == 1
    p0 = dict(_leaves(s["variables"]["params"]))
    mu, nu = dict(_leaves(mu)), dict(_leaves(nu))
    for path, g in got.items():
        gt = g.astype(np.float64) + WD * p0[path].astype(np.float64)
        want_mu, want_nu = (1 - B1) * gt, (1 - B2) * gt * gt
        assert _close(mu[path], want_mu, 1e-5, 1e-9), (
            path, _rel(mu[path], want_mu))
        assert _close(nu[path], want_nu, 1e-5, 1e-15), (
            path, _rel(nu[path], want_nu))

    # the strict check of the backward's math: the port in f64
    model, _, _ = _port(s)
    model.double().train()
    logits = model(torch.from_numpy(
        s["img"].transpose(0, 3, 1, 2).copy()).double())
    loss64 = _port_loss(torch.from_numpy(s["cw"]))(
        logits.permute(0, 2, 3, 1), torch.from_numpy(s["lab"]))
    loss64.backward()
    assert abs(float(loss64.detach()) - value) <= LOSS_REL * abs(value)
    got = dict(_leaves(convert.params_tree(
        {n: p.grad for n, p in model.named_parameters()}, model)))
    for path, ref in grads.items():
        assert _close(got[path], ref, GRAD_F64), (path,
                                                  _rel(got[path], ref))


def test_adam_state_round_trip_with_transposed_convs(setup):
    """optax adam state -> torch.optim.Adam -> reference trees, bit for
    bit; the moments of a transposed conv's kernel are transposed and
    flipped as the kernel is."""
    s = setup
    rng = np.random.RandomState(3)
    mu = jax.tree_util.tree_map(
        lambda p: rng.randn(*p.shape).astype(np.float32),
        s["variables"]["params"])
    nu = jax.tree_util.tree_map(np.abs, mu)
    state = (optax.EmptyState(),
             optax.ScaleByAdamState(count=jnp.asarray(5, jnp.int32),
                                    mu=mu, nu=nu),
             optax.EmptyState())
    model = build_model(s["arch"], CLASSES, device="cpu")
    opt = O.build_optimizer("adam", model.parameters())
    convert.load_adam_state(opt, model, state)
    if s["arch"] == "enet":
        for w, ref in ((model.fullconv.weight, mu["fullconv"]["kernel"]),
                       (model.up4.up[0].weight,
                        mu["up4"]["up"]["0"]["kernel"])):
            np.testing.assert_array_equal(
                opt.state[w]["exp_avg"].numpy(),
                ref[::-1, ::-1].transpose(2, 3, 0, 1))
        w = model.stage4[0].core[0].weight          # a conv of equal shape
        np.testing.assert_array_equal(
            opt.state[w]["exp_avg_sq"].numpy(),
            nu["stage4"]["0"]["core"]["0"]["kernel"].transpose(3, 2, 0, 1))
    count, mu2, nu2 = convert.adam_state(opt, model)
    assert count == 5
    for a, b in ((mu2, mu), (nu2, nu)):
        la, lb = dict(_leaves(a)), dict(_leaves(b))
        assert set(la) == set(lb)
        for path in lb:
            np.testing.assert_array_equal(la[path], lb[path])
