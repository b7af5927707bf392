"""The port's training path against the JAX reference, on the CPU.

Schedules, optimizers, Dropout, and Fast-SCNN-19 train steps through
``esn_tpu_torch.train.step.make_train_step`` against
``esn_tpu.train.step.make_train_step`` on the same numpy weights,
converted with ``esn_tpu_torch.convert``, in f32. Dropout is off (rate 0)
on both sides in the step parity tests: the two draw different masks.
The reference's loss runs its exact scan resize-CE here; the port's runs
the plain version of its resize-CE kernel. Tolerances are stated per test.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

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
from esn_tpu_torch.train.step import fold_in, make_train_step

CLASSES = 19
BATCH, HW = 2, (128, 256)
LR, TOTAL = 4.5e-4, 100


# ---------------------------------------------------------------- schedules

@pytest.mark.parametrize("name, kw", [
    ("poly", {}),
    ("poly", {"power": 2.0}),
    ("warmpoly", {"warmup_steps": 7, "warmup_factor": 0.25}),
    ("warmpoly", {"warmup_steps": 0}),
    ("constant", {}),
])
def test_schedule_matches_reference(name, kw):
    """lr(step) for steps 0..T+5 (past T the poly clips at 0). The
    reference computes in f32, the port in double: rel 1e-6, and abs
    1e-7 of the base lr near T, where f32's ``1 - t`` cancels."""
    want = JS.build_schedule(name, 0.01, 40, **kw)
    got = S.build_schedule(name, 0.01, 40, **kw)
    for step in range(46):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-9, err_msg=f"step {step}")
    with pytest.raises(KeyError):
        S.build_schedule("cosine", 0.01, 40)


# --------------------------------------------------------------- optimizers

@pytest.mark.parametrize("name", ["sgd", "adam", "adamw"])
def test_optimizer_update_matches_optax(name):
    """Three updates at a fixed lr on the same params and gradients (so
    momentum and bias correction take part): f32 in other association,
    so atol 1e-6, a few ulps of params of order 2."""
    rng = np.random.RandomState(0)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    lr = 0.01
    tx = JO.build_optimizer(name, lr, weight_decay=0.05)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = O.build_optimizer(name, list(tp.values()), weight_decay=0.05)
    opt.param_groups[0]["lr"] = lr
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=0, err_msg=k)
    with pytest.raises(KeyError):
        O.build_optimizer("ranger", list(tp.values()))


# ------------------------------------------------------------------ dropout

def _drop(x, seed, rate=0.25):
    d = Dropout(rate).train()
    d.generator = torch.Generator().manual_seed(seed)
    return d(x)


def test_dropout_mask_from_explicit_generator():
    """Same seed, same mask; other seed or a later draw, another mask;
    the global RNG is untouched; kept values scaled by 1/keep; the keep
    rate within 5 standard deviations of a binomial(n, 0.75)."""
    x = torch.ones(64, 64, 32)
    n = x.numel()
    state = torch.random.get_rng_state()
    a, b, c = _drop(x, 1), _drop(x, 1), _drop(x, 2)
    assert torch.equal(torch.random.get_rng_state(), state)
    assert torch.equal(a, b) and not torch.equal(a, c)
    d = Dropout(0.25).train()
    d.generator = torch.Generator().manual_seed(1)
    first, second = d(x), d(x)
    assert torch.equal(first, a) and not torch.equal(first, second)
    assert set(torch.unique(a).tolist()) == {0.0, float(x[0, 0, 0] / 0.75)}
    kept = float((a != 0).float().sum())
    sd = (n * 0.75 * 0.25) ** 0.5
    assert abs(kept - 0.75 * n) <= 5 * sd


def test_dropout_identity_in_eval_and_at_rate_zero_and_needs_generator():
    x = torch.randn(2, 3, 4, 5)
    assert Dropout(0.5).eval()(x) is x
    assert Dropout(0.0).train()(x) is x
    with pytest.raises(RuntimeError, match="generator"):
        Dropout(0.5).train()(x)


def test_train_step_dropout_masks_per_step_and_microbatch():
    """The step seeds each mask from (seed, step, microbatch): two runs
    from one seed agree, successive steps and microbatches differ."""
    assert fold_in(3, 0) == fold_in(3, 0)
    seeds = {fold_in(3, 0), fold_in(3, 1), fold_in(4, 0), fold_in(3, 0, 1),
             fold_in(3, 1, 0)}
    assert len(seeds) == 5 and all(0 <= s < 2 ** 63 for s in seeds)

    class Probe(torch.nn.Module):
        LOGITS_TAIL = "conv"

        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(()))
            self.drop = Dropout(0.5)
            self.masks = []

        def run(self, x, method=None):
            y = self.drop(x * self.w)
            self.masks.append(y.detach() != 0)
            return y

    def masks(seed, steps, ga=1):
        model = Probe()
        step = make_train_step(
            model, lambda y, lab: y.mean(),
            torch.optim.SGD(model.parameters(), lr=0.0), grad_accum=ga,
            generator=torch.Generator().manual_seed(seed))
        batch = {"image": torch.ones(2, 1, 8, 8),
                 "label": torch.zeros(2, 8, 8)}
        for _ in range(steps):
            step(batch)
        return model.masks

    a, b = masks(7, 2), masks(7, 2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])
    assert not torch.equal(a[0], masks(8, 1)[0])
    m = masks(7, 1, ga=2)
    assert not torch.equal(m[0], m[1])


# ---------------------------------------------------------- Fast-SCNN step

def _random_variables(tree, rng):
    """numpy values for every leaf of a reference variables tree: convs
    ~ N(0, 2/fan_in), BN affines and running stats non-trivial."""
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


def _batch(seed):
    """Seeded smooth images (a random field at 1/32 resolution, upsampled)
    and labels: the argmax of a smooth random 19-class field, with a band
    of ignore pixels."""
    rng = np.random.RandomState(seed)
    h, w = HW

    def smooth(c, f):
        low = rng.randn(BATCH, h // f, w // f, c).astype(np.float32)
        return np.asarray(jax.image.resize(low, (BATCH, h, w, c), "linear"))

    img = smooth(3, 32) + 0.1 * rng.randn(BATCH, h, w, 3).astype(np.float32)
    lab = np.argmax(smooth(CLASSES, 16), -1).astype(np.int32)
    lab[:, h // 2 - 4:h // 2 + 4] = 255
    hist = np.bincount(lab[lab != 255], minlength=CLASSES).astype(np.float64)
    cw = (1.0 / np.log(1.10 + hist / hist.sum())).astype(np.float32)
    return img.astype(np.float32), lab, cw


@pytest.fixture(scope="module")
def setup():
    """Reference model (dropout off) with numpy variables and its train
    step (adam + poly, fused resize-CE through logits_lowres), traced
    once; the batch."""
    jmodel = jax_build_model("fastscnn", CLASSES)
    jmodel.head.drop.rate = 0.0
    shapes = jax.eval_shape(
        lambda k: jmodel.init(k, jnp.zeros((1, 64, 128, 3), jnp.float32)),
        jax.random.PRNGKey(0))
    variables = _random_variables(shapes, np.random.RandomState(0))
    img, lab, cw = _batch(1)
    sched = JS.poly_schedule(LR, TOTAL)
    tx = JO.build_optimizer("adam", sched)
    loss = partial(JL.resize_cross_entropy, num_classes=CLASSES,
                   class_weights=jnp.asarray(cw))
    steps = {ga: jax_make_train_step(jmodel, loss, tx, schedule=sched,
                                     fwd_method="logits_lowres",
                                     grad_accum=ga, donate=False)
             for ga in (1, 2)}
    return dict(jmodel=jmodel, variables=variables, tx=tx, steps=steps,
                batch={"image": jnp.asarray(img), "label": jnp.asarray(lab)},
                img=img, lab=lab, cw=cw)


def _port(variables, cw, opt_state=None, count=0, grad_accum=1):
    """Port model with these variables, dropout off; its adam + poly train
    step through the fused-CE spec, at step ``count``."""
    model = build_model("fastscnn", CLASSES, device="cpu")
    model.head.drop.rate = 0.0
    model.load_state_dict(convert.to_state_dict(variables), strict=True)
    opt = O.build_optimizer("adam", model.parameters())
    if opt_state is not None:
        convert.load_adam_state(opt, model, opt_state)
    fused, method = L.fused_resize_ce_spec(model, "ce")
    loss = partial(fused, num_classes=CLASSES,
                   class_weights=torch.from_numpy(cw))
    step = make_train_step(model, loss, opt,
                           schedule=S.build_schedule("poly", LR, TOTAL),
                           fwd_method=method, grad_accum=grad_accum)
    step.count = count
    return model, opt, step


def _torch_batch(s):
    return {"image": torch.from_numpy(s["img"].transpose(0, 3, 1, 2).copy()),
            "label": torch.from_numpy(s["lab"])}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# Tolerances of the step parity (f32 on both sides, CPU). At this size
# (2x3x128x256: BN over as few as 2 values in the PPM) the gradient is
# ill-conditioned in f32. Measured against an f64 oracle (the reference's
# own math under jax_enable_x64) at the initial weights: the reference's
# f32 gradients are up to 3.9e-2 per-leaf rel-L2 off it (median 1.9e-2),
# the port's up to 3.7e-3; at the state after two steps the reference's
# f32 first moment is ~12% (all leaves together) from the port's, whose
# gradient stays within 1e-2 per leaf of the oracle; and a few leaves of
# the port's own f32 gradient move by several % with the number of CPU
# threads. So the gradient, and the Adam moments built from it, are held
# against the oracle, and the rest against the reference's f32 step:
# - loss: |d| <= 1e-5 relative; f32 sums over 65K pixels in other orders.
# - gradients: per-leaf rel-L2 <= 1e-2 against the oracle, plus an
#   absolute 1e-6 for leaves whose true gradient is ~0 (a BN bias whose
#   shift the next train-mode BN removes: |g| ~ 1e-8).
# - Adam moments after the step against the reference's update rule in
#   f64 on the oracle's gradient (mu = b1 mu' + (1-b1)(g + wd p'), nu
#   alike with the square): per-leaf rel-L2 <= 1e-2 for mu, 2e-2 for nu
#   (squared), plus the same absolute 1e-6 (1e-12 for nu).
# - params: |d| <= 2*lr against the reference's step. Adam's update is
#   ~lr*sign(g) per element, and f32 gradients disagree in sign where |g|
#   is within their error; the moments check the update's size and
#   direction.
# - BN running stats: atol = rtol = 1e-4, as the whole network's logits
#   in test_torch_fastscnn.py (f32 differences compound over its depth).
LOSS_REL, GRAD_RL2, ABS, STAT_TOL = 1e-5, 1e-2, 1e-6, 1e-4
B1, B2, WD = 0.9, 0.999, 1e-4


def _close(got, ref, rel, atol=ABS):
    return np.linalg.norm(got - ref) <= rel * np.linalg.norm(ref) + atol


def _compare_state(model, opt, jstate, jprev, grads):
    """After the port's step: params and BN stats against the reference's
    step (``jstate``); the step count; the Adam moments against the
    reference's update rule from ``jprev`` (its state before the step)
    with the oracle's gradients ``grads``."""
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    want = convert.to_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params, "stats": jstate.stats}))
    for key, ref in want.items():
        ref = ref.numpy()
        if "running_" in key:
            np.testing.assert_allclose(sd[key], ref, atol=STAT_TOL,
                                       rtol=STAT_TOL, err_msg=key)
        else:
            assert np.all(np.abs(sd[key] - ref) <= 2 * LR + 1e-7), key
    count, mu, nu = convert.adam_state(opt, model)
    assert count == int(convert._find_adam(jstate.opt_state).count)
    prev = convert._find_adam(jprev.opt_state)
    mu0, nu0 = dict(_leaves(prev.mu)), dict(_leaves(prev.nu))
    p0 = dict(_leaves(jprev.params))
    mu, nu = dict(_leaves(mu)), dict(_leaves(nu))
    for path, g in grads.items():
        gt = g + WD * p0[path].astype(np.float64)
        want_mu = B1 * mu0[path] + (1 - B1) * gt
        want_nu = B2 * nu0[path] + (1 - B2) * gt * gt
        assert _close(mu[path], want_mu, GRAD_RL2), (
            path, _rel(mu[path], want_mu))
        assert _close(nu[path], want_nu, 2 * GRAD_RL2, ABS ** 2), (
            path, _rel(nu[path], want_nu))


def _check_grads(model, oracle):
    """The port's gradients after its step against the f64 oracle."""
    grads = {n: p.grad for n, p in model.named_parameters()}
    got = dict(_leaves(convert.params_tree(grads, model)))
    assert set(got) == set(oracle)
    for path, ref in oracle.items():
        assert _close(got[path].astype(np.float64), ref, GRAD_RL2), (
            path, _rel(got[path], ref))


@pytest.fixture(scope="module")
def grad_oracle(setup):
    """``oracle(variables, images, labels) -> (loss, {path: grad})``: the
    reference's loss and gradient in f64 (jax_enable_x64): its
    train-mode forward through logits_lowres and
    cross_entropy(resize_bilinear(z)) (the scan resize-CE path takes
    int32 indices only). Traced once per batch shape."""
    from esn_tpu import nn as jnn
    from esn_tpu.ops.resize import resize_bilinear
    s = setup

    def loss(params, stats, images, labels):
        z, _ = jnn.apply(s["jmodel"], {"params": params, "stats": stats},
                         images, train=True, mutable=True,
                         method="logits_lowres")
        return JL.cross_entropy(
            resize_bilinear(z, HW), labels, num_classes=CLASSES,
            class_weights=jnp.asarray(s["cw"], jnp.float64))

    value_and_grad = jax.jit(jax.value_and_grad(loss))

    def oracle(variables, images, labels):
        jax.config.update("jax_enable_x64", True)
        try:
            v = jax.tree_util.tree_map(
                lambda a: jnp.asarray(np.asarray(a), jnp.float64), variables)
            value, grads = value_and_grad(
                v["params"], v["stats"], jnp.asarray(images, jnp.float64),
                jnp.asarray(labels))
            return float(value), dict(_leaves(jax.tree_util.tree_map(
                np.asarray, grads)))
        finally:
            jax.config.update("jax_enable_x64", False)
    return oracle


def _run_both(s, jstate, variables, opt_state=None, count=0, grad_accum=1):
    """The reference's step from ``jstate`` and the port's from the same
    state converted; both losses agree."""
    jnew, jm = s["steps"][grad_accum](jstate, s["batch"],
                                      jax.random.PRNGKey(0))
    model, opt, step = _port(variables, s["cw"], opt_state, count,
                             grad_accum)
    metrics = step(_torch_batch(s))
    assert step.count == count + 1
    assert metrics["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    loss, want = float(metrics["loss"]), float(jm["loss"])
    assert abs(loss - want) <= LOSS_REL * abs(want), (loss, want)
    return model, opt, jnew, loss


def test_train_step_matches_reference(setup, grad_oracle):
    """One step on converted weights: loss, per-leaf gradients, Adam
    moments, params and BN running stats after the step."""
    s = setup
    jstate = TrainState.create(s["variables"], s["tx"])
    model, opt, jnew, loss = _run_both(s, jstate, s["variables"])
    value, grads = grad_oracle(s["variables"], s["img"], s["lab"])
    assert abs(loss - value) <= LOSS_REL * abs(value)
    _check_grads(model, grads)
    _compare_state(model, opt, jnew, jstate, grads)


def test_resumed_step_matches_reference(setup, grad_oracle):
    """Two reference steps, the state (params, stats, Adam count/mu/nu)
    converted, then one more step on each side."""
    s = setup
    jstate = TrainState.create(s["variables"], s["tx"])
    for _ in range(2):
        jstate, _ = s["steps"][1](jstate, s["batch"], jax.random.PRNGKey(0))
    variables = jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params, "stats": jstate.stats})
    model, opt, jnew, _ = _run_both(s, jstate, variables, jstate.opt_state,
                                    count=2)
    grads = grad_oracle(variables, s["img"], s["lab"])[1]
    _check_grads(model, grads)
    _compare_state(model, opt, jnew, jstate, grads)


def test_grad_accum_step_matches_reference(setup, grad_oracle):
    """grad_accum=2: two microbatches of 1 image, BN stats threaded
    through them in order, gradients averaged, the mean loss. The oracle
    is the mean of the two images' gradients (the running stats that
    thread through only centre BN's moments, which leaves its output
    unchanged)."""
    s = setup
    jstate = TrainState.create(s["variables"], s["tx"])
    model, opt, jnew, _ = _run_both(s, jstate, s["variables"],
                                    grad_accum=2)
    per_image = [grad_oracle(s["variables"], s["img"][i:i + 1],
                             s["lab"][i:i + 1])[1] for i in range(BATCH)]
    grads = {k: sum(g[k] for g in per_image) / BATCH for k in per_image[0]}
    _check_grads(model, grads)
    _compare_state(model, opt, jnew, jstate, grads)


def test_adam_state_round_trip(setup):
    """optax adam state -> torch.optim.Adam -> reference trees, bit for
    bit, kernels in both layouts."""
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
    model = build_model("fastscnn", CLASSES, device="cpu")
    opt = O.build_optimizer("adam", model.parameters())
    convert.load_adam_state(opt, model, state)
    w = model.ltd.conv.conv.weight
    np.testing.assert_array_equal(
        opt.state[w]["exp_avg"].numpy(),
        mu["ltd"]["conv"]["conv"]["kernel"].transpose(3, 2, 0, 1))
    count, mu2, nu2 = convert.adam_state(opt, model)
    assert count == 5
    for a, b in ((mu2, mu), (nu2, nu)):
        la, lb = dict(_leaves(a)), dict(_leaves(b))
        assert set(la) == set(lb)
        for path in lb:
            np.testing.assert_array_equal(la[path], lb[path])


def test_convert_copies_and_never_aliases():
    """Both directions copy: a converted state_dict does not share memory
    with the reference's (read-only) arrays, and converted variables do
    not change when the model trains on in place."""
    w = jnp.arange(6, dtype=jnp.float32).reshape(1, 1, 2, 3)
    sd = convert.to_state_dict({"params": {"c": {"kernel": w}}})
    sd["c.weight"].add_(1.0)                 # would write into w's buffer
    np.testing.assert_array_equal(np.asarray(w),
                                  np.arange(6).reshape(1, 1, 2, 3))
    model = build_model("fastscnn", 3, device="cpu")
    tree = convert.to_variables(model.state_dict())
    before = tree["params"]["head"]["conv"]["bias"].copy()
    with torch.no_grad():
        model.head.conv.bias.add_(1.0)
    np.testing.assert_array_equal(tree["params"]["head"]["conv"]["bias"],
                                  before)
