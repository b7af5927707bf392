"""The port's ``radam`` and ``ranger`` (``esn_tpu_torch/train/optimizers.py``)
against the JAX package's ``build_optimizer`` (optax's ``scale_by_radam``,
the reference's ``lookahead``), on the CPU.

Parameters and gradients come from numpy seeds; both sides take the same
gradients, weight decay and a learning rate that changes every step (the
reference's schedule, set into the port's ``param_groups`` as its train
step does). Tolerances are stated beside each test.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from esn_tpu.train import checkpoint as jax_ckpt
from esn_tpu.train.optimizers import build_optimizer as jax_build_optimizer
from esn_tpu.train.state import TrainState as JaxTrainState
from esn_tpu_torch import convert
from esn_tpu_torch.models import build_model
from esn_tpu_torch.train import checkpoint as ckpt
from esn_tpu_torch.train.optimizers import RAdam, Ranger, build_optimizer
from esn_tpu_torch.train.state import TrainState

STEPS = 14
SHAPES = [(3, 4), (5,), (2, 2, 3), (7, 1, 3, 3)]
LRS = [1e-2 * (1 + 0.1 * i) for i in range(STEPS)]
WD = 1e-2
# The port computes optax's f32 scalars (beta^t, rho_t, r_t, the bias
# corrections) with optax's operations and the moments with the same
# formulas; what differs is the order of f32 roundings inside an element's
# update (an FMA here or there). Read: 3.0e-8 (radam) and 1.2e-10 (ranger)
# at most on parameters of size ~1 over 14 steps.
PARAM_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's tests (six workers in tier-1)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(seed=0, shapes=SHAPES):
    rng = np.random.RandomState(seed)
    p0 = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(STEPS)]
    return p0, grads


def _jax_run(name, p0, grads, weight_decay=WD, **kw):
    """The reference's optimizer over ``STEPS`` steps: the parameters and
    the optimizer state after each."""
    tx = jax_build_optimizer(name, lambda c: jnp.asarray(LRS)[c],
                             weight_decay=weight_decay, **kw)
    params = {str(i): jnp.asarray(a) for i, a in enumerate(p0)}
    state = tx.init(params)
    update = jax.jit(tx.update)
    out = []
    for g in grads:
        u, state = update({str(i): jnp.asarray(a) for i, a in enumerate(g)},
                          state, params)
        params = optax.apply_updates(params, u)
        out.append(([np.asarray(params[str(i)]) for i in range(len(p0))],
                    state))
    return out


def _port_params(p0):
    return [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in p0]


def _port_step(opt, params, g, lr):
    for p, a in zip(params, g):
        p.grad = torch.from_numpy(a.copy())
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()


@pytest.mark.parametrize("name", ["radam", "ranger"])
@pytest.mark.parametrize("scale,wd", [(1.0, WD), (1e-8, 0.0)])
def test_matches_the_reference_over_14_steps(name, scale, wd):
    """Every parameter after every step within PARAM_ATOL of the
    reference's; for ranger also the slow weights (the reference's
    ``LookaheadState.slow_params``), and the syncs at steps 6 and 12.
    Gradients of size 1e-8 (no decay) make sqrt(v̂) as small as eps,
    where optax's ``sqrt(v̂) + eps`` and torch's ``(sqrt(v) + eps) /
    sqrt(1 - b2^t)`` part (by ~1e-4 a step here)."""
    p0, grads = _problem()
    grads = [[g * np.float32(scale) for g in step] for step in grads]
    want = _jax_run(name, p0, grads, weight_decay=wd)
    params = _port_params(p0)
    opt = build_optimizer(name, params, weight_decay=wd)
    assert type(opt) is (Ranger if name == "ranger" else RAdam)
    for t in range(STEPS):
        _port_step(opt, params, grads[t], LRS[t])
        ref_params, ref_state = want[t]
        for p, r in zip(params, ref_params):
            np.testing.assert_allclose(p.detach().numpy(), r, rtol=0,
                                       atol=PARAM_ATOL, err_msg=f"step {t + 1}")
        if name == "ranger":
            slow = ref_state.slow_params
            for i, p in enumerate(params):
                np.testing.assert_allclose(
                    opt.state[p]["slow"].numpy(), np.asarray(slow[str(i)]),
                    rtol=0, atol=PARAM_ATOL, err_msg=f"slow, step {t + 1}")
            assert int(ref_state.count) == int(opt.state[params[0]]["step"])
            if (t + 1) % 6 == 0:        # a sync: fast reset to slow
                for p in params:
                    assert torch.equal(opt.state[p]["slow"], p.detach())


def _rho_crossing(trajectory):
    """The first step whose update is not the bias-corrected momentum: with
    a constant gradient 1, lr 1 and no decay, m̂ = v̂ = 1 (up to the f32
    bias corrections), so the unrectified step moves a parameter by 1 and
    the rectified one by r_t (0.026 at b2 = 0.999's crossing, below 0.2 at
    the others')."""
    sizes = -np.diff(np.concatenate([[0.0], trajectory]))
    t = next(t for t, d in enumerate(sizes) if d < 0.5)
    np.testing.assert_allclose(sizes[:t], 1.0, rtol=1e-5)
    return t + 1


@pytest.mark.parametrize("b2", [0.999, 0.99, 0.95, 0.997405499])
def test_rho_crosses_the_threshold_at_the_references_step(b2):
    """The step at which rho_t first reaches 5 (the sixth at b2 = 0.999)
    is optax's, and so is r_t at every step: a parameter's trajectory
    within 1e-6 relative of the reference's (f32 scalars with optax's
    operations; read: 0 to 1.2e-7). At b2 = 0.997405499 rho_5 is 5.0
    exactly in f32: optax rectifies there (rho >= 5), where torch's RAdam
    would wait a step (rho > 5)."""
    tx = optax.chain(optax.scale_by_radam(b2=b2), optax.scale(-1.0))
    params = {"w": jnp.zeros((4,), jnp.float32)}
    state = tx.init(params)
    # jitted, as the reference's train step runs it: eagerly, optax takes
    # beta2^t with a concrete exponent by repeated products, another f32
    # value, and 1 - beta2^t magnifies the difference (r_6 0.6% apart)
    update = jax.jit(tx.update)
    ref = []
    for _ in range(STEPS):
        u, state = update({"w": jnp.ones((4,), jnp.float32)}, state, params)
        params = optax.apply_updates(params, u)
        ref.append(float(params["w"][0]))
    p = torch.nn.Parameter(torch.zeros(4))
    opt = RAdam([p], lr=1.0, betas=(0.9, b2))
    got = []
    for _ in range(STEPS):
        p.grad = torch.ones(4)
        opt.step()
        got.append(float(p.detach()[0]))
    assert _rho_crossing(got) == _rho_crossing(ref)
    if b2 in (0.999, 0.997405499):
        assert _rho_crossing(got) == (6 if b2 == 0.999 else 5)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def test_lookahead_syncs_slow_toward_fast():
    """At steps 6 and 12 the parameters are slow + 0.5 (fast - slow), with
    slow the weights before the step and fast a twin RAdam's step from the
    same state and gradients (bit for bit: the same f32 operations);
    between syncs the slow weights stay put."""
    p0, grads = _problem(1)
    params = _port_params(p0)
    opt = Ranger(params, weight_decay=WD)
    syncs = []
    for t in range(STEPS):
        for p, a in zip(params, grads[t]):
            p.grad = torch.from_numpy(a.copy())
        for group in opt.param_groups:
            group["lr"] = LRS[t]
        slow = ([opt.state[p]["slow"].clone() for p in params] if t
                else [p.detach().clone() for p in params])
        twin_params = [p.detach().clone() for p in params]
        twin = RAdam(twin_params, weight_decay=WD)
        if t:
            twin.load_state_dict(copy.deepcopy(opt.state_dict()))
        for tp, p in zip(twin_params, params):
            tp.grad = p.grad.clone()
            tp.requires_grad_()
        for group in twin.param_groups:
            group["lr"] = LRS[t]
        twin.step()
        opt.step()
        if (t + 1) % 6 == 0:
            syncs.append(t + 1)
            for p, s, f in zip(params, slow, twin_params):
                assert torch.equal(p.detach(), s + 0.5 * (f.detach() - s))
                assert torch.equal(opt.state[p]["slow"], p.detach())
        else:
            for p, s, f in zip(params, slow, twin_params):
                assert torch.equal(p.detach(), f.detach())
                assert torch.equal(opt.state[p]["slow"], s)
    assert syncs == [6, 12]


@pytest.mark.parametrize("name", ["radam", "ranger"])
def test_resume_from_state_dict_is_bit_exact(name):
    """Seven steps, the optimizer's ``state_dict`` into a new optimizer
    over copies of the parameters, seven more: bit for bit the run of 14
    (the second half crosses ranger's sync at step 12 from the slow weights
    of the first half)."""
    p0, grads = _problem(2)
    straight = _port_params(p0)
    opt = build_optimizer(name, straight, weight_decay=WD)
    for t in range(STEPS):
        _port_step(opt, straight, grads[t], LRS[t])
    first = _port_params(p0)
    opt = build_optimizer(name, first, weight_decay=WD)
    for t in range(7):
        _port_step(opt, first, grads[t], LRS[t])
    saved = copy.deepcopy(opt.state_dict())
    resumed = [torch.nn.Parameter(p.detach().clone()) for p in first]
    opt = build_optimizer(name, resumed, weight_decay=WD)
    opt.load_state_dict(saved)
    for t in range(7, STEPS):
        _port_step(opt, resumed, grads[t], LRS[t])
    for a, b in zip(straight, resumed):
        assert torch.equal(a, b)


def _tree_grads(model, seed, steps):
    """Seeded gradient trees in the reference's layout for ``model``'s
    parameters, and the same as the port's named tensors."""
    rng = np.random.RandomState(seed)
    trees = []
    for _ in range(steps):
        named = {n: rng.randn(*p.shape).astype(np.float32) * 0.1
                 for n, p in model.named_parameters()}
        tree = convert.params_tree({n: torch.from_numpy(a)
                                    for n, a in named.items()}, model)
        trees.append((tree, named))
    return trees


@pytest.mark.parametrize("name", ["radam", "ranger"])
def test_a_jax_checkpoint_resumes_in_the_port(tmp_path, name):
    """The reference's radam/ranger takes seven steps on Fast-SCNN's
    parameters and writes its ``.ckpt`` (``TrainState`` with the optax
    state: ``ScaleByAdamState`` in the chain, ranger's ``LookaheadState``
    around it); the port's ``load_checkpoint`` reads it into its model and
    optimizer, and the next five steps (to ranger's sync at step 12, from
    the checkpoint's slow weights) give the reference's parameters within
    PARAM_ATOL."""
    model = build_model("fastscnn", 19, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    variables = convert.to_variables(model.state_dict(), model)
    grads = _tree_grads(model, 3, 12)
    lrs = [1e-3 * (1 + 0.1 * i) for i in range(12)]
    tx = jax_build_optimizer(name, lambda c: jnp.asarray(lrs)[c])
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = tx.init(params)
    update = jax.jit(tx.update)
    for t in range(12):
        if t == 7:
            path = jax_ckpt.save_checkpoint(
                str(tmp_path), 1, JaxTrainState(
                    jax.device_get(params), variables["stats"],
                    jax.device_get(state), np.asarray(7, np.int32)))
        u, state = update(jax.tree_util.tree_map(jnp.asarray, grads[t][0]),
                          state, params)
        params = optax.apply_updates(params, u)

    port = build_model("fastscnn", 19, device="cpu")
    opt = build_optimizer(name, port.parameters())
    loaded, _ = ckpt.load_checkpoint(path, TrainState(port, opt))
    assert loaded.step == 7
    first = next(iter(port.parameters()))
    assert int(opt.state[first]["step"]) == 7
    assert ("slow" in opt.state[first]) == (name == "ranger")
    named = dict(port.named_parameters())
    for t in range(7, 12):
        for n, p in named.items():
            p.grad = torch.from_numpy(grads[t][1][n].copy())
        for group in opt.param_groups:
            group["lr"] = lrs[t]
        opt.step()
    want = convert.params_state_dict(jax.device_get(params), port)
    for n, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   rtol=0, atol=PARAM_ATOL, err_msg=n)


def test_a_restored_ranger_state_loads_through_convert():
    """``convert.load_optimizer_state`` takes the reference's ranger state
    live and as a checkpoint restores it (flax writes ``LookaheadState``
    under its field names): per parameter the RAdam moments, the count and
    the slow weights bit for bit; a state without Lookahead raises."""
    model = build_model("fastscnn", 19, device="cpu")
    variables = convert.to_variables(model.state_dict(), model)
    tx = jax_build_optimizer("ranger", 1e-3)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = tx.init(params)
    grads = _tree_grads(model, 4, 1)[0][0]
    _, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), state,
                         params)
    live = jax.device_get(state)
    restored = serialization.msgpack_restore(serialization.msgpack_serialize(
        serialization.to_state_dict(live)))
    assert set(restored) == {"inner", "slow_params", "count"}
    mu = convert.params_state_dict(convert._find_adam(live).mu, model)
    slow = convert.params_state_dict(live.slow_params, model)
    for opt_state in (live, restored):
        opt = build_optimizer("ranger", model.parameters())
        convert.load_optimizer_state(opt, model, opt_state)
        for n, p in model.named_parameters():
            s = opt.state[p]
            assert float(s["step"]) == 1.0
            assert torch.equal(s["exp_avg"], mu[n])
            assert torch.equal(s["slow"], slow[n])
    with pytest.raises(ValueError, match="lookahead"):
        convert.load_optimizer_state(
            build_optimizer("ranger", model.parameters()), model,
            jax.device_get(jax_build_optimizer("radam", 1e-3).init(params)))
