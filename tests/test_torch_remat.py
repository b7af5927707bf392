"""``make_train_step(..., remat=True)`` in the port: the forward recomputed
during the backward (a non-reentrant ``torch.utils.checkpoint`` with the
``nn.Recompute`` contexts), on the CPU.

In f32 a step with remat equals the step without it bit for bit: the
loss, every gradient, the BN running statistics and the parameters after
the optimizer's step, with dropout on (Fast-SCNN's ``Dropout``, ENet's
``SpatialDropout``) and under ``grad_accum`` 1 and 2. Then one step
against the JAX package's own ``make_train_step(remat=True)`` from the
same weights (dropout off on both sides: they draw different masks).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (ABS, CLASSES, GRAD_F64, LOSS_REL, STAT_TOL,
                           as_f64, batch, init_shapes, random_variables,
                           reference_dropout_off, rel, x64)
from esn_tpu.models import build_model as jax_build_model
from esn_tpu.train import losses as JL
from esn_tpu.train import optimizers as JO
from esn_tpu.train import schedules as JS
from esn_tpu.train.state import TrainState as JaxTrainState
from esn_tpu.train.step import make_train_step as jax_make_train_step
from esn_tpu_torch import convert
from esn_tpu_torch.models import build_model
from esn_tpu_torch.nn import BatchNorm, Dropout
from esn_tpu_torch.train import losses as L
from esn_tpu_torch.train import optimizers as O
from esn_tpu_torch.train import schedules as S
from esn_tpu_torch.train.step import make_train_step
from _torch_parity import one_torch_thread, plain_reference  # noqa: F401
from _torch_parity import LR, TOTAL


def _step(arch, loss, grad_accum, remat, seed=0):
    """One adam + poly step of ``arch`` (seeded init, dropout on) with
    ``loss`` (a CE-family loss on a resize-tail model through
    ``logits_lowres`` and the resize-CE kernel's plain version); returns
    the loss and the model's gradients, buffers and parameters after it."""
    model = build_model(arch, CLASSES, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    assert any(m.rate > 0 for m in model.modules() if isinstance(m, Dropout))
    fused, method = L.fused_resize_ce_spec(model, loss)
    step = make_train_step(
        model, partial(fused or L.build_loss(loss), num_classes=CLASSES),
        O.build_optimizer("adam", model.parameters()),
        schedule=S.build_schedule("poly", LR, TOTAL), fwd_method=method,
        grad_accum=grad_accum, remat=remat,
        generator=torch.Generator().manual_seed(5))
    rng = np.random.RandomState(seed + 1)
    images = torch.from_numpy(rng.randn(4, 3, 64, 128).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, CLASSES + 1, (4, 64, 128))
                              .astype(np.int32))
    labels[labels == CLASSES] = 255
    value = step({"image": images, "label": labels})["loss"]
    return (value, {n: p.grad for n, p in model.named_parameters()},
            dict(model.named_buffers()), dict(model.named_parameters()))


@pytest.mark.parametrize("arch,loss", [("fastscnn", "ce"), ("enet", "ohem"),
                                       ("fastscnn", "lovasz")])
@pytest.mark.parametrize("grad_accum", [1, 2])
def test_remat_step_is_bit_identical(arch, loss, grad_accum):
    plain = _step(arch, loss, grad_accum, remat=False)
    remat = _step(arch, loss, grad_accum, remat=True)
    assert torch.equal(plain[0], remat[0])
    for got, want in zip(remat[1:], plain[1:]):
        assert set(got) == set(want)
        for name in want:
            assert torch.equal(got[name], want[name]), name


def test_recompute_keeps_running_mean_and_dropout_state():
    """What the recompute reads back: each BatchNorm the running mean its
    first run centred on (not the updated buffer), each Dropout its
    generator's state before the first draw; after the backward the
    modules hold no tape."""
    model = build_model("fastscnn", CLASSES, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    step = make_train_step(
        model, partial(L.cross_entropy, num_classes=CLASSES),
        O.build_optimizer("adam", model.parameters()), remat=True,
        generator=torch.Generator().manual_seed(5))
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    means = [bn.running_mean.clone() for bn in bns]
    seen = {}
    forward = type(bns[0]).forward

    def spy(bn, x):
        tape = bn._tape
        if tape is not None and tape.replaying:
            seen.setdefault(bn, tape.values[0].clone())
        return forward(bn, x)

    type(bns[0]).forward = spy
    try:
        step({"image": torch.randn(2, 3, 64, 128),
              "label": torch.randint(0, CLASSES, (2, 64, 128))})
    finally:
        type(bns[0]).forward = forward
    assert set(seen) == set(bns)
    for bn, before in zip(bns, means):
        assert torch.equal(seen[bn], before)
        assert not torch.equal(bn.running_mean, before)
    assert all(m._tape is None for m in model.modules()
               if isinstance(m, (BatchNorm, Dropout)))


# Against the reference's remat step, both in f64 (the reference under
# x64, the port's model in f64, its loss in f32 as its step casts the
# logits): f32 steps at this size are ill-conditioned (train-mode BN over
# few values; the port's and the reference's f32 gradients of the stem
# read 2.0e-2 apart). SGD + poly, dropout off; after one step SGD's
# momentum is the decayed gradient g + wd p on both sides (optax's
# ``trace``, torch's ``momentum_buffer``), held per leaf within GRAD_F64
# rel-L2 plus ABS (tests/_torch_parity.py: the f32 loss's rounding; a
# conv bias under a train-mode BN has gradient 0); the loss within
# LOSS_REL; the parameters within 2 lr |trace| + 1e-9 of the reference's;
# the BN statistics within STAT_TOL.


def test_remat_step_matches_the_references_remat_step():
    hw = (128, 256)
    jmodel = jax_build_model("fastscnn", CLASSES)
    reference_dropout_off(jmodel)
    shapes = init_shapes(jmodel, jnp.zeros((1, *hw, 3), jnp.float32))
    variables = random_variables(shapes, np.random.RandomState(0))
    img, lab, cw = batch(1, hw)
    sched = JS.poly_schedule(LR, TOTAL)

    def jloss(logits, labels):
        return JL.cross_entropy(logits, labels, num_classes=CLASSES,
                                class_weights=jnp.asarray(cw, jnp.float64))
    with x64():
        tx = JO.build_optimizer("sgd", sched)
        jstep = jax_make_train_step(jmodel, jloss, tx, schedule=sched,
                                    compute_dtype=jnp.float64, donate=False,
                                    remat=True)
        v = as_f64(variables)
        state = JaxTrainState(v["params"], v["stats"], tx.init(v["params"]),
                              jnp.int32(0))
        state, metrics = jstep(state, {"image": jnp.asarray(img, jnp.float64),
                                       "label": jnp.asarray(lab)},
                               jax.random.PRNGKey(0))
        state = jax.device_get(state)
    model = build_model("fastscnn", CLASSES, device="cpu")
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    model.load_state_dict(convert.to_state_dict(variables, model),
                          strict=True)
    model.double()
    want = convert.to_state_dict({"params": state.params,
                                  "stats": state.stats}, model)
    trace = convert.params_state_dict(convert._find_fields(
        state.opt_state, ("trace",))[0], model)
    fused, method = L.fused_resize_ce_spec(model, "ce")
    opt = O.build_optimizer("sgd", model.parameters())
    step = make_train_step(
        model, partial(fused, num_classes=CLASSES,
                       class_weights=torch.from_numpy(cw)),
        opt, schedule=S.build_schedule("poly", LR, TOTAL), fwd_method=method,
        compute_dtype=torch.float64, remat=True)
    loss = float(step({"image": torch.from_numpy(
        img.transpose(0, 3, 1, 2).copy()), "label": torch.from_numpy(lab)})
        ["loss"])
    assert abs(loss - float(metrics["loss"])) <= LOSS_REL * abs(loss)
    got = model.state_dict()
    for name, p in model.named_parameters():
        buf, ref = opt.state[p]["momentum_buffer"], trace[name].double()
        assert (float((buf - ref).norm())
                <= GRAD_F64 * float(ref.norm()) + ABS), (
            name, rel(buf.numpy(), ref.numpy()))
        assert float((got[name] - want[name]).abs().max()) <= (
            2 * LR * float(ref.abs().max()) + 1e-9), name
    for name, b in model.named_buffers():
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   atol=STAT_TOL, rtol=STAT_TOL,
                                   err_msg=name)
