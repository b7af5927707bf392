"""Rank-side cases of the data-parallel tests (``tests/test_torch_parallel_*.py``).

Each case is a module-level function that ``esn_tpu_torch.parallel.launch
.run_ranks`` runs on every rank of a gloo group on the CPU, and that the
test process also runs on its own, with no group, as the one-process
reference: with no group every ``parallel.mesh`` helper is the identity,
so the same code computes the one-process result. Arguments are global
numpy batches; each rank takes its rows (``mesh.shard_batch``). Results
come back as numpy.

This module imports neither JAX nor the reference, so each rank starts
quickly.
"""
import contextlib
import functools
import os
import types

import numpy as np
import torch

from esn_tpu_torch.models import build_model
from esn_tpu_torch.nn import BatchNorm, Dropout
from esn_tpu_torch.parallel import mesh
from esn_tpu_torch.parallel.launch import to_numpy
from esn_tpu_torch.train import losses as L
from esn_tpu_torch.train import optimizers as O
from esn_tpu_torch.train import schedules as S
from esn_tpu_torch.train.evaluation import run_eval
from esn_tpu_torch.train.step import make_eval_step, make_train_step

CLASSES = 19
LR, TOTAL = 4.5e-4, 100


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _numpy(fn):
    """The case's results as numpy, in a rank and in the test process."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        return to_numpy(fn(*args, **kwargs))
    return run


@_numpy
def helpers_case(seed: int):
    """global_sum and gather_rows: values and gradients of each rank's
    weighted sum of the result."""
    w = mesh.world()
    rng = np.random.RandomState(seed)
    xs, cs = rng.randn(w.size, 5), rng.randn(w.size, 5)
    gx, gc = rng.randn(w.size, 2, 3), rng.randn(w.size, 2 * w.size, 3)
    x = _t(xs[w.rank]).requires_grad_()
    y = mesh.global_sum(x)
    (y * _t(cs[w.rank])).sum().backward()
    xg = _t(gx[w.rank]).requires_grad_()
    g = mesh.gather_rows(xg)
    (g * _t(gc[w.rank])).sum().backward()
    counts = mesh.all_sum(torch.arange(3) + w.rank)     # int64
    return dict(y=y, dx=x.grad, g=g, dg=xg.grad, counts=counts,
                devices=mesh.rank_devices(), backend=w.backend,
                size=w.size, rank=w.rank)


@_numpy
def bn_case(x, cot, params, dtype="float64", route="forward", device="cpu"):
    """One training BatchNorm forward and backward on this rank's rows of
    ``x``; the gradients of the affine summed over the ranks. ``route``
    "kernels" takes K8's route (``BatchNorm._kernels``: the kernels on
    the card, their plain versions on the CPU) whatever the device;
    ``device`` "cuda": this rank's card."""
    dt = getattr(torch, dtype)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device == "cuda" else torch.device("cpu"))
    bn = BatchNorm(x.shape[1]).to(device=dev, dtype=dt)
    with torch.no_grad():
        for name, v in params.items():
            getattr(bn, name).copy_(_t(v))
    mine = mesh.shard_batch({"x": x, "c": cot})
    xr = _t(mine["x"]).to(device=dev, dtype=dt).requires_grad_()
    y = bn._kernels(xr) if route == "kernels" else bn(xr)
    (y * _t(mine["c"]).to(device=dev, dtype=dt)).sum().backward()
    mesh.all_reduce_grads(bn.parameters())
    return dict(y=y, dx=xr.grad, dweight=bn.weight.grad, dbias=bn.bias.grad,
                running_mean=bn.running_mean, running_var=bn.running_var)


LOSSES = {
    "ce": lambda lg, lb, cw: L.cross_entropy(
        lg, lb, num_classes=CLASSES, class_weights=cw),
    "label_smoothing": lambda lg, lb, cw: L.build_loss("label_smoothing")(
        lg, lb, num_classes=CLASSES, class_weights=cw),
    "ohem": lambda lg, lb, cw: L.ohem_cross_entropy(
        lg, lb, num_classes=CLASSES, class_weights=cw),
    "ohem_min_kept": lambda lg, lb, cw: L.ohem_cross_entropy(
        lg, lb, num_classes=CLASSES, class_weights=cw,
        min_kept=(3 * lg.shape[0] * lg.shape[1] * lg.shape[2]
                  * mesh.world().size) // 4),
    "focal": lambda lg, lb, cw: L.focal_loss(
        lg, lb, num_classes=CLASSES, class_weights=cw),
    "lovasz": lambda lg, lb, cw: L.lovasz_softmax(
        lg, lb, num_classes=CLASSES),
    "lovasz_hist": lambda lg, lb, cw: L.lovasz_softmax_hist(
        lg, lb, num_classes=CLASSES),
}


class _Thresholds:
    """Records every OHEM threshold the losses compute."""

    def __init__(self):
        self.values = []
        self._orig = L.ohem_threshold

    def __enter__(self):
        def record(*a, **k):
            t = self._orig(*a, **k)
            self.values.append(t.detach().clone())
            return t
        L.ohem_threshold = record
        return self

    def __exit__(self, *exc):
        L.ohem_threshold = self._orig


@_numpy
def loss_case(logits, labels, cw, z, zlabels):
    """Every loss (and the K3 route, ``resize_cross_entropy`` at r=4) on
    this rank's rows, f64: the value summed over the ranks, the gradient
    of this rank's rows, the OHEM thresholds."""
    mine = mesh.shard_batch({"lg": logits, "lb": labels, "z": z,
                             "zl": zlabels})
    cw_t = _t(cw)
    out = {}
    with _Thresholds() as th:
        for name, fn in LOSSES.items():
            lg = _t(mine["lg"]).requires_grad_()
            v = fn(lg, _t(mine["lb"]), cw_t)
            v.backward()
            out[name] = dict(value=mesh.all_sum(v.detach()), grad=lg.grad)
        for name, eps in (("resize_ce", 0.0), ("resize_ce_smooth", 0.1)):
            zz = _t(mine["z"]).requires_grad_()
            v = L.resize_cross_entropy(zz, _t(mine["zl"]),
                                       num_classes=CLASSES, class_weights=cw_t,
                                       label_smoothing=eps)
            v.backward()
            out[name] = dict(value=mesh.all_sum(v.detach()), grad=zz.grad)
    out["thresholds"] = th.values
    return out


@_numpy
def threshold_case(p_true, min_kept):
    """``ohem_threshold`` and ``kth_smallest`` of this rank's rows of
    ``p_true`` (flat per row)."""
    mine = _t(mesh.shard_batch({"p": p_true})["p"]).reshape(-1)
    return dict(threshold=L.ohem_threshold(mine, 0.7, min_kept),
                kth=L.kth_smallest(mine, min_kept))


# ------------------------------------------------------------- train steps
def _weights(cw):
    return _t(np.asarray(cw, np.float32))


def step_loss(name, cw):
    cw_t = _weights(cw)

    def ce(lg, lb):
        return L.cross_entropy(lg, lb, num_classes=CLASSES, class_weights=cw_t)

    def ce_ohem(lg, lb):
        return ce(lg, lb) + L.ohem_cross_entropy(lg, lb, num_classes=CLASSES)
    return {"ce": ce, "ce_ohem": ce_ohem}[name]


@_numpy
def step_case(arch, images, labels, cw, *, loss="ce_ohem", dtype="float64",
              grad_accum=1, remat=False, state=None, dropout=True, steps=1,
              seed=0):
    """``steps`` adam + poly steps of ``arch`` (weights from ``seed``, or
    ``state``: a state dict of numpy arrays) on this rank's rows of the
    global batch: each step's loss, the gradients of the last step, the
    BN statistics and parameters after the steps, the OHEM thresholds."""
    dt = getattr(torch, dtype)
    model = build_model(arch, CLASSES, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    if state is not None:
        model.load_state_dict({k: _t(v) for k, v in state.items()})
    if not dropout:
        for m in model.modules():
            if isinstance(m, Dropout):
                m.rate = 0.0
    model.to(dt)
    opt = O.build_optimizer("adam", model.parameters())
    mesh.broadcast_state(model, opt)
    step = make_train_step(model, step_loss(loss, cw), opt,
                           schedule=S.build_schedule("poly", LR, TOTAL),
                           compute_dtype=dt, grad_accum=grad_accum,
                           remat=remat,
                           generator=torch.Generator().manual_seed(7))
    mine = mesh.shard_batch({"image": images, "label": labels}, grad_accum)
    batch = {"image": _t(mine["image"]), "label": _t(mine["label"])}
    with _Thresholds() as th:
        losses = [step(batch)["loss"] for _ in range(steps)]
    return dict(
        loss=torch.stack(losses),
        grads={n: p.grad for n, p in model.named_parameters()},
        state=model.state_dict(), thresholds=th.values)


@contextlib.contextmanager
def planted(fault):
    """A rank that skips one of the step's collectives, planted in this
    process for the duration: ``local_normaliser`` (the losses divide by
    this rank's weight), ``local_bn_moments`` (BatchNorm takes this rank's
    moments), ``unsummed_grads`` (the loss is summed, the gradients not);
    ``none`` plants nothing."""
    from esn_tpu_torch.nn import layers
    swaps = {"none": [],
             "local_normaliser": [(L, "_normalised", lambda total, weight:
                                   total / torch.clamp(weight.detach(),
                                                       min=1e-8))],
             "local_bn_moments": [(layers, "mesh", types.SimpleNamespace(
                 active=lambda: False))],
             "unsummed_grads": [(mesh, "all_reduce_grads",
                                 lambda params, *extra: tuple(
                                     mesh.all_sum(e) for e in extra))]}[fault]
    real = [getattr(owner, name) for owner, name, _ in swaps]
    for owner, name, value in swaps:
        setattr(owner, name, value)
    try:
        yield
    finally:
        for (owner, name, _), value in zip(swaps, real):
            setattr(owner, name, value)


def fault_case(fault, *args, **kwargs):
    """``step_case`` with ``fault`` planted (:func:`planted`)."""
    with planted(fault):
        return step_case(*args, **kwargs)


@_numpy
def eval_case(arch, images, labels, loader_batch, seed=0):
    """``run_eval`` of ``arch`` (f32) over ``images`` in batches of
    ``loader_batch`` (the last one shorter): the confusion matrix and the
    rows ``per_image`` saw (rank 0 under a group)."""
    model = build_model(arch, CLASSES, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    step = make_eval_step(model, CLASSES)
    loader = [{"image": images[i:i + loader_batch],
               "label": labels[i:i + loader_batch]}
              for i in range(0, len(images), loader_batch)]
    seen = []
    cm = run_eval(step, loader, lambda x: x.permute(0, 3, 1, 2).float(),
                  CLASSES,
                  per_image=lambda i, pred, batch: seen.append(pred.copy()))
    return dict(cm=cm, preds=np.stack(seen) if seen else np.zeros(0))


# --------------------------------------------------------- trainer and CLIs
@_numpy
def trainer_case(cfg_kwargs, savedir, epochs=None, resume_epoch=None,
                 f64=False):
    """Fit a ``Trainer`` (``TrainConfig(**cfg_kwargs)``, savedir given);
    with ``resume_epoch``, from that epoch's checkpoint of ``savedir``'s
    run. ``f64`` runs the Trainer's model, steps and checkpoints in f64
    (a test-side switch: the model doubled, the steps' compute dtype f64,
    a resume reloaded into the f64 model), so that rounding does not
    hide what the ranks compute. The logged events, the model's state,
    the run dir's files and the log's header lines (rank 0's files)."""
    import json

    from esn_tpu_torch.train import checkpoint as ckpt
    from esn_tpu_torch.train.trainer import TrainConfig, Trainer
    cfg = TrainConfig(savedir=savedir, **cfg_kwargs)
    if resume_epoch is not None:
        cfg = TrainConfig(savedir=savedir + "_resumed",
                          resume=os.path.join(cfg.run_dir,
                                              f"model_{resume_epoch}.ckpt"),
                          **cfg_kwargs)
    trainer = Trainer(cfg)
    if f64:
        trainer.model.double()
        trainer.train_step.compute_dtype = torch.float64
        trainer.eval_step = make_eval_step(
            trainer.model, trainer.spec.num_classes,
            ignore_index=trainer.spec.ignore_label,
            compute_dtype=torch.float64)
        if cfg.resume:
            ckpt.load_checkpoint(cfg.resume, trainer.state)
    miou = trainer.fit(epochs)
    mesh.barrier()
    with open(os.path.join(cfg.run_dir, "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    with open(os.path.join(cfg.run_dir, "log.txt")) as f:
        header = f.read().splitlines()[:3]
    return dict(miou=miou, events=events, state=trainer.model.state_dict(),
                run_dir=cfg.run_dir, files=sorted(os.listdir(cfg.run_dir)),
                header=header, count=trainer.train_step.count,
                rows=None if trainer._rows is None else trainer._rows)


@_numpy
def cli_case(train_argv, test_argv):
    """``cli.train`` then ``cli.test`` on the checkpoint it wrote; the
    test CLI's printed lines (rank 0 prints)."""
    import contextlib
    import io

    from esn_tpu_torch.cli import test as test_cli
    from esn_tpu_torch.cli import train as train_cli
    train_cli.main(train_argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        test_cli.main(test_argv)
    return dict(lines=out.getvalue().splitlines())



def raise_case():
    """Rank 1 raises."""
    if mesh.world().rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return mesh.all_sum(torch.ones(1))


def hang_case():
    """Rank 0 waits in a collective that rank 1 never joins."""
    if mesh.world().rank == 0:
        mesh.all_sum(torch.ones(1))
    import time
    time.sleep(600)


@_numpy
def losses_case(inputs, p_true, min_kepts):
    """:func:`loss_case` for each named input set, and
    :func:`threshold_case` for each ``min_kept``."""
    out = {name: loss_case.__wrapped__(*args)
           for name, args in inputs.items()}
    out["select"] = [threshold_case.__wrapped__(p_true, k)
                     for k in min_kepts]
    return out


def many_case(calls):
    """Several cases in one spawn: ``calls`` is a list of ``(case name,
    args, kwargs)``; returns their results in order."""
    return [globals()[name](*args, **kwargs) for name, args, kwargs in calls]


@_numpy
def cuda_step_case(images, labels):
    """One f32 (TF32 off) weighted-CE adam step of Fast-SCNN-19 on the card
    through the fused resize-CE kernel (K3), on this rank's rows: the
    loss, the gradients summed over the ranks, the BN statistics, K3's
    launches."""
    from esn_tpu_torch.ops import kernels as K
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    model = build_model("fastscnn", CLASSES, device=dev,
                        generator=torch.Generator().manual_seed(0))
    fused, method = L.fused_resize_ce_spec(model, "ce")
    step = make_train_step(
        model, functools.partial(fused, num_classes=CLASSES),
        O.build_optimizer("adam", model.parameters()), fwd_method=method,
        generator=torch.Generator(device=dev).manual_seed(3))
    mine = mesh.shard_batch({"image": images, "label": labels})
    K.reset_launches()
    loss = step({"image": _t(mine["image"]).to(dev),
                 "label": _t(mine["label"]).to(dev)})["loss"]
    torch.cuda.synchronize()
    return dict(loss=loss, launches=dict(K.LAUNCHES),
                grads=torch.cat([p.grad.flatten()
                                 for p in model.parameters()]),
                stats=torch.cat([b.flatten() for b in model.buffers()]))
