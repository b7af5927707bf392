"""Rank-side cases of the spatial-sharding tests
(``tests/test_torch_spatial_*.py``).

Each case is a module-level function that ``esn_tpu_torch.parallel.launch
.run_ranks`` runs on every rank of a gloo group on the CPU, laid out as a
``(data, model)`` mesh (``parallel.spatial.make_spatial_mesh``), and that
the test process runs with no group as the one-process reference (with no
group and ``S = 1`` every spatial path is off). Arguments are global
numpy arrays; each rank takes its batch rows and image rows. Results come
back as numpy.

This module imports neither JAX nor the reference, so each rank starts
quickly.
"""
import functools

import numpy as np
import torch

from esn_tpu_torch import nn as enn
from esn_tpu_torch.models import build_model
from esn_tpu_torch.ops import convolution as C
from esn_tpu_torch.ops import pooling as P
from esn_tpu_torch.ops import resize as R
from esn_tpu_torch.parallel import mesh, spatial
from esn_tpu_torch.parallel.launch import to_numpy

import _torch_parallel as TP


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def layout(n_spatial):
    """Lay the world out as (W / S, S); nothing with no group."""
    if mesh.active():
        spatial.make_spatial_mesh(mesh.world().size // n_spatial, n_spatial)
    return mesh.world()


# ----------------------------------------------------------------- the ops
def _conv(k, s=1, d=1, kw=None, groups=1):
    """A conv of kernel (k, kw or k), stride s, dilation (d, 1), "same"
    padding, with a bias; the weight from the case's arrays."""
    kw = k if kw is None else kw

    def run(x, p):
        return C.conv2d(x, p["w"], stride=s, padding=(d * (k - 1) // 2,
                                                      (kw - 1) // 2),
                        dilation=(d, 1), groups=groups, bias=p["b"])
    return run, lambda c: {"w": (c, c // groups, k, kw), "b": (c,)}


def _transpose(k, s, p, op):
    def run(x, q):
        return C.conv2d_transpose(x, q["w"], stride=s, padding=p,
                                  output_padding=op, bias=q["b"])
    return run, lambda c: {"w": (c, c, k, k), "b": (c,)}


def _plain(fn):
    return lambda x, p: fn(x), lambda c: {}


OPS = {
    **{f"conv_k{k}_s{s}": _conv(k, s) for k in (1, 3, 5, 7) for s in (1, 2)},
    **{f"conv_k3_d{d}": _conv(3, d=d) for d in (2, 4, 8, 16)},
    "conv_k3x1_d4": _conv(3, d=4, kw=1),
    "conv_k5x1": _conv(5, kw=1),
    "conv_k1x3": _conv(1, kw=3),
    "depthwise_k3_s2": _conv(3, 2, groups=4),
    "depthwise_k3_d8": _conv(3, d=8, groups=4),
    "transpose_k3_s2_p1_op1": _transpose(3, 2, 1, 1),
    "transpose_k2_s2": _transpose(2, 2, 0, 0),
    "transpose_k3_s1_p1": _transpose(3, 1, 1, 0),
    "max_pool_2": _plain(lambda x: P.max_pool2d(x, 2, 2)),
    "max_pool_3_s2_p1": _plain(lambda x: P.max_pool2d(x, 3, 2, 1)),
    "avg_pool_3_s2_p1": _plain(lambda x: P.avg_pool2d(x, 3, 2, 1)),
    "avg_pool_3_s2_p1_exclude_pad": _plain(
        lambda x: P.avg_pool2d(x, 3, 2, 1, count_include_pad=False)),
    "avg_pool_2": _plain(lambda x: P.avg_pool2d(x, 2)),
    "index_pool_unpool": _plain(lambda x: P.max_unpool2d_2x2(
        *P.max_pool2d_with_indices_2x2(x))),
    "resize_x2": _plain(lambda x: R.resize_bilinear(
        x, (x.shape[2] * 2, x.shape[3] * 2))),
    "resize_x4": _plain(lambda x: R.resize_bilinear(
        x, (x.shape[2] * 4, x.shape[3] * 4))),
    "resize_x8": _plain(lambda x: R.resize_bilinear(
        x, (x.shape[2] * 8, x.shape[3] * 8))),
    "resize_quarter": _plain(lambda x: R.resize_bilinear(
        x, (x.shape[2] // 4, x.shape[3] // 4))),
    "resize_half": _plain(lambda x: R.resize_bilinear(
        x, (x.shape[2] // 2, x.shape[3] // 2))),
}
def whole_adaptive_pool(x, bins):
    """PPM's pool of a shard: the adaptive pool of the whole map
    (``spatial.whole``) inside ``spatial.replicated()``."""
    full = spatial.whole(x)
    with spatial.replicated():
        return P.adaptive_avg_pool2d(full, bins)


# whole-height reductions: the result is replicated on the model group
REDUCTIONS = {
    "global_avg_pool": lambda x: P.global_avg_pool(x),
    **{f"adaptive_{b}": functools.partial(whole_adaptive_pool, bins=b)
       for b in (1, 2, 3, 6)},
}
# a replicated input resized to this rank's rows of S x (rows, cols)
UPSAMPLES = {"replicated_to_x": (1, 1), "replicated_3_to_x": (3, 3),
             "replicated_6_to_x": (6, 6)}


def op_params(name, c, seed):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*shape) for k, shape in OPS[name][1](c).items()}


def _numpy(fn):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        return to_numpy(fn(*args, **kwargs))
    return run


@_numpy
def op_case(name, x, cot, params, n_spatial):
    """``OPS[name]`` on this rank's rows of ``x`` (f64, NCHW) inside
    ``spatial.sharded()``: its output rows and the gradient of
    ``Σ y * cot`` (this rank's rows of ``cot``) for x and the
    parameters (summed over the ranks)."""
    w = layout(n_spatial)
    xr = _t(spatial.shard_batch_spatial({"x": x}, w=w)["x"]).requires_grad_()
    ps = {k: _t(v).requires_grad_() for k, v in params.items()}
    with spatial.sharded():
        y = OPS[name][0](xr, ps)
        c = _t(spatial.shard_batch_spatial({"c": cot}, w=w)["c"])
        (y * c).sum().backward()
    grads = {k: mesh.all_sum(p.grad) for k, p in ps.items()}
    return dict(y=y, dx=xr.grad, grads=grads)


@_numpy
def reduction_case(name, x, cot, n_spatial):
    """``REDUCTIONS[name]`` of this rank's rows (replicated result);
    only model index 0 back-propagates ``cot``, so the group sum's
    backward must carry it to every rank's rows."""
    w = layout(n_spatial)
    xr = _t(spatial.shard_batch_spatial({"x": x}, w=w)["x"]).requires_grad_()
    with spatial.sharded():
        y = REDUCTIONS[name](xr)
        c = _t(mesh.shard_batch({"c": cot}, w=w)["c"])
        (y * c * (w.model_index == 0)).sum().backward()
    return dict(y=y, dx=xr.grad)


@_numpy
def upsample_case(name, x, cot, n_spatial):
    """A replicated map (this rank's batch rows of ``x``, whole) resized
    inside ``spatial.replicated()`` to this rank's rows of the sharded
    output; the gradient summed over the model group (as the pool that
    made the map would)."""
    w = layout(n_spatial)
    xr = _t(mesh.shard_batch({"x": x}, w=w)["x"]).requires_grad_()
    rows, cols = cot.shape[2] // max(w.spatial, 1), cot.shape[3]
    with spatial.sharded(), spatial.replicated():
        y = R.resize_bilinear(xr, (rows, cols))
        c = _t(spatial.shard_batch_spatial({"c": cot}, w=w)["c"])
        (y * c).sum().backward()
    return dict(y=y, dx=mesh.all_sum(xr.grad))


@_numpy
def dropout_case(x, rate, seed, n_spatial):
    """A training ``Dropout`` and ``SpatialDropout`` on this rank's rows
    of ``x`` inside ``spatial.sharded()``, each drawn from a generator
    seeded alike on every rank."""
    w = layout(n_spatial)
    xr = _t(spatial.shard_batch_spatial({"x": x}, w=w)["x"])
    out = {}
    for name, kind in (("dropout", enn.Dropout),
                       ("spatial_dropout", enn.SpatialDropout)):
        m = kind(rate).train()
        m.generator = torch.Generator().manual_seed(seed)
        with spatial.sharded():
            out[name] = m(xr)
    return out


@_numpy
def bn_case(x, cot, params, n_spatial):
    """A training BatchNorm on this rank's rows of ``x``: output, input
    gradient, the affine's gradients summed over the ranks, the running
    statistics."""
    w = layout(n_spatial)
    bn = enn.BatchNorm(x.shape[1]).double()
    with torch.no_grad():
        for k, v in params.items():
            getattr(bn, k).copy_(_t(v))
    mine = spatial.shard_batch_spatial({"x": x, "c": cot}, w=w)
    xr = _t(mine["x"]).requires_grad_()
    with spatial.sharded():
        y = bn(xr)
        (y * _t(mine["c"])).sum().backward()
    mesh.all_reduce_grads(bn.parameters())
    return dict(y=y, dx=xr.grad, dweight=bn.weight.grad, dbias=bn.bias.grad,
                running_mean=bn.running_mean, running_var=bn.running_var)


@_numpy
def regroup_case(n_spatial):
    """Lay the world out at ``n_spatial``, then at S = 1, then at
    ``n_spatial`` again: the second layout reuses the first's model group
    (no new process group), and a group sum over it still gives S."""
    layout(n_spatial)
    first = mesh.model_group()
    if mesh.active():
        mesh.set_spatial(1)
    w = layout(n_spatial)
    with spatial.sharded():
        ax = spatial.axis()
        one = torch.ones(1, dtype=torch.float64)
        total = spatial.group_sum(one, ax) if ax is not None else one
    return dict(same=mesh.model_group() is first, spatial=w.spatial,
                total=total)


def many_case(calls):
    """Several cases in one spawn: ``(name, args, kwargs)`` each, of this
    module or of ``_torch_parallel``."""
    return [(globals().get(name) or getattr(TP, name))(*args, **kwargs)
            for name, args, kwargs in calls]


# ----------------------------------------------------------- model steps
@_numpy
def spatial_step_case(arch, images, labels, cw, n_spatial, *, loss="ce",
                      dtype="float64", state=None, dropout=True, seed=0,
                      grad_accum=1, remat=False):
    """One adam + poly step of ``arch`` (weights from ``seed``, or
    ``state``; ``grad_accum`` and ``remat`` as the step's) on this rank's
    batch rows' image rows of the global batch, taken inside the sharded
    context by ``make_train_step``: the loss, the gradients summed over
    the ranks, the state after the step, the OHEM thresholds."""
    from esn_tpu_torch.train import optimizers as O
    from esn_tpu_torch.train import schedules as S
    from esn_tpu_torch.train.step import make_train_step
    w = layout(n_spatial)
    dt = getattr(torch, dtype)
    model = build_model(arch, TP.CLASSES, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    if state is not None:
        model.load_state_dict({k: _t(v) for k, v in state.items()})
    if not dropout:
        for m in model.modules():
            if isinstance(m, enn.Dropout):
                m.rate = 0.0
    model.to(dt)
    opt = O.build_optimizer("adam", model.parameters())
    mesh.broadcast_state(model, opt)
    step = make_train_step(model, STEP_LOSSES[loss](cw), opt,
                           schedule=S.build_schedule("poly", TP.LR, TP.TOTAL),
                           compute_dtype=dt, grad_accum=grad_accum,
                           remat=remat,
                           generator=torch.Generator().manual_seed(7))
    mine = spatial.shard_batch_spatial({"image": images, "label": labels},
                                       grad_accum, w=w)
    batch = {"image": _t(mine["image"]), "label": _t(mine["label"])}
    with TP._Thresholds() as th:
        out = step(batch)
    grads = {n: p.grad for n, p in model.named_parameters()}
    return dict(loss=out["loss"], grads=grads, state=model.state_dict(),
                thresholds=th.values)


def _ce(cw):
    from esn_tpu_torch.train import losses as L
    cw_t = _t(np.asarray(cw, np.float32))
    return lambda lg, lb: L.cross_entropy(lg, lb, num_classes=TP.CLASSES,
                                          class_weights=cw_t)


def _ohem(cw):
    from esn_tpu_torch.train import losses as L
    ce = _ce(cw)
    return lambda lg, lb: ce(lg, lb) + L.ohem_cross_entropy(
        lg, lb, num_classes=TP.CLASSES)


def _lovasz(cw):
    from esn_tpu_torch.train import losses as L
    return lambda lg, lb: L.lovasz_softmax(lg, lb, num_classes=TP.CLASSES)


STEP_LOSSES = {"ce": _ce, "ohem": _ohem, "lovasz": _lovasz}


@_numpy
def zoo_case(archs, images, cots, n_spatial):
    """Each model of ``archs`` (f64, train mode, dropout off, weights from
    seed 0): its full forward on this rank's rows inside the sharded
    context, and the gradients of ``Σ logits * cot`` for the input and
    the parameters (summed over the ranks)."""
    w = layout(n_spatial)
    out = {}
    for arch in archs:
        model = build_model(arch, TP.CLASSES, device="cpu",
                            generator=torch.Generator().manual_seed(0))
        for m in model.modules():
            if isinstance(m, enn.Dropout):
                m.rate = 0.0
        model.double().train()
        mine = spatial.shard_batch_spatial(
            {"x": images[arch], "c": cots[arch]}, w=w)
        x = _t(mine["x"]).requires_grad_()
        with spatial.sharded():
            y = model(x)
            (y * _t(mine["c"])).sum().backward()
        mesh.all_reduce_grads(model.parameters())
        out[arch] = dict(y=y, dx=x.grad,
                         grads={n: p.grad for n, p in model.named_parameters()
                                if p.grad is not None},
                         state={k: v for k, v in model.state_dict().items()
                                if "running_" in k})
    return out


@_numpy
def forward_case(arch, state, images, n_spatial, dtype="float32"):
    """``arch`` in eval mode with the weights ``state``: its forward on
    this rank's rows of ``images`` inside the sharded context."""
    w = layout(n_spatial)
    dt = getattr(torch, dtype)
    model = build_model(arch, TP.CLASSES, device="cpu")
    model.load_state_dict({k: _t(v) for k, v in state.items()})
    model.to(dt).eval()
    x = _t(spatial.shard_batch_spatial({"x": images}, w=w)["x"]).to(dt)
    with torch.no_grad(), spatial.sharded():
        return model(x)


@_numpy
def no_model_axis_case(images, labels, cw):
    """A CE + OHEM Fast-SCNN step (f32) in a data-parallel world (S = 1)
    with every spatial exchange and every collective recorded: the
    exchanges, the group sums, the all-reduces given a group (a model
    group) and all of them."""
    import torch.distributed as dist
    seen = {"fetch": 0, "group_sum": 0, "grouped": 0, "all_reduce": 0}
    real = (spatial._exchange, spatial.group_sum, dist.all_reduce)

    def exchange(*a, **k):
        seen["fetch"] += 1
        return real[0](*a, **k)

    def group_sum(*a, **k):
        seen["group_sum"] += 1
        return real[1](*a, **k)

    def all_reduce(t, *a, **k):
        seen["all_reduce"] += 1
        seen["grouped"] += int(k.get("group") is not None or bool(a[1:]))
        return real[2](t, *a, **k)
    layout(1)
    spatial._exchange, spatial.group_sum, dist.all_reduce = \
        exchange, group_sum, all_reduce
    try:
        TP.step_case.__wrapped__("fastscnn", images, labels, cw,
                                 dtype="float32")
    finally:
        spatial._exchange, spatial.group_sum, dist.all_reduce = real
    return seen


def spatial_fault_case(fault, *args, **kwargs):
    """``spatial_step_case`` with ``fault`` planted in this process:
    ``zero_halo`` (every row exchange gives zeros, as if each shard's
    border were the image's), ``none`` (nothing)."""
    real = spatial._exchange
    if fault == "zero_halo":
        spatial._exchange = lambda x, plan, ax: torch.zeros_like(
            real(x, plan, ax))
    try:
        return spatial_step_case(*args, **kwargs)
    finally:
        spatial._exchange = real
