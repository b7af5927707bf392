"""The port's training steps against the reference's in float64, on a
golden config's own batches: the witness that separates a fault in the
step from f32 chaos.

    JAX_PLATFORMS=cpu python tests/_golden_f64.py [CONFIG] [--optim adam]
        [--steps N] [--seed S] [--out FILE]

The reference's ``Trainer`` (one CPU device, dropout rate 0) gives the
init, the class weights and the augmented batches of the first N steps
(its ``train_epoch``'s own draws). Both packages then take the N steps
from that init in float64 (``jax_enable_x64``; the port's model
``.double()``): the model in train mode (BN statistics updated), the
config's loss with the class weights, the optimizer with weight decay and
the poly schedule, each package's own. The reference's step is written
out here (its ``make_train_step`` casts the logits to f32); its OHEM
threshold comes from ``lax.top_k`` (``ESN_TPU_OHEM_TOPK=1``, its own
switch: the radix select reads 32-bit patterns).

Printed per step: the two losses' relative gap; at the snapshot steps,
per parameter and statistic, the rel-L2 of the port's value against the
reference's, over the reference's move since the init (median and max
over leaves). A chaos control runs beside it: the port again from the
init times (1 + 1e-12 r), r standard normal, against the port's own run.
A fault shows as a gap far above the control's from the first steps on;
chaos as a gap that grows like the control's.
"""
import argparse
import json
import os
import sys
import types

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOTS = (1, 2, 5, 10, 20, 40, 80, 160)
PLAIN_ENV = {"ESN_TPU_S2D_CONV": "0", "ESN_TPU_S2D_STEM": "0",
             "ESN_TPU_FOLD": "0", "ESN_TPU_SCAN_CHAIN": "0",
             "ESN_TPU_OHEM_TOPK": "1"}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _dropout_off(module, seen=None):
    """Every dropout rate of a reference model to 0 (its modules are plain
    attribute holders)."""
    from esn_tpu import nn as jnn
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
            _dropout_off(child, seen)


def reference(kw, steps):
    """The reference's init, class weights and first ``steps`` augmented
    batches, then its ``steps`` float64 steps: per-step losses and the
    variables at each snapshot."""
    import jax
    import jax.numpy as jnp
    import optax
    from esn_tpu import nn as jnn
    from esn_tpu.train.losses import build_loss
    from esn_tpu.train.optimizers import build_optimizer
    from esn_tpu.train.trainer import TrainConfig, Trainer
    cfg = TrainConfig(**kw)
    tr = Trainer(cfg)
    _dropout_off(tr.model)
    init = jax.tree_util.tree_map(
        np.asarray, jax.device_get({"params": tr.state.params,
                                    "stats": tr.state.stats}))
    batches = []
    for epoch in range(cfg.max_epochs):
        tr.train_loader.set_epoch(epoch)
        rng = jax.random.PRNGKey(cfg.seed * 1000003 + epoch)
        for i, b in enumerate(tr.train_loader):
            x, y = tr.augment(jax.random.fold_in(rng, i),
                              jnp.asarray(b["image"]), jnp.asarray(b["label"]))
            batches.append((np.asarray(x), np.asarray(y)))
            if len(batches) == steps:
                break
        if len(batches) == steps:
            break
    weights = np.asarray(tr.datas["classWeights"], np.float64)
    spec = tr.spec
    jax.config.update("jax_enable_x64", True)
    # the reference casts to f32 in places (the losses' logits and class
    # weights, BN's moments, a conv's weight gradient): here to f64
    f64 = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                   if not k.startswith("__")})
    f64.float32 = jnp.float64
    patched = [m for name, m in list(sys.modules.items())
               if name.startswith("esn_tpu.") and getattr(m, "jnp", None)
               is jnp]
    for m in patched:
        m.jnp = f64
    try:
        loss_fn = build_loss(cfg.loss, num_classes=spec.num_classes,
                             ignore_index=spec.ignore_label)
        cw = jnp.asarray(weights, jnp.float64)
        # the schedule at an f64 step: an int32 count gives an f32 rate
        tx = build_optimizer(
            cfg.optim, lambda c: tr.schedule(jnp.asarray(c, jnp.float64)),
            weight_decay=cfg.weight_decay)
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                   init)

        def fwd(params, stats, x, y):
            logits, new = jnn.apply(tr.model, {"params": params,
                                               "stats": stats}, x,
                                    train=True, mutable=True,
                                    rngs={"dropout": jax.random.PRNGKey(0)})
            return loss_fn(logits, y, class_weights=cw), new["stats"]

        @jax.jit
        def step(params, stats, opt, x, y):
            (loss, stats), g = jax.value_and_grad(fwd, has_aux=True)(
                params, stats, x, y)
            updates, opt = tx.update(g, opt, params)
            return optax.apply_updates(params, updates), stats, opt, loss

        params, stats = v["params"], v["stats"]
        opt = tx.init(params)
        losses, snaps, lrs = [], {}, []
        for n, (x, y) in enumerate(batches, 1):
            params, stats, opt, loss = step(params, stats, opt,
                                            jnp.asarray(x, jnp.float64),
                                            jnp.asarray(y))
            losses.append(float(loss))
            lrs.append(float(tr.schedule(n - 1)))
            if n in SNAPSHOTS or n == len(batches):
                snaps[n] = jax.tree_util.tree_map(
                    np.asarray, {"params": params, "stats": stats})
    finally:
        jax.config.update("jax_enable_x64", False)
        for m in patched:
            m.jnp = jnp
    return dict(init=init, weights=weights, batches=batches, losses=losses,
                snaps=snaps, lrs=lrs,
                total_steps=cfg.max_epochs * max(len(tr.train_loader), 1))


def port(kw, ref, perturb=0.0):
    """The port's ``steps`` float64 steps from the reference's init on its
    batches (``perturb``: the init times 1 + perturb r)."""
    import torch
    from esn_tpu_torch import convert
    from esn_tpu_torch.data.datasets import get_spec
    from esn_tpu_torch.models import build_model
    from esn_tpu_torch.nn.layers import Dropout
    from esn_tpu_torch.train.losses import build_loss
    from esn_tpu_torch.train.optimizers import build_optimizer
    from esn_tpu_torch.train.schedules import build_schedule
    from esn_tpu_torch.train.step import make_train_step
    from esn_tpu_torch.train.trainer import TrainConfig
    cfg = TrainConfig(**dict(kw, device="cpu"))
    spec = get_spec(cfg.dataset)
    model = build_model(cfg.model, spec.num_classes, device="cpu")
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    init = ref["init"]
    if perturb:
        rng = np.random.RandomState(0)
        init = _map(ref["init"], lambda a: a.astype(np.float64) * (
            1 + perturb * rng.randn(*a.shape)))
    sd = convert.to_state_dict(init, model)
    model.double()
    model.load_state_dict({k: v.double() for k, v in sd.items()},
                          strict=True)
    schedule = build_schedule(cfg.lr_schedule, cfg.lr, ref["total_steps"],
                              power=cfg.poly_exp,
                              warmup_steps=cfg.warmup_iters,
                              warmup_factor=cfg.warmup_factor)
    opt = build_optimizer(cfg.optim, model.parameters(),
                          weight_decay=cfg.weight_decay)
    base = build_loss(cfg.loss)
    cw = torch.from_numpy(ref["weights"])

    def loss_fn(logits, labels):
        return base(logits, labels, class_weights=cw,
                    num_classes=spec.num_classes,
                    ignore_index=spec.ignore_label)
    step = make_train_step(model, loss_fn, opt, schedule=schedule,
                           compute_dtype=torch.float64, fwd_method=None,
                           generator=torch.Generator().manual_seed(0))
    losses, snaps, lrs = [], {}, []
    for n, (x, y) in enumerate(ref["batches"], 1):
        m = step({"image": torch.from_numpy(
            x.transpose(0, 3, 1, 2).astype(np.float64)),
            "label": torch.from_numpy(y.copy())})
        losses.append(float(m["loss"]))
        lrs.append(m["lr"])
        if n in SNAPSHOTS or n == len(ref["batches"]):
            snaps[n] = convert.to_variables(
                {k: v.detach().clone() for k, v in
                 model.state_dict().items()}, model)
    return losses, snaps, lrs


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(np.asarray(v))
            for k, v in tree.items()}


def gaps(a, b, init):
    """Per leaf of the params and stats: |a - b| / |b - init| (rel-L2),
    by path."""
    out = {}
    for coll in ("params", "stats"):
        la, lb, li = (dict(_leaves(t[coll])) for t in (a, b, init))
        for path, vb in lb.items():
            move = np.linalg.norm(vb.astype(np.float64) - li[path])
            if move > 0:
                out[(coll,) + path] = float(np.linalg.norm(
                    la[path].astype(np.float64) - vb) / move)
    return out


def witness(config, optim, steps, seed=1, control=True):
    """Both packages' ``steps`` float64 steps of golden ``config`` with
    ``optim``: one row a snapshot step (the relative loss gap, the state
    gaps' median and max over leaves, and the control's)."""
    import tempfile
    from esn_tpu_torch.tools import golden_run as G
    os.environ.update(PLAIN_ENV)
    with tempfile.TemporaryDirectory() as tmp:
        root = G.build_fixture(os.path.join(tmp, "ds"))
        kw = dict(G.CONFIGS[config], data_root=root, optim=optim, seed=seed,
                  savedir=os.path.join(tmp, "ckpt"))
        kw["input_size"] = tuple(kw["input_size"])
        ref = reference(kw, steps)
        losses, snaps, lrs = port(kw, ref)
        if control:
            c_losses, c_snaps, _ = port(kw, ref, perturb=1e-12)
    rows = []
    for n in sorted(snaps):
        g = np.asarray(list(gaps(snaps[n], ref["snaps"][n],
                                 ref["init"]).values()))
        row = {"step": n,
               "loss_gap": abs(losses[n - 1] - ref["losses"][n - 1])
               / abs(ref["losses"][n - 1]),
               "lr_gap": max(abs(a - b) / b for a, b in
                             zip(lrs[:n], ref["lrs"][:n])),
               "median": float(np.median(g)), "max": float(g.max())}
        if control:
            c = np.asarray(list(gaps(c_snaps[n], snaps[n],
                                     ref["init"]).values()))
            row.update(control_loss_gap=abs(c_losses[n - 1] - losses[n - 1])
                       / abs(losses[n - 1]),
                       control_median=float(np.median(c)),
                       control_max=float(c.max()))
        rows.append(row)
    return {"config": config, "optim": optim, "seed": seed, "steps": steps,
            "ref_losses": ref["losses"], "port_losses": losses,
            "snapshots": rows}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("config", nargs="?", default="enet")
    parser.add_argument("--optim", default="adam")
    parser.add_argument("--steps", type=int, default=40)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--threads", type=int, default=2)
    parser.add_argument("--out", default="")
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    import torch
    torch.set_num_threads(args.threads)
    record = witness(args.config, args.optim, args.steps, args.seed)
    for r in record["snapshots"]:
        print("step %4d  loss gap %.3e (control %.3e)  state gap median "
              "%.3e max %.3e (control %.3e %.3e)" % (
                  r["step"], r["loss_gap"], r["control_loss_gap"],
                  r["median"], r["max"], r["control_median"],
                  r["control_max"]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)


if __name__ == "__main__":
    main()
