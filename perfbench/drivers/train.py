"""Training: the Trainer's default route, one step at a time, each step
ending in a synchronise.

The route is the one ``train/trainer.py`` builds: weighted
cross-entropy with the class weights of the labels through
``losses.fused_resize_ce_spec`` (``fwd_method="logits_lowres"``, the
fused resize-CE kernel), ``build_optimizer("adam")`` with the mix's
learning rate and weight decay, the ``poly`` schedule over the mix's
total steps, bf16 compute, the dropout generator seeded from the run's
seed. One train step object is built and driven from the seed: its
first ``check_steps`` steps, on distinct batches of the pool, are the
checked ones and the warm-up; the window continues with the same object.

The check: the reference takes the same first steps from the same
weights on the same batches in f32. Read, each as a share: each step's
loss (``loss_gap``, the largest); the first step's gradient as Adam
takes it, read back from the program's optimizer state (``m_1 = (1 -
b1) g``), by the worst leaf (``grad_gap``) and by the median leaf
(``grad_gap_median``); each parameter's change over the checked steps,
by the worst leaf (``change_gap``) and the median leaf. A leaf's gap is
the gap between the program's norm and the reference's, over the larger
of the reference's norm of that leaf and of the median leaf. The cell's
limits file names the numbers compared: the worst leaf's gradient is the
rounding of one small leaf in bf16 (the first layers' BN scales), so the
median leaf's stands in for it (PERF.md).
Leaves whose raw gradient in the reference lies under a thousandth of
the median leaf's (a shift that the next training-mode BN removes) move
under Adam by round-off alone: they are left out of the change.
"""
from __future__ import annotations

import statistics
import time
from functools import partial
from typing import Callable, Dict, Optional

from .. import bench
from ..reference import step as RS
from ..yardstick import inputs, shapes
from ..yardstick.seeds import derive
from ..yardstick.weights import make_weights
from . import common


def poly(base: float, total: int, power: float) -> Callable[[int], float]:
    return lambda t: base * (1.0 - min(max(t / total, 0.0), 1.0)) ** power


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float], leaves):
    """The largest gap between the program's and the reference's norm of
    a leaf, over the larger of the reference's norm and the median
    leaf's; and that leaf."""
    gaps = leaf_gaps(prog, ref, leaves)
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], leaves):
    """Each leaf's gap (a NaN on either side reads as an infinite gap)."""
    med = statistics.median(ref[k] for k in leaves)
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in leaves}
    return {k: (g if g == g else float("inf")) for k, g in gaps.items()}


def prepare(cell: bench.Cell, seed: int, device) -> Dict:
    """The benchmark's weights, the pool of images and labels, the class
    weights and the seeds, from the seed."""
    cfg, tr = cell.config, cell.traffic
    classes, hw, n = cfg["classes"], tuple(cfg["image_hw"]), tr["batch"]
    ref_mod = bench.reference_module(cfg["reference"])
    meta = shapes.meta_model(ref_mod.build, classes)
    images, labels = inputs.pool(seed, tr["pool"], n, hw, classes,
                                 cfg["ignore_label"], device,
                                 with_labels=True)
    cell.valid_pixels = int(((labels[0] >= 0) & (labels[0] < classes))
                            .sum())
    return {"ref_mod": ref_mod, "meta": meta,
            "weights": make_weights(meta, seed, device),
            "images": images, "labels": labels,
            "class_weights": inputs.class_weights(labels, classes),
            "total_steps": tr["max_epochs"] * tr["iters_per_epoch"],
            "dropout_seed": derive(seed, "dropout")}


def reference_steps(cell: bench.Cell, p: Dict, ref) -> Dict:
    """The reference ``ref`` (loaded with the weights) through the
    checked steps on the batches the program took."""
    tr = cell.traffic
    k = len(p["images"])
    steps = range(tr["check_steps"])
    return RS.train_steps(
        ref, [p["images"][i % k] for i in steps],
        [p["labels"][i % k] for i in steps], p["class_weights"],
        lr_at=poly(tr["lr"], p["total_steps"], tr["poly_exp"]),
        weight_decay=tr["weight_decay"], ignore=cell.config["ignore_label"],
        dropout_seed=p["dropout_seed"],
        recompute=cell.config.get("reference_recompute", False))


def gaps(prog: Dict, ref: Dict) -> Dict:
    """The numbers compared, of the program's (or a control's) losses,
    first-gradient norms and change norms against the reference's, and
    beside them the median leaf's gaps and the leaves that set the
    worst."""
    loss_gap = max(abs(a - b) / abs(b) if a == a and b == b
                   else float("inf")
                   for a, b in zip(prog["losses"], ref["losses"]))
    leaves = list(ref["grad"])
    grad_gap, grad_leaf = worst_leaf(prog["grad"], ref["grad"], leaves)
    med_raw = statistics.median(ref["grad_raw"].values())
    moving = [k for k in leaves if ref["grad_raw"][k] >= 1e-3 * med_raw]
    change_gap, change_leaf = worst_leaf(prog["change"], ref["change"],
                                         moving)
    return {"loss_gap": loss_gap, "loss_gap_first":
            abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0]),
            "grad_gap": grad_gap, "change_gap": change_gap,
            "grad_gap_median": median_leaf(prog["grad"], ref["grad"], leaves),
            "change_gap_median": median_leaf(prog["change"], ref["change"],
                                             moving),
            "grad_leaf": grad_leaf, "change_leaf": change_leaf,
            "change_top": top_leaves(prog["change"], ref["change"], moving),
            "left_out": sorted(set(leaves) - set(moving))}


def top_leaves(prog: Dict[str, float], ref: Dict[str, float], leaves,
               k: int = 4):
    """The ``k`` leaves of the widest gaps: ``[leaf, gap, program's norm,
    reference's norm]``."""
    gaps = leaf_gaps(prog, ref, leaves)
    return [[n, gaps[n], prog[n], ref[n]]
            for n in sorted(gaps, key=gaps.get, reverse=True)[:k]]


def median_leaf(prog: Dict[str, float], ref: Dict[str, float], leaves):
    """The median over the leaves of each leaf's gap, measured as in
    :func:`worst_leaf`."""
    return statistics.median(leaf_gaps(prog, ref, leaves).values())


def run(cell: bench.Cell, seed: int, seconds: float, trace: bool, device,
        t0: float, log: Callable[[str], None],
        fault: Optional[Callable] = None) -> Dict:
    import torch
    from esn_tpu_torch.models import build_model
    from esn_tpu_torch.ops import kernels as K
    from esn_tpu_torch.train.losses import fused_resize_ce_spec
    from esn_tpu_torch.train.optimizers import build_optimizer
    from esn_tpu_torch.train.schedules import build_schedule
    from esn_tpu_torch.train.step import make_train_step

    cfg, tr = cell.config, cell.traffic
    classes, hw, n = cfg["classes"], tuple(cfg["image_hw"]), tr["batch"]
    ignore = cfg["ignore_label"]
    dtype = getattr(torch, cfg["compute_dtype"])
    prep = prepare(cell, seed, device)
    ref_mod, meta, weights = prep["ref_mod"], prep["meta"], prep["weights"]
    images, labels = prep["images"], prep["labels"]
    cw, total = prep["class_weights"], prep["total_steps"]

    # the program: the Trainer's route
    model = build_model(cfg["model"], classes, device=device)
    model.load_state_dict(weights)
    fused, fwd_method = fused_resize_ce_spec(model, tr["loss"])
    loss_fn = partial(fused, class_weights=cw, num_classes=classes,
                      ignore_index=ignore)
    opt = build_optimizer(tr["optimizer"], model.parameters(),
                          weight_decay=tr["weight_decay"])
    schedule = build_schedule(tr["schedule"], tr["lr"], total,
                              power=tr["poly_exp"],
                              warmup_steps=tr["warmup_iters"],
                              warmup_factor=tr["warmup_factor"])
    step = make_train_step(model, loss_fn, opt, schedule=schedule,
                           compute_dtype=dtype, fwd_method=fwd_method,
                           generator=torch.Generator().manual_seed(
                               prep["dropout_seed"]))
    if fault is not None:
        step = fault(step)
    named = dict(model.named_parameters())

    def pick(i):
        return {"image": images[i % len(images)],
                "label": labels[i % len(labels)]}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    # the checked first steps, through the window's own call and feed
    b1 = opt.defaults["betas"][0]
    steps = tr["check_steps"]
    losses, first_grad = [], None
    for i in range(steps):
        losses.append(step(pick(i))["loss"])
        if i == 0:
            first_grad = {k: (opt.state[p]["exp_avg"] / (1 - b1)).double()
                          .norm() if "exp_avg" in opt.state[p]
                          else torch.zeros((), device=device)
                          for k, p in named.items()}
    change = {k: (p.detach() - weights[k]).double().norm()
              for k, p in named.items()}
    losses = [float(v) for v in losses]
    first_grad = {k: float(v) for k, v in first_grad.items()}
    change = {k: float(v) for k, v in change.items()}
    sync()
    setup_s = time.perf_counter() - t0

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    launches0 = dict(K.LAUNCHES)
    window = common.measure(pick, step, sync, seconds, first=steps)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    launches = {k: (v - launches0[k]) / window.calls
                for k, v in K.LAUNCHES.items() if v != launches0[k]}
    tr_trace = (common.traced(pick, step, sync, tr["traced_steps"],
                              steps + window.calls) if trace else None)

    calls = shapes.layer_calls(meta, n, hw, train=True)
    readings = common.Readings(
        route="train", window=window,
        flops_per_call=shapes.model_flops(meta, n, hw, train=True),
        kernels=common.kernel_work(bench.work_modules(), calls, cell),
        trace=tr_trace, launches_per_call=launches)

    del step, opt, model, named, loss_fn
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref = ref_mod.build(classes).to(device)
    ref.load_state_dict(weights)
    got = reference_steps(cell, prep, ref)
    g = gaps({"losses": losses, "grad": first_grad, "change": change}, got)
    checks = [(k, g[k], v["limit"]) for k, v in cell.limits.items()]
    log(f"samples: {window.calls} steps of {n} in {window.seconds:.6f} s")
    log(common.describe(window))
    log(f"losses: program {losses} reference {got['losses']}")
    log("read beside them: " + ", ".join(
        f"{k} {v!r}" for k, v in g.items()
        if k not in cell.limits and k not in ("left_out", "change_top")))
    log(f"widest changes (leaf, gap, program, reference): {g['change_top']}")
    log(f"left out of the change: {g['left_out']}")
    return {
        "correct": common.verdict(checks), "attempted": window.calls,
        "failed": 0, "setup_s": setup_s, "peak_bytes": peak,
        "e2e": {"train_img_per_s": n * window.calls / window.seconds,
                "peak_mem_gb": peak / 1e9},
        "readings": readings, "checks": checks,
        "diagnostics": {k: v for k, v in g.items() if k != "left_out"}}
