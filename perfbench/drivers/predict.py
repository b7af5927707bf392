"""Batch prediction: ``make_predict_step(model, compute_dtype=...)`` on a
pool of distinct seeded batches, one client in a closed loop, each
batch's int32 map synchronised on the card and not copied to the host.

Set-up: the benchmark's weights from the seed; the BN running statistics
from the reference's training pass at momentum 1 over a seeded
calibration batch (variances floored), handed to the program as part of
its weights; the program's model and predict step; each batch of the
pool predicted twice. ``setup_s`` leaves out the reference's
calibration pass, which is the benchmark's work, not the program's.

The check: a sample of the window's maps, one for each batch of the pool
(every image of the pool), drawn from the seed among the window's first
``sample_cycles`` passes over the pool. Each sampled map is copied to
host memory as soon as it is synchronised, so the window holds no map on
the card beyond the call that made it. Once the window has closed, each
is judged against the reference's f32 logits: the widest gap by which
the reference's logit at the map's class lies below its best
(``map_gap_max``), and the share of pixels that name another class than
the reference's argmax (``map_mismatch``).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

from .. import bench
from ..reference import step as RS
from ..yardstick import inputs, shapes
from ..yardstick.seeds import derive
from ..yardstick.weights import make_weights
from . import common


def prepare(cell: bench.Cell, seed: int, device):
    """The benchmark's weights (with the calibrated statistics) and the
    pool of images, from the seed: ``(reference module, meta model,
    weights, images, seconds of the reference's calibration pass)``."""
    cfg, tr = cell.config, cell.traffic
    classes, hw, n = cfg["classes"], tuple(cfg["image_hw"]), tr["batch"]
    ref_mod = bench.reference_module(cfg["reference"])
    meta = shapes.meta_model(ref_mod.build, classes)
    weights = make_weights(meta, seed, device)
    images, _ = inputs.pool(seed, tr["pool"], n, hw, classes,
                            cfg["ignore_label"], device, with_labels=False)
    ref = ref_mod.build(classes).to(device)
    ref.load_state_dict(weights)
    t0 = time.perf_counter()
    RS.calibrate(ref, inputs.images(seed, "calibration",
                                    tr["calibration_images"], hw, device),
                 cfg["bn_var_floor"])
    weights = {k: v.detach().clone() for k, v in ref.state_dict().items()}
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize()
    return ref_mod, meta, weights, images, time.perf_counter() - t0


def sampled_calls(cell: bench.Cell, seed: int) -> Dict[int, int]:
    """The window's calls whose maps are judged: for each batch of the
    pool, one of its first ``sample_cycles`` calls, drawn from the seed
    (``{call index: pool slot}``)."""
    pool, cycles = cell.traffic["pool"], cell.traffic["sample_cycles"]
    return {slot + pool * (derive(seed, "sample", slot) % cycles): slot
            for slot in range(pool)}


def judge(cell: bench.Cell, ref, images, maps) -> Dict[str, float]:
    """The numbers compared: ``maps[slot]`` for each batch of the pool
    that has one against the reference ``ref``."""
    widest, mismatched, pixels = 0.0, 0, 0
    for slot in sorted(maps):
        got = RS.predict_gaps(ref, images[slot], maps[slot],
                              cell.traffic["reference_chunk"])
        widest = max(widest, got["widest"])
        mismatched += got["mismatched"]
        pixels += got["pixels"]
    if pixels == 0:             # no map to judge
        return {"map_gap_max": float("inf"), "map_mismatch": float("inf"),
                "pixels": 0}
    return {"map_gap_max": widest, "map_mismatch": mismatched / pixels,
            "pixels": pixels}


def run(cell: bench.Cell, seed: int, seconds: float, trace: bool, device,
        t0: float, log: Callable[[str], None],
        fault: Optional[Callable] = None) -> Dict:
    import torch
    from esn_tpu_torch.models import build_model
    from esn_tpu_torch.ops import kernels as K
    from esn_tpu_torch.train.step import make_predict_step

    cfg, tr = cell.config, cell.traffic
    classes, hw, n = cfg["classes"], tuple(cfg["image_hw"]), tr["batch"]
    dtype = getattr(torch, cfg["compute_dtype"])
    ref_mod, meta, weights, images, calib_s = prepare(cell, seed, device)

    # the program
    model = build_model(cfg["model"], classes, device=device)
    model.load_state_dict(weights)
    predict = make_predict_step(model, compute_dtype=dtype)
    if fault is not None:
        predict = fault(predict)

    def pick(i):
        return images[i % len(images)]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    for _ in range(2):
        for x in images:
            predict(x)
    # host memory for the sampled maps
    sample = sampled_calls(cell, seed)
    kept = {slot: torch.empty((n, *hw), dtype=torch.int32,
                              pin_memory=device.type == "cuda")
            for slot in sample.values()}
    sync()
    setup_s = time.perf_counter() - t0 - calib_s

    # the window
    def keep(i, out):
        if i in sample:
            slot = sample[i]
            if out.shape == kept[slot].shape:
                kept[slot].copy_(out)
            else:               # a map of another shape: judged as wrong
                kept[slot] = torch.empty(0, dtype=torch.int32)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    launches0 = dict(K.LAUNCHES)
    window = common.measure(pick, predict, sync, seconds, keep=keep,
                            min_calls=max(sample) + 1)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    launches = {k: (v - launches0[k]) / window.calls
                for k, v in K.LAUNCHES.items() if v != launches0[k]}
    tr_trace = (common.traced(pick, predict, sync, tr["traced_calls"],
                              window.calls) if trace else None)

    calls = shapes.layer_calls(meta, n, hw, train=False)
    readings = common.Readings(
        route="predict", window=window,
        flops_per_call=shapes.model_flops(meta, n, hw, train=False),
        kernels=common.kernel_work(bench.work_modules(), calls, cell),
        trace=tr_trace, launches_per_call=launches)

    # the program's state goes before the reference runs
    del predict, model
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref = ref_mod.build(classes).to(device)
    ref.load_state_dict(weights)
    got = judge(cell, ref, images, kept)
    checks = [(k, got[k], v["limit"]) for k, v in cell.limits.items()]
    log(f"samples: {window.calls} batches of {n} in {window.seconds:.6f} s; "
        f"checked {got['pixels']} pixels of the maps of calls "
        f"{sorted(sample)}; reference's calibration {calib_s:.6f} s, "
        f"not in setup_s")
    log(common.describe(window))
    return {
        "correct": common.verdict(checks), "attempted": window.calls,
        "failed": 0, "setup_s": setup_s, "peak_bytes": peak,
        "e2e": {
            "predict_img_per_s": n * window.calls / window.seconds,
            "predict_p95_ms": 1e3 * common.percentile(window.latencies, 95),
            "peak_mem_gb": peak / 1e9,
        },
        "readings": readings, "checks": checks, "diagnostics": got}
