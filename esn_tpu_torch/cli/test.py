#!/usr/bin/env python
"""Evaluation CLI of the port, with the flags of the reference's
``test.py``.

Loads a checkpoint (the port's or the JAX package's), runs the val split,
prints per-class IoU and mIoU. ``--best`` sweeps every checkpoint of the
run dir for the best epoch; ``--save`` writes colourised predictions.
On the CUDA device unless ``--cuda False``. Launched at ``W`` ranks
(``torchrun``, as ``cli.train``) it evaluates over the world, as the
reference's ``test.py`` evaluates over all devices: each rank scores its
rows of every batch, the confusion matrices are summed, and rank 0
prints and saves.
"""
import argparse
import os
import sys

from . import parse_hw, str2bool


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="esn_tpu_torch evaluation")
    p.add_argument("--model", default="ENet")
    p.add_argument("--dataset", default="camvid",
                   choices=["cityscapes", "camvid"])
    p.add_argument("--checkpoint", default="")
    p.add_argument("--best", action="store_true",
                   help="sweep all checkpoints in the run dir (from "
                        "--checkpoint's directory, or derived from "
                        "--savedir/--train_batch_size/--train_type like the "
                        "train CLI)")
    p.add_argument("--savedir", default="./checkpoint",
                   help="the train CLI's savedir, for --best without "
                        "--checkpoint")
    p.add_argument("--train_type", default="train",
                   choices=["train", "trainval"])
    p.add_argument("--train_batch_size", type=int, default=8,
                   help="batch size of the training run being swept "
                        "(names the run dir), for --best without --checkpoint")
    p.add_argument("--save", action="store_true",
                   help="save colorized predictions")
    p.add_argument("--save_seg_dir", default="./result")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--data_root", default=None)
    p.add_argument("--synthetic_len", type=int, default=16)
    p.add_argument("--synthetic_hw", default=None, help="H,W synthetic source")
    p.add_argument("--compute_dtype", default=None,
                   help="float32|bfloat16 (default: bfloat16 on the card, "
                        "float32 on the CPU)")
    p.add_argument("--cuda", type=str2bool, default=True,
                   help="boolean: True runs on the CUDA device (and raises "
                        "without one), False/0 on the CPU")
    p.add_argument("--gpus", default="0",
                   help="accepted and ignored: torchrun --nproc_per_node "
                        "sets the ranks")
    return p.parse_args(argv)


def evaluate(model, loader, eval_transform, spec, *, save_dir=None,
             dataset="camvid", compute_dtype=None, eval_step=None):
    """(per-class IoU, mIoU) of ``model`` over ``loader``; with
    ``save_dir``, a colourised PNG of each prediction."""
    import numpy as np
    import torch

    from ..data import palettes
    from ..train.evaluation import run_eval
    from ..train.metrics import iou_from_confusion
    from ..train.step import make_eval_step

    if eval_step is None:
        eval_step = make_eval_step(
            model, spec.num_classes, ignore_index=spec.ignore_label,
            compute_dtype=compute_dtype or torch.float32)
    per_image = None
    if save_dir:
        def per_image(i, pred_hw, batch):
            palettes.save_predict(
                pred_hw, np.asarray(batch["label"][i]), batch["name"][i],
                dataset, save_dir, output_grey=False, output_color=True)
    cm = run_eval(eval_step, loader, eval_transform, spec.num_classes,
                  per_image=per_image)
    iou, miou = iou_from_confusion(torch.from_numpy(cm))
    return iou.numpy(), float(miou)


def main(argv=None):
    args = parse_args(argv)
    from ..parallel import mesh
    joined = not mesh.active()      # leave only a group this run joins
    try:
        return _main(args, mesh.init_data_parallel(
            "cuda" if args.cuda else "cpu"))
    finally:
        if joined:
            mesh.shutdown()


def _main(args, world):
    import torch

    from ..data import build_dataset_test
    from ..data.datasets import get_spec
    from ..models import build_model
    from ..train import checkpoint as ckpt
    from ..train.step import make_eval_step
    from ..train.trainer import (TrainConfig, resolve_compute_dtype,
                                 resolve_device)

    device = resolve_device(str(world.device))
    say = print if world.rank == 0 else (lambda *a: None)
    kw = {"root": args.data_root} if args.data_root else {}
    if args.synthetic_hw:
        kw["synthetic_hw"] = parse_hw(args.synthetic_hw)
    spec = get_spec(args.dataset)
    _, loader, eval_transform = build_dataset_test(
        args.dataset, num_workers=args.num_workers, none_gt=False,
        batch_size=args.batch_size, synthetic_len=args.synthetic_len, **kw)
    model = build_model(args.model, spec.num_classes, device=device,
                        generator=torch.Generator().manual_seed(0))

    candidates = []
    if args.best:
        run_dir = os.path.dirname(args.checkpoint) if args.checkpoint \
            else TrainConfig(model=args.model, dataset=args.dataset,
                             batch_size=args.train_batch_size,
                             train_type=args.train_type,
                             savedir=args.savedir).run_dir
        candidates = [p for _, p in ckpt.list_checkpoints(run_dir)]
        if not candidates:
            say(f"=> --best: no checkpoints found in {run_dir}")
    elif args.checkpoint:
        candidates = [args.checkpoint]

    dtype = resolve_compute_dtype(args.compute_dtype, device)
    # one eval step for the whole sweep: checkpoints load into its model
    eval_step = make_eval_step(model, spec.num_classes,
                               ignore_index=spec.ignore_label,
                               compute_dtype=dtype)
    save_dir = args.save_seg_dir if args.save else None

    if not candidates:
        say("=> no checkpoint given; evaluating random init")
        iou, miou = evaluate(model, loader, eval_transform, spec,
                             save_dir=save_dir, dataset=args.dataset,
                             eval_step=eval_step)
        if world.rank == 0:
            _report(iou, miou, args.dataset)
        return 0

    best_path, best_miou, best_iou = None, -1.0, None
    for path in candidates:
        _, meta = ckpt.load_variables(path, model)
        iou, miou = evaluate(model, loader, eval_transform, spec,
                             save_dir=save_dir, dataset=args.dataset,
                             eval_step=eval_step)
        say(f"=> {os.path.basename(path)} (epoch {meta.get('epoch')}): "
            f"mIoU {miou:.4f}")
        if miou > best_miou:
            best_path, best_miou, best_iou = path, miou, iou
    say(f"=> best: {os.path.basename(best_path)} mIoU {best_miou:.4f}")
    if world.rank == 0:
        _report(best_iou, best_miou, args.dataset)
    return 0


def _report(iou, miou, dataset):
    from ..data.palettes import CAMVID_CLASSES, CITYSCAPES_CLASSES
    names = CITYSCAPES_CLASSES if dataset == "cityscapes" else CAMVID_CLASSES
    for i, v in enumerate(iou):
        name = names[i] if i < len(names) else f"class{i}"
        print(f"  {name:>15s}: {v:.4f}")
    print(f"  {'meanIoU':>15s}: {miou:.4f}")


if __name__ == "__main__":
    sys.exit(main())
