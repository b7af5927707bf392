#!/usr/bin/env python
"""Training CLI of the port, with the flags of the reference's
``train.py``.

    python -m esn_tpu_torch.cli.train --model FastSCNN --dataset cityscapes \
        --max_epochs 300 --batch_size 8 --lr 4.5e-4 --lr_schedule poly

On the CUDA device (bf16 by default) unless ``--cuda False`` (the CPU,
f32 by default). Data-parallel at ``W`` ranks through ``torchrun``, which
ships with torch:

    python -m torch.distributed.run --standalone --nproc_per_node W \
        -m esn_tpu_torch.cli.train --model FastSCNN ...

Each rank then joins the group from the launcher's environment
(``WORLD_SIZE > 1``; no flag) and takes its rows of the global batch
(``parallel.mesh``); ``--batch_size`` stays the global batch. ``--gpus``
is accepted and ignored: the launcher sets the ranks, and rank ``r``
runs on card ``r % cards`` (NCCL where every rank has a card of its own,
gloo otherwise). ``--encoder_checkpoint`` grafts a trained ESPNet-C's
checkpoint (the port's or the JAX package's) into ESPNet's encoder
before training. Every optimizer (``--optim sgd|adam|adamw|radam|ranger``),
loss (``--use_ohem``, ``--use_label_smoothing``, ``--use_focal``,
``--use_lovaszsoftmax``) and ``--remat`` of the reference runs.
``--spatial S`` shards image height over ``S`` ranks (the reference's
``(data, model)`` mesh, ``parallel.spatial``): launch ``n_data x S``
ranks, e.g. ``--nproc_per_node 2 ... --spatial 2``. Every height inside
the reference's envelope runs, also where a stage's rows do not split
evenly (CamVid's 720 rows over 2 keep 45 at 1/16): such a stage's shards
differ by a row, or are empty.
"""
import argparse
import sys

from . import parse_hw, str2bool


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="esn_tpu_torch training")
    p.add_argument("--model", default="ENet")
    p.add_argument("--dataset", default="camvid",
                   choices=["cityscapes", "camvid"])
    p.add_argument("--input_size", default=None,
                   help="H,W crop size (default: dataset-native)")
    p.add_argument("--max_epochs", type=int, default=300)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=4.5e-4)
    p.add_argument("--optim", default="adam",
                   choices=["sgd", "adam", "adamw", "radam", "ranger"])
    p.add_argument("--lr_schedule", default="poly",
                   choices=["poly", "warmpoly", "constant"])
    p.add_argument("--poly_exp", type=float, default=0.9)
    p.add_argument("--warmup_iters", type=int, default=500)
    p.add_argument("--warmup_factor", type=float, default=1.0 / 3.0)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--use_ohem", action="store_true")
    p.add_argument("--use_label_smoothing", action="store_true")
    p.add_argument("--use_lovaszsoftmax", action="store_true")
    p.add_argument("--use_focal", action="store_true")
    p.add_argument("--random_mirror", type=str2bool, default=True,
                   help="boolean: False/0 turns it off")
    p.add_argument("--random_scale", type=str2bool, default=True,
                   help="boolean: False/0 turns it off")
    p.add_argument("--aug_mode", default="batch",
                   choices=["batch", "reference"],
                   help="'reference' = per-image scale draw with the 0.5-2.0"
                        " scale set, scale-then-crop; 'batch' = one scale a"
                        " batch, crop-then-resize (default)")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--train_type", default="train",
                   choices=["train", "trainval"])
    p.add_argument("--resume", default="",
                   help="checkpoint to resume from (the port's or the JAX "
                        "package's)")
    p.add_argument("--savedir", default="./checkpoint")
    p.add_argument("--logFile", default="log.txt")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--val_epochs", type=int, default=50)
    p.add_argument("--compute_dtype", default=None,
                   help="float32|bfloat16 (default: bfloat16 on the card, "
                        "float32 on the CPU)")
    p.add_argument("--grad_accum", type=int, default=1)
    p.add_argument("--data_root", default=None)
    p.add_argument("--synthetic_len", type=int, default=64)
    p.add_argument("--synthetic_hw", default=None, help="H,W synthetic source")
    p.add_argument("--profile_dir", default="",
                   help="write a torch.profiler Chrome trace of the first "
                        "epoch here")
    p.add_argument("--remat", action="store_true",
                   help="recompute the forward during the backward")
    p.add_argument("--spatial", type=int, default=1,
                   help="shard image height over this many ranks (the "
                        "model axis; launch n_data x spatial ranks with "
                        "torchrun)")
    p.add_argument("--encoder_checkpoint", default="",
                   help="a trained ESPNet-C checkpoint (the port's or the "
                        "JAX package's) to graft into ESPNet's encoder")
    p.add_argument("--cuda", type=str2bool, default=True,
                   help="boolean: True runs on the CUDA device (and raises "
                        "without one), False/0 on the CPU")
    p.add_argument("--gpus", default="0",
                   help="accepted and ignored: torchrun --nproc_per_node "
                        "sets the ranks")
    return p.parse_args(argv)


def config_from_args(args):
    from ..data.datasets import get_spec
    from ..train.trainer import TrainConfig

    spec = get_spec(args.dataset)
    h, w = parse_hw(args.input_size) if args.input_size \
        else spec.default_crop_hw
    loss = "ce"
    if args.use_ohem:
        loss = "ohem"
    elif args.use_label_smoothing:
        loss = "label_smoothing"
    elif args.use_lovaszsoftmax:
        loss = "lovasz"
    elif args.use_focal:
        loss = "focal"
    kw = dict(
        model=args.model, dataset=args.dataset, input_size=(h, w),
        max_epochs=args.max_epochs, batch_size=args.batch_size, lr=args.lr,
        optim=args.optim, lr_schedule=args.lr_schedule,
        poly_exp=args.poly_exp, warmup_iters=args.warmup_iters,
        warmup_factor=args.warmup_factor, weight_decay=args.weight_decay,
        loss=loss, random_scale=args.random_scale,
        random_mirror=args.random_mirror, aug_mode=args.aug_mode,
        num_workers=args.num_workers, train_type=args.train_type,
        resume=args.resume, savedir=args.savedir, log_file=args.logFile,
        seed=args.seed, val_epochs=args.val_epochs,
        compute_dtype=args.compute_dtype,
        grad_accum=args.grad_accum, synthetic_len=args.synthetic_len,
        profile_dir=args.profile_dir, remat=args.remat, spatial=args.spatial,
        encoder_checkpoint=args.encoder_checkpoint,
        device="cuda" if args.cuda else "cpu")
    if args.synthetic_hw:
        kw["synthetic_hw"] = parse_hw(args.synthetic_hw)
    if args.data_root:
        kw["data_root"] = args.data_root
    return TrainConfig(**kw)


def main(argv=None):
    args = parse_args(argv)
    cfg = config_from_args(args)
    from ..parallel import mesh
    from ..train.trainer import Trainer
    joined = not mesh.active()      # leave only a group this run joins
    try:
        trainer = Trainer(cfg)
        say = print if trainer.world.rank == 0 else (lambda *a: None)
        say(f"=> model {cfg.model} ({trainer.n_params} params), "
            f"dataset {cfg.dataset}, crop {cfg.input_size}, "
            f"loss {cfg.loss}, optim {cfg.optim}/{cfg.lr_schedule}, "
            f"{trainer.device} {trainer.compute_dtype}, "
            f"{trainer.world.size} rank(s)")
        miou = trainer.fit()
        say(f"=> final mIoU: {miou:.4f}")
    finally:
        if joined:
            mesh.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
