#!/usr/bin/env python
"""Prediction CLI of the port, with the flags of the reference's
``predict.py``.

Runs the unlabeled test split and writes grey trainID PNGs (Cityscapes:
converted to labelIDs for server submission) and colourised PNGs, with
the port's own PNG writer. On the CUDA device unless ``--cuda False``.
"""
import argparse
import sys

from . import parse_hw, str2bool


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="esn_tpu_torch prediction")
    p.add_argument("--model", default="ENet")
    p.add_argument("--dataset", default="camvid",
                   choices=["cityscapes", "camvid"])
    p.add_argument("--checkpoint", default="")
    p.add_argument("--save_seg_dir", default="./result/predict")
    p.add_argument("--output_grey", action="store_true", default=True)
    p.add_argument("--output_color", action="store_true", default=True)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--data_root", default=None)
    p.add_argument("--synthetic_len", type=int, default=8)
    p.add_argument("--synthetic_hw", default=None, help="H,W synthetic source")
    p.add_argument("--compute_dtype", default=None,
                   help="float32|bfloat16 (default: bfloat16 on the card, "
                        "float32 on the CPU)")
    p.add_argument("--cuda", type=str2bool, default=True,
                   help="boolean: True runs on the CUDA device (and raises "
                        "without one), False/0 on the CPU")
    p.add_argument("--gpus", default="0",
                   help="accepted and ignored: the port runs on one device")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from ..data import build_dataset_test, palettes
    from ..data.datasets import get_spec
    from ..models import build_model
    from ..train import checkpoint as ckpt
    from ..train.step import make_predict_step
    from ..train.trainer import resolve_compute_dtype, resolve_device

    device = resolve_device("cuda" if args.cuda else "cpu")
    kw = {"root": args.data_root} if args.data_root else {}
    if args.synthetic_hw:
        kw["synthetic_hw"] = parse_hw(args.synthetic_hw)
    spec = get_spec(args.dataset)
    _, loader, eval_transform = build_dataset_test(
        args.dataset, num_workers=args.num_workers, none_gt=True,
        batch_size=args.batch_size, synthetic_len=args.synthetic_len, **kw)
    model = build_model(args.model, spec.num_classes, device=device,
                        generator=torch.Generator().manual_seed(0))
    if args.checkpoint:
        ckpt.load_variables(args.checkpoint, model)
    dtype = resolve_compute_dtype(args.compute_dtype, device)
    predict = make_predict_step(model, compute_dtype=dtype)

    count = 0
    for batch in loader:
        images = eval_transform(torch.from_numpy(batch["image"]).to(device))
        pred = predict(images).cpu().numpy()
        for i, name in enumerate(batch["name"]):
            palettes.save_predict(
                pred[i], None, name, args.dataset, args.save_seg_dir,
                output_grey=args.output_grey, output_color=args.output_color)
            count += 1
    print(f"=> wrote {count} predictions to {args.save_seg_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
