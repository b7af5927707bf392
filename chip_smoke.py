#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``esn_tpu_torch/csrc``, checks each kernel
against its plain PyTorch version at the shapes the models' predicts and
train step and CGNet's predict give it (plus odd-size cases; K5 and K6,
the port's fixed-order backward of the bilinear resize and of the
adaptive pool, at PPM's maps, Fast-SCNN's x4 fusion and x8 tail at
config 5 and CamVid's 720x960, in f32 and bf16, also against torch's own
backward, two launches bit for bit, and K5 the transpose of the
forward's map bit for bit; K7, the subpixel class argmax, at the heads
of ENet (config 5), ERFNet, ESNet, ESPNet, FSSNet and SQNet (config 3)
and LinkNet (config 2) and at an odd size, in bf16 and f32, within its
gap rule, two launches bit for bit, planted ties to the first class,
beside the two-call route it replaces; K1 also at r = 2, FPENet's x2
head at config 3 and 5), then drives these paths through the port's
entry points, each with the launch counts from zero (every train step
launches K5 and K6 once for each upsample and adaptive pool it
back-propagates through, BWD_STEP):

- predict: Fast-SCNN-19 at batch 8, 3x1024x2048, bf16
  (``build_model`` + ``make_predict_step``): output, launch counts,
  agreement with the same model on the plain versions, img/s;
- predict: CGNet-19 (M=3, N=21) the same way: 22 ``cgblock`` launches and
  one ``resize_argmax`` launch per predict;
- train: five steps of Fast-SCNN-19 at batch 8, 3x1024x2048, bf16
  (``build_model`` + ``build_optimizer("adam")`` +
  ``build_schedule("poly")`` + ``make_train_step(fwd_method=
  "logits_lowres")`` with the fused resize-CE loss): one ``resize_ce``
  forward and backward launch per step, a falling loss, moving BN
  statistics, one f32 step against the plain versions, ms/step;
- predict after a train step, for both models: a predict step built
  first, one train step, then a predict that must run in eval mode (the
  eval launch counts, BN running statistics untouched, the class map of
  an eval-mode predict), and the host time of the per-call
  ``model.eval()``;
- the index pool/unpool pair on the card, contiguous and
  ``channels_last``, f32 and bf16, on inputs with planted ties and at an
  odd size with ``output_size``: bit for bit the CPU's result;
- ENet-19 at full width and depth, batch 8, 3x1024x2048, bf16, through
  ``build_model("enet")``, ``make_predict_step``, ``make_train_step`` and
  ``make_eval_step``. Its predict and eval launch K7 once (the fused
  subpixel head, img/s and peak memory timed in turns with the argmax of
  its full logits), its train step no kernel of K1-K4, so the card is
  also held against the CPU: the f32 predict of a slice, and one f32
  train step on a small slice (loss, per-leaf gradients). Train: five
  steps with the config-5 loss (class-weighted CE
  + OHEM on the full-resolution logits), a falling loss, moving BN
  statistics, finite gradients on every leaf, ms/step, peak memory.
  Eval: labels made from the model's own prediction with a band of
  ignored rows and ``valid = 6`` of 8 give a diagonal confusion matrix
  and mIoU 1; an eval step built before a train step and called after it
  runs in eval mode;
- Fast-SCNN-19 with the config-5 loss, ``fwd_method=None`` (OHEM needs
  the full-resolution logits, so the step leaves the fused resize-CE
  route: ``resize_ce`` launches 0 times, and the script says so): five
  steps, a falling loss, ms/step and peak memory in turns with the
  weighted-CE step;
- ContextNet-19 (config 5), b8 bf16 3x1024x2048: predict (``dsconv`` 5
  launches, ``resize_argmax`` 1; against the plain versions; img/s), five
  weighted-CE train steps through ``logits_lowres`` (``resize_ce`` 1
  forward and 1 backward a step; one f32 step against the plain
  versions), the config-5 step (``resize_ce`` 0) timed in turns with the
  weighted-CE one, a predict after a train step; K2 is also held against
  its plain version at the two ContextNet shapes no other path gives;
- the weight gradient of a bf16 depthwise conv in channels_last with a
  row dilation above 1 (wrong in torch's CPU convolution, which the port
  works around there) against an f64 run on the card, at five shapes;
- EDANet-19 and LEDNet-19 (config 3), b8 bf16 3x512x1024: predict
  (``resize_argmax`` 1, held at its shape too; LEDNet's f32 predict of a
  2-image slice also against the CPU) and five weighted-CE train steps
  (``resize_ce`` 1 + 1 a step), as ContextNet's;
- config 4, b8 bf16 3x768x1536: ESPNetv2-19 and DABNet-19 the same way
  (predict ``resize_argmax`` 1, also the f32 predict of a 2-image slice
  against the CPU; five train steps, ``resize_ce`` 1 + 1 a step);
  CGNet-19's five weighted-CE train steps (``resize_ce`` 1 + 1 a step,
  ``cgblock`` 0: training runs the composed blocks), then a predict at
  batch 8 built before a train step and called after it (``cgblock`` 22
  at config 4's two shapes, ``resize_argmax`` 1); K1, K3 and K4 are also
  held against their plain versions at these shapes;
- ESPNet-C-19 at 3x512x1024 as EDANet (K1 a predict, K3 a train step),
  then saved as a checkpoint: ESPNet-19's encoder, which
  ``load_encoder`` grafts (every leaf the donor's bit for bit) into the
  ESPNet that the next phase drives as ERFNet's below;
- ESPNet-19, ERFNet-19, ESNet-19, FPENet-19, FSSNet-19, SQNet-19 and
  UNet-19 (3x512x1024), SegNet-11 and LinkNet-11 (config 2, 3x352x480:
  both need sides that are multiples of 32), b8 bf16: a predict launches
  the model's fused head (K7 once for ESPNet, ERFNet, ESNet, FSSNet, SQNet
  and LinkNet, K1 once at r = 2 for FPENet, nothing for SegNet and UNet;
  ZOO_PREDICT_LAUNCHES; img/s and peak memory of a head timed in turns
  with the argmax of the full logits), a train step no kernel of K1-K4;
  each is held against the CPU as ENet is (the f32 predict of a 2-image
  slice, SegNet's outside the fields of its flipped pool windows; one f32
  train step of a slice), five weighted-CE steps, ms/step, peak memory,
  img/s;
- the rest of the training surface on Fast-SCNN-19 at config 5 (b8 bf16
  3x1024x2048): ``radam`` and ``ranger``, 12 weighted-CE steps each
  (``resize_ce`` 1 + 1 a step; RAdam's rho >= 5 at step 6, Lookahead's
  syncs at 6 and 12 held against slow + 0.5 (fast - slow); 12 f32 steps
  of a slice on the card with the CPU replaying their gradients; ms/step
  and peak memory beside adam's); ``focal``, ``lovasz`` and
  ``lovasz_hist`` on one forward's full-size f32 logits (focal at gamma 0
  against ``cross_entropy``, lovasz_hist within its quantisation bound of
  lovasz, each against the CPU on a slice), then five steps with each (no
  kernel: these losses take the full logits); ``remat`` with the
  weighted-CE step (``resize_ce`` 1 + 1 a step: the loss stays outside the
  recomputed forward) and with CE + OHEM, against the same steps without
  it (loss and BN statistics bit for bit, gradients within the atomics'
  noise), ms/step and peak memory with and without;
- the user's entry points: ``esn_tpu_torch.cli.train`` on Fast-SCNN-19,
  Cityscapes-shaped synthetic data (1024x2048 sources, 512x1024 crops),
  batch 8, bf16, two epochs of two steps with validation every epoch
  (ms/step, img/s, the host's share, val ms/batch, peak memory; K3 once
  forward and once backward a step, K2 4 times and K1 once a val batch);
  the prefetched batches against the loader's; resumes from epoch 1
  equal to the straight run bit for bit, in bf16 and (cuDNN
  deterministic) in f32, two faulty f32 resumes caught; ``cli.test``
  against the
  Trainer's mIoU; ``cli.predict``'s PNGs against the predict step's maps;
  then ``cli.train --optim ranger --use_lovaszsoftmax --remat``, two
  epochs of six steps (K1 and K2 at validation, no K3: Lovász takes the
  full logits), and its f32 resume from epoch 1 equal to the straight
  run bit for bit, Lookahead syncing at step 12 from the checkpoint's
  slow weights;
- data parallelism (``data_parallel``): two ranks on the one card under
  gloo (``parallel.launch.run_ranks``; both share the card), Fast-SCNN-19
  at config 5, a global batch of 8 (4 rows a rank), against the same
  steps in one process on the same batch and weights: three weighted-CE
  adam steps (K3 1 + 1 a step a rank) and one CE + OHEM step from the
  same starting state, in f32 (TF32 off) and bf16; each kind of step's
  first from equal weights within stated bounds (loss, BN statistics,
  and the CE step's gradient no further from an f64 step on the card
  than the one-process gradient is; see DP_BOUNDS); the ranks' state bit
  for bit equal after every step; the global OHEM select bit for bit the
  one-process topk; a bf16 Lovász step (the sort gathers every rank's
  errors) whose first loss lies within DP_LOSS_REL of one process's; one
  padded val batch (7 images of 8) whose summed confusion matrix equals
  the one-process one up to near ties; the f32 steps in a one-rank NCCL
  group; ``torchrun --nproc_per_node 2 -m esn_tpu_torch.cli.train`` and a
  resume against one process; the step's time at 2 ranks, and from a
  ``torch.profiler`` trace of one step the collectives' ranges, split
  into their own cost (the same collectives replayed with the ranks
  aligned and the card idle) and waiting. Each rank reports its kernel
  launches back; a rank that raises, hangs or exits nonzero fails the
  phase;
- spatial sharding (``spatial``): two ranks on the one card under gloo
  laid out as (1 data x 2 model), image height sharded over them
  (``parallel.spatial``), on the reference's spatial route (full forward,
  plain class-weighted CE; no kernel launches on it), against the same
  step in one process: Fast-SCNN-19 at config 5 (batch 8) and ENet-19 at
  3x512x1024, each one adam step from equal weights in f32 (TF32 off) and
  bf16 within the data_parallel gate (DP_BOUNDS' first CE step: loss, BN
  statistics, the gradient against an f64 step on the card); the ranks'
  states bit for bit equal; the bf16 step's ms and peak memory a rank
  against one process, and its collectives' count and own cost;
  ``torchrun --nproc_per_node 2 -m esn_tpu_torch.cli.train --spatial 2``
  against one process, each rank's validation launching K1 and K2;
- uneven spatial shards (``spatial_uneven``): K2 at Fast-SCNN's four
  eval DSConvs and K1 at its predict tail at CamVid's 720x960 against
  their plain versions; then the same runs as ``spatial`` with
  Fast-SCNN-19 and LEDNet-19 at 720x960, whose stages split into shards
  a row apart (45 rows at 1/16 over 2), held to ``SPU_GATES``; the
  row-count sums' share of a step; the torchrun check at 720x960;
- the port's image decoder (``decode``): Cityscapes-sized PNG records
  (2048x1024 RGB images and grey labels) written with row filters 0-4
  in turn by the phase's own encoder, each decoded equal to the array
  written; the bilinear and nearest resizes equal to a numpy oracle of
  the reference's formulas; records a second on one thread, through
  ``BatchLoader`` at 1, 4 and 8 workers and through ``NativePipeline``,
  beside what a b8 Fast-SCNN step consumes; the JPEG and Adam7 fixtures
  of ``tests/data/jpeg`` decoded to the reference's hashes, and a
  2048x1024 JPEG's images a second on one thread and through
  ``NativePipeline``;
- the golden runs (``golden``): ``GOLDEN.json``'s four tiny real-PNG
  trainings (ENet, Fast-SCNN, ENet with OHEM, ERFNet on a CamVid-like
  96x128 fixture) through ``tools/golden_run.py``: the fixture's PNGs
  read through ``ManifestDataset`` and the decoder, each config trained
  by the port's Trainer at seeds 1-3 in f32 (TF32 off, cuDNN
  deterministic: each run repeats, as bf16's do) and in bf16, a
  majority of each config's runs held to the reference's spread over
  seeds (``golden_spread.json``: ranges and an mIoU floor), the medians
  of bf16 against f32's; Fast-SCNN launches K3 once forward and once
  backward a step (48 steps a run) and K2 4 times and K1 once in each
  validation, ENet and ERFNet K7 once in each validation.

Each phase prints its seconds. Exits non-zero on any failure, and when
no CUDA device is present. The last line of standard output is one JSON
object; the line before it lists the kernels, and ``launches by model``
above them each model's launch counts; a kernel's ``launches`` in the
kernels line are summed over all of them. ``ms``/``plain_ms``/``bound_ms``:
for ``fused_dsconv`` the sum of Fast-SCNN's four layers' bf16 times per
predict, each timed at its own shape; for ``resize_argmax`` its time per
predict; for ``resize_ce_sums`` forward + backward per train step
(``chip_smoke.json`` keeps the two apart: ``fwd_ms``, ``bwd_ms``, their
bounds, and the forward's SFU floor
``fwd_sfu_floor_ms``); for ``fused_cgblock_pre`` its bf16
time per CGNet predict at 1024x2048 (2 launches at the stage2 shape, 20
at stage3's); for ``resize_bilinear_bwd`` (K5) and ``adaptive_pool_bwd``
(K6) their time per Fast-SCNN weighted-CE step at config 5 (K5 at PPM's
four upsamples and the fusion's, bf16; K6 at PPM's four pools, f32), each
at its own shape. ``bound_ms`` is computed from this run's shapes and
labels (see ``bound``); ``library_ms`` is null for K1-K4, since no single
PyTorch call computes any of the four functions, and for K5 and K6 the
time of torch's own CUDA backward (``upsample_bilinear2d_backward``,
``_adaptive_avg_pool2d_backward``) at the same shapes. For
``subpixel_argmax`` (K7) the numbers are those of ENet's head at config
5 in bf16 (one launch a predict), ``library_ms`` the two-call route
``F.conv_transpose2d`` then ``torch.argmax`` (no single call computes
it), ``max_abs_err`` the largest gap between the exact logits of the
classes that the kernel and the plain version chose. ``max_abs_err``:
for K5 and K6 the largest difference from their plain versions at those
shapes; for ``resize_argmax`` the largest gap between the f32 upsampled logits of
the classes that the kernel and the plain version chose (every K1 case
also launches twice and must give the same map bit for bit); for ``resize_ce_sums`` the largest
difference of dz. ``launches`` for ``resize_ce_sums`` counts forward and
backward launches together. Details go to ``chip_smoke.json`` in the
output directory beside this script.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import io
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
CLASSES = 19
BATCH = 8
IMAGE_HW = (1024, 2048)
# fused_dsconv tolerances, |kernel - plain| <= atol + rtol * |plain|:
#  f32 (TF32 off): both sum in f32, in other orders;
#  bf16: the output rounds to bf16 (2^-8 relative); the kernel also rounds
#  mid (the depthwise result after its affine and act) and pw to bf16
#  before its tensor-core product, as the TPU kernel does, where the plain
#  version rounds the depthwise result before the affine and keeps pw f32.
DSCONV_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (5e-2, 2e-2)}
# bf16 also against dsconv_kernel_rounding, which rounds where the kernel
# rounds, on inputs whose depthwise sums and affine are exact in f32 (x,
# dw, a1, b1 on a dyadic grid), so mid is the same on both sides: the
# outputs differ only where the two f32 orders of the product's sum put
# the output on the other side of a bf16 rounding, at most
# DSCONV_BF16_DIFFER of the elements (plus 2), each by one bf16 step. An
# emulation that skips the mid rounding differs at ~25% (measured against
# the Pallas kernel in interpret mode on the CPU).
DSCONV_BF16_DIFFER = 1e-3
# resize_argmax: where kernel and plain pick different classes, the f32
# upsampled logits of the two classes lie within this gap, relative to the
# larger magnitude (at least 1): f32 association for f32; for bf16 the
# plain version rounds the upsampled logits to bf16 before its argmax, and
# two values round to one tie only when they lie within one bf16 ulp,
# which is at most 2^-7 of the value.
ARGMAX_GAP = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
# predict with the kernels vs the same model with the plain versions. f32
# (TF32 off): re-association only. bf16: the kernel keeps the depthwise
# result in f32 where the plain version rounds it to bf16, and with random
# weights such rounding differences carry through the network (two plain
# bf16 variants of the same seeded model disagree at ~2% of pixels at
# 512x256 on the CPU).
PREDICT_MISMATCH_MAX = {"float32": 1e-4, "bfloat16": 0.05}
# ... and the largest low-res logit difference between the two runs, as a
# share of the plain run's logit std, which bounds what counts as a near
# tie there. From readings on an H100: f32 5.1e-6 (bound ~10x), bf16
# 0.121, i.e. 0.25 against a std of 2.06 (bound ~2x). ContextNet's own
# bf16 bound: its five DSConvs round where the plain versions do not, and
# its logits spread less (read: 0.34375 against a std of 1.33, 0.26; the
# same 0.34375 as Fast-SCNN's, about 5 bf16 steps of its largest logits).
LOWRES_DIFF_MAX = {"float32": 5e-5, "bfloat16": 0.25}
LOWRES_DIFF_MAX_BY_MODEL = {"ContextNet": {"float32": 5e-5, "bfloat16": 0.5}}
VAR_FLOOR = 0.01
# resize_ce_sums (K3) against its plain version, f32, TF32 off:
# |dS| <= RESIZE_CE_SUM_REL * |S| (and N alike): both sum f32 terms over
# up to 16.7M pixels, in other orders (the kernel in double per block);
# dz rel-L2 <= RESIZE_CE_DZ_REL, as tests/test_pallas_resize_ce.py.
RESIZE_CE_SUM_REL, RESIZE_CE_DZ_REL = 1e-5, 1e-4
# train: one f32 step (TF32 off) with the kernel vs the plain versions
# from the same copied model and optimizer: the loss within
# TRAIN_LOSS_REL; per-leaf gradient rel-L2 within TRAIN_GRAD_REL (the two
# differ only in the loss tail's dz, 1e-6-level, carried back through
# cuDNN's f32 backward, which sums in its own order), plus TRAIN_GRAD_ABS
# for the leaves whose exact gradient is 0 (a BN bias whose shift the next
# train-mode BN removes; their f32 gradients are ~1e-9 of noise).
TRAIN_LOSS_REL, TRAIN_GRAD_REL, TRAIN_GRAD_ABS = 1e-5, 1e-3, 1e-6
TRAIN_STEPS, TRAIN_TOTAL_STEPS, TRAIN_LR = 5, 1000, 4.5e-4
# fused_cgblock_pre (K4) against its plain version. j: f32 (TF32 off):
# |kernel - plain| <= 1e-4 + 1e-4 |plain| (f32 sums in other orders);
# bf16: j rounds to bf16, the plain version also rounds loc/sur (the
# kernel does not), and y can round the other way where the two f32
# reduce sums straddle a rounding boundary: one bf16 rounding of a value
# as large as the largest |j|, atol = 2^-7 max|j|, rtol = 2^-7.
# Sums, per (n, c): f32 |d| <= CGBLOCK_SUM_REL * sum|j| (f32
# association); bf16: the kernel sums its f32 j, the plain version its
# bf16 j0, so |d| <= sum|j - j0| (the j just held) + 2^-9 (1 + 2^-8)
# sum|j| (the kernel's one rounding of its f32 j to the stored j) +
# CGBLOCK_SUM_REL * sum|j0|. (A bound of 4e-3 sum|j| held before was a
# reading, not a bound: with the inputs drawn after config 4's rows two
# odd shapes read 4.3e-3 and 4.5e-3 on an H100, the strict check below
# passing at 0 and 3 elements one bf16 step apart.)
CGBLOCK_SUM_REL = 1e-5
# bf16 also against cgblock_pre_kernel_rounding, which rounds where the
# kernel rounds (y before the taps, j once, sums over the f32 j), on inputs
# whose reduce and its affine are exact in f32 (x, w1, a1, b1 on a dyadic
# grid), so y is the same on both sides. j then differs only where the two
# f32 orders of the tap sums put j on the other side of a bf16 rounding:
# at most CGBLOCK_BF16_DIFFER of the elements (plus 2, for the small
# shapes), each by one bf16 step (+ 2^-16 max|j| where j cancels to near
# 0); sums within CGBLOCK_SUM_REL. A skipped y rounding or a
# truncated j moves 38-50% of the elements (measured against the Pallas
# kernel in interpret mode at (2,40,64,128) d=4).
CGBLOCK_BF16_DIFFER = 1e-3
# CGNet-19 at batch 8: the two CG-block shapes of predict and their
# launches per predict (stage2: 2 blocks, stage3: 20), at config 5's
# 1024x2048 and at config 4's 768x1536 (the predict after its train step)
CGBLOCK_MAIN = [("stage2", (BATCH, 256, 512, 64), 2, 2),
                ("stage3", (BATCH, 128, 256, 128), 4, 20)]
CGBLOCK_CONFIG4 = [("config4 stage2", (BATCH, 192, 384, 64), 2, 2),
                   ("config4 stage3", (BATCH, 96, 192, 128), 4, 20)]
IGNORE = 255
# ENet has no kernel to hold against a plain version, so the card is held
# against the CPU, f32, TF32 off. Predict of a 2-image slice: the class
# maps differ at no more than ENET_MISMATCH_MAX of the pixels. Where two
# values of a pool window lie within f32 rounding of each other the two
# devices may remember other positions (at most ENET_FLIPS_MAX of the
# windows), and the unpooled value lands one pixel aside: the logits move
# by up to ~0.4 of their std inside the decoder's receptive field of that
# window (within 24 pixels of a down2 window, 8 of a down1 window).
# Outside those fields the logits differ by at most ENET_LOGIT_DIFF_MAX
# of the CPU logits' std (f32 sums in other orders through ~100 convs),
# and a mismatch is a near-tie: the CPU's logits of the two classes lie
# within twice that. One CE + OHEM train step of a 2 x 3 x 256 x 512
# slice: the loss within TRAIN_LOSS_REL; per-leaf gradient rel-L2 within
# ENET_GRAD_REL plus TRAIN_GRAD_ABS (train-mode BN makes the f32 gradient
# ill-conditioned: on the CPU alone, at 2 x 3 x 64 x 128, it moves by up
# to 1.6e-2 when the two images swap places,
# tests/test_torch_enet_train.py; read on an H100 against the CPU: 3.2e-2
# on the worst leaf, 5.8e-3 the median).
ENET_MISMATCH_MAX, ENET_LOGIT_DIFF_MAX, ENET_GRAD_REL = 1e-4, 1e-3, 8e-2
ENET_FLIPS_MAX = 1e-5
ENET_SLICE_HW = (256, 512)
# ERFNet (config 3) and SegNet and LinkNet (config 2, CamVid's 11 classes)
# launch no kernel either and are held against the CPU as ENet is, f32,
# TF32 off: (classes, input H x W of the b8 bf16 runs, the H x W of the
# 2-image slice of the f32 train step). SegNet and LinkNet need sides that
# are multiples of 32, in the reference too: CamVid's 360x480 runs at
# 352x480.
# ESPNet (the decoder on ESPNet-C's encoder, which load_encoder grafts
# from the espnet_c phase's checkpoint) launches none either and runs at
# config 3's size, where ESPNet trained on Cityscapes.
CONFIG3_HW = (512, 1024)
ZOO_CONV = {"erfnet": (19, CONFIG3_HW, (256, 512)),
            "segnet": (11, (352, 480), (256, 352)),
            "linknet": (11, (352, 480), (256, 352)),
            "espnet": (19, CONFIG3_HW, (256, 512)),
            "esnet": (19, CONFIG3_HW, (256, 512)),
            "fpenet": (19, CONFIG3_HW, (256, 512)),
            "fssnet": (19, CONFIG3_HW, (256, 512)),
            "sqnet": (19, CONFIG3_HW, (256, 512)),
            "unet": (19, CONFIG3_HW, (256, 512))}
# Config 4 ("Cityscapes 768px"): the short side 768 at Cityscapes' 1:2
# aspect; every side a multiple of 32, as ESPNetv2's 1/16 level and K1
# and K3 at r = 8 need.
CONFIG4_HW = (768, 1536)
# (classes, input H x W) of each model's runs here where they are not
# config 5's (19 classes at 1024x2048): EDANet and ESPNet-C run at config
# 3's size, ESPNetv2 and DABNet at config 4's
MODEL_INPUT = {"edanet": (CLASSES, CONFIG3_HW),
               "lednet": (CLASSES, CONFIG3_HW),
               "espnet_c": (CLASSES, CONFIG3_HW),
               "espnetv2": (CLASSES, CONFIG4_HW),
               "dabnet": (CLASSES, CONFIG4_HW),
               **{arch: (c, hw) for arch, (c, hw, _) in ZOO_CONV.items()}}
# Predict of a 2-image slice, the card against the CPU: outside the
# fields of the pool windows whose index differs between the devices
# (SegNet's five index pools; the others have none) the logits differ by
# at most ZOO_LOGIT_DIFF_MAX of the CPU logits' std and a mismatch is a
# near-tie (the CPU's logits of the two classes within twice that); at
# most ZOO_MISMATCH_MAX of the pixels outside the fields differ. The f32
# logits of ERFNet and SegNet are ill-conditioned: on the CPU the
# reference's own f32 logits lie up to 1.1e-3 (ERFNet, 0.8 of its std) and
# 2.0e-4 (SegNet) from its f64 ones (tests/test_torch_erfnet_edanet.py,
# tests/test_torch_segnet_linknet.py). The f32 train step of the slice:
# per-leaf gradient rel-L2 within ZOO_GRAD_REL plus TRAIN_GRAD_ABS (on the
# CPU against an f64 oracle at 2x3x64x128: ERFNet 3.0e-2, SegNet 7.6e-3,
# LinkNet 2.2e-4 at 2x3x64x96; read on an H100 against the CPU at these
# slices: ERFNet 3.6e-2, SegNet 1.6e-2, LinkNet 1.0e-2, train-mode BN
# making the f32 gradient ill-conditioned as ENet's), leaving out the
# leaves whose gradient is zero in exact arithmetic
# (``zero_gradient_leaves``: a conv bias that a train-mode BN follows;
# ERFNet's stem bias read 5.2e-6 on the card against 5.2e-6 on the CPU at
# the 256x512 slice, noise on both sides). ESPNet's bounds are LinkNet's
# (its f32 logits are well-conditioned on the CPU, 4.3e-6 from the
# reference's f64 ones, tests/test_torch_espnet.py; read on an H100 against
# the CPU: logits within 9.5e-6, 1.8e-5 of their std, gradient 2.5e-3 at
# most). ESPNetv2's and DABNet's f32 predict of a 2-image slice is held
# the same way (``predict_phase(vs_cpu=True)``; their f32 logits lie
# 2.0e-5 and 1.0e-5 from the reference's f64 ones on the CPU,
# tests/test_torch_espnetv2_dabnet.py; read on an H100 against the CPU:
# 4.8e-6 and 2.0e-5 of their std, mismatch 4.2e-7 and 8.5e-7).
# SegNet's CPU step takes the card step's pool positions
# (``replayed_index_pools``): left to break near-ties in its windows
# itself, it moved the per-leaf gradients by 6.5e-2 (median; 9.5e-2 at
# most) against the card's (read on an H100; its f32 predict of 2 images
# found 16 windows whose index differs between the devices).
ZOO_MISMATCH_MAX = 1e-3
# the kernels a zoo model's predict launches: its fused head, K7 for the
# seven whose last layer is a stride-2 transposed conv, K1 at r = 2 for
# FPENet; SegNet and UNet none
ZOO_PREDICT_LAUNCHES = {
    **{arch: {"subpixel_argmax": 1} for arch in (
        "erfnet", "linknet", "espnet", "esnet", "fssnet", "sqnet")},
    "fpenet": {"resize_argmax": 1}, "segnet": {}, "unet": {}}
#
# LEDNet (a resize tail: K1 a predict, K3 a train step, held as EDANet is
# and its f32 predict against the CPU as ESPNetv2's) and ESNet (a conv
# tail, no kernel, held as ERFNet is): on the CPU at 2x3x64x128 the
# reference's own f32 logits lie 2.4e-4 (LEDNet) and 2.7e-4 (ESNet) from
# its f64 ones (relative to max(1, |logit|); the port's 5.4e-4 and 3.2e-4),
# and the port's f32 step lies 4.8e-2 and 2.5e-2 (worst leaf) from the
# reference's f64 oracle (tests/test_torch_lednet_esnet.py): their residual
# stacks amplify rounding as ERFNet's do, so they take ERFNet's bounds
# (read on an H100 against the CPU: logits within 3.3e-5 (LEDNet) and
# 6.1e-4 (ESNet) of their std, mismatch 9.5e-7 and 5.5e-5; ESNet's step of
# a slice 4.3e-2 at the worst leaf, 2.0e-2 the median).
# FPENet (a resize tail without logits_lowres: no kernel, held as ERFNet
# is): its f32 logits are well-conditioned (the reference's own lie 3.2e-5
# from its f64 ones), so LinkNet's logit bound; its f32 step is not: on
# the CPU it lies 9.8e-2 (worst leaf, an SE gate with one hidden unit)
# from the f64 oracle (tests/test_torch_fpenet.py); read on an H100
# against the CPU: logits within 1.7e-4 of their std, mismatch 1.1e-5, the
# step of a slice 4.4e-2 (worst leaf), 1.5e-2 (median). FSSNet, SQNet and
# UNet (no kernel, held as ERFNet is) are well-conditioned in f32 on the
# CPU: the reference's own f32 logits lie 1.0e-5, 1.5e-6 and 2.0e-5 from
# its f64 ones, the port's f32 step 7.5e-6, 3.5e-4 and 7.8e-6 (worst leaf)
# from the f64 oracle (tests/test_torch_fssnet_sqnet_unet.py, UNet at
# base 8), as LinkNet's (2.2e-4 on the CPU, 1.0e-2 on the card against
# the CPU): LinkNet's bounds. SQNet's and UNet's plain max pools may
# route a window's gradient to another position where two of its values
# lie within f32 rounding of each other on the two devices. Read on an
# H100 against the CPU: logits within 6.6e-5, 1.6e-5 and 7.3e-5 of their
# std, mismatch 9.5e-7, 9.5e-7 and 8.6e-6; the step of a slice 8.0e-3,
# 5.4e-4 and 8.3e-3 at the worst leaf.
ZOO_LOGIT_DIFF_MAX = {"erfnet": 5e-3, "segnet": 2e-3, "linknet": 1e-3,
                      "espnet": 1e-3, "espnetv2": 1e-3, "dabnet": 1e-3,
                      "lednet": 5e-3, "esnet": 5e-3, "fpenet": 1e-3,
                      "fssnet": 1e-3, "sqnet": 1e-3, "unet": 1e-3}
ZOO_GRAD_REL = {"erfnet": 8e-2, "segnet": 3e-2, "linknet": 3e-2,
                "espnet": 3e-2, "esnet": 8e-2, "fpenet": 0.2,
                "fssnet": 3e-2, "sqnet": 3e-2, "unet": 3e-2}
EVAL_VALID = 6
# The CLI phase: items in the train, val and test splits (two train steps
# an epoch, one val and one test batch). Resume: runs resumed from
# model_1.ckpt repeat epoch 2 of a straight run.
#
# The strict check is in f32, TF32 off, cuDNN deterministic (the flag an
# exact resume on the card needs; the CLI leaves it at torch's default):
# the straight run and one resume, the step count, lr and epoch loss
# equal, and every tensor of the epoch-2 checkpoint equal bit for bit
# (parameters, BN running statistics, the optimizer's whole state). It
# holds since K5 and K6 sum the backward of the bilinear upsamples (PPM's
# and the fusion's) and of PPM's adaptive pools in one order: torch's CUDA
# backward of both adds with atomics, and the check then held limits
# (read on an H100: parameters 9.7e-4 to 1.2e-3, statistics ~9e-8, first
# moments 3.3e-3 to 3.7e-3, rel-L2 of the epoch's update). The check also
# runs two faulty resumes, which must differ and lie beyond RESUME_F32 on
# the gaps (rel-L2 of the epoch-2 update, _epoch2_gaps) they corrupt: one
# that drops the optimizer's state (read 1.28 on the parameters, 0.87 on
# the first moments) and one that resets the BN statistics (0.98 on the
# statistics). One that loses the step count fails the step and lr
# checks (chip_smoke.json keeps the readings, "resume_f32").
#
# The bf16 check (the CLI's own dtype and cuDNN's default flags): one
# resume, the step count, lr and epoch loss equal and every tensor of
# the epoch-2 checkpoint equal bit for bit. Without K5 and K6 it was a
# smoke check (two resumes, the straight run within 4x their gap: 0.13 on
# the parameters, 0.42-0.45 on the first moments); with them a bf16 step
# repeats bit for bit under cuDNN's default flags, which an f32 step does
# not (cuDNN's f32 weight gradients; esn_tpu_torch.tools.determinism_probe
# reads both).
CLI_TRAIN, CLI_VAL, CLI_TEST = 16, 8, 8
RESUME_F32 = {"params": 1e-2, "stats": 1e-5, "exp_avg": 3e-2}
ZERO_GRAD_REL = 1e-8
# The CLI phase's last run: --optim ranger --use_lovaszsoftmax --remat, six
# steps an epoch, so that Lookahead syncs at the end of epoch 1 (step 6)
# and within the resumed epoch 2 (step 12), from the slow weights of the
# checkpoint; held by the f32 resume check with the RESUME_F32 limits.
CLI_RANGER_TRAIN = 48

# radam and ranger (Fast-SCNN-19, config 5): OPTIM_STEPS steps cross
# RAdam's rho >= 5 (its sixth step at beta2 = 0.999) and two Lookahead
# syncs (steps 6 and 12). At a sync the parameters must equal slow + 0.5
# (fast - slow) from the slow weights before the step and the fast
# weights of a twin RAdam step on the same state and gradients: the same
# f32 operations in the same order, so bit for bit; checked within
# LOOKAHEAD_REL of the largest |want| all the same, and the bit-equality
# reported. The OPTIM_STEPS f32 steps of a 2x3x256x512 slice on the card
# (TF32 off, dropout off), and the same optimizer on the CPU taking the
# card's gradients and learning rate at each step: what differs is the
# optimizer's f32 arithmetic on each device (an FMA here or there), which
# compounds over the steps without feedback: each parameter within
# OPTIM_CPU_ULP of its largest |value| (16 f32 ulps), the update of all
# parameters together within OPTIM_CPU_REL (rel-L2). Not the CPU's own
# steps: f32 training of Fast-SCNN at this size is chaotic (train-mode BN
# at random init makes the gradient ill-conditioned, and the steps feed
# it back): on the CPU alone, 8 threads against 1 move the 12-step update
# by 0.90 (radam) and 0.61 (adam) rel-L2, and the card against the CPU
# read 0.89 for radam.
OPTIM_STEPS = 12
LOOKAHEAD_REL = 1e-7
OPTIM_CPU_REL, OPTIM_CPU_ULP = 1e-5, 2.0 ** -20

# focal and the two Lovász losses on one forward's f32 logits at config 5:
# focal at gamma 0 is cross_entropy ((1 - p)^0 = 1 exactly: the values
# equal, the gradients within FOCAL_CE_REL rel-L2, the gamma term's
# backward adding zeros); lovasz_hist within its quantisation bound of
# lovasz (lovasz_hist_vs_sort) plus LOVASZ_SUM_REL of the value (f32
# sums of C x N terms in other orders: a tree sum's error, log2(3.2e8) x
# 2^-24 x 2 = 3.4e-6, rounded up); each loss, value and gradient, on a
# 2 x 256 x 512 slice of the logits on the card against the CPU within
# LOSS_CPU_REL (value) and LOSS_CPU_GRAD_REL (gradient rel-L2, by loss):
# softmax, exp and log in other orders (~1e-7); for lovasz also the
# order of the pixels whose errors the two devices round apart, which
# moves their share of the Jaccard increments; for lovasz_hist the key of
# a pixel whose error the two devices round across a bucket's edge, which
# gives it the next bucket's mean increment. Read on an H100 against the
# CPU: focal 1.5e-7, lovasz 9.2e-5, lovasz_hist 2.4e-3 (values equal but
# focal's, 2.1e-7).
LOSS_NAMES = ("focal", "lovasz", "lovasz_hist")
FOCAL_CE_REL = 1e-6
LOVASZ_BUCKETS = 4096
LOVASZ_SUM_REL = 1e-5
# ... and each bucket's tie-block sum of the two versions' gradients with
# respect to the errors within LOVASZ_BLOCK_ABS (both make it from the same
# f32 Jaccard values, each within 2^-24 of the exact one, <= 1: the
# sort's increments telescope to their difference, the hist's count x
# (step / count) rounds once more; 4 x 2^-24, doubled)
LOVASZ_BLOCK_ABS = 2.0 ** -21
LOSS_CPU_REL = 1e-5
LOSS_CPU_GRAD_REL = {"focal": 1e-5, "lovasz": 1e-3, "lovasz_hist": 1e-2}

# remat (the config-5 step, bf16, from the same weights, batch and dropout
# seed, with and without): the loss, the BN running statistics and every
# gradient equal bit for bit (the recompute's forward is the same, it
# moves no statistic, and K5 and K6 sum the upsamples' and pools'
# backward in one order; with torch's atomic backward the gradients were
# held within 4x the gap of two steps without remat), and a second step
# without remat equal too.

# K5 and K6, the port's own kernels (csrc/resize_bilinear_bwd.cu,
# csrc/adaptive_pool_bwd.cu): the backward of the bilinear resize and of
# the adaptive pool in a fixed order, where torch's CUDA backward adds
# with atomics. Each launches once for every recorded resize or adaptive
# pool that a train step back-propagates through: BWD_STEP gives (K5, K6)
# a step by model, with the loss on the low-res logits through K3
# ("lowres") and on the full-resolution logits ("full": one more K5 on a
# resize tail, its x8 upsample; FPENet's resize tail is always full),
# counted on the CPU with the route forced at these sizes and at 64x128.
# Other models launch neither. TPU_KERNELS are K1-K4's counters.
BWD_STEP = {"fastscnn": {"lowres": (5, 4), "full": (6, 4)},
            "espnetv2": {"lowres": (5, 4), "full": (6, 4)},
            "contextnet": {"lowres": (1, 0), "full": (2, 0)},
            "lednet": {"lowres": (3, 0), "full": (4, 0)},
            "edanet": {"lowres": (0, 0), "full": (1, 0)},
            "dabnet": {"lowres": (0, 0), "full": (1, 0)},
            "cgnet": {"lowres": (0, 0), "full": (1, 0)},
            "espnet_c": {"lowres": (0, 0), "full": (1, 0)},
            "fpenet": {"lowres": (3, 0), "full": (3, 0)}}
TPU_KERNELS = ("dsconv", "resize_argmax", "resize_ce_fwd", "resize_ce_bwd",
               "cgblock")
# K5/K6 against their plain versions on the card: f32 within BWD_F32_REL
# of the largest |gradient| (two f32 sums of the same terms in another
# order; the terms a gradient element sums are at most a few hundred at
# these ratios); bf16 within one bf16 step of the plain version (both
# round an f32 sum once, K.bf16_step_gap).
BWD_F32_REL = 1e-5

# The least time the card could take for a kernel's work (bound_ms): the
# larger of its bytes (each input read once, each output written once)
# over HBM_BPS and its operations over the peak rate for their type:
# products of bf16 operands on the tensor cores (BF16_TC_FLOPS), all
# other arithmetic in f32 outside them (F32_FLOPS); NVIDIA H100 SXM data
# sheet, dense, at 700 W. Operations per element, the least each
# algorithm needs: K1 3 per (full-res pixel, class) (the y-blend of the
# column's x-lerped logits, 1 FMA, whose x-lerp a column shares over r
# rows, and a compare and select 2); K3 forward 6 per (valid full-res
# pixel, class) (the blend 2 as K1's, max, the scaled subtraction, exp and
# sum 4; the true logit and the mean are per pixel), backward 9 (lerp 2, softmax 3, gradient 2, the transposed lerp
# 2); K2 18 per (output pixel, input channel) for the depthwise taps and
# 2 Cin per (output pixel, output channel) for the pointwise product; K4
# 2 C per (pixel, reduced channel) for the reduce and 36 per (pixel,
# reduced channel) for the two stencils; K7 2 per multiply-add of the
# taps that lie inside the input (a product: at the tensor cores' rate in
# bf16) and 3 per (output pixel, class) (the bias, a compare and select).
HBM_BPS, F32_FLOPS, BF16_TC_FLOPS = 3.35e12, 67e12, 989e12
# K3's forward also has an SFU floor, beside its bound: one exp a (valid
# pixel, class) and one log a valid pixel at SFU_PER_CLOCK results a clock
# on each SM (CUDA C++ Programming Guide, arithmetic throughput, compute
# capability 9.0), at the card's largest SM clock (nvidia-smi).
SFU_PER_CLOCK = 16


# data parallelism (the data_parallel phase): DP_RANKS ranks on the one card
# under gloo (two ranks and one card: the backend rule picks gloo),
# Fast-SCNN-19 at config 5, a global batch of BATCH, against one process on
# the same batch and weights: DP_CE_STEPS weighted-CE adam steps (K3 1 + 1 a
# step a rank), and one CE + OHEM step from the same starting state. The
# gate is each kind of step taken from equal weights (DP_BOUNDS). f32 (TF32
# off) training of this model is chaotic on the card: two one-process runs
# of three steps ended 0.12 apart (rel-L2 of the parameters' update) when
# they differed only by the atomics of the upsample and pooling backward,
# since adam's first steps move each parameter by ~lr sign(g) and f32 gets
# the sign of the small gradients wrong. K5 and K6 took those atomics out,
# but the phase's f32 steps run with cuDNN's deterministic flag off, whose
# f32 weight gradients still differ run to run
# (esn_tpu_torch.tools.determinism_probe), and two ranks sum BN's moments
# and the gradient in another order than one process does; a bound on
# later steps would have to be as large as what it compares, so later
# steps are held only to the ranks' equality with each other. From equal
# weights:
# - the loss within DP_LOSS_REL and the BN statistics' update (rel-L2)
#   within DP_STATS_REL, for the CE and the OHEM step;
# - the CE step's gradient summed over the ranks (all parameters together)
#   no further from the same step's gradient in f64 on the card
#   (``dp_oracle_grads``) than DP_GRAD_RATIO times the one-process f32
#   gradient is: the first layers' weight gradients sum ~4 M products each
#   with heavy cancellation, and the ranks' convolutions at 4 rows sum them
#   otherwise than at 8 (other cuDNN algorithms), so the two f32 gradients
#   lie 6.6e-3 apart where two one-process runs lie under 2.5e-4. Adam's
#   first update is a function of the gradient alone (m = (1-b1) g,
#   v = (1-b2) g^2), so this also holds the parameters after the step.
# Readings (NVIDIA H100 80GB HBM3, 700 W, before these bounds were set):
# f32 loss 1.0e-7, statistics 2.5e-7, gradient ratio 1.075; bf16 loss 0.0,
# statistics 1.8e-7, ratio 1.0015. bf16 is held to the same bounds, derived
# from f32's as follows: both sides round the same f32 accumulations to
# bf16, an element whose f32 sums differ by d rounds apart with probability
# d / ulp and then by one ulp, so a mean over millions of elements (the
# loss, a BN statistic) differs by ~d on average, as in f32; the gradient
# ratio compares each bf16 run with its own one-process bf16 run. A rank
# that skips a collective fails these bounds tenfold or more: a local CE
# normaliser, local BN moments or unsummed gradients, each planted at a
# small size on the CPU (tests/test_torch_parallel_train.py,
# test_planted_faults_fail_the_first_step_bounds).
DP_RANKS, DP_CE_STEPS, DP_TIMED_STEPS = 2, 3, 5
DP_LOSS_REL, DP_GRAD_RATIO, DP_STATS_REL = 1e-5, 2.0, 1e-4
DP_BOUNDS = {"ce_first": {"loss_rel": DP_LOSS_REL, "stats_rel": DP_STATS_REL,
                          "grad_to_f64_ratio": DP_GRAD_RATIO},
             "ohem_first": {"loss_rel": DP_LOSS_REL,
                            "stats_rel": DP_STATS_REL}}
# the eval batch: DP_EVAL_VALID real images padded to BATCH, 4 rows a rank
DP_EVAL_VALID = 7
# seconds a spawn of ranks, or a torchrun, may take before it is killed
DP_LIMIT = 420.0
# torchrun: cli.train, Fast-SCNN-19 on Cityscapes-shaped synthetic data at
# DP_CLI_HW, batch 8, 2 epochs of one step, f32 (TF32 off through
# NVIDIA_TF32_OVERRIDE=0). Epoch 1's loss is the first step's, from equal
# weights: within DP_LOSS_REL of one process's; a resume restores the
# epoch-1 state whole, so the resumed epoch 2 lies within DP_LOSS_REL of
# the straight one (read: equal); epoch 2 follows one adam step whose small
# gradients' signs f32 gets wrong, within DP_CLI_STEP2_REL of one process's
# (set at 10x an estimate of ~1.9e-4: an epoch-1 mean of steps 1 and 2 read
# 9.5e-5 where step 1 reads ~1e-7; then read on that card: epoch 1 9.6e-8,
# epoch 2 3.3e-5, the resume equal)
DP_CLI_STEP2_REL = 2e-3
DP_CLI_HW = (256, 512)

# spatial sharding (the spatial phase): SP_RANKS ranks on the one card
# under gloo, image height sharded over a model axis of SP_RANKS (n_data
# 1), against one process on the same batch and weights. Both take the
# reference's spatial route, the model's full forward and the plain
# class-weighted CE (no fused resize-CE kernel: K3 reads no rows across
# shards). From equal weights, one adam step in f32 (TF32 off) and one in
# bf16, each held by the data_parallel gate (DP_BOUNDS["ce_first"]): the
# loss, the BN statistics' update, and the gradient's distance to the same
# one-process step in f64 on the card over the one-process f32 (bf16)
# run's. Fast-SCNN-19 at config 5 (IMAGE_HW, global batch BATCH) and
# ENet-19 at config 3's size (SP_ENET_HW). Then the bf16 step's ms and
# peak memory a rank against one process, and its collectives' own cost
# (collective_costs); torchrun cli.train --spatial at SP_CLI_HW for one
# epoch of one step (f32), its loss within DP_LOSS_REL of one process's
# (which takes K3: the same loss to f32 rounding).
SP_RANKS, SP_TIMED_STEPS = 2, 5
SP_ENET_HW = CONFIG3_HW
SP_CLI_HW = DP_CLI_HW
# Fast-SCNN's convs over a shard's window of rows round as over the whole
# tensor (none differs, in f32 and bf16: ``python3 -m
# esn_tpu_torch.tools.spatial_diag``'s ``conv_windows``), and its pooled
# PPM maps are the whole map's (``models/blocks.py``), so both of its
# steps are held to the data_parallel gate as it is. ENet's are not:
# cuDNN runs its transposed and 5x1 convs over a window with other
# algorithms (``conv_windows`` reads which, and at how many elements),
# so (this phase's readings on that card, NVIDIA H100 80GB HBM3, 700 W,
# before these bounds were set) its f32 step's loss and statistics meet
# the gate (3.0e-7, 6.1e-7) while its gradient, led by the first layers'
# weight gradients, each a sum of ~4 M products with heavy cancellation,
# comes out 1.79-1.96 times further from f64 than one process's: held at
# SP_ENET_GRAD_RATIO. In bf16 those one-ulp differences cascade through
# ENet's 16 dilated and asymmetric layers into a 1.0e-4 loss and 4.9e-4
# statistics gap (the same in every run), so its bf16 step is held to
# the f64 step instead: its statistics' update and gradient each no
# further from the f64 step's than SP_TO_F64_RATIO times the one-process
# bf16 step's (read 1.04, 1.02), and its loss within SP_ENET_BF16_LOSS of
# one process's (a scalar's distance to f64 can be near 0 by chance: no
# ratio). Held against a halo fault planted in every row exchange at
# this phase's sizes (``spatial_diag``'s ``faults``, on that card): zero
# halos read, f32, Fast-SCNN loss 1.95e-3, statistics 3.5e-2, gradient
# ratio 163, ENet 7.9e-4, 8.7e-3, 161; bf16 Fast-SCNN loss 1.67e-3,
# statistics 3.5e-2, ENet loss 6.4e-4, statistics and gradient ratios
# 5.3 and 1.34. Each row fetched one row off: f32 Fast-SCNN 8.0e-4,
# 9.9e-3, 139, ENet 3.9e-4, 6.9e-3, 146; bf16 Fast-SCNN 2.6e-4, 9.8e-3,
# ENet 4.1e-4, ratios 4.3 and 1.27. So ENet's bf16 loss bound sits at
# 2.5x its reading, under both faults' 4.1e-4 and 6.4e-4 (2^-8 passed
# them), and each fault breaks at least two bounds of every step.
SP_ENET_GRAD_RATIO, SP_TO_F64_RATIO, SP_ENET_BF16_LOSS = 3.0, 2.0, 2.5e-4
SP_GATES = {
    "fastscnn": {"float32": DP_BOUNDS["ce_first"],
                 "bfloat16": DP_BOUNDS["ce_first"]},
    "enet": {"float32": {**DP_BOUNDS["ce_first"],
                         "grad_to_f64_ratio": SP_ENET_GRAD_RATIO},
             "bfloat16": {"loss_rel": SP_ENET_BF16_LOSS,
                          "stats_to_f64_ratio": SP_TO_F64_RATIO,
                          "grad_to_f64_ratio": SP_TO_F64_RATIO}}}

# uneven spatial shards (the spatial_uneven phase): Fast-SCNN-19 and
# LEDNet-19 at CamVid's native 720x960 over SP_RANKS ranks on the one
# card, as the spatial phase runs config 5. The rows of a stage split
# balanced (``parallel.spatial.bounds``): Fast-SCNN keeps 45 rows at 1/16
# (22 + 23) and 23 at 1/32 (11 + 12), LEDNet's attention pyramid 45, 23
# and 12. The bounds below were set from ``spatial_diag --uneven`` before
# this phase's first reading.
# Before anything is timed, K2 at Fast-SCNN's four eval DSConvs and K1 at
# its predict tail at this size, each against its plain version (their
# column tiles end in tails at 120 and 240 columns). The bounds, with
# ``spatial_diag --uneven``'s readings on that card (NVIDIA H100 80GB
# HBM3, 700 W; sound, and under zero_halo / shifted_halo / t_miscount):
# - Fast-SCNN f32: SP_GATES["fastscnn"] as it is (sound loss 0,
#   statistics 2.7e-7, gradient ratio 1.06; the faults 1.7e-4 / 2.4e-3 /
#   9.1e-4, 4.8e-2 / 1.6e-2 / 8.6e-2, 141 / 144 / 133).
# - Fast-SCNN bf16: the gate's statistics and gradient bounds, and the
#   loss within SP_ENET_BF16_LOSS of one process's, as ENet's bf16 step
#   at config 3 (SP_GATES["enet"]): its convs round over a window as over
#   the whole tensor (``conv_windows``: none of 45 differs), but its BN
#   moments sum a shard at a time and a scale one f32 ulp apart rounds to
#   another bf16 value now and then, so the sound step read a loss 4.5e-5
#   from one process's, over the gate's 1e-5 (statistics 5.7e-6, its
#   distances to the f64 step 1.000 and 0.998 times one process's); the
#   faults read loss 1.2e-3 / 2.4e-3 / 8.5e-4, statistics 4.9e-2 /
#   1.6e-2 / 8.6e-2: each breaks two bounds.
# - LEDNet f32: the data_parallel gate (sound 7.0e-8, 3.3e-7, 0.79; the
#   faults 1.3e-3 / 4.1e-4 / 1.0e-4, 2.0e-2 / 6.8e-3 / 1.7e-2, 97 / 71 /
#   8.0: each breaks all three).
# - LEDNet bf16: cuDNN runs 50 of its 114 convs (the 3x1 ones) otherwise
#   over a window (up to 2.6e-5 of their elements), and its bf16 loss is
#   chaotic at 1e-3 (one process's lies 1.7e-3 from the f64 step's; the
#   sharded step's loss read 1.6e-3 from one process's, the faults
#   1.7-2.5e-3): no loss bound. Its statistics' update within
#   SPU_LEDNET_BF16_STATS of one process's (read 7.8e-4; the faults
#   2.0e-2 / 8.8e-3 / 1.7e-2) and no further from the f64 step's than
#   SPU_LEDNET_TO_F64 times one process's (read 1.005; the faults 5.2 /
#   1.98 / 4.6): each fault breaks both.
# Then ``torchrun
# --nproc_per_node SP_RANKS -m esn_tpu_torch.cli.train --spatial
# SP_RANKS`` at 720x960 for one step and a validation pass (whole images
# split over the ranks: each rank's predicts launch K1 and K2), its loss
# within DP_LOSS_REL of one process's.
CAMVID_HW = (720, 960)
SPU_MODELS = (("fastscnn", CAMVID_HW), ("lednet", CAMVID_HW))
SPU_CLI_HW = CAMVID_HW
SPU_DSCONV = [("fastscnn", "ltd.ds1", (BATCH, 360, 480, 32), 48, 2),
              ("fastscnn", "ltd.ds2", (BATCH, 180, 240, 48), 64, 2),
              ("fastscnn", "head.ds1", (BATCH, 90, 120, 128), 128, 1),
              ("fastscnn", "head.ds2", (BATCH, 90, 120, 128), 128, 1)]
SPU_ARGMAX = (BATCH, 90, 120, CLASSES)
SPU_LEDNET_BF16_STATS, SPU_LEDNET_TO_F64 = 3e-3, 1.5
SPU_GATES = {
    "fastscnn": {"float32": SP_GATES["fastscnn"]["float32"],
                 "bfloat16": {**SP_GATES["fastscnn"]["bfloat16"],
                              "loss_rel": SP_ENET_BF16_LOSS}},
    "lednet": {"float32": DP_BOUNDS["ce_first"],
               "bfloat16": {"stats_rel": SPU_LEDNET_BF16_STATS,
                            "stats_to_f64_ratio": SPU_LEDNET_TO_F64}}}


class SmokeFailure(RuntimeError):
    pass


def bound(nbytes: float, f32_ops: float, product_ops: float = 0.0,
          product_rate: float = F32_FLOPS):
    """(bound ms, what sets it) for this many bytes and operations."""
    t_bytes = nbytes / HBM_BPS
    t_ops = f32_ops / F32_FLOPS + product_ops / product_rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def dsconv_bound(shape, cout, stride, itemsize):
    n, h, w, cin = shape
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    nbytes = ((n * h * w * cin + n * ho * wo * cout) * itemsize
              + (11 * cin + cin * cout + 2 * cout) * 4)
    px = n * ho * wo
    return bound(nbytes, 18 * px * cin, 2 * px * cin * cout,
                 BF16_TC_FLOPS if itemsize == 2 else F32_FLOPS)


def sm_clock_max_mhz() -> float:
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def launches_equal(got, want) -> bool:
    """``got`` (every kernel's count) equal to ``want``, in which a kernel
    left out counts 0."""
    return got == {k: want.get(k, 0) for k in got}


def bwd_launches(arch, steps, full=False):
    """K5's and K6's launches over ``steps`` train steps of ``arch``
    (BWD_STEP)."""
    k5, k6 = BWD_STEP.get(arch, {}).get("full" if full else "lowres", (0, 0))
    return {"resize_bilinear_bwd": k5 * steps,
            "adaptive_pool_bwd": k6 * steps}


def tpu_launches(launches):
    """K1-K4's counts of ``launches``."""
    return {k: launches[k] for k in TPU_KERNELS}


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def dsconv_case(K, torch, gen, shape, cout, stride, dtype, act1="relu",
                act2="relu"):
    """K2 against its plain version, in bf16 also against the emulation of
    its rounding points; the time of each (CUDA events) and the bound."""
    n, h, w, cin = shape
    dev = "cuda"
    # in bf16, x, dw, a1 and b1 on a dyadic grid (the depthwise sums and
    # their affine exact in f32)
    q = ((lambda t, k: torch.round(t * k) / k) if dtype == torch.bfloat16
         else (lambda t, k: t))
    x = q(torch.randn(shape, generator=gen, device=dev), 8).to(dtype)
    dw = q(torch.randn((3, 3, cin), generator=gen, device=dev) / 3, 32)
    pw = torch.randn((cin, cout), generator=gen, device=dev) / math.sqrt(cin)
    a1 = q(torch.rand((cin,), generator=gen, device=dev) + 0.5, 16)
    b1 = q(torch.randn((cin,), generator=gen, device=dev) * 0.1, 256)
    a2 = torch.rand((cout,), generator=gen, device=dev) + 0.5
    b2 = torch.randn((cout,), generator=gen, device=dev) * 0.1
    args = (x, dw, a1, b1, pw, a2, b2)
    kw = dict(stride=stride, act1=act1, act2=act2)
    got = K.fused_dsconv(*args, **kw)
    ref = K.dsconv_ref(*args, **kw)
    torch.cuda.synchronize()
    check(got.shape == ref.shape and got.dtype == x.dtype,
          f"dsconv {shape} shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    err = (got.float() - ref.float()).abs()
    atol, rtol = DSCONV_TOL[str(dtype).split(".")[-1]]
    excess = float((err - atol - rtol * ref.float().abs()).max())
    row = {"shape": list(shape), "cout": cout, "stride": stride,
           "dtype": str(dtype).split(".")[-1], "acts": [act1, act2],
           "max_abs_err": float(err.max()), "atol": atol, "rtol": rtol,
           "within_tol": excess <= 0}
    if dtype == torch.bfloat16:
        differ, far = K.bf16_step_gap(got, K.dsconv_kernel_rounding(*args,
                                                                    **kw))
        allowed = 2 + DSCONV_BF16_DIFFER * got.numel()
        row.update(emul_differ=differ, emul_differ_allowed=allowed,
                   emul_far=far)
        row["within_tol"] &= differ <= allowed and far == 0
    again = K.fused_dsconv(*args, **kw)
    row["bit_identical"] = bool(torch.equal(got, again))
    row["bound_ms"], row["bound_by"] = dsconv_bound(shape, cout, stride,
                                                    x.element_size())
    row.update(ms=cuda_ms(lambda: K.fused_dsconv(*args, **kw)),
               plain_ms=cuda_ms(lambda: K.dsconv_ref(*args, **kw)))
    return row


def upsampled_gap(torch, F, y, r, a, b):
    """|L[a] - L[b]| of the f32 bilinear x r upsample L of NHWC logits y,
    and max(|L[a]|, |L[b]|, 1), at each pixel (a, b: (N, rh, rw) class
    maps)."""
    n, h, w, c = y.shape
    up = F.interpolate(y.permute(0, 3, 1, 2).float(), size=(h * r, w * r),
                       mode="bilinear", align_corners=False)
    la = up.gather(1, a.long()[:, None]).squeeze(1)
    lb = up.gather(1, b.long()[:, None]).squeeze(1)
    mag = torch.clamp(torch.maximum(la.abs(), lb.abs()), min=1.0)
    return (la - lb).abs(), mag


def resize_argmax_case(K, torch, F, gen, shape, r, dtype):
    y = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    got = K.resize_argmax(y, r)
    again = K.resize_argmax(y, r)
    ref = K.resize_argmax_ref(y, r)
    torch.cuda.synchronize()
    n, h, w, c = shape
    check(got.shape == (n, h * r, w * r) and got.dtype == torch.int32,
          f"resize_argmax {shape} r={r}: {tuple(got.shape)} {got.dtype}")
    gap, mag = upsampled_gap(torch, F, y, r, got, ref)
    rel = ARGMAX_GAP[str(dtype).split(".")[-1]]
    bound_ms, bound_by = bound(y.numel() * y.element_size() + got.numel() * 4,
                               3 * got.numel() * c)
    row = {"shape": list(shape), "r": r, "dtype": str(dtype).split(".")[-1],
           "mismatch_rate": float((got != ref).float().mean()),
           "max_abs_err": float(gap.max()), "gap_rel_tol": rel,
           "within_tol": bool((gap <= rel * mag).all()),
           "bit_identical": bool(torch.equal(got, again)),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "ms": cuda_ms(lambda: K.resize_argmax(y, r)),
           "plain_ms": cuda_ms(lambda: K.resize_argmax_ref(y, r))}
    return row


# K7 (subpixel_argmax) at the heads of the seven models whose last layer
# is a stride-2 transposed conv, b8 at each one's size here: (models,
# x (N, H, W, I) under the head, classes, kernel, padding, bias)
K7_HEADS = [("enet", (BATCH, 512, 1024, 16), 19, 3, 1, False),
            ("erfnet, esnet", (BATCH, 256, 512, 16), 19, 2, 0, True),
            ("espnet", (BATCH, 256, 512, 19), 19, 2, 0, False),
            ("fssnet", (BATCH, 256, 512, 16), 19, 3, 1, True),
            ("sqnet", (BATCH, 256, 512, 32), 19, 2, 0, True),
            ("linknet", (BATCH, 176, 240, 32), 11, 2, 0, True),
            ("odd", (2, 37, 53, 19), 11, 3, 1, True)]
# K1 at r = 2: FPENet's x2 head at config 3 and config 5
K1_R2 = [("fpenet config-3 head", (BATCH, 256, 512, CLASSES)),
         ("fpenet config-5 head", (BATCH, 512, 1024, CLASSES))]


def subpixel_argmax_case(K, torch, F, gen, models, shape, cout, k, p, bias,
                         dtype):
    """K7 against its plain version at one head: where the maps differ,
    the exact logits of the two classes within the gap rule
    (``gap_rule``); two launches bit for bit; the time of the kernel, of
    the plain version and of the two-call route the port took before
    (``F.conv_transpose2d`` then ``argmax``: no single PyTorch call
    computes the function), and the bound."""
    import importlib        # kernels.subpixel_argmax is the wrapper
    SA = importlib.import_module(
        "esn_tpu_torch.ops.kernels.subpixel_argmax")
    cin = shape[-1]
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    w = torch.randn((cin, cout, k, k), generator=gen,
                    device="cuda") / math.sqrt(cin * k)
    b = (torch.randn((cout,), generator=gen, device="cuda") * 0.1
         if bias else None)
    kw = dict(stride=(2, 2), padding=(p, p))
    got = K.subpixel_argmax(x, w, b, **kw)
    again = K.subpixel_argmax(x, w, b, **kw)
    ref = K.subpixel_argmax_ref(x, w, b, **kw)
    torch.cuda.synchronize()
    n, h, wd, _ = shape
    check(got.shape == (n, 2 * h, 2 * wd) and got.dtype == torch.int32,
          f"subpixel_argmax {shape}: {tuple(got.shape)} {got.dtype}")
    diff = got != ref
    rule = SA.gap_rule(dtype, w, (2, 2), (p, p))
    gap = rel = torch.zeros(1, device="cuda", dtype=torch.float64)
    if bool(diff.any()):
        gap, mag = SA.argmax_gap(x, w, b, got, ref, **kw)
        gap, rel = gap[diff], (gap / mag)[diff]
        del mag
    xc = x.permute(0, 3, 1, 2)           # NCHW view, channels_last memory

    def two_call():
        z = F.conv_transpose2d(xc, w.to(dtype), None if b is None
                               else b.to(dtype), stride=2, padding=p,
                               output_padding=2 + 2 * p - k)
        return torch.argmax(z, dim=1)
    taps = SA.phase_taps(k, k, (2, 2), (p, p))
    macs = n * cin * cout * sum(max(h - abs(dy), 0) * max(wd - abs(dx), 0)
                                for phase in taps for dy, dx, _ in phase)
    bound_ms, bound_by = bound(
        x.numel() * x.element_size() + got.numel() * 4,
        3 * got.numel() * cout, 2 * macs,
        BF16_TC_FLOPS if dtype == torch.bfloat16 else F32_FLOPS)
    row = {"models": models, "shape": list(shape), "classes": cout,
           "kernel": k, "padding": p, "bias": bias,
           "dtype": str(dtype).split(".")[-1],
           "mismatch_rate": float(diff.float().mean()),
           "max_gap_rel": float(rel.max()), "gap_rule": rule,
           "max_abs_err": float(gap.max()),
           "within_tol": bool((rel <= rule).all()),
           "bit_identical": bool(torch.equal(got, again)),
           "macs": macs, "bound_ms": bound_ms, "bound_by": bound_by,
           "ms": cuda_ms(lambda: K.subpixel_argmax(x, w, b, **kw)),
           "plain_ms": cuda_ms(lambda: K.subpixel_argmax_ref(x, w, b, **kw)),
           "library_ms": cuda_ms(two_call),
           "library_call": "F.conv_transpose2d then torch.argmax (two calls)"}
    return row


def subpixel_ties(K, torch, gen, dtype):
    """K7 on planted exact ties: classes 3 and 7 with the same weights and
    bias (100 above the rest) tie at every pixel, and zero features tie
    every class without a bias; the first class must win everywhere."""
    x = torch.randn((2, 64, 128, 16), generator=gen, device="cuda").to(dtype)
    w = torch.randn((16, 19, 3, 3), generator=gen, device="cuda") / 7
    w[:, 7] = w[:, 3]
    b = torch.zeros(19, device="cuda")
    b[[3, 7]] = 100.0
    kw = dict(stride=(2, 2), padding=(1, 1))
    tied = K.subpixel_argmax(x, w, b, **kw)
    zero = K.subpixel_argmax(torch.zeros_like(x), w, None, **kw)
    return {"dtype": str(dtype).split(".")[-1],
            "tied_3_7_first": bool((tied == 3).all()),
            "zero_features_first": bool((zero == 0).all())}


def kernel_phase(torch, F, K):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    # the four eval DSConvs of Fast-SCNN at batch 8, and the two of
    # ContextNet's five whose shapes no other path gives (its shallow.ds3,
    # ds1 and ds2 are Fast-SCNN's head shape)
    main = [("fastscnn", "ltd.ds1", (BATCH, 512, 1024, 32), 48, 2),
            ("fastscnn", "ltd.ds2", (BATCH, 256, 512, 48), 64, 2),
            ("fastscnn", "head.ds1", (BATCH, 128, 256, 128), 128, 1),
            ("fastscnn", "head.ds2", (BATCH, 128, 256, 128), 128, 1),
            ("contextnet", "shallow.ds1", (BATCH, 512, 1024, 32), 64, 2),
            ("contextnet", "shallow.ds2", (BATCH, 256, 512, 64), 128, 2)]
    dsconv_rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for model, name, shape, cout, stride in main:
            row = dsconv_case(K, torch, gen, shape, cout, stride, dtype)
            row.update(model=model, layer=name)
            dsconv_rows.append(row)
        row = dsconv_case(K, torch, gen, (2, 37, 53, 24), 16, 2, dtype,
                          act1="relu6", act2="none")
        row["layer"] = "odd"
        dsconv_rows.append(row)
    argmax_rows = []
    for dtype in (torch.bfloat16, torch.float32):
        row = resize_argmax_case(K, torch, F, gen, (BATCH, 128, 256, CLASSES),
                                 8, dtype)
        row["layer"] = "predict tail"
        argmax_rows.append(row)
        # EDANet's and ESPNet-C's tail at config 3's 512x1024; ESPNetv2's,
        # DABNet's and CGNet's at config 4's 768x1536
        for layer, hw in (("config-3 predict tail", CONFIG3_HW),
                          ("config-4 predict tail", CONFIG4_HW)):
            row = resize_argmax_case(
                K, torch, F, gen, (BATCH, hw[0] // 8, hw[1] // 8, CLASSES),
                8, dtype)
            row["layer"] = layer
            argmax_rows.append(row)
        # odd: h not a multiple of the band, a partial column tile; r = 5
        # with C = 64, the shared-memory instantiation
        for shape, r in (((2, 13, 21, CLASSES), 3), ((1, 9, 120, 64), 5)):
            row = resize_argmax_case(K, torch, F, gen, shape, r, dtype)
            row["layer"] = "odd"
            argmax_rows.append(row)
        # r = 2: FPENet's fused x2 head
        for layer, shape in K1_R2:
            row = resize_argmax_case(K, torch, F, gen, shape, 2, dtype)
            row["layer"] = layer
            argmax_rows.append(row)
    subpixel_rows, ties = [], []
    for dtype in (torch.bfloat16, torch.float32):
        for head in K7_HEADS:
            subpixel_rows.append(subpixel_argmax_case(K, torch, F, gen, *head,
                                                      dtype))
            torch.cuda.empty_cache()
        ties.append(subpixel_ties(K, torch, gen, dtype))
    for row in dsconv_rows + argmax_rows + subpixel_rows + ties:
        print("kernel", json.dumps(row))
    bad = [r for r in dsconv_rows + argmax_rows + subpixel_rows
           if not r["within_tol"]]
    check(not bad, f"kernel outside tolerance: {bad}")
    check(all(r["bit_identical"] for r in dsconv_rows),
          "fused_dsconv: two launches differ")
    check(all(r["bit_identical"] for r in argmax_rows),
          "resize_argmax: two launches differ")
    check(all(r["bit_identical"] for r in subpixel_rows),
          "subpixel_argmax: two launches differ")
    check(all(t["tied_3_7_first"] and t["zero_features_first"] for t in ties),
          f"subpixel_argmax: a planted tie went to a later class: {ties}")
    return dsconv_rows, argmax_rows, subpixel_rows, ties


# The weight gradient of a bf16 depthwise conv in channels_last memory
# with a row dilation above 1, on the card, against an f64 run on the
# card: on the CPU torch gets it wrong (rel-max 1.2-1.6, NaN at d=8;
# esn_tpu_torch.ops.convolution.conv2d takes that case through NCHW
# copies there, tests/test_torch_conv_bf16_dw.py), so the card's route is
# held at the same shapes ((N, C, H, W), kernel, dilation). dW, dx and the
# output lie within DW_BF16_REL (rel-max) of f64: the CPU's NCHW route
# reads 2.5e-3 to 4.1e-3 at these shapes.
DW_BF16_CASES = [((2, 32, 24, 48), (3, 3), (2, 2)),
                 ((2, 32, 24, 48), (3, 3), (4, 4)),
                 ((2, 32, 24, 48), (3, 1), (2, 1)),
                 ((2, 16, 48, 96), (3, 3), (8, 8)),
                 ((2, 64, 96, 192), (3, 1), (4, 1))]
DW_BF16_REL = 1e-2


def depthwise_bf16_phase(torch):
    """The port's bf16 channels_last depthwise conv at DW_BF16_CASES on
    the card (a ``Conv`` moved to channels_last, as ``build_model`` leaves
    a model's): dW, dx and the output against an f64 run on the card."""
    from esn_tpu_torch.nn import Conv
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    for shape, kernel, dilation in DW_BF16_CASES:
        gen = torch.Generator().manual_seed(0)
        pad = tuple(d * (k // 2) for k, d in zip(kernel, dilation))
        conv = Conv(shape[1], shape[1], kernel, padding=pad,
                    dilation=dilation, groups=shape[1], bias=False)
        conv.reset_parameters(gen)
        x = torch.randn(shape, generator=gen)
        go = torch.randn(shape, generator=gen)
        out = {}
        for dtype in (torch.float64, torch.bfloat16):
            m = copy.deepcopy(conv).to(
                device="cuda", memory_format=torch.channels_last,
                dtype=torch.float64 if dtype == torch.float64
                else torch.float32)
            xx = x.to(device="cuda", dtype=dtype).contiguous(
                memory_format=torch.channels_last).requires_grad_()
            y = m(xx)
            y.backward(go.to(device="cuda", dtype=dtype).contiguous(
                memory_format=torch.channels_last))
            out[dtype] = (y.detach().double(), xx.grad.double(),
                          m.weight.grad.double(), y.is_contiguous(
                              memory_format=torch.channels_last))
        ref, got = out[torch.float64], out[torch.bfloat16]

        def rel(a, b):
            return float((a - b).abs().max() / b.abs().max())
        row = {"shape": list(shape), "kernel": list(kernel),
               "dilation": list(dilation), "dw_rel_max": rel(got[2], ref[2]),
               "dx_rel_max": rel(got[1], ref[1]),
               "y_rel_max": rel(got[0], ref[0]),
               "channels_last_out": got[3], "limit": DW_BF16_REL}
        row["within_tol"] = bool(
            max(row["dw_rel_max"], row["dx_rel_max"], row["y_rel_max"])
            <= DW_BF16_REL and got[3])
        print("depthwise bf16 dW", json.dumps(row))
        rows.append(row)
    torch.backends.cudnn.allow_tf32 = True    # the library default again
    check(all(r["within_tol"] for r in rows),
          f"bf16 depthwise gradients outside {DW_BF16_REL}: {rows}")
    return rows


def cgblock_args(torch, gen, shape, dtype):
    """Seeded K4 inputs; in bf16, x, w1, a1 and b1 on a dyadic grid (the
    reduce and its affine exact in f32)."""
    n, h, w, c = shape
    half, dev = c // 2, "cuda"
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    uni = lambda *s: torch.rand(s, generator=gen, device=dev)   # noqa: E731
    q = ((lambda t, k: torch.round(t * k) / k) if dtype == torch.bfloat16
         else (lambda t, k: t))
    return (q(rnd(*shape), 8).to(dtype),
            q(rnd(c, half) * 0.3 / math.sqrt(c / 64), 32),
            q(rnd(half) * 0.1 + 1.0, 16), q(rnd(half) * 0.1, 256),
            uni(half) * 0.3 + 0.1, rnd(3, 3, half) * 0.3,
            rnd(3, 3, half) * 0.3, rnd(c) * 0.1 + 1.0, rnd(c) * 0.1,
            uni(c) * 0.3 + 0.1)



def cgblock_case(K, torch, gen, shape, d, dtype):
    """K4 against its plain version: j, the sums, bit-identity over two
    launches and a third whose grid is capped at 3 blocks (other blocks
    take the units), and the time of each (CUDA events)."""
    args = cgblock_args(torch, gen, shape, dtype)
    j, s = K.fused_cgblock_pre(*args, d=d)
    j2, s2 = K.fused_cgblock_pre(*args, d=d)
    j3, s3 = K.fused_cgblock_pre(*args, d=d, max_blocks=3)   # another grid
    j0, s0 = K.cgblock_pre_ref(*args, d=d)
    torch.cuda.synchronize()
    name = str(dtype).split(".")[-1]
    check(j.shape == j0.shape and j.dtype == dtype and s.shape == s0.shape,
          f"cgblock {shape} shape {tuple(j.shape)} vs {tuple(j0.shape)}")
    err = (j.float() - j0.float()).abs()
    if name == "float32":
        atol = rtol = 1e-4
    else:
        atol, rtol = 2.0 ** -7 * float(j0.float().abs().max()), 2.0 ** -7
    excess = float((err - atol - rtol * j0.float().abs()).max())
    scale = j0.float().abs().sum((1, 2))
    sum_rel = float(((s - s0).abs() / scale).max())
    sum_bound = CGBLOCK_SUM_REL * scale
    if name == "bfloat16":
        sum_bound = sum_bound + (err.sum((1, 2)) + 2.0 ** -9 * (1 + 2.0 ** -8)
                                 * j.float().abs().sum((1, 2)))
    sum_excess = float(((s - s0).abs() - sum_bound).max())
    n, h, w, c = shape
    px, half, es = n * h * w, c // 2, j.element_size()
    bound_ms, bound_by = bound(
        2 * px * c * es + n * c * 4 + (c * half + 22 * half + 3 * c) * 4,
        36 * px * half, 2 * px * c * half,
        BF16_TC_FLOPS if es == 2 else F32_FLOPS)
    row = {"shape": list(shape), "d": d, "dtype": name,
           "max_abs_err": float(err.max()), "atol": atol, "rtol": rtol,
           "sum_rel_err": sum_rel,
           "sum_bound_rel": float((sum_bound / scale).min()),
           "within_tol": excess <= 0 and sum_excess <= 0,
           "bound_ms": bound_ms, "bound_by": bound_by}
    if name == "bfloat16":
        differ, far, emul_sum_rel = K.bf16_rounding_gap(
            j, s, *K.cgblock_pre_kernel_rounding(*args, d=d))
        allowed = 2 + CGBLOCK_BF16_DIFFER * j.numel()
        row.update(emul_differ=differ, emul_differ_allowed=allowed,
                   emul_far=far, emul_sum_rel_err=emul_sum_rel)
        row["within_tol"] &= (differ <= allowed and far == 0 and emul_sum_rel
                              <= CGBLOCK_SUM_REL)
    row.update(
        bit_identical=bool(torch.equal(j, j2) and torch.equal(s, s2)
                           and torch.equal(j, j3) and torch.equal(s, s3)),
        ms=cuda_ms(lambda: K.fused_cgblock_pre(*args, d=d)),
        plain_ms=cuda_ms(lambda: K.cgblock_pre_ref(*args, d=d)))
    return row


def cgblock_phase(torch, K):
    """K4 at CGNet predict's two shapes at config 5's size and at config
    4's, and at odd shapes (odd H/W,
    d >= H/2 with half = 12, d = 1, and C = 18, whose pixels are not whole
    16-byte vectors; the strip walk's edges: H and W smaller than a strip
    and than d, a last strip of one column and a last segment of one row,
    d larger than the rows of a step, N = 1; all of them with fewer units
    than resident blocks), bf16 and f32, TF32 off."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(4)
    odd = [("odd", (2, 13, 21, 64), 2), ("odd", (1, 9, 7, 24), 4),
           ("odd", (2, 16, 20, 24), 1),
           ("odd", (2, 11, 13, 18), 3),   # C*itemsize not a multiple of 16
           ("odd", (1, 5, 3, 16), 6),     # H, W < d < a strip
           ("odd", (3, 33, 65, 64), 2),   # a last strip and segment of 1
           ("odd", (1, 70, 40, 32), 9),   # d > the 8 rows of a step
           ("odd", (1, 40, 70, 128), 4)]  # N = 1 at stage3's width
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for layer, shape, d, *per_predict in (CGBLOCK_MAIN + CGBLOCK_CONFIG4
                                              + odd):
            row = cgblock_case(K, torch, gen, shape, d, dtype)
            row["layer"] = layer
            if per_predict:
                row["launches_per_predict"] = per_predict[0]
            rows.append(row)
            print("kernel", json.dumps(row))
    torch.backends.cudnn.allow_tf32 = True    # the library default again
    check(all(r["within_tol"] for r in rows),
          f"fused_cgblock_pre outside tolerance: "
          f"{[r for r in rows if not r['within_tol']]}")
    check(all(r["bit_identical"] for r in rows),
          "fused_cgblock_pre: two launches differ")
    return rows


def resize_ce_value_and_grad(torch, fn, z, lab, cw, r, eps):
    zz = z.clone().requires_grad_()
    s, n = fn(zz, lab, cw, r=r, ignore_index=IGNORE, label_smoothing=eps)
    (s / torch.clamp(n, min=1e-8)).backward()
    return s.detach(), n.detach(), zz.grad


def resize_ce_case(K, torch, gen, shape, r, eps, weighted, timed=False,
                   all_ignored=False, scale=1.0):
    """K3 against its plain version: S, N, the loss and dz; for the main
    shape also bit-identity over two launches and the times of forward
    and backward (CUDA events) of each. ``scale`` multiplies the logits
    (x100: a class spreads by more than 64 between two tap rows, where the
    forward takes each pixel's own max)."""
    b, h, w, c = shape
    z = torch.randn(shape, generator=gen, device="cuda") * scale
    lab = torch.randint(0, c, (b, h * r, w * r), generator=gen,
                        device="cuda", dtype=torch.int32)
    drop = torch.rand(lab.shape, generator=gen, device="cuda") < 0.05
    lab = torch.where(drop | all_ignored, torch.full_like(lab, IGNORE), lab)
    cw = (torch.rand((c,), generator=gen, device="cuda") + 0.5
          if weighted else None)
    s, n, dz = resize_ce_value_and_grad(torch, K.resize_ce_sums, z, lab, cw,
                                        r, eps)
    s0, n0, dz0 = resize_ce_value_and_grad(torch, K.resize_ce_sums_ref, z,
                                           lab, cw, r, eps)
    torch.cuda.synchronize()
    loss, loss0 = float(s / max(float(n), 1e-8)), float(s0 / max(float(n0),
                                                                 1e-8))
    dz_norm = float(torch.linalg.norm(dz0))
    dz_rel = float(torch.linalg.norm(dz - dz0)) / max(dz_norm, 1e-30)
    row = {"shape": list(shape), "r": r, "label_smoothing": eps, "scale": scale,
           "weighted": weighted, "S": float(s), "plain_S": float(s0),
           "N": float(n), "plain_N": float(n0), "loss": loss,
           "plain_loss": loss0, "dz_max_abs_err": float((dz - dz0).abs().max()),
           "dz_rel_l2": dz_rel}
    if all_ignored:
        ok = (float(s) == 0.0 and float(n) == 0.0 and math.isfinite(loss)
              and float(dz.abs().max()) == 0.0)
    else:
        ok = (abs(float(s - s0)) <= RESIZE_CE_SUM_REL * abs(float(s0))
              and abs(float(n - n0)) <= RESIZE_CE_SUM_REL * abs(float(n0))
              and dz_rel <= RESIZE_CE_DZ_REL)
    row["within_tol"] = bool(ok)
    if timed:
        # the bounds count the valid pixels of these labels
        nvalid = int(((lab != IGNORE) & (lab >= 0) & (lab < c)).sum())
        zbytes, lbytes = z.numel() * 4, lab.numel() * 4
        row["fwd_bound_ms"], fwd_by = bound(zbytes + lbytes, 6 * nvalid * c)
        row["bwd_bound_ms"], bwd_by = bound(2 * zbytes + lbytes,
                                            9 * nvalid * c)
        row["bound_ms"] = row["fwd_bound_ms"] + row["bwd_bound_ms"]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        row["sm_clock_max_mhz"] = sm_clock_max_mhz()
        row["fwd_sfu_floor_ms"] = 1e3 * nvalid * (c + 1) / (
            sms * SFU_PER_CLOCK * row["sm_clock_max_mhz"] * 1e6)
        row["bound_by"] = (bwd_by if row["bwd_bound_ms"] >= row["fwd_bound_ms"]
                           else fwd_by)
        again = resize_ce_value_and_grad(torch, K.resize_ce_sums, z, lab, cw,
                                         r, eps)
        row["bit_identical"] = all(bool(torch.equal(x, y)) for x, y in
                                   zip((s, n, dz), again))
        for name, fn in (("", K.resize_ce_sums),
                         ("plain_", K.resize_ce_sums_ref)):
            zz = z.clone().requires_grad_()
            kw = dict(r=r, ignore_index=IGNORE, label_smoothing=eps)
            with torch.no_grad():
                row[f"{name}fwd_ms"] = cuda_ms(lambda: fn(z, lab, cw, **kw))
            ss, nn_ = fn(zz, lab, cw, **kw)
            loss_t = ss / torch.clamp(nn_, min=1e-8)
            row[f"{name}bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
                loss_t, zz, retain_graph=True))
            row[f"{name}ms"] = row[f"{name}fwd_ms"] + row[f"{name}bwd_ms"]
    return row


def resize_ce_phase(torch, K):
    """K3 at the train step's shape, at config 4's (ESPNetv2's, DABNet's
    and CGNet's 768x1536), at the CLI phase's (a 512x1024 crop, EDANet's,
    ESPNet-C's and LEDNet's config-3 shape) and at odd shapes, f32 (the only dtype
    K3 takes: a bf16 step casts its logits to f32 for the loss), TF32
    off; the timed shapes also bit for bit over two launches."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = [resize_ce_case(K, torch, gen, (BATCH, 128, 256, CLASSES), 8, 0.0,
                           True, timed=True),
            resize_ce_case(K, torch, gen, (2, 13, 21, CLASSES), 3, 0.1, False),
            resize_ce_case(K, torch, gen, (1, 9, 7, 5), 16, 0.0, True),
            resize_ce_case(K, torch, gen, (2, 13, 21, CLASSES), 3, 0.1, True,
                           scale=100.0),
            resize_ce_case(K, torch, gen, (1, 7, 12, 64), 4, 0.1, True),
            resize_ce_case(K, torch, gen, (1, 8, 8, CLASSES), 8, 0.0, True,
                           all_ignored=True),
            resize_ce_case(K, torch, gen, (BATCH, 64, 128, CLASSES), 8, 0.0,
                           True, timed=True),
            resize_ce_case(K, torch, gen, (BATCH, CONFIG4_HW[0] // 8,
                                           CONFIG4_HW[1] // 8, CLASSES), 8,
                           0.0, True, timed=True)]
    rows[0]["layer"] = "train loss tail"
    rows[-2]["layer"] = "CLI train crop and config 3 (512x1024)"
    rows[-1]["layer"] = "config-4 train loss tail (768x1536)"
    for row in rows:
        print("kernel", json.dumps(row))
    check(all(r["within_tol"] for r in rows),
          f"resize_ce_sums outside tolerance: {rows}")
    check(all(r["bit_identical"] for r in rows if "bit_identical" in r),
          "resize_ce_sums: two launches differ")
    return rows


def bwd_case(K, torch, gen, kind, g_shape, in_hw, dtype, timed=False,
             channels_last=True, scales=None):
    """K5 (``kind`` "resize") or K6 ("pool") on an output gradient of
    ``g_shape`` for an input of ``in_hw`` (K5 by the scale factors
    ``scales`` if given): against its plain version (f32 within
    BWD_F32_REL of the largest |gradient|, bf16 within one bf16 step),
    against torch's own CUDA backward (the library call, f32 within the
    same bound), two launches bit for bit; timed: the times of the kernel,
    the plain version and the library call (CUDA events), and the
    bound."""
    n, c, ho, wo = g_shape
    h, w = in_hw
    g = torch.randn(g_shape, generator=gen, device="cuda").to(dtype)
    if channels_last:
        g = g.contiguous(memory_format=torch.channels_last)
    fmt = (torch.channels_last if channels_last and not g.is_contiguous()
           else torch.contiguous_format)
    if kind == "resize":
        def run():
            return K.resize_bilinear_bwd(g, in_hw, scales)

        def plain():
            return K.resize_bilinear_bwd_ref(g, in_hw, scales)

        def library():
            return torch.ops.aten.upsample_bilinear2d_backward(
                g, [ho, wo], [n, c, h, w], False,
                *(scales if scales is not None else (None, None)))
        f32_ops = 4 * g.numel() + 4 * n * c * ho * w
    else:
        x = torch.empty((n, c, h, w), dtype=dtype, device="cuda",
                        memory_format=fmt)

        def run():
            return K.adaptive_pool_bwd(g, in_hw)

        def plain():
            return K.adaptive_pool_bwd_ref(g, in_hw)

        def library():
            return torch.ops.aten._adaptive_avg_pool2d_backward(g, x)
        f32_ops = n * c * h * w + 2 * g.numel()
    got, again, ref, lib = run(), run(), plain(), library()
    torch.cuda.synchronize()
    check(got.shape == (n, c, h, w) and got.dtype == dtype
          and got.is_contiguous(memory_format=fmt),
          f"{kind} backward {g_shape} -> {in_hw}: {tuple(got.shape)} "
          f"{got.dtype}")
    scale = max(1.0, float(ref.float().abs().max()))
    err = float((got.float() - ref.float()).abs().max())
    lib_err = float((got.float() - lib.float()).abs().max())
    row = {"kind": kind, "g_shape": list(g_shape), "in_hw": list(in_hw),
           "scales": scales, "dtype": str(dtype).split(".")[-1],
           "channels_last": fmt == torch.channels_last,
           "max_abs_err": err, "library_max_abs_err": lib_err,
           "bit_identical": bool(torch.equal(got, again))}
    if dtype == torch.bfloat16:
        differ, far = K.bf16_step_gap(got, ref)
        row.update(bf16_differ=differ, bf16_far=far)
        row["within_tol"] = far == 0
    else:
        row["tol"] = BWD_F32_REL * scale
        row["within_tol"] = err <= row["tol"] and lib_err <= row["tol"]
    row["bound_ms"], row["bound_by"] = bound(
        (g.numel() + got.numel()) * g.element_size(), f32_ops)
    if timed:
        row.update(ms=cuda_ms(run), plain_ms=cuda_ms(plain),
                   library_ms=cuda_ms(library))
    return row


def resize_map_equal(K, torch, F, n_in, n_out):
    """Whether K5 is the transpose of the forward's own map along an axis
    of ``n_in`` -> ``n_out``, bit for bit: ``F.interpolate`` of the
    identity reads the forward's weights, K5 of one-hot output gradients
    the backward's (f32, on the card)."""
    eye = torch.eye(n_in, device="cuda").reshape(n_in, 1, n_in, 1)
    fwd = F.interpolate(eye, size=(n_out, 1), mode="bilinear",
                        align_corners=False).reshape(n_in, n_out)
    g = torch.eye(n_out, device="cuda").reshape(n_out, 1, n_out, 1)
    bwd = K.resize_bilinear_bwd(g, (n_in, 1)).reshape(n_out, n_in)
    return bool(torch.equal(fwd, bwd.t()))


def bwd_routes_equal(K, torch, gen, g_shape, in_hw, scales, dtype):
    """K5's streaming and fan-in routes on the same g give the same bits
    (each element's order depends on its terms alone)."""
    RB = sys.modules["esn_tpu_torch.ops.kernels.resize_bilinear_bwd"]
    g = torch.randn(g_shape, generator=gen, device="cuda").to(dtype) \
        .contiguous(memory_format=torch.channels_last)
    out = []
    for route in (RB.STREAM, RB.FANIN):
        gx = torch.empty(g_shape[:2] + tuple(in_hw), dtype=dtype,
                         device="cuda", memory_format=torch.channels_last)
        RB._launch(g, gx, RB._call(tuple(g_shape), tuple(in_hw), dtype,
                                   True, scales, g.get_device(), route))
        out.append(gx)
    return bool(torch.equal(*out))


def bwd_window_equal(K, torch, gen, ratio, dtype):
    """K5 on a window of input rows [lo, hi) by the whole tensor's scale
    factors, on the output-gradient rows that the window's resize makes
    (as ops/resize.py's sharded backward forms it), gives the whole
    tensor's bits on every row whose run lies inside the window."""
    n, c, h, w, lo, hi = 2, 16, 64, 64, 21, 31
    scales = (float(ratio), float(ratio))
    g = torch.randn((n, c, h * ratio, w * ratio), generator=gen,
                    device="cuda").to(dtype) \
        .contiguous(memory_format=torch.channels_last)
    win = g[:, :, lo * ratio:hi * ratio].contiguous(
        memory_format=torch.channels_last)
    whole = K.resize_bilinear_bwd(g, (h, w), scales)
    part = K.resize_bilinear_bwd(win, (hi - lo, w), scales)
    return bool(torch.equal(part[:, :, 1:-1], whole[:, :, lo + 1:hi - 1]))


# K5's and K6's shapes: Fast-SCNN-19's train step at config 5 (b8,
# 1024x2048; its 1/32 map 32x64): PPM's four pools of the 128-channel map
# (K6, f32: the pool sums in f32) and four upsamples of its 32-channel
# reductions (K5), the fusion's x4 upsample of the 1/32 map to 1/8 (K5),
# and, on a full-resolution loss, the x8 tail of the logits (K5, f32);
# the same model at CamVid's 720x960 (1/32 map 23x30, 1/8 90x120). The
# step's own dtype is bf16 but the pool's and the tail's.
PPM_BINS = (1, 2, 3, 6)


def bwd_phase(torch, F, K):
    """K5 and K6 at the shapes above in f32 and bf16 (bwd_case), timed
    at config 5's; an odd NCHW case each; K5 the transpose of the
    forward's map along every axis of these shapes (resize_map_equal)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    for (layer, lo, hi8, timed) in (("config 5", (32, 64), (128, 256), True),
                                    ("camvid 720x960", (23, 30), (90, 120),
                                     False)):
        for dtype in (torch.bfloat16, torch.float32):
            main = dtype == torch.bfloat16
            for b in PPM_BINS:
                rows.append({**bwd_case(K, torch, gen, "pool",
                                        (BATCH, 128, b, b), lo, dtype,
                                        timed=timed),
                             "layer": f"{layer} ppm pool {b}",
                             "main": timed and dtype == torch.float32})
                rows.append({**bwd_case(K, torch, gen, "resize",
                                        (BATCH, 32, *lo), (b, b), dtype,
                                        timed=timed),
                             "layer": f"{layer} ppm upsample {b}",
                             "main": timed and main})
            rows.append({**bwd_case(K, torch, gen, "resize",
                                    (BATCH, 128, *hi8), lo, dtype,
                                    timed=timed),
                         "layer": f"{layer} fusion x4", "main": timed and main})
    rows.append({**bwd_case(K, torch, gen, "resize",
                            (BATCH, CLASSES, 1024, 2048), (128, 256),
                            torch.float32, timed=True),
                 "layer": "config 5 full-resolution tail x8", "main": False})
    for dtype in (torch.bfloat16, torch.float32):
        rows.append({**bwd_case(K, torch, gen, "resize", (2, 5, 29, 11),
                                (13, 17), dtype, channels_last=False),
                     "layer": "odd", "main": False})
        rows.append({**bwd_case(K, torch, gen, "pool", (2, 5, 2, 3),
                                (13, 17), dtype, channels_last=False),
                     "layer": "odd", "main": False})
    # K5's route edges (untimed): fan-in runs longer than its 32 lanes;
    # the streaming threshold (2^16 input elements) from below and above;
    # streaming bands cut at odd sizes with 19 f32 channels (pixels of 76
    # bytes, rows off 16-byte boundaries); the ratio route streaming; a
    # downscale streaming
    for layer, g_shape, in_hw, scales, dtype in (
            ("edge fan-in run 70", (2, 3, 70, 40), (1, 1), None,
             torch.bfloat16),
            ("edge fan-in 64512 inputs", (2, 8, 126, 128), (63, 64), None,
             torch.float32),
            ("edge streaming 65536 inputs", (2, 8, 128, 128), (64, 64),
             None, torch.float32),
            ("edge odd bands c19", (2, 19, 296, 360), (37, 45), None,
             torch.float32),
            ("edge ratio streaming", (2, 40, 132, 96), (33, 48), (4.0, 2.0),
             torch.bfloat16),
            ("edge downscale streaming", (2, 64, 22, 30), (90, 120), None,
             torch.float32)):
        rows.append({**bwd_case(K, torch, gen, "resize", g_shape, in_hw,
                                dtype, scales=scales),
                     "layer": layer, "main": False})
    routes = {f"{g_shape}->{in_hw} {str(dtype).split('.')[-1]}":
              bwd_routes_equal(K, torch, gen, g_shape, in_hw, scales, dtype)
              for g_shape, in_hw, scales, dtype in (
                  ((BATCH, 32, 32, 64), (1, 1), None, torch.bfloat16),
                  ((BATCH, 32, 32, 64), (6, 6), None, torch.bfloat16),
                  ((2, 128, 128, 256), (32, 64), None, torch.bfloat16),
                  ((1, CLASSES, 256, 512), (32, 64), None, torch.float32),
                  ((2, 64, 22, 30), (90, 120), None, torch.float32))}
    windows = {f"x{r} {str(dtype).split('.')[-1]}":
               bwd_window_equal(K, torch, gen, r, dtype)
               for r in (2, 4, 8) for dtype in (torch.bfloat16, torch.float32)}
    axes = sorted({(b, n) for n in (32, 64, 23, 30) for b in PPM_BINS}
                  | {(32, 128), (64, 256), (23, 90), (30, 120),
                     (128, 1024), (256, 2048), (13, 29), (17, 11)})
    maps = {f"{a}->{b}": resize_map_equal(K, torch, F, a, b)
            for a, b in axes}
    for row in rows:
        print("kernel", json.dumps(row))
    print("resize_bilinear_bwd: the forward's map, transposed bit for bit",
          json.dumps(maps))
    print("resize_bilinear_bwd: the two routes, bit for bit",
          json.dumps(routes))
    print("resize_bilinear_bwd: a window of rows against the whole, bit for "
          "bit", json.dumps(windows))
    check(all(r["within_tol"] for r in rows),
          f"K5/K6 outside tolerance: {[r for r in rows if not r['within_tol']]}")
    check(all(r["bit_identical"] for r in rows),
          "K5/K6: two launches differ")
    check(all(maps.values()), f"K5 is not the forward's map transposed: "
          f"{maps}")
    check(all(routes.values()), f"K5's routes differ: {routes}")
    check(all(windows.values()), f"K5 on a window differs from the whole: "
          f"{windows}")
    return {"rows": rows, "maps": maps, "routes": routes, "windows": windows}


def smooth_images(torch, F, gen, n, hw):
    """Seeded image-like batch: a random field at 1/32 resolution, upsampled,
    plus a little pixel noise, so images differ in their global means (iid
    noise would give every image the same pooled features)."""
    low = torch.randn((n, 3, hw[0] // 32, hw[1] // 32), generator=gen,
                      device=gen.device)
    x = F.interpolate(low, size=hw, mode="bilinear", align_corners=False)
    return x + 0.1 * torch.randn((n, 3, *hw), generator=gen, device=gen.device)


def seeded_model(torch, F, build_model, BatchNorm, seed: int,
                 arch: str = "fastscnn", classes: int = CLASSES):
    """``arch`` (``classes`` classes) on the card: port init from a seeded
    generator, BN affines drawn from it too, running stats from one train
    pass at momentum 1 over a seeded batch, with each variance floored at
    VAR_FLOOR (random weights leave near-dead channels whose tiny batch
    variance would scale them by up to 1/sqrt(eps))."""
    from esn_tpu_torch.nn import set_dropout_generator
    gen = torch.Generator().manual_seed(seed)
    model = build_model(arch, classes, device="cuda", generator=gen)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():
        for bn in bns:
            bn.weight.copy_(torch.rand(bn.weight.shape, generator=gen) + 0.5)
            bn.bias.copy_(torch.randn(bn.bias.shape, generator=gen) * 0.1)
            bn.momentum = 1.0
        calib = smooth_images(torch, F, gen, 4, (512, 1024)).cuda()
        set_dropout_generator(model, torch.Generator(device="cuda")
                              .manual_seed(seed))    # the train-mode pass
        model.train()
        model(calib.contiguous(memory_format=torch.channels_last))
        for bn in bns:
            bn.momentum = 0.1
            bn.running_var.clamp_(min=VAR_FLOOR)
    return model.eval()


@contextlib.contextmanager
def plain_versions(K):
    """Route the model's and the loss's kernel calls to the kernels' plain
    versions (both look them up in ``esn_tpu_torch.ops.kernels`` at call
    time)."""
    names = {"fused_dsconv": K.dsconv_ref, "resize_argmax": K.resize_argmax_ref,
             "resize_ce_sums": K.resize_ce_sums_ref,
             "fused_cgblock_pre": K.cgblock_pre_ref,
             "resize_bilinear_bwd": K.resize_bilinear_bwd_ref,
             "adaptive_pool_bwd": K.adaptive_pool_bwd_ref,
             "subpixel_argmax": K.subpixel_argmax_ref}
    saved = {name: getattr(K, name) for name in names}
    for name, plain in names.items():
        setattr(K, name, plain)
    try:
        yield
    finally:
        for name, kernel in saved.items():
            setattr(K, name, kernel)


def compare_with_plain(torch, F, K, model, make_predict_step, images, dtype):
    """Predict with the kernels and with their plain versions, same model,
    same images; mismatch rate, and whether every mismatch is a near-tie:
    the two classes' f32 upsampled logits (plain run) lie within twice the
    largest low-res logit difference (itself bounded by LOWRES_DIFF_MAX)
    plus the argmax rounding gap."""
    name = str(dtype).split(".")[-1]
    predict = make_predict_step(model, compute_dtype=dtype)
    x = images.to(dtype=dtype, memory_format=torch.channels_last)
    with torch.inference_mode():
        y_kernel, pred_kernel = model.logits_lowres(x), predict(images)
        with plain_versions(K):
            y_plain, pred_plain = model.logits_lowres(x), predict(images)
        y_plain = y_plain.permute(0, 2, 3, 1)
        delta = float((y_kernel.permute(0, 2, 3, 1).float()
                       - y_plain.float()).abs().max())
        mismatch = pred_kernel != pred_plain
        gap, mag = upsampled_gap(torch, F, y_plain, 8, pred_kernel,
                                 pred_plain)
        near_ties = bool((gap <= 2 * delta + ARGMAX_GAP[name] * mag)
                         [mismatch].all())
    std = float(y_plain.float().std())
    diff_max = LOWRES_DIFF_MAX_BY_MODEL.get(type(model).__name__,
                                            LOWRES_DIFF_MAX)[name]
    row = {"model": type(model).__name__, "dtype": name,
           "batch": images.shape[0],
           "mismatch_rate": float(mismatch.float().mean()),
           "mismatch_max": PREDICT_MISMATCH_MAX[name],
           "lowres_logit_max_abs_diff": delta,
           "lowres_logit_std": std,
           "lowres_diff_max": diff_max * std,
           "near_ties_only": near_ties}
    print("predict vs plain", json.dumps(row))
    check(row["mismatch_rate"] <= row["mismatch_max"]
          and delta <= row["lowres_diff_max"] and near_ties,
          f"predict disagrees with its plain versions: {row}")
    return row


def timed_predict(torch, predict, images, iters: int = 10) -> float:
    """Seconds per batch over ``iters`` calls after one warm-up call, host
    clock, synchronised."""
    predict(images)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        predict(images)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters


def predict_phase(torch, F, K, build_model, BatchNorm, make_predict_step,
                  arch, want_launches, hw=IMAGE_HW, vs_cpu=False):
    """``arch`` predict at bf16 b8 3 x ``hw``: the launch counts of one
    predict (``want_launches``), the class map, agreement with the plain
    versions in bf16 and f32, with ``vs_cpu`` the f32 predict of a 2-image
    slice against the CPU (``zoo_predict_vs_cpu``), img/s with the kernels
    and with the plain versions, peak memory."""
    model = seeded_model(torch, F, build_model, BatchNorm, seed=0, arch=arch)
    gen = torch.Generator(device="cuda").manual_seed(1)
    images = smooth_images(torch, F, gen, BATCH, hw)
    predict = make_predict_step(model, compute_dtype=torch.bfloat16)
    predict(images)                                   # warm-up
    torch.cuda.synchronize()

    # the main path, once, with the launch counts from zero
    K.reset_launches()
    pred = predict(images)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    print(f"{arch} predict launches", json.dumps(launches))
    check(launches_equal(launches, want_launches),
          f"{arch}: launch counts per predict {launches}")
    check(tuple(pred.shape) == (BATCH, *hw) and pred.dtype == torch.int32,
          f"predict output {tuple(pred.shape)} {pred.dtype}")
    lo, hi = int(pred.min()), int(pred.max())
    check(0 <= lo and hi < CLASSES, f"predict classes in [{lo}, {hi}]")
    n_classes = int((torch.bincount(pred.flatten().long(),
                                    minlength=CLASSES) > 0).sum())
    print(f"{arch} predict output int32 {tuple(pred.shape)}, classes in "
          f"[{lo}, {hi}], {n_classes} seen")

    compared = [compare_with_plain(torch, F, K, model, make_predict_step,
                                   images, torch.bfloat16)]
    torch.backends.cudnn.allow_tf32 = False
    compared.append(compare_with_plain(torch, F, K, model, make_predict_step,
                                       images, torch.float32))
    torch.backends.cudnn.allow_tf32 = True    # the library default again
    cpu = (zoo_predict_vs_cpu(torch, F, model, images[:2].contiguous(
        memory_format=torch.channels_last), arch) if vs_cpu else None)

    # kernels against plain versions, in turns: plain, kernel, kernel, plain
    torch.cuda.reset_peak_memory_stats()
    times = {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        if which == "plain":
            with plain_versions(K):
                times[which].append(timed_predict(torch, predict, images))
        else:
            times[which].append(timed_predict(torch, predict, images))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms = {k: 1e3 * sum(v) / len(v) for k, v in times.items()}
    img_s = {k: BATCH / (v / 1e3) for k, v in ms.items()}
    print(f"{arch} predict bf16 b{BATCH} {hw[1]}x{hw[0]}: "
          f"{img_s['kernel']:.2f} img/s ({ms['kernel']:.3f} ms/batch) with "
          f"the kernels, {img_s['plain']:.2f} img/s ({ms['plain']:.3f} "
          f"ms/batch) with the plain versions; peak {peak_gb:.2f} GB")
    return {"launches": launches, "classes_seen": n_classes,
            "compared": compared, "vs_cpu": cpu, "img_per_s": img_s["kernel"],
            "plain_img_per_s": img_s["plain"], "ms_per_batch": ms,
            "peak_gb": peak_gb, "batch": BATCH, "hw": list(hw)}


def learnable_labels(torch, F, gen, n, hw, classes=CLASSES):
    """Seeded labels a network can fit: the argmax of a smooth random
    ``classes``-class field (1/16 resolution, upsampled), with a band of
    ignored rows across the middle."""
    low = torch.randn((n, classes, hw[0] // 16, hw[1] // 16), generator=gen,
                      device=gen.device)
    field = F.interpolate(low, size=hw, mode="bilinear", align_corners=False)
    labels = field.argmax(1).to(torch.int32)
    del field
    labels[:, hw[0] // 2 - 16:hw[0] // 2 + 16] = IGNORE
    return labels


def class_weights(torch, labels, classes=CLASSES):
    """The reference's class weights ``1 / ln(1.10 + p_c)`` of the labels'
    class histogram, through the port's ``data.inform``."""
    from esn_tpu_torch.data.inform import compute_class_weights
    hist = torch.bincount(labels[labels != IGNORE].long(), minlength=classes)
    return torch.from_numpy(compute_class_weights(hist.cpu().numpy())).to(
        labels.device)


def config5_loss(cw):
    """The reference's config-5 loss: class-weighted CE plus OHEM, both on
    the same full-resolution NHWC logits."""
    from esn_tpu_torch.train.losses import cross_entropy, ohem_cross_entropy

    def loss(logits, labels):
        return (cross_entropy(logits, labels, num_classes=cw.numel(),
                              class_weights=cw, ignore_index=IGNORE)
                + ohem_cross_entropy(logits, labels, num_classes=cw.numel(),
                                     ignore_index=IGNORE))
    return loss


def config5_step(torch, model, opt, cw, dtype, remat=False):
    """poly lr on ``opt`` with the config-5 loss on the model's own
    full-resolution logits (``fwd_method=None``); dropout masks from a
    seeded generator on the model's device; ``remat`` as the step's."""
    from esn_tpu_torch.train.losses import fused_resize_ce_spec
    from esn_tpu_torch.train.schedules import build_schedule
    from esn_tpu_torch.train.step import make_train_step
    check(fused_resize_ce_spec(model, "ohem") == (None, None),
          "OHEM must not take the fused resize-CE route")
    device = next(model.parameters()).device
    return make_train_step(
        model, config5_loss(cw.to(device)), opt,
        schedule=build_schedule("poly", TRAIN_LR, TRAIN_TOTAL_STEPS),
        compute_dtype=dtype, fwd_method=None, remat=remat,
        generator=torch.Generator(device=device).manual_seed(3))


def train_step(torch, model, opt, cw, dtype, loss="ce", remat=False):
    """train.py's step through the port's entry points, with the loss
    ``loss`` (class-weighted CE, train.py's default, unless told
    otherwise): a CE-family loss through logits_lowres on a resize-tail
    model (the loss owns the x8 upsample: the fused resize-CE kernel), any
    other loss, and any loss of a conv-tail model, on the full logits;
    poly lr on ``opt``; dropout masks from a seeded generator on the
    model's device; ``remat`` as the step's."""
    from esn_tpu_torch.train.losses import build_loss, fused_resize_ce_spec
    from esn_tpu_torch.train.schedules import build_schedule
    from esn_tpu_torch.train.step import make_train_step
    fused, method = fused_resize_ce_spec(model, loss)
    device = next(model.parameters()).device
    fn = functools.partial(fused or build_loss(loss), num_classes=cw.numel(),
                           class_weights=cw.to(device), ignore_index=IGNORE)
    return make_train_step(
        model, fn, opt,
        schedule=build_schedule("poly", TRAIN_LR, TRAIN_TOTAL_STEPS),
        compute_dtype=dtype, fwd_method=method, remat=remat,
        generator=torch.Generator(device=device).manual_seed(3))


def train_setup(torch, F, arch: str = "fastscnn", hw=IMAGE_HW,
                classes: int = CLASSES):
    """``arch`` on the card (port init, seed 0), adam, and one seeded
    batch of 3 x ``hw``: smooth images, learnable labels, their class
    weights."""
    from esn_tpu_torch.models import build_model
    from esn_tpu_torch.train.optimizers import build_optimizer
    model = build_model(arch, classes, device="cuda",
                        generator=torch.Generator().manual_seed(0))
    opt = build_optimizer("adam", model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(3)
    images = smooth_images(torch, F, gen, BATCH, hw)
    labels = learnable_labels(torch, F, gen, BATCH, hw, classes)
    return model, opt, {"image": images, "label": labels}, class_weights(
        torch, labels, classes)


def compare_train_step(torch, K, model, opt, batch, cw, skip=frozenset()):
    """One f32 step (TF32 off) from copies of the same model and optimizer,
    with the kernel and with the plain versions: loss and per-leaf
    gradients, but for the leaves in ``skip`` (gradient 0 in exact
    arithmetic: both runs read rounding noise there)."""
    runs = {}
    for which in ("kernel", "plain"):
        m = copy.deepcopy(model)
        o = type(opt)(m.parameters())
        o.load_state_dict(opt.state_dict())
        step = train_step(torch, m, o, cw, torch.float32)
        with plain_versions(K) if which == "plain" else contextlib.nullcontext():
            loss = float(step(batch)["loss"])
        runs[which] = (loss, {n: p.grad.detach().clone()
                              for n, p in m.named_parameters()})
        del m, o, step
    (loss, grads), (loss0, grads0) = runs["kernel"], runs["plain"]
    diff = {n: float(torch.linalg.norm(grads[n] - g0))
            for n, g0 in grads0.items() if n not in skip}
    norm = {n: float(torch.linalg.norm(grads0[n])) for n in diff}
    excess = {n: diff[n] - TRAIN_GRAD_REL * norm[n] - TRAIN_GRAD_ABS
              for n in diff}
    worst = max(excess, key=excess.get)
    rel = {n: diff[n] / norm[n] for n in diff if norm[n] > 1e3 * TRAIN_GRAD_ABS}
    worst_rel = max(rel, key=rel.get)
    row = {"dtype": "float32", "loss": loss, "plain_loss": loss0,
           "zero_gradient_leaves_left_out": len(skip),
           "loss_rel_diff": abs(loss - loss0) / abs(loss0),
           "loss_rel_max": TRAIN_LOSS_REL, "grad_rel_l2_max": rel[worst_rel],
           "grad_rel_l2_worst_leaf": worst_rel,
           "grad_rel_bound": TRAIN_GRAD_REL, "grad_abs_bound": TRAIN_GRAD_ABS,
           "worst_leaf_by_bound": worst, "worst_leaf_diff": diff[worst],
           "worst_leaf_norm": norm[worst]}
    print("train step vs plain", json.dumps(row))
    check(row["loss_rel_diff"] <= TRAIN_LOSS_REL and excess[worst] <= 0,
          f"train step disagrees with its plain versions: {row}")
    return row


def timed_steps(torch, step, batch, iters: int = 10) -> float:
    """Seconds per train step over ``iters`` steps after one warm-up step,
    host clock, synchronised."""
    step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step(batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters


def train_phase(torch, F, K, BatchNorm, arch="fastscnn", hw=IMAGE_HW):
    """``arch`` (a resize-tail model, 19 classes) training at bf16 b8 3 x
    ``hw`` through the port's entry points: launch counts, a falling loss
    over five steps on one batch, BN running stats that move, the f32 step
    against the plain versions (leaving out the leaves whose gradient is
    zero in exact arithmetic, ``zero_gradient_leaves``), and the step's
    time with the kernel and with the plain versions."""
    model, opt, batch, cw = train_setup(torch, F, arch, hw)
    torch.backends.cudnn.allow_tf32 = False
    _, zero = zero_gradient_leaves(torch, F, arch)
    compared = compare_train_step(torch, K, model, opt, batch, cw, skip=zero)
    torch.backends.cudnn.allow_tf32 = True    # the library default again

    step = train_step(torch, model, opt, cw, torch.bfloat16)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    stats0 = [m.running_mean.clone() for m in bns]
    # the main path, five steps, with the launch counts from zero
    K.reset_launches()
    losses = [float(step(batch)["loss"]) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    print(f"{arch} train launches", json.dumps(launches))
    print(f"{arch} train losses", json.dumps(losses))
    check(launches_equal(launches, {"resize_ce_fwd": TRAIN_STEPS,
                                    "resize_ce_bwd": TRAIN_STEPS,
                                    **bwd_launches(arch, TRAIN_STEPS)}),
          f"launch counts over {TRAIN_STEPS} train steps {launches}")
    check(all(math.isfinite(v) for v in losses), f"train losses {losses}")
    check(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    moved = sum(not torch.equal(m.running_mean, m0)
                for m, m0 in zip(bns, stats0))
    check(moved == len(bns), f"BN running stats moved in {moved} of "
          f"{len(bns)} layers")

    # kernel against plain versions, in turns: plain, kernel, kernel, plain
    torch.cuda.reset_peak_memory_stats()
    times = {"kernel": [], "plain": []}
    peak = {}
    for which in ("plain", "kernel", "kernel", "plain"):
        torch.cuda.reset_peak_memory_stats()
        with plain_versions(K) if which == "plain" else contextlib.nullcontext():
            times[which].append(timed_steps(torch, step, batch))
        peak[which] = max(peak.get(which, 0.0),
                          torch.cuda.max_memory_allocated() / 1e9)
    ms = {k: 1e3 * sum(v) / len(v) for k, v in times.items()}
    img_s = {k: BATCH / (v / 1e3) for k, v in ms.items()}
    print(f"{arch} train bf16 b{BATCH} {hw[1]}x{hw[0]}: "
          f"{img_s['kernel']:.2f} img/s ({ms['kernel']:.3f} ms/step) with "
          f"the kernel, {img_s['plain']:.2f} img/s ({ms['plain']:.3f} "
          f"ms/step) with the plain versions; peak {peak['kernel']:.2f} GB "
          f"vs {peak['plain']:.2f} GB")
    return {"launches": launches, "losses": losses, "bn_layers_moved": moved,
            "compared": compared, "ms_per_step": ms, "img_per_s": img_s,
            "peak_gb": peak, "batch": BATCH, "hw": list(hw),
            "class_weights": cw.tolist()}


def interleaved_phase(torch, F, K, build_model, make_predict_step, arch,
                      want_launches, batch_size: int = 2, hw=IMAGE_HW):
    """A predict step built before a train step of the same model and
    called after it, bf16 at 3 x ``hw``: the predict runs in eval mode
    (``want_launches``, BN running statistics bit for bit as the step left
    them, the class map of a predict of the model put in eval mode by
    hand). Also the host time of what a predict call pays for that: a
    read of every module's ``training`` flag, and one ``model.eval()`` on the
    first call after a train step."""
    from esn_tpu_torch.train.optimizers import build_optimizer
    model = build_model(arch, CLASSES, device="cuda",
                        generator=torch.Generator().manual_seed(0))
    predict = make_predict_step(model, compute_dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(5)
    images = smooth_images(torch, F, gen, batch_size, hw)
    labels = learnable_labels(torch, F, gen, batch_size, hw)
    step = train_step(torch, model, build_optimizer("adam", model.parameters()),
                      class_weights(torch, labels), torch.bfloat16)
    loss = float(step({"image": images, "label": labels})["loss"])
    check(model.training and math.isfinite(loss),
          f"{arch}: after a train step training={model.training} loss={loss}")
    stats = {name: buf.clone() for name, buf in model.named_buffers()}
    K.reset_launches()
    pred = predict(images)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    print(f"{arch} predict after a train step: launches", json.dumps(launches))
    check(launches_equal(launches, want_launches),
          f"{arch}: predict after a train step launched {launches}")
    check(not any(m.training for m in model.modules()),
          f"{arch}: predict left modules in train mode")
    moved = [name for name, buf in model.named_buffers()
             if not torch.equal(buf, stats[name])]
    check(not moved, f"{arch}: predict moved the buffers {moved[:5]}")
    model.eval()
    with torch.inference_mode():
        want = model.predict(images.to(dtype=torch.bfloat16,
                                       memory_format=torch.channels_last))
    check(bool(torch.equal(pred, want)),
          f"{arch}: predict after a train step differs from an eval-mode "
          f"predict at {float((pred != want).float().mean()):.3g} of pixels")
    modules = list(model.modules())
    host_ms = {}
    for name, fn in (("eval", model.eval),
                     ("check", lambda: any(m.training for m in modules))):
        t0 = time.perf_counter()
        for _ in range(100):
            fn()
        host_ms[name] = 1e3 * (time.perf_counter() - t0) / 100
    print(f"{arch}: {len(modules)} modules, host time of model.eval() "
          f"{host_ms['eval']:.4f} ms (the first predict after a train step), "
          f"of the mode check {host_ms['check']:.4f} ms (every predict)")
    return {"launches": launches, "train_loss": loss,
            "modules": len(modules), "eval_call_host_ms": host_ms["eval"],
            "mode_check_host_ms": host_ms["check"], "batch": batch_size,
            "hw": list(hw)}


def planted_ties(torch, gen, shape, dtype):
    """Seeded values with ties inside 2x2 windows: a constant block, two
    values that alternate, and, once rounded to bf16, a block of values
    that lie within one bf16 step of each other."""
    x = torch.randn(shape, generator=gen)
    x[:, :, 2:10, 4:20] = 0.75
    x[:, :, 10:12, 0:4] = torch.tensor([[-1.0, 2.0, 2.0, -1.0],
                                        [2.0, 2.0, -3.0, 2.0]])
    x[:, :, 12:20, 0:16] = 1.0 + 0.004 * torch.rand((8, 16), generator=gen)
    return x.to(dtype)


def pool_phase(torch):
    """``max_pool2d_with_indices_2x2`` then ``max_unpool2d_2x2`` on the
    card against the CPU, bit for bit: values, indices (ties go to the
    first window position), the unpooled tensor and its memory format;
    contiguous and channels_last, f32 and bf16, an even size and an odd
    one with ``output_size``."""
    from esn_tpu_torch.ops import pooling as P
    gen = torch.Generator().manual_seed(6)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for channels_last in (False, True):
            for hw in ((64, 96), (37, 53)):
                x = planted_ties(torch, gen, (2, 16, *hw), dtype)
                if channels_last:
                    x = x.contiguous(memory_format=torch.channels_last)
                fmt = (torch.channels_last if channels_last
                       else torch.contiguous_format)
                xc = x.cuda()
                check(xc.is_contiguous(memory_format=fmt), "pool input format")
                v0, i0 = P.max_pool2d_with_indices_2x2(x)
                v1, i1 = P.max_pool2d_with_indices_2x2(xc)
                u0 = P.max_unpool2d_2x2(v0, i0, hw)
                u1 = P.max_unpool2d_2x2(v1, i1, hw)
                w = 2 * (hw[1] // 2)
                tied = i0[:, :, 1:5, 2:10]     # the constant block's windows
                first = (torch.arange(1, 5)[:, None] * 2 * w
                         + torch.arange(2, 10)[None, :] * 2)
                windows = x[:, :, :2 * (hw[0] // 2), :w].unflatten(
                    2, (-1, 2)).unflatten(4, (-1, 2))
                n_tied = int(((windows == windows.amax((3, 5), keepdim=True))
                              .sum((3, 5)) > 1).sum())
                row = {"dtype": str(dtype).split(".")[-1],
                       "channels_last": channels_last, "hw": list(hw),
                       "tied_windows": n_tied,
                       "values_equal": bool(torch.equal(v0, v1.cpu())),
                       "indices_equal": bool(torch.equal(i0, i1.cpu())),
                       "unpool_equal": bool(torch.equal(u0, u1.cpu())),
                       "first_position": bool((tied == first).all()),
                       "unpool_shape_ok": tuple(u1.shape[2:]) == hw,
                       "format_kept": bool(P.max_unpool2d_2x2(v1, i1)
                                           .is_contiguous(memory_format=fmt))}
                rows.append(row)
                print("pool/unpool", json.dumps(row))
    bad = [r for r in rows if not all(v for k, v in r.items() if k not in
                                      ("dtype", "channels_last", "hw"))]
    check(not bad, f"pool/unpool on the card differs from the CPU: {bad}")
    return rows


def head_vs_full_logits(torch, model, predict, images, iters=5):
    """A model's predict (its fused head) timed in turns with the argmax
    of its full logits, ``argmax_lastdim(model(x))`` (the forward called
    here directly; the port has no switch), bf16, each with its peak
    memory; and how often the two maps differ (near-ties of bf16
    rounding: the head argmaxes f32 phase logits)."""
    from esn_tpu_torch.ops.classify import argmax_lastdim

    @torch.inference_mode()
    def full(imgs):
        x = imgs.to(dtype=torch.bfloat16, memory_format=torch.channels_last)
        return argmax_lastdim(model(x).permute(0, 2, 3, 1))
    runs = {"head": predict, "full_logits": full}
    times, peaks = {k: [] for k in runs}, {k: 0.0 for k in runs}
    for which in ("full_logits", "head", "head", "full_logits"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times[which].append(timed_predict(torch, runs[which], images, iters))
        peaks[which] = max(peaks[which],
                           torch.cuda.max_memory_allocated() / 1e9)
    ms = {k: 1e3 * sum(v) / len(v) for k, v in times.items()}
    n = images.shape[0]
    row = {"img_per_s": {k: n / (v / 1e3) for k, v in ms.items()},
           "ms_per_batch": ms, "peak_gb": peaks,
           "mismatch_rate": float((predict(images) != full(images))
                                  .float().mean())}
    print(f"{type(model).__name__} predict bf16 b{n}: the fused head "
          f"{row['img_per_s']['head']:.2f} img/s, peak "
          f"{peaks['head']:.2f} GB; the full logits "
          f"{row['img_per_s']['full_logits']:.2f} img/s, peak "
          f"{peaks['full_logits']:.2f} GB; maps differ at "
          f"{row['mismatch_rate']:.2e}")
    return row


def enet_predict_phase(torch, F, K, build_model, BatchNorm,
                       make_predict_step):
    """ENet-19 predict at bf16 b8 3x1024x2048: output, launch counts (K7
    once: its fused subpixel head), img/s and peak memory timed in turns
    with the argmax of its full logits; the f32 predict of a 2-image
    slice on the card against the CPU (K7's plain version). Returns the
    model too (the eval phase scores it)."""
    model = seeded_model(torch, F, build_model, BatchNorm, seed=0, arch="enet")
    gen = torch.Generator(device="cuda").manual_seed(1)
    images = smooth_images(torch, F, gen, BATCH, IMAGE_HW)
    predict = make_predict_step(model, compute_dtype=torch.bfloat16)
    predict(images)                                   # warm-up
    torch.cuda.synchronize()
    K.reset_launches()
    pred = predict(images)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    print("enet predict launches", json.dumps(launches),
          "(K7, the fused subpixel head)")
    check(launches_equal(launches, {"subpixel_argmax": 1}),
          f"enet predict launched {launches}")
    check(tuple(pred.shape) == (BATCH, *IMAGE_HW) and pred.dtype == torch.int32,
          f"enet predict output {tuple(pred.shape)} {pred.dtype}")
    lo, hi = int(pred.min()), int(pred.max())
    check(0 <= lo and hi < CLASSES, f"enet predict classes in [{lo}, {hi}]")
    n_classes = int((torch.bincount(pred.flatten().long(),
                                    minlength=CLASSES) > 0).sum())
    check(n_classes > 3, f"enet predict saw {n_classes} classes")
    print(f"enet predict output int32 {tuple(pred.shape)}, classes in "
          f"[{lo}, {hi}], {n_classes} seen")

    # the card against the CPU: f32, TF32 off, a 2-image slice
    torch.backends.cudnn.allow_tf32 = False
    x = images[:2].contiguous(memory_format=torch.channels_last)
    cpu_model = copy.deepcopy(model).to("cpu")
    indices = {"cuda": [], "cpu": []}     # of down1 and down2, in order
    hooks = [block.register_forward_hook(
        lambda _m, _i, out, dev=dev: indices[dev].append(out[1].cpu()))
        for dev, m in (("cuda", model), ("cpu", cpu_model))
        for block in (m.down1, m.down2)]
    with torch.inference_mode():
        logits = model(x).cpu()
        t0 = time.perf_counter()
        logits0 = cpu_model(x.cpu())
        for hook in hooks:
            hook.remove()
        got = make_predict_step(model)(x).cpu()
        want = make_predict_step(cpu_model)(x.cpu())
        cpu_s = time.perf_counter() - t0
    torch.backends.cudnn.allow_tf32 = True    # the library default again
    # the decoder's receptive field of each window whose index differs
    flips, field = [], torch.zeros(logits.shape[0], *logits.shape[2:],
                                   dtype=torch.bool)
    for i_card, i_cpu, cell, radius in zip(indices["cuda"], indices["cpu"],
                                           (4, 8), (2, 3)):
        differ = i_card != i_cpu
        flips.append(int(differ.sum()))
        m = F.max_pool2d(differ.any(1, keepdim=True).float(), 2 * radius + 1,
                         1, radius)
        field |= F.interpolate(m, scale_factor=cell)[:, 0] > 0
    windows = sum(i.numel() for i in indices["cpu"])
    std = float(logits0.std())
    tol = ENET_LOGIT_DIFF_MAX * std
    diff = (logits - logits0).abs()
    mismatch = got != want
    a = logits0.gather(1, got.long()[:, None]).squeeze(1)
    b = logits0.gather(1, want.long()[:, None]).squeeze(1)
    near_ties = bool(((a - b).abs() <= 2 * tol)[mismatch & ~field].all())
    compared = {"dtype": "float32", "batch": 2,
                "mismatch_rate": float(mismatch.float().mean()),
                "mismatch_max": ENET_MISMATCH_MAX,
                "pool_indices_differ": flips, "pool_windows": windows,
                "flips_max": ENET_FLIPS_MAX * windows,
                "pixels_in_their_fields": int(field.sum()),
                "logit_std": std, "logit_diff_tol": tol,
                "logit_diff_median": float(diff.flatten()[::97].median()),
                "logit_max_abs_diff": float(diff.max()),
                "logit_max_abs_diff_elsewhere": float(
                    diff.amax(1)[~field].max()),
                "near_ties_only_elsewhere": near_ties, "cpu_seconds": cpu_s}
    print("enet predict, the card vs the CPU", json.dumps(compared))
    check(compared["mismatch_rate"] <= ENET_MISMATCH_MAX
          and sum(flips) <= compared["flips_max"]
          and compared["logit_max_abs_diff_elsewhere"] <= tol and near_ties,
          f"enet predict on the card disagrees with the CPU: {compared}")

    head = head_vs_full_logits(torch, model, predict, images)
    return model, images, {
        "launches": launches, "classes_seen": n_classes, "compared": compared,
        "img_per_s": head["img_per_s"]["head"],
        "ms_per_batch": head["ms_per_batch"]["head"],
        "peak_gb": head["peak_gb"]["head"], "head_vs_full_logits": head,
        "batch": BATCH}


def compare_step_with_cpu(torch, model, opt, batch, cw, name="enet",
                          make_step=None, slice_hw=ENET_SLICE_HW,
                          grad_rel=ENET_GRAD_REL, skip=frozenset(),
                          replay_pools=False):
    """One f32 step (TF32 off; ``make_step``, the config-5 step by
    default) on a small slice of the batch, from copies of the same model
    and optimizer on the card and on the CPU, dropout off: loss and
    per-leaf gradients, but for the leaves in ``skip`` (gradient 0 in
    exact arithmetic: both devices read rounding noise there). With
    ``replay_pools`` the CPU step takes the card step's index-pool
    positions (``replayed_index_pools``)."""
    from esn_tpu_torch.nn import Dropout
    make_step = make_step or config5_step
    h, w = slice_hw
    runs, pools = {}, []
    for dev in ("cuda", "cpu"):
        m = copy.deepcopy(model).to(dev)
        for sub in m.modules():       # the two devices draw other masks
            if isinstance(sub, Dropout):
                sub.rate = 0.0
        o = type(opt)(m.parameters())
        o.load_state_dict(opt.state_dict())
        step = make_step(torch, m, o, cw, torch.float32)
        pooled = (contextlib.nullcontext() if not replay_pools
                  else recorded_index_pools(pools) if dev == "cuda"
                  else replayed_index_pools(pools))
        with pooled:
            loss = float(step({"image": batch["image"][:2, :, :h, :w].to(dev),
                               "label": batch["label"][:2, :h, :w].to(dev)})
                         ["loss"])
        runs[dev] = (loss, {n: p.grad.detach().cpu()
                            for n, p in m.named_parameters()})
        del m, o, step
    (loss, grads), (loss0, grads0) = runs["cuda"], runs["cpu"]
    diff = {n: float(torch.linalg.norm(grads[n] - g0))
            for n, g0 in grads0.items() if n not in skip}
    norm = {n: float(torch.linalg.norm(grads0[n])) for n in diff}
    excess = {n: diff[n] - grad_rel * norm[n] - TRAIN_GRAD_ABS
              for n in diff}
    worst = max(excess, key=excess.get)
    rel = {n: diff[n] / norm[n] for n in diff if norm[n] > 1e3 * TRAIN_GRAD_ABS}
    worst_rel = max(rel, key=rel.get)
    row = {"dtype": "float32", "slice": [2, 3, h, w], "loss": loss,
           "zero_gradient_leaves_left_out": len(skip),
           "cpu_took_the_card_pool_positions": replay_pools,
           "cpu_loss": loss0, "loss_rel_diff": abs(loss - loss0) / abs(loss0),
           "loss_rel_max": TRAIN_LOSS_REL, "grad_rel_l2_max": rel[worst_rel],
           "grad_rel_l2_median": sorted(rel.values())[len(rel) // 2],
           "grad_rel_l2_worst_leaf": worst_rel,
           "grad_rel_bound": grad_rel, "grad_abs_bound": TRAIN_GRAD_ABS,
           "worst_leaf_by_bound": worst, "worst_leaf_diff": diff[worst],
           "worst_leaf_norm": norm[worst]}
    print(f"{name} train step, the card vs the CPU", json.dumps(row))
    check(row["loss_rel_diff"] <= TRAIN_LOSS_REL and excess[worst] <= 0,
          f"{name} train step on the card disagrees with the CPU: {row}")
    return row


def steps_check(torch, K, BatchNorm, name, model, step, batch,
                loss_name="CE + OHEM"):
    """Five steps on one batch with the launch counts from zero, of a
    step on the full-resolution logits (the config-5 loss, or any loss of
    a conv-tail model): no launch of K1-K4, K5 and K6 as BWD_STEP's
    "full" says, a falling loss, BN running stats that move, finite
    gradients on every leaf."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    stats0 = [m.running_mean.clone() for m in bns]
    K.reset_launches()
    losses = [float(step(batch)["loss"]) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    print(f"{name} {loss_name} train launches", json.dumps(launches),
          "(resize_ce 0: only CE and label smoothing take the fused "
          "resize-CE route)" if hasattr(model, "logits_lowres")
          else "(no kernel of K1-K4 lies on its path)")
    print(f"{name} {loss_name} train losses", json.dumps(losses))
    want = bwd_launches(name, TRAIN_STEPS, full=True)
    check(launches_equal(launches, want),
          f"{name}: a {loss_name} step launched {launches}, want {want}")
    check(all(math.isfinite(v) for v in losses), f"{name} losses {losses}")
    check(losses[-1] < losses[0], f"{name} loss did not fall: {losses}")
    moved = sum(not torch.equal(m.running_mean, m0)
                for m, m0 in zip(bns, stats0))
    check(moved == len(bns), f"{name}: BN running stats moved in {moved} of "
          f"{len(bns)} layers")
    bad = [n for n, p in model.named_parameters()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    check(not bad, f"{name}: no finite gradient on {bad[:5]}")
    return {"launches": launches, "losses": losses, "bn_layers_moved": moved,
            "leaves": sum(1 for _ in model.parameters())}


def enet_train_phase(torch, F, K, BatchNorm):
    """ENet-19 training at bf16 b8 3x1024x2048 with the config-5 loss: the
    f32 step of a slice against the CPU, five steps, ms/step, peak
    memory."""
    model, opt, batch, cw = train_setup(torch, F, "enet")
    torch.backends.cudnn.allow_tf32 = False
    compared = compare_step_with_cpu(torch, model, opt, batch, cw)
    torch.backends.cudnn.allow_tf32 = True    # the library default again
    step = config5_step(torch, model, opt, cw, torch.bfloat16)
    result = steps_check(torch, K, BatchNorm, "enet", model, step, batch)
    torch.cuda.reset_peak_memory_stats()
    sec = timed_steps(torch, step, batch, iters=5)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"enet train (CE + OHEM) bf16 b{BATCH} {IMAGE_HW[1]}x{IMAGE_HW[0]}:"
          f" {BATCH / sec:.2f} img/s ({1e3 * sec:.3f} ms/step); peak "
          f"{peak_gb:.2f} GB")
    result.update(compared=compared, ms_per_step=1e3 * sec,
                  img_per_s=BATCH / sec, peak_gb=peak_gb, batch=BATCH)
    return result


def enet_eval_phase(torch, K, build_model, model, images):
    """``make_eval_step`` on the predict phase's ENet (K7 once a batch):
    labels made from its own prediction, with a band of ignored rows, and
    ``valid`` =
    EVAL_VALID of 8 give a diagonal confusion matrix over the non-ignored
    pixels of the first rows and mIoU 1 over the present classes. Then an
    eval step built before a train step and called after it: eval mode,
    the buffers untouched, the class map of an eval-mode predict."""
    from esn_tpu_torch.train.metrics import iou_from_confusion
    from esn_tpu_torch.train.optimizers import build_optimizer
    from esn_tpu_torch.train.step import make_eval_step
    evaluate = make_eval_step(model, CLASSES, ignore_index=IGNORE,
                              compute_dtype=torch.bfloat16)
    pred0, _ = evaluate({"image": images, "label": torch.zeros(
        (BATCH, *IMAGE_HW), dtype=torch.int32, device="cuda")})
    labels = pred0.clone()
    labels[:, IMAGE_HW[0] // 2 - 16:IMAGE_HW[0] // 2 + 16] = IGNORE
    K.reset_launches()
    pred, cm = evaluate({"image": images, "label": labels,
                         "valid": EVAL_VALID})
    torch.cuda.synchronize()
    check(launches_equal(dict(K.LAUNCHES), {"subpixel_argmax": 1}),
          f"enet eval launched {K.LAUNCHES}")
    check(bool(torch.equal(pred, pred0)), "two eval steps differ")
    counted = int((labels[:EVAL_VALID] != IGNORE).sum())
    iou, miou = iou_from_confusion(cm)
    present = int((cm.sum(0) + cm.sum(1) > 0).sum())
    row = {"cm_sum": int(cm.sum()), "pixels_counted": counted,
           "off_diagonal": int(cm.sum() - torch.diagonal(cm).sum()),
           "classes_present": present, "miou": float(miou),
           "valid": EVAL_VALID, "cm_dtype": str(cm.dtype)}
    print("enet eval", json.dumps(row))
    check(tuple(cm.shape) == (CLASSES, CLASSES) and cm.dtype == torch.int64
          and row["cm_sum"] == counted and row["off_diagonal"] == 0
          and present > 3 and row["miou"] == 1.0,
          f"enet eval step: {row}")
    sec = timed_predict(torch, lambda x: evaluate(
        {"image": x, "label": labels, "valid": EVAL_VALID}), images, iters=5)
    row.update(ms_per_batch=1e3 * sec, img_per_s=BATCH / sec)
    print(f"enet eval step bf16 b{BATCH}: {BATCH / sec:.2f} img/s "
          f"({1e3 * sec:.3f} ms/batch)")

    # built before a train step, called after it (batch 2)
    fresh = build_model("enet", CLASSES, device="cuda",
                        generator=torch.Generator().manual_seed(0))
    evaluate = make_eval_step(fresh, CLASSES, ignore_index=IGNORE,
                              compute_dtype=torch.bfloat16)
    small = {"image": images[:2], "label": labels[:2]}
    cw = class_weights(torch, small["label"])
    step = config5_step(torch, fresh,
                        build_optimizer("adam", fresh.parameters()), cw,
                        torch.bfloat16)
    loss = float(step(small)["loss"])
    check(fresh.training and math.isfinite(loss),
          f"enet: after a train step training={fresh.training} loss={loss}")
    stats = {name: buf.clone() for name, buf in fresh.named_buffers()}
    pred, cm = evaluate(small)
    check(not any(m.training for m in fresh.modules()),
          "enet: the eval step left modules in train mode")
    moved = [name for name, buf in fresh.named_buffers()
             if not torch.equal(buf, stats[name])]
    check(not moved, f"enet: the eval step moved the buffers {moved[:5]}")
    fresh.eval()
    with torch.inference_mode():
        want = fresh.predict(small["image"].to(
            dtype=torch.bfloat16, memory_format=torch.channels_last))
    check(bool(torch.equal(pred, want)),
          "enet: eval after a train step differs from an eval-mode predict")
    check(int(cm.sum()) == int((small["label"] != IGNORE).sum()),
          "enet: eval after a train step miscounts")
    print("enet eval after a train step: eval mode, buffers untouched")
    row["after_train_loss"] = loss
    return row


def config5_ab_phase(torch, F, K, BatchNorm, arch="fastscnn", iters=5):
    """``arch`` (a resize-tail model: Fast-SCNN-19 or ContextNet-19) with
    the config-5 loss at bf16 b8 3x1024x2048, ``fwd_method=None``: five
    steps, then its time and peak memory in turns with the weighted-CE
    step through the fused resize-CE kernel (the same model and step with
    and without K3: the price of leaving the fused tail)."""
    model, opt, batch, cw = train_setup(torch, F, arch)
    step = config5_step(torch, model, opt, cw, torch.bfloat16)
    result = steps_check(torch, K, BatchNorm, arch, model, step, batch)
    fused = train_step(torch, model, opt, cw, torch.bfloat16)
    times, peak = {"ce": [], "ce_ohem": []}, {}
    for which in ("ce", "ce_ohem", "ce_ohem", "ce"):
        torch.cuda.reset_peak_memory_stats()
        times[which].append(timed_steps(
            torch, fused if which == "ce" else step, batch, iters=iters))
        peak[which] = max(peak.get(which, 0.0),
                          torch.cuda.max_memory_allocated() / 1e9)
    ms = {k: 1e3 * sum(v) / len(v) for k, v in times.items()}
    print(f"{arch} train bf16 b{BATCH} {IMAGE_HW[1]}x{IMAGE_HW[0]}: CE + "
          f"OHEM on full-resolution logits {ms['ce_ohem']:.3f} ms/step, peak "
          f"{peak['ce_ohem']:.2f} GB; weighted CE through the fused resize-CE "
          f"kernel {ms['ce']:.3f} ms/step, peak {peak['ce']:.2f} GB")
    result.update(ms_per_step=ms, peak_gb=peak, batch=BATCH)
    return result


@contextlib.contextmanager
def replayed_index_pools(store):
    """Make every ``max_pool2d_with_indices_2x2`` call take the next
    indices of ``store`` (recorded on the card by
    ``recorded_index_pools``) in place of its own: the values at those
    positions (a gather, whose gradient reaches those positions, as the
    pool's does), so that a CPU run follows the card's pool positions
    where the two would break a near-tie in a window otherwise."""
    from esn_tpu_torch.ops import pooling as P
    real = P.max_pool2d_with_indices_2x2

    def replaying(x):
        idx = store.pop(0).to(x.device)
        plane = x[:, :, :2 * idx.shape[2], :2 * idx.shape[3]].flatten(2)
        return plane.gather(2, idx.flatten(2)).view_as(idx), idx
    P.max_pool2d_with_indices_2x2 = replaying
    try:
        yield
    finally:
        P.max_pool2d_with_indices_2x2 = real


@contextlib.contextmanager
def recorded_index_pools(store):
    """Append the indices of every ``max_pool2d_with_indices_2x2`` call
    (the models look it up in ``esn_tpu_torch.ops.pooling`` at call time)
    to ``store``, on the CPU."""
    from esn_tpu_torch.ops import pooling as P
    real = P.max_pool2d_with_indices_2x2

    def recording(x):
        values, idx = real(x)
        store.append(idx.cpu())
        return values, idx
    P.max_pool2d_with_indices_2x2 = recording
    try:
        yield
    finally:
        P.max_pool2d_with_indices_2x2 = real


def segnet_field_radii():
    """SegNet's decoder receptive radius (full-resolution pixels) of a
    value that the unpool of pool level i puts one place aside: one cell
    of 2^i pixels, then the n_i 3x3 convs at that level, those of every
    finer level and the head conv."""
    from esn_tpu_torch.models.segnet import VGG_CFG
    n = [k for _, k in VGG_CFG]
    return [2 ** i * (1 + n[i]) + sum(2 ** k * n[k] for k in range(i)) + 1
            for i in range(len(n))]


def zoo_predict_vs_cpu(torch, F, model, x, arch):
    """The f32 logits and class map of ``x`` on the card against the CPU
    (TF32 off): mismatches outside the receptive fields of the pool
    windows whose remembered position differs between the devices must
    be near-ties and rare, and the logits there close."""
    from esn_tpu_torch.ops.classify import argmax_lastdim
    from esn_tpu_torch.train.step import make_predict_step
    torch.backends.cudnn.allow_tf32 = False
    cpu_model = copy.deepcopy(model).to("cpu")
    indices = {"cuda": [], "cpu": []}
    with torch.inference_mode():
        with recorded_index_pools(indices["cuda"]):
            logits = model(x).cpu()
        got = make_predict_step(model)(x).cpu()
        t0 = time.perf_counter()
        with recorded_index_pools(indices["cpu"]):
            logits0 = cpu_model(x.cpu())
        cpu_s = time.perf_counter() - t0
        want = argmax_lastdim(logits0.permute(0, 2, 3, 1))
    torch.backends.cudnn.allow_tf32 = True    # the library default again
    n, _, h, w = logits.shape
    field = torch.zeros((n, h, w), dtype=torch.bool)
    flips = []
    radii = segnet_field_radii() if indices["cpu"] else []
    for i_card, i_cpu, radius in zip(indices["cuda"], indices["cpu"], radii):
        differ = (i_card != i_cpu).any(1, keepdim=True).float()
        flips.append(int((i_card != i_cpu).sum()))
        cell = h // differ.shape[2]
        r = -(-radius // cell) + 1
        m = F.max_pool2d(differ, 2 * r + 1, 1, r)
        field |= F.interpolate(m, scale_factor=cell)[:, 0] > 0
    windows = sum(i.numel() for i in indices["cpu"])
    std = float(logits0.std())
    tol = ZOO_LOGIT_DIFF_MAX[arch] * std
    diff = (logits - logits0).abs().amax(1)
    mismatch = got != want
    a = logits0.gather(1, got.long()[:, None]).squeeze(1)
    b = logits0.gather(1, want.long()[:, None]).squeeze(1)
    outside = ~field
    row = {"dtype": "float32", "batch": n, "hw": [h, w],
           "mismatch_rate": float(mismatch.float().mean()),
           "mismatch_rate_elsewhere": float(
               (mismatch & outside).sum()) / max(int(outside.sum()), 1),
           "mismatch_max": ZOO_MISMATCH_MAX,
           "pool_indices_differ": flips, "pool_windows": windows,
           "field_share": float(field.float().mean()),
           "logit_std": std, "logit_diff_tol": tol,
           "logit_max_abs_diff": float(diff.max()),
           "logit_max_abs_diff_elsewhere": float(diff[outside].max()),
           "near_ties_only_elsewhere": bool(
               ((a - b).abs() <= 2 * tol)[mismatch & outside].all()),
           "cpu_seconds": cpu_s}
    print(f"{arch} predict, the card vs the CPU", json.dumps(row))
    check(row["mismatch_rate_elsewhere"] <= ZOO_MISMATCH_MAX
          and row["field_share"] <= 0.5
          and row["logit_max_abs_diff_elsewhere"] <= tol
          and row["near_ties_only_elsewhere"],
          f"{arch} predict on the card disagrees with the CPU: {row}")
    return row


def zoo_conv_phase(torch, F, K, BatchNorm, build_model, make_predict_step,
                   arch, prepare=None):
    """``arch`` (a model of ZOO_CONV, which gives its classes and sizes;
    ``prepare(model)``, where given, runs on each model
    once it is built: ESPNet's encoder graft) at full width and depth, b8
    bf16, through ``build_model``,
    ``make_predict_step`` and ``make_train_step``. Its predict launches
    its fused head (ZOO_PREDICT_LAUNCHES: K7 or K1) and its train step no
    kernel of K1-K4, so the card is held against the CPU, as ENet is:
    predict (the launch counts, the f32 predict of a 2-image slice against
    the CPU, img/s and peak memory, with a head timed in turns with the
    argmax of the full logits), one f32 train step of a slice against the
    CPU (loss, per-leaf
    gradients), five steps with class-weighted CE on the full logits (a
    falling loss, moving BN statistics, finite gradients on every leaf),
    ms/step and peak memory."""
    classes, hw, slice_hw = ZOO_CONV[arch]
    model = seeded_model(torch, F, build_model, BatchNorm, seed=0, arch=arch,
                         classes=classes)
    prepared = prepare(model) if prepare else None
    gen = torch.Generator(device="cuda").manual_seed(1)
    images = smooth_images(torch, F, gen, BATCH, hw)
    predict = make_predict_step(model, compute_dtype=torch.bfloat16)
    predict(images)                                   # warm-up
    torch.cuda.synchronize()
    K.reset_launches()
    pred = predict(images)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    want = ZOO_PREDICT_LAUNCHES[arch]
    print(f"{arch} predict launches", json.dumps(launches),
          f"(its head: {json.dumps(want)})")
    check(launches_equal(launches, want),
          f"{arch} predict launched {launches}, want {want}")
    check(tuple(pred.shape) == (BATCH, *hw) and pred.dtype == torch.int32,
          f"{arch} predict output {tuple(pred.shape)} {pred.dtype}")
    lo, hi = int(pred.min()), int(pred.max())
    check(0 <= lo and hi < classes, f"{arch} predict classes in [{lo}, {hi}]")
    compared = zoo_predict_vs_cpu(
        torch, F, model, images[:2].contiguous(
            memory_format=torch.channels_last), arch)
    if want:
        head = head_vs_full_logits(torch, model, predict, images)
        sec, predict_peak = (head["ms_per_batch"]["head"] / 1e3,
                             head["peak_gb"]["head"])
    else:
        torch.cuda.reset_peak_memory_stats()
        sec, head = timed_predict(torch, predict, images, iters=5), None
        predict_peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"{arch} predict bf16 b{BATCH} {hw[1]}x{hw[0]}: {BATCH / sec:.2f} "
          f"img/s ({1e3 * sec:.3f} ms/batch); peak {predict_peak:.2f} GB")
    result = {"predict": {"launches": launches, "compared": compared,
                          "img_per_s": BATCH / sec, "ms_per_batch": 1e3 * sec,
                          "peak_gb": predict_peak,
                          "head_vs_full_logits": head}, "prepared": prepared}
    del model, predict, images, pred
    torch.cuda.empty_cache()

    model, opt, batch, cw = train_setup(torch, F, arch, hw, classes)
    if prepare:
        prepare(model)
    torch.backends.cudnn.allow_tf32 = False
    _, zero = zero_gradient_leaves(torch, F, arch, classes)
    compared = compare_step_with_cpu(torch, model, opt, batch, cw, name=arch,
                                     make_step=train_step, slice_hw=slice_hw,
                                     grad_rel=ZOO_GRAD_REL[arch], skip=zero,
                                     replay_pools=arch == "segnet")
    torch.backends.cudnn.allow_tf32 = True    # the library default again
    step = train_step(torch, model, opt, cw, torch.bfloat16)
    train = steps_check(torch, K, BatchNorm, arch, model, step, batch,
                        loss_name="CE")
    torch.cuda.reset_peak_memory_stats()
    sec = timed_steps(torch, step, batch, iters=5)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"{arch} train (CE) bf16 b{BATCH} {hw[1]}x{hw[0]}: "
          f"{BATCH / sec:.2f} img/s ({1e3 * sec:.3f} ms/step); peak "
          f"{peak_gb:.2f} GB")
    train.update(compared=compared, ms_per_step=1e3 * sec,
                 img_per_s=BATCH / sec, peak_gb=peak_gb)
    result.update(train=train, batch=BATCH, hw=list(hw), classes=classes)
    return result


def espnet_c_checkpoint(torch, F, build_model, BatchNorm, savedir):
    """ESPNet-C-19 on the card (seeded, BN statistics from a calibration
    pass) saved as a checkpoint of the port's in ``savedir``, as the first
    stage of ESPNet's two-stage recipe leaves it; returns its path."""
    from esn_tpu_torch.train import checkpoint as ckpt
    from esn_tpu_torch.train.optimizers import build_optimizer
    from esn_tpu_torch.train.state import TrainState
    model = seeded_model(torch, F, build_model, BatchNorm, seed=7,
                         arch="espnet_c")
    return ckpt.save_checkpoint(savedir, 1, TrainState(
        model, build_optimizer("adam", model.parameters())))


def graft_encoder(torch, path, model):
    """``load_encoder`` of the ESPNet-C checkpoint at ``path`` into
    ``model.enc`` (on the card), then every grafted leaf against the
    donor's, bit for bit; returns the number of leaves grafted."""
    from esn_tpu_torch.train import checkpoint as ckpt
    ckpt.load_encoder(path, model)
    donor = _state(torch, path)["model"]
    enc = model.enc.state_dict()
    check(set(enc) == set(donor) - {"head.weight"},
          f"grafted leaves {sorted(set(enc) ^ set(donor))[:5]} differ")
    bad = [k for k, v in enc.items() if not torch.equal(v.cpu(), donor[k])]
    check(not bad, f"grafted encoder leaves differ from the donor's: {bad[:5]}")
    return len(enc)


def _cli(main, argv):
    """``main(argv)`` with its standard output captured; returns the
    output (the CLIs print their report)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    check(rc == 0, f"{main.__module__} returned {rc}")
    return buf.getvalue()


def _launch_delta(K, run):
    """``run()`` with the launch counts from zero; returns (its result,
    the counts)."""
    K.reset_launches()
    out = run()
    return out, dict(K.LAUNCHES)


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _state(torch, path):
    return torch.load(path, map_location="cpu", weights_only=True)["state"]


def _epoch2_gaps(one, a, b):
    """How far run b's epoch 2 lies from run a's, both from the state
    ``one``: the rel-L2 of the epoch's update of all parameters together,
    of all BN running statistics together, and its median over the
    leaves; the rel-L2 of all adam first moments together."""
    import numpy as np
    import torch

    def cat(ts):
        return torch.cat([t.double().flatten() for t in ts])

    def update(run, k):
        return run["model"][k].double() - one["model"][k].double()

    stats = [k for k in a["model"]
             if k.endswith(("running_mean", "running_var"))]
    params = [k for k in a["model"] if a["model"][k].is_floating_point()
              and k not in stats]
    moments = [[v["exp_avg"] for v in run["optimizer"]["state"].values()]
               for run in (a, b)]
    return {
        "params": _rel(cat([update(b, k) for k in params]),
                       cat([update(a, k) for k in params])),
        "stats": _rel(cat([update(b, k) for k in stats]),
                      cat([update(a, k) for k in stats])),
        "median_leaf": float(np.median([_rel(update(b, k), update(a, k))
                                        for k in params + stats])),
        "exp_avg": _rel(cat(moments[1]), cat(moments[0]))}


def zero_gradient_leaves(torch, F, arch="fastscnn", classes=CLASSES):
    """(``arch``'s parameter names in the optimizer's order, those whose
    gradient is zero in exact arithmetic, such as a conv bias that a
    train-mode BN follows): one f64 backward of CE on the CPU, 2x3x64x128,
    train mode, dropout off; a gradient under ZERO_GRAD_REL of the
    largest."""
    from esn_tpu_torch.models import build_model
    from esn_tpu_torch.nn import Dropout
    model = build_model(arch, classes, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    model.double().train()
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 3, 64, 128), generator=gen, dtype=torch.float64)
    lab = torch.randint(0, classes, (2, 64, 128), generator=gen)
    F.cross_entropy(model(x), lab).backward()
    grads = {n: float(p.grad.abs().max())
             for n, p in model.named_parameters()}
    top = max(grads.values())
    return list(grads), {n for n, g in grads.items()
                         if g <= ZERO_GRAD_REL * top}


def _losing(load, what):
    """A faulty ``checkpoint.load_checkpoint``: ``load``, then the
    optimizer's state dropped or the BN statistics reset."""
    def faulty(path, state):
        state, meta = load(path, state)
        if what == "optimizer":
            state.optimizer.state.clear()
        else:
            for name, buf in state.model.named_buffers():
                if name.endswith("running_mean"):
                    buf.zero_()
                elif name.endswith("running_var"):
                    buf.fill_(1.0)
        return state, meta
    return faulty


def differing(torch, a, b, at=""):
    """The paths in two nested states (dicts, lists, tensors, numbers) at
    which they are not equal bit for bit."""
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return [f"{at}: keys"]
        return [p for k in a for p in differing(torch, a[k], b[k],
                                                f"{at}/{k}")]
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return [f"{at}: length"]
        return [p for i, (x, y) in enumerate(zip(a, b))
                for p in differing(torch, x, y, f"{at}/{i}")]
    if torch.is_tensor(a) and torch.is_tensor(b):
        same = (a.shape == b.shape and a.dtype == b.dtype
                and torch.equal(a, b))
        return [] if same else [at]
    return [] if a == b else [at]


def check_f32_resume(torch, F, cli_train, args, tmp, prefix="f32"):
    """The strict resume check: two epochs straight, then epoch 2 again
    from its ``model_1.ckpt``, f32, TF32 off, cuDNN deterministic. The
    resumed run's step, lr and epoch loss equal the straight run's, and
    its ``model_2.ckpt`` state does bit for bit: every parameter, BN
    statistic and optimizer state (adam's or ranger's moments, step
    counts, Lookahead's slow weights) (``differing`` lists none). Two
    faulty resumes, one that drops the optimizer's state and one that
    resets the BN statistics, must differ, and lie beyond RESUME_F32 on
    the gaps they corrupt. The runs' directories in ``tmp`` start with
    ``prefix``. Returns the readings."""
    from esn_tpu_torch.train import checkpoint as ckpt
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    load = ckpt.load_checkpoint

    def train(name, *extra):
        _cli(cli_train.main, args + ["--savedir", str(Path(tmp) / name),
                                     *extra])
        d = Path(tmp) / name / "cityscapes" / f"FastSCNNbs{BATCH}gpu1_train"
        return d, json.loads((d / "events.jsonl").read_text()
                             .splitlines()[-1])

    try:
        d, ev_s = train(f"{prefix}_straight")
        resume = ("--resume", str(d / "model_1.ckpt"))
        runs = {"resumed": train(f"{prefix}_resumed", *resume)}
        for what in ("optimizer", "statistics"):
            ckpt.load_checkpoint = _losing(load, what)
            try:
                runs[f"without_{what}"] = train(f"{prefix}_without_{what}",
                                                *resume)
            finally:
                ckpt.load_checkpoint = load
    finally:
        torch.backends.cudnn.deterministic = det
    one, straight = (_state(torch, d / f"model_{e}.ckpt") for e in (1, 2))
    out = {}
    for name, (rd, ev) in runs.items():
        st = _state(torch, rd / "model_2.ckpt")
        diff = differing(torch, st, straight)
        out[name] = {"step": st["step"], "lr": ev["lr"], "loss": ev["loss"],
                     "straight_loss": ev_s["loss"],
                     "differing": len(diff), "first_differing": diff[:5],
                     "gaps": _epoch2_gaps(one, straight, st)}
    print(f"cli resume {prefix}", json.dumps(out))
    got = out["resumed"]
    check(got["step"] == straight["step"] and got["lr"] == ev_s["lr"]
          and got["loss"] == ev_s["loss"],
          f"f32 resume: step {got['step']}, lr {got['lr']}, loss "
          f"{got['loss']} against {straight['step']}, {ev_s['lr']}, "
          f"{ev_s['loss']}")
    check(got["differing"] == 0, f"f32 resume: {got['differing']} tensors "
          f"differ from the straight run's: {got['first_differing']}")
    for name, keys in (("without_optimizer", ("params", "exp_avg")),
                       ("without_statistics", ("stats",))):
        gaps = out[name]["gaps"]
        check(out[name]["differing"] > 0
              and all(gaps[k] > RESUME_F32[k] for k in keys),
              f"f32 resume {name} passes the limits {RESUME_F32}: {gaps}")
    return out


def lookahead_watch(torch, opt):
    """Step hooks on ``opt`` (a ``Ranger``) that hold each Lookahead sync:
    before the step, the slow weights and the fast weights of a twin
    ``RAdam`` step on a copy of the same state and gradients; after it, the
    parameters and the slow weights against slow + SLOW_STEP_SIZE (fast -
    slow). Returns (the rows of each sync, the hooks' handles)."""
    from esn_tpu_torch.train.optimizers import RAdam
    rows, pending = [], []

    def live():
        return [p for g in opt.param_groups for p in g["params"]
                if p.grad is not None]

    def pre(o, args, kwargs):
        params = live()
        state = o.state[params[0]]
        t = int(state["step"]) + 1 if "step" in state else 1
        if t % o.SYNC_PERIOD:
            return
        twin_params = [p.detach().clone() for p in params]
        twin = RAdam(twin_params)
        twin.load_state_dict(copy.deepcopy(o.state_dict()))
        for tp, p in zip(twin_params, params):
            tp.grad = p.grad.detach().clone()
        twin.step()
        pending.append((t, [o.state[p]["slow"].clone() for p in params],
                        twin_params, params))

    def post(o, args, kwargs):
        if not pending:
            return
        t, slow, fast, params = pending.pop()
        want = [s + o.SLOW_STEP_SIZE * (f - s) for s, f in zip(slow, fast)]
        diff = max(float((p - w).abs().max()) for p, w in zip(params, want))
        scale = max(float(w.abs().max()) for w in want)
        kept = all(torch.equal(o.state[p]["slow"], p) for p in params)
        row = {"step": t, "max_abs_diff": diff, "max_abs_want": scale,
               "bit_equal": all(torch.equal(p, w)
                                for p, w in zip(params, want)),
               "slow_equals_params": kept}
        print("lookahead sync", json.dumps(row))
        check(diff <= LOOKAHEAD_REL * scale and kept,
              f"Lookahead sync at step {t}: {row}")
        rows.append(row)

    return rows, (opt.register_step_pre_hook(pre),
                  opt.register_step_post_hook(post))


def _concat(torch, tensors):
    return torch.cat([t.double().flatten() for t in tensors])


def optim_vs_cpu(torch, model0, batch, cw, name):
    """OPTIM_STEPS f32 steps (TF32 off) of ``name`` on a 2 x 3 x 256 x 512
    slice of ``batch`` on the card, from a copy of ``model0`` with dropout
    off, and the same optimizer on the CPU taking, step by step, the card's
    gradients and learning rate: every parameter of the CPU's run against
    the card's (OPTIM_CPU_ULP), and the update of all together
    (OPTIM_CPU_REL)."""
    from esn_tpu_torch.nn import Dropout
    from esn_tpu_torch.train.optimizers import build_optimizer
    h, w = ENET_SLICE_HW
    card = copy.deepcopy(model0)
    for sub in card.modules():
        if isinstance(sub, Dropout):
            sub.rate = 0.0
    step = train_step(torch, card, build_optimizer(name, card.parameters()),
                      cw, torch.float32)
    host = copy.deepcopy(card).cpu()
    host_opt = build_optimizer(name, host.parameters())
    piece = {"image": batch["image"][:2, :, :h, :w],
             "label": batch["label"][:2, :h, :w].contiguous()}
    losses = []
    for _ in range(OPTIM_STEPS):
        metrics = step(piece)
        losses.append(float(metrics["loss"]))
        for ph, pc in zip(host.parameters(), card.parameters()):
            ph.grad = pc.grad.detach().cpu()
        for group in host_opt.param_groups:
            group["lr"] = metrics["lr"]
        host_opt.step()
    p0 = {n: p.detach().cpu().double() for n, p in model0.named_parameters()}
    got = {n: p.detach().cpu().double() for n, p in card.named_parameters()}
    want = {n: p.detach().double() for n, p in host.named_parameters()}
    ulps = {n: float((got[n] - want[n]).abs().max())
            / max(float(want[n].abs().max()), 1e-30) for n in want}
    worst = max(ulps, key=ulps.get)
    row = {"dtype": "float32", "slice": [2, 3, h, w], "steps": OPTIM_STEPS,
           "losses": losses,
           "update_rel_l2": _rel(_concat(torch, [got[n] - p0[n] for n in p0]),
                                 _concat(torch, [want[n] - p0[n]
                                                 for n in p0])),
           "update_rel_l2_max": OPTIM_CPU_REL,
           "leaf_max_abs_diff_over_max_abs_worst": ulps[worst],
           "worst_leaf": worst, "leaf_max": OPTIM_CPU_ULP,
           "bit_equal_leaves": sum(torch.equal(got[n], want[n])
                                   for n in want), "leaves": len(want)}
    print(f"{name}: {OPTIM_STEPS} f32 steps of a slice on the card, the CPU "
          f"replaying its gradients", json.dumps(row))
    check(row["update_rel_l2"] <= OPTIM_CPU_REL
          and ulps[worst] <= OPTIM_CPU_ULP,
          f"{name} on the card disagrees with the CPU: {row}")
    return row


def optim_phase(torch, F, K):
    """``--optim radam`` and ``ranger`` on Fast-SCNN-19 at config 5 (bf16,
    b8, 3x1024x2048), class-weighted CE through K3, poly lr: OPTIM_STEPS
    steps of each from the same weights and batch with the launch counts
    from zero (K3 1 + 1 a step), finite losses, every parameter with a
    gradient moved; at each Lookahead sync the parameters against slow +
    0.5 (fast - slow) (``lookahead_watch``); f32 steps of a slice on the
    card, the CPU replaying them (``optim_vs_cpu``); ms/step and peak memory of
    each beside adam's, in turns (adam, radam, ranger, ranger, radam,
    adam)."""
    from esn_tpu_torch.train.optimizers import build_optimizer
    model0, _, batch, cw = train_setup(torch, F)
    _, zero = zero_gradient_leaves(torch, F)
    result, steps = {}, {}
    for name in ("radam", "ranger"):
        model = copy.deepcopy(model0)
        opt = build_optimizer(name, model.parameters())
        step = train_step(torch, model, opt, cw, torch.bfloat16)
        syncs, hooks = (lookahead_watch(torch, opt) if name == "ranger"
                        else ([], ()))
        # the main path, OPTIM_STEPS steps, with the launch counts from zero
        K.reset_launches()
        losses = [float(step(batch)["loss"]) for _ in range(OPTIM_STEPS)]
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        for hook in hooks:
            hook.remove()
        print(f"fastscnn {name} train launches", json.dumps(launches))
        print(f"fastscnn {name} train losses", json.dumps(losses))
        check(launches_equal(launches, {
            "resize_ce_fwd": OPTIM_STEPS, "resize_ce_bwd": OPTIM_STEPS,
            **bwd_launches("fastscnn", OPTIM_STEPS)}),
              f"{name}: launch counts over {OPTIM_STEPS} steps {launches}")
        check(all(math.isfinite(v) for v in losses), f"{name} losses {losses}")
        p0 = dict(model0.named_parameters())
        still = [n for n, p in model.named_parameters()
                 if n not in zero and torch.equal(p, p0[n])]
        check(not still, f"{name}: parameters that did not move {still[:5]}")
        if name == "ranger":
            check([r["step"] for r in syncs] == [6, 12],
                  f"Lookahead synced at {[r['step'] for r in syncs]}")
        torch.backends.cudnn.allow_tf32 = False
        vs_cpu = optim_vs_cpu(torch, model0, batch, cw, name)
        torch.backends.cudnn.allow_tf32 = True   # the library default again
        result[name] = {"launches": launches, "losses": losses,
                        "lookahead_syncs": syncs, "vs_cpu": vs_cpu}
        steps[name] = step
    adam_model = copy.deepcopy(model0)
    steps["adam"] = train_step(
        torch, adam_model, build_optimizer("adam", adam_model.parameters()),
        cw, torch.bfloat16)
    times, peak = {k: [] for k in steps}, {}
    for which in ("adam", "radam", "ranger", "ranger", "radam", "adam"):
        torch.cuda.reset_peak_memory_stats()
        times[which].append(timed_steps(torch, steps[which], batch, iters=5))
        peak[which] = max(peak.get(which, 0.0),
                          torch.cuda.max_memory_allocated() / 1e9)
    ms = {k: 1e3 * sum(v) / len(v) for k, v in times.items()}
    print(f"fastscnn train bf16 b{BATCH} {IMAGE_HW[1]}x{IMAGE_HW[0]}, weighted"
          f" CE through K3: " + ", ".join(
              f"{k} {ms[k]:.3f} ms/step (peak {peak[k]:.2f} GB)"
              for k in ("adam", "radam", "ranger")))
    result.update(ms_per_step=ms, peak_gb=peak, batch=BATCH)
    return result


def lovasz_hist_vs_sort(torch, z, labels, classes=CLASSES,
                        buckets=LOVASZ_BUCKETS):
    """How far ``lovasz_softmax_hist`` may lie from ``lovasz_softmax`` on
    the logits ``z`` (NHWC f32), and how far their tie blocks lie apart:
    ``{"value_bound", "grad_l2_bound", "block_sum_gap"}``.

    Take one present class. Its errors are sorted (or bucketed) in
    descending order; each pixel's sorted gradient is its Jaccard
    increment, ``1/U`` for a foreground pixel and ``I/(U(U+1))`` for a
    background one (``I``, ``U``: the intersection and union before it),
    never negative, and a bucket's increments add up to its Jaccard step
    ΔJ_b in any order within it, which the hist version spreads evenly
    over the bucket.

    - value_bound: both values are convex combinations of a bucket's
      errors times ΔJ_b, and a bucket's errors lie within (1 + 2^-10)/(B -
      1) of each other (B buckets; the f32 product e (B - 1) may round
      across a key's edge), so the class's two sums differ by at most that
      times ΣΔJ_b = 1 (every pixel seen: I = 0); so does their mean over
      the present classes.
    - grad_l2_bound: in bucket b the sorted gradients lie in ``[lo_b,
      hi_b]`` from the bucket's first and last ``I``, ``U`` (the counts
      before it and its own), and so does their mean, so the gradients
      with respect to the errors differ by at most ``hi_b - lo_b`` each,
      over the present classes' count. The errors' Jacobian with respect
      to a pixel's logits is ±(diag(p) - p p^T) by rows, whose spectral
      norm is at most max_c 2 p_c (1 - p_c) <= 1/2 (Gershgorin), so the
      gradients with respect to the logits differ in L2 by at most half
      the errors' bound. Where a tie block mixes foreground and
      background pixels (bf16 logits make large ones) the bound is loose:
      the sort's gradient inside a tie block depends on the pixels' order,
      the hist's is their mean.
    - block_sum_gap: the largest difference of the two versions' sums of
      the gradients with respect to the errors over one bucket's valid
      pixels (f64 sums), which both make ΔJ_b from the same f32 Jaccard
      values: the sort's increments telescope, the hist's n_b ΔJ_b / n_b
      rounds once (LOVASZ_BLOCK_ABS).
    """
    from esn_tpu_torch.train.losses import (_lovasz_errors,
                                            _lovasz_hist_coefficients,
                                            _lovasz_sort_coefficients)
    nb, spare = buckets, classes * buckets
    with torch.no_grad():
        errors, fg, valid = _lovasz_errors(z, labels, classes, IGNORE)
        key = (errors * (nb - 1)).to(torch.int32).clamp_(0, nb - 1)
        key += torch.arange(classes, device=key.device,
                            dtype=torch.int32) * nb
        counted = torch.where(valid[:, None], key, spare).flatten()

        def by_key(keys, weights=None):
            return torch.bincount(keys, weights=weights,
                                  minlength=spare + 1)[:-1].view(
                                      classes, nb).double()

        n_b = by_key(counted)
        fg_b = by_key(torch.where(fg.bool(), key, spare).flatten())
        sort_sum = by_key(counted, _lovasz_sort_coefficients(
            errors, fg).double().flatten())
        coef, present = _lovasz_hist_coefficients(errors, fg, valid, nb)
        hist_sum = by_key(counted, coef.double().flatten())
        del errors, fg, key, counted, coef
    block_gap = float((sort_sum - hist_sum)[present].abs().max())
    n_b, fg_b = n_b.flip(-1), fg_b.flip(-1)      # descending keys
    bg_b = n_b - fg_b
    gts = fg_b.sum(-1, keepdim=True)
    inter0 = gts - (fg_b.cumsum(-1) - fg_b)       # before the bucket
    union0 = torch.clamp(gts + (bg_b.cumsum(-1) - bg_b), min=1.0)
    union1 = union0 + bg_b                        # after it
    inf = torch.full_like(n_b, math.inf)
    lo = torch.minimum(
        torch.where(fg_b > 0, 1.0 / union1, inf),
        torch.where(bg_b > 0, (inter0 - fg_b) / (union1 * (union1 + 1)), inf))
    hi = torch.maximum(
        torch.where(fg_b > 0, 1.0 / union0, -inf),
        torch.where(bg_b > 0, inter0 / (union0 * (union0 + 1)), -inf))
    spread = torch.where(n_b > 0, hi - lo, torch.zeros_like(n_b))
    de = math.sqrt(float((n_b * spread.square())[present].sum()))
    return {"value_bound": (1 + 2.0 ** -10) / (nb - 1),
            "grad_l2_bound": 0.5 * de / float(present.sum()),
            "block_sum_gap": block_gap}


def _loss_value_and_grad(torch, fn, z, labels):
    """(value, gradient with respect to ``z``) of ``fn(z, labels)``."""
    z = z.detach().requires_grad_()
    loss = fn(z, labels)
    loss.backward()
    return float(loss), z.grad


def loss_phase(torch, F, K, BatchNorm):
    """``--use_focal``, ``--use_lovaszsoftmax`` and ``lovasz_hist`` on
    Fast-SCNN-19 at config 5 (bf16, b8, 3x1024x2048; these are no CE-family
    losses, so they take the full logits and no kernel):

    1. on one train-mode bf16 forward's f32 logits: each loss's value and
       gradient with respect to the logits, its time (CUDA events) and its
       peak memory beyond the logits; focal at gamma 0 against
       ``cross_entropy`` (FOCAL_CE_REL); lovasz_hist against lovasz within
       the bounds of ``lovasz_hist_vs_sort`` (value, gradient rel-L2, the
       sums over each tie block);
    2. each loss on a 2 x 256 x 512 slice of those logits, the card against
       the CPU in f32 (LOSS_CPU_REL, LOSS_CPU_GRAD_REL);
    3. TRAIN_STEPS train steps with each loss (adam + poly, class weights),
       launch counts all 0, a falling loss, moving BN statistics
       (``steps_check``), then its ms/step and peak memory.
    """
    from esn_tpu_torch.nn import set_dropout_generator
    from esn_tpu_torch.train.losses import build_loss, cross_entropy
    from esn_tpu_torch.train.optimizers import build_optimizer
    model0, _, batch, cw = train_setup(torch, F)
    labels = batch["label"]
    kw = dict(num_classes=CLASSES, class_weights=cw, ignore_index=IGNORE)
    fns = {name: functools.partial(build_loss(name), **kw)
           for name in LOSS_NAMES}
    fns["focal_gamma0"] = functools.partial(build_loss("focal"), gamma=0.0,
                                            **kw)
    fns["ce"] = functools.partial(cross_entropy, **kw)
    model = copy.deepcopy(model0).train()
    set_dropout_generator(model, torch.Generator(device="cuda").manual_seed(3))
    with torch.no_grad():
        z = model(batch["image"].to(dtype=torch.bfloat16,
                                    memory_format=torch.channels_last))
        z = z.float().permute(0, 2, 3, 1).contiguous()
    del model
    result = {"logits": list(z.shape)}
    values, grads = {}, {}
    for name, fn in fns.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        values[name], grads[name] = _loss_value_and_grad(torch, fn, z, labels)
        extra_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        ms = cuda_ms(lambda: _loss_value_and_grad(torch, fn, z, labels),
                     iters=3, warmup=1)
        result[name] = {"value": values[name], "ms": ms,
                        "peak_beyond_logits_gb": extra_gb}
        check(math.isfinite(values[name])
              and bool(torch.isfinite(grads[name]).all()),
              f"{name}: value {values[name]} or its gradient not finite")
    gamma0 = {"value_equal": values["focal_gamma0"] == values["ce"],
              "value_rel": abs(values["focal_gamma0"] - values["ce"])
              / abs(values["ce"]),
              "grad_rel_l2": _rel(grads["focal_gamma0"], grads["ce"]),
              "grad_equal": bool(torch.equal(grads["focal_gamma0"],
                                             grads["ce"])),
              "max": FOCAL_CE_REL}
    print("focal at gamma 0 vs cross_entropy", json.dumps(gamma0))
    check(gamma0["value_rel"] <= FOCAL_CE_REL
          and gamma0["grad_rel_l2"] <= FOCAL_CE_REL,
          f"focal at gamma 0 is not cross_entropy: {gamma0}")
    gaps = lovasz_hist_vs_sort(torch, z, labels)
    hist = {"value_gap": abs(values["lovasz_hist"] - values["lovasz"]),
            "value_bound": gaps["value_bound"]
            + LOVASZ_SUM_REL * abs(values["lovasz"]),
            "grad_rel_l2": _rel(grads["lovasz_hist"], grads["lovasz"]),
            "grad_rel_l2_bound": gaps["grad_l2_bound"]
            / float(grads["lovasz"].double().norm()) + LOVASZ_SUM_REL,
            "block_sum_gap": gaps["block_sum_gap"],
            "block_sum_gap_max": LOVASZ_BLOCK_ABS}
    print("lovasz_hist vs lovasz", json.dumps(hist))
    check(hist["value_gap"] <= hist["value_bound"]
          and hist["grad_rel_l2"] <= hist["grad_rel_l2_bound"]
          and hist["block_sum_gap"] <= LOVASZ_BLOCK_ABS,
          f"lovasz_hist beyond its quantisation bound of lovasz: {hist}")
    result.update(focal_gamma0_vs_ce=gamma0, hist_vs_sort=hist)
    del grads

    # 2. a slice, the card against the CPU, f32
    h, w = ENET_SLICE_HW
    piece, lab = z[:2, :h, :w].contiguous(), labels[:2, :h, :w].contiguous()
    cpu_kw = dict(kw, class_weights=cw.cpu())
    vs_cpu = {}
    for name in LOSS_NAMES:
        v, g = _loss_value_and_grad(torch, fns[name], piece, lab)
        v0, g0 = _loss_value_and_grad(
            torch, functools.partial(build_loss(name), **cpu_kw),
            piece.cpu(), lab.cpu())
        vs_cpu[name] = {"value": v, "cpu_value": v0,
                        "value_rel": abs(v - v0) / abs(v0),
                        "grad_rel_l2": _rel(g.cpu(), g0)}
    print("losses on a slice, the card vs the CPU", json.dumps(vs_cpu))
    bad = {k: r for k, r in vs_cpu.items()
           if not (r["value_rel"] <= LOSS_CPU_REL
                   and r["grad_rel_l2"] <= LOSS_CPU_GRAD_REL[k])}
    check(not bad, f"losses on the card disagree with the CPU: {bad}")
    result["vs_cpu"] = vs_cpu
    del z, piece

    # 3. train steps with each loss
    for name in LOSS_NAMES:
        model = copy.deepcopy(model0)
        step = train_step(torch, model,
                          build_optimizer("adam", model.parameters()), cw,
                          torch.bfloat16, loss=name)
        row = steps_check(torch, K, BatchNorm, "fastscnn", model, step, batch,
                          loss_name=name)
        torch.cuda.reset_peak_memory_stats()
        sec = timed_steps(torch, step, batch, iters=5)
        row.update(ms_per_step=1e3 * sec,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        print(f"fastscnn train ({name}) bf16 b{BATCH} "
              f"{IMAGE_HW[1]}x{IMAGE_HW[0]}: {row['ms_per_step']:.3f} "
              f"ms/step; peak {row['peak_gb']:.2f} GB; the loss's value and "
              f"gradient alone {result[name]['ms']:.3f} ms, "
              f"{result[name]['peak_beyond_logits_gb']:.2f} GB beyond the "
              f"logits")
        result[name]["train"] = row
        del model, step
    return result


def remat_phase(torch, F, K):
    """``--remat`` on the config-5 step of Fast-SCNN-19 (bf16, b8,
    3x1024x2048), with class-weighted CE through K3 (K3 1 + 1 a step with
    and without: the loss stays outside the recomputed forward) and with CE
    + OHEM (no kernel): from the same weights, batch and dropout seed, one
    step without remat, one with, one more without; the loss and the BN
    running statistics and the gradients bit for bit, as the two steps
    without remat are to each other; then ms/step and peak
    memory with and without, in turns (plain, remat, remat, plain)."""
    from esn_tpu_torch.train.optimizers import build_optimizer
    model0, _, batch, cw = train_setup(torch, F)
    result = {}
    for loss in ("ce", "ce_ohem"):
        runs, steps = {}, {}
        for which in ("plain", "remat", "plain_again"):
            model = copy.deepcopy(model0)
            opt = build_optimizer("adam", model.parameters())
            make = config5_step if loss == "ce_ohem" else train_step
            step = make(torch, model, opt, cw, torch.bfloat16,
                        remat=which == "remat")
            K.reset_launches()
            value = float(step(batch)["loss"])
            torch.cuda.synchronize()
            runs[which] = {
                "loss": value, "launches": dict(K.LAUNCHES),
                "grads": {n: p.grad.detach().clone()
                          for n, p in model.named_parameters()},
                "stats": {n: b.clone() for n, b in model.named_buffers()}}
            steps[which] = step
        want = ({"resize_ce_fwd": 1, "resize_ce_bwd": 1} if loss == "ce"
                else {})
        for which, run in runs.items():
            check(launches_equal(run["launches"], {
                **want, **bwd_launches("fastscnn", 1,
                                       full=loss == "ce_ohem")}),
                  f"remat {loss} {which}: launches {run['launches']}")
        plain, remat, again = runs["plain"], runs["remat"], runs["plain_again"]
        names = list(plain["grads"])

        def gap(a, b):
            return _rel(_concat(torch, [a["grads"][n] for n in names]),
                        _concat(torch, [b["grads"][n] for n in names]))

        leaf = {n: _rel(remat["grads"][n], plain["grads"][n]) for n in names
                if float(plain["grads"][n].norm()) > 0}
        worst = max(leaf, key=leaf.get)
        row = {"loss": plain["loss"], "remat_loss": remat["loss"],
               "loss_equal": remat["loss"] == plain["loss"],
               "stats_equal": all(torch.equal(remat["stats"][n], b)
                                  for n, b in plain["stats"].items()),
               "grad_gap": gap(remat, plain), "plain_grad_gap": gap(again,
                                                                   plain),
               "grads_equal": all(torch.equal(remat["grads"][n],
                                              plain["grads"][n])
                                  for n in names),
               "worst_leaf": worst, "worst_leaf_gap": leaf[worst],
               "launches": remat["launches"]}
        row["plain_grads_equal"] = all(
            torch.equal(again["grads"][n], plain["grads"][n]) for n in names)
        print(f"remat {loss}: with vs without", json.dumps(row))
        check(row["loss_equal"] and row["stats_equal"] and row["grads_equal"]
              and row["plain_grads_equal"] and again["loss"] == plain["loss"],
              f"remat {loss}: the step differs from the step without: {row}")
        del runs
        times, peak = {"plain": [], "remat": []}, {}
        for which in ("plain", "remat", "remat", "plain"):
            torch.cuda.reset_peak_memory_stats()
            times[which].append(timed_steps(torch, steps[which], batch,
                                            iters=5))
            peak[which] = max(peak.get(which, 0.0),
                              torch.cuda.max_memory_allocated() / 1e9)
        row["ms_per_step"] = {k: 1e3 * sum(v) / len(v)
                              for k, v in times.items()}
        row["peak_gb"] = peak
        print(f"fastscnn train ({loss}) bf16 b{BATCH} "
              f"{IMAGE_HW[1]}x{IMAGE_HW[0]}: "
              f"{row['ms_per_step']['plain']:.3f} ms/step, peak "
              f"{peak['plain']:.2f} GB without remat; "
              f"{row['ms_per_step']['remat']:.3f} ms/step, peak "
              f"{peak['remat']:.2f} GB with")
        result[loss] = row
        del steps
    return result


def cli_phase(torch, K):
    """The user's entry points, ``esn_tpu_torch.cli.train`` / ``test`` /
    ``predict``, on Fast-SCNN-19 and Cityscapes-shaped synthetic data
    (1024x2048 sources, the dataset's default crop 512x1024), batch 8,
    bf16 on the card:

    1. train: two epochs of 16 items (2 steps each), validation every
       epoch at the source resolution; ms/step, img/s, the host's share of
       a step, val ms/batch and peak memory from the run's
       ``events.jsonl``; launches: K3 forward and backward once a step,
       K2 4 times and K1 once a val batch.
    2. the prefetcher: an epoch of the train loader through
       ``device_prefetch``, held on the card while the card works, equals
       the loader's own batches.
    3. resume: in bf16, a run from ``model_1.ckpt`` repeats epoch 2 bit
       for bit (step, lr, loss, every tensor of the checkpoint); in f32
       with cuDNN deterministic, the same of a straight run and a resume,
       and two faulty resumes that differ and lie beyond RESUME_F32
       (``check_f32_resume``).
    4. ``cli.test --checkpoint model_2.ckpt`` at the train run's val
       batch gives the Trainer's epoch-2 mIoU and per-class IoU.
    5. ``cli.predict``'s grey PNGs, read back with the port's own reader,
       equal ``make_predict_step``'s maps (as labelIDs).
    6. ``--optim ranger --use_lovaszsoftmax --remat``: two epochs of
       CLI_RANGER_TRAIN items (six steps each), launches (K2 and K1 at
       validation only), the slow weights in the checkpoint; its f32
       resume held as adam's (``check_f32_resume``).

    The val split is written as packed ``.npy`` records (the
    ``SyntheticDataset`` items the train run's val split holds), so that
    ``cli.test`` scores the same images as the Trainer: on synthetic data
    the test CLI's val split has another seed, as the reference's. The
    train and test splits stay synthetic.
    """
    import tempfile

    import numpy as np

    from esn_tpu_torch.cli import predict as cli_predict
    from esn_tpu_torch.cli import test as cli_test
    from esn_tpu_torch.cli import train as cli_train
    from esn_tpu_torch.data import (CITYSCAPES, BatchLoader, SyntheticDataset,
                                    build_dataset_test, device_prefetch)
    from esn_tpu_torch.data.palettes import trainid_to_labelid
    from esn_tpu_torch.data.native import decode_grey
    from esn_tpu_torch.models import build_model
    from esn_tpu_torch.train import checkpoint as ckpt
    from esn_tpu_torch.train.step import make_predict_step

    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "data"
        t0 = time.perf_counter()
        val = SyntheticDataset(CITYSCAPES, length=CLI_VAL, seed=1)
        (root / "cityscapes").mkdir(parents=True)
        lines = []
        for i in range(len(val)):
            item = val[i]
            name = f"val_{i:05d}.npy"
            np.save(root / "cityscapes" / name, np.concatenate(
                [item["image"], item["label"][..., None].astype(np.uint8)], -1))
            lines.append(name)
        (root / "cityscapes" / "cityscapes_val_list.txt").write_text(
            "\n".join(lines) + "\n")
        result["pack_val_s"] = time.perf_counter() - t0

        common = ["--model", "FastSCNN", "--dataset", "cityscapes",
                  "--data_root", str(root), "--compute_dtype", "bfloat16"]
        train_args = common + [
            "--batch_size", str(BATCH), "--max_epochs", "2", "--val_epochs",
            "1", "--synthetic_len", str(CLI_TRAIN), "--num_workers", "4"]

        # 1. train
        straight = Path(tmp) / "straight"
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, launches = _launch_delta(K, lambda: _cli(
            cli_train.main, train_args + ["--savedir", str(straight)]))
        result["train_run_s"] = time.perf_counter() - t0
        run_dir = straight / "cityscapes" / f"FastSCNNbs{BATCH}gpu1_train"
        events = [json.loads(line) for line in
                  (run_dir / "events.jsonl").read_text().splitlines()]
        check(len(events) == 2, f"train events {len(events)}")
        check(all(math.isfinite(e["loss"]) for e in events),
              f"train losses {[e['loss'] for e in events]}")
        check(all(0.0 <= e["miou"] <= 1.0 for e in events),
              f"val mIoU {[e['miou'] for e in events]}")
        steps = CLI_TRAIN // BATCH
        want = {"resize_ce_fwd": 2 * steps, "resize_ce_bwd": 2 * steps,
                "dsconv": 2 * 4 * (CLI_VAL // BATCH),
                "resize_argmax": 2 * (CLI_VAL // BATCH),
                **bwd_launches("fastscnn", 2 * steps)}
        check(launches_equal(launches, want), f"train CLI launches "
              f"{launches}, want {want}")
        last = events[-1]
        ms_step = 1e3 * last["train_s"] / steps
        result.update(
            launches=launches, losses=[e["loss"] for e in events],
            miou=[e["miou"] for e in events], ms_per_step=ms_step,
            img_per_s=BATCH * steps / last["train_s"],
            host_ms_per_step=last["host_step"]["mean_ms"],
            host_share=last["host_step"]["mean_ms"] / ms_step,
            val_ms_per_batch=1e3 * last["val_s"] / (CLI_VAL // BATCH),
            epoch_s=[e["time_s"] for e in events],
            peak_gb=torch.cuda.max_memory_allocated() / 1e9)

        # 2. the prefetcher against the loader (the Trainer's train
        # loader: seed 0, shuffled by epoch, drop_last)
        loader = BatchLoader(
            SyntheticDataset(CITYSCAPES, length=CLI_TRAIN),
            BATCH, shuffle=True, drop_last=True, num_workers=4)
        held, work = [], []
        for batch in device_prefetch(iter(loader), "cuda"):
            held.append(batch)      # the card works on it while the
            work.append(batch["image"].float().mean())  # next one copies
        expect = list(iter(loader))
        check(len(held) == len(expect) == steps, "prefetched batch count")
        for got, ref in zip(held, expect):
            for key in ("image", "label"):
                check(got[key].device.type == "cuda" and np.array_equal(
                    got[key].cpu().numpy(), ref[key]),
                    f"prefetched {key} differs from the loader's")
            check(got["name"] == ref["name"], "prefetched names differ")
        result["prefetch_batches_equal"] = len(held)
        del held, work

        # 3. resume from epoch 1: epoch 2 again, bit for bit
        _cli(cli_train.main, train_args + [
            "--savedir", str(Path(tmp) / "resumed"), "--resume",
            str(run_dir / "model_1.ckpt")])
        d = Path(tmp) / "resumed" / "cityscapes" / f"FastSCNNbs{BATCH}gpu1_train"
        ev = [json.loads(line) for line in
              (d / "events.jsonl").read_text().splitlines()]
        check(len(ev) == 1 and ev[0]["epoch"] == 2, f"resumed events {ev}")
        one = _state(torch, run_dir / "model_1.ckpt")
        straight = _state(torch, run_dir / "model_2.ckpt")
        r1 = _state(torch, d / "model_2.ckpt")
        diff = differing(torch, r1, straight)
        resume = {"step": [straight["step"], r1["step"]],
                  "lr": [events[1]["lr"], ev[0]["lr"]],
                  "loss": [events[1]["loss"], ev[0]["loss"]],
                  "differing": len(diff), "first_differing": diff[:5],
                  "gaps": _epoch2_gaps(one, straight, r1)}
        print("cli resume", json.dumps(resume))
        check(straight["step"] == r1["step"] == 2 * steps,
              f"resumed step {resume['step']}")
        check(events[1]["lr"] == ev[0]["lr"]
              and events[1]["loss"] == ev[0]["loss"],
              f"resumed lr, loss {resume['lr']}, {resume['loss']}")
        check(not diff, f"resume: {len(diff)} tensors differ from the "
              f"straight run's: {diff[:5]}")
        result["resume"] = resume
        f32_args = [a if a != "bfloat16" else "float32" for a in train_args]
        result["resume_f32"] = check_f32_resume(
            torch, torch.nn.functional, cli_train,
            f32_args + ["--val_epochs", "2"], tmp)

        # 4. cli.test on model_2.ckpt, at the train run's val batch
        (out, test_launches) = _launch_delta(K, lambda: _cli(cli_test.main, common + [
            "--checkpoint", str(run_dir / "model_2.ckpt"),
            "--batch_size", str(BATCH), "--synthetic_len", str(CLI_TRAIN)]))
        report = {line.split(":")[0].strip(): float(line.split(":")[1])
                  for line in out.splitlines()
                  if line.startswith("  ") and ":" in line}
        check(f"{report['meanIoU']:.4f}" == f"{last['miou']:.4f}",
              f"cli.test mIoU {report['meanIoU']} != the Trainer's "
              f"{last['miou']}")
        names = [n for n in report if n != "meanIoU"]
        worst = max(abs(report[n] - v)
                    for n, v in zip(names, last["per_class_iou"]))
        check(worst <= 5.1e-5, f"cli.test per-class IoU off by {worst}")
        check(test_launches["dsconv"] == 4 * (CLI_VAL // BATCH)
              and test_launches["resize_argmax"] == CLI_VAL // BATCH,
              f"cli.test launches {test_launches}")
        result["test"] = {"miou": report["meanIoU"],
                          "launches": test_launches}

        # 5. cli.predict: its grey PNGs against the predict step's maps
        pred_dir = Path(tmp) / "pred"
        (_, predict_launches) = _launch_delta(K, lambda: _cli(cli_predict.main, common + [
            "--checkpoint", str(run_dir / "model_2.ckpt"), "--batch_size",
            str(BATCH), "--synthetic_len", str(CLI_TEST),
            "--save_seg_dir", str(pred_dir)]))
        check(predict_launches["dsconv"] == 4 * (CLI_TEST // BATCH)
              and predict_launches["resize_argmax"] == CLI_TEST // BATCH,
              f"cli.predict launches {predict_launches}")
        _, test_loader, transform = build_dataset_test(
            "cityscapes", none_gt=True, root=str(root), batch_size=BATCH,
            synthetic_len=CLI_TEST)
        model = build_model("fastscnn", CLASSES, device="cuda")
        ckpt.load_variables(str(run_dir / "model_2.ckpt"), model)
        predict = make_predict_step(model, compute_dtype=torch.bfloat16)
        n_png = 0
        for batch in test_loader:
            maps = predict(transform(torch.from_numpy(batch["image"]).to(
                "cuda"))).cpu().numpy()
            for pred, name in zip(maps, batch["name"]):
                grey = decode_grey(str(pred_dir / name))
                check(np.array_equal(grey, trainid_to_labelid(pred)),
                      f"cli.predict {name} differs from the predict step")
                n_png += 1
        check(n_png == CLI_TEST, f"{n_png} PNGs compared")
        result["predict"] = {"pngs_equal": n_png, "launches": predict_launches}

        # 6. ranger + Lovász + remat: two epochs of six steps, then its f32
        # resume from epoch 1 against the straight run
        ranger_args = common + [
            "--batch_size", str(BATCH), "--max_epochs", "2", "--val_epochs",
            "1", "--synthetic_len", str(CLI_RANGER_TRAIN), "--num_workers",
            "4", "--optim", "ranger", "--use_lovaszsoftmax", "--remat"]
        torch.cuda.reset_peak_memory_stats()
        _, ranger_launches = _launch_delta(K, lambda: _cli(
            cli_train.main, ranger_args + ["--savedir",
                                           str(Path(tmp) / "ranger")]))
        d = Path(tmp) / "ranger" / "cityscapes" / f"FastSCNNbs{BATCH}gpu1_train"
        ev = [json.loads(line) for line in
              (d / "events.jsonl").read_text().splitlines()]
        ranger_steps = CLI_RANGER_TRAIN // BATCH
        st = _state(torch, d / "model_2.ckpt")
        check(len(ev) == 2 and all(math.isfinite(e["loss"]) for e in ev)
              and st["step"] == 2 * ranger_steps,
              f"ranger run: events {ev}, step {st['step']}")
        check(all("slow" in v for v in st["optimizer"]["state"].values()),
              "ranger run: no slow weights in the optimizer's state")
        want = {"dsconv": 2 * 4 * (CLI_VAL // BATCH),
                "resize_argmax": 2 * (CLI_VAL // BATCH),
                **bwd_launches("fastscnn", 2 * ranger_steps, full=True)}
        check(launches_equal(ranger_launches, want), f"ranger run launches "
              f"{ranger_launches}, want {want}")
        ms_ranger = 1e3 * ev[-1]["train_s"] / ranger_steps
        ranger = {"launches": ranger_launches, "losses": [e["loss"] for e in ev],
                  "ms_per_step": ms_ranger,
                  "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        print(f"cli train fastscnn --optim ranger --use_lovaszsoftmax "
              f"--remat bf16 b{BATCH}: {ms_ranger:.3f} ms/step, peak "
              f"{ranger['peak_gb']:.2f} GB, launches "
              + json.dumps(ranger_launches))
        ranger["resume_f32"] = check_f32_resume(
            torch, torch.nn.functional, cli_train,
            [a if a != "bfloat16" else "float32" for a in ranger_args]
            + ["--val_epochs", "2"], tmp, prefix="ranger_f32")
        result["ranger_lovasz_remat"] = ranger
    print(f"cli train fastscnn cityscapes bf16 b{BATCH} "
          f"{IMAGE_HW[1]}x{IMAGE_HW[0]} sources: "
          f"{result['ms_per_step']:.3f} ms/step "
          f"({result['img_per_s']:.2f} img/s; host "
          f"{result['host_ms_per_step']:.3f} ms/step, share "
          f"{result['host_share']:.3f}), val {result['val_ms_per_batch']:.3f}"
          f" ms/batch, peak {result['peak_gb']:.2f} GB, launches "
          + json.dumps(result["launches"]))
    return result


# -------------------------------------------------------------- data parallel
@contextlib.contextmanager
def recorded_thresholds():
    """Every OHEM threshold the losses compute inside, in order, as Python
    floats (exact for f32): the losses look ``ohem_threshold`` up at call
    time."""
    from esn_tpu_torch.train import losses as L
    seen, orig = [], L.ohem_threshold

    def record(*args, **kwargs):
        t = orig(*args, **kwargs)
        seen.append(float(t))
        return t
    L.ohem_threshold = record
    try:
        yield seen
    finally:
        L.ohem_threshold = orig


def dp_steps(torch, model, opt, batch, cw, dtype):
    """On ``batch`` (this rank's rows under a group): DP_CE_STEPS
    weighted-CE adam steps (K3 on a resize-tail model), then one CE + OHEM
    step on the full logits from the state the CE steps started from (the
    weights and statistics restored, a new adam), so that both kinds of
    step are taken once from equal weights. Returns the losses, the first
    CE step's gradient (summed over the ranks), the OHEM threshold, and
    the state before, after the first CE step, after the CE steps and
    after the OHEM step (f32, on the CPU)."""
    from esn_tpu_torch.train.optimizers import build_optimizer

    def snapshot():
        return {k: v.detach().float().cpu().clone()
                for k, v in model.state_dict().items()}
    before = snapshot()
    ce = train_step(torch, model, opt, cw, dtype)
    losses = [float(ce(batch)["loss"])]
    grads = {n: p.grad.detach().float().cpu().clone()
             for n, p in model.named_parameters()}
    after_first = snapshot()
    losses += [float(ce(batch)["loss"]) for _ in range(DP_CE_STEPS - 1)]
    after_ce = snapshot()
    model.load_state_dict(before)
    ohem = config5_step(torch, model, build_optimizer(
        "adam", model.parameters()), cw, dtype)
    with recorded_thresholds() as thresholds:
        ohem_loss = float(ohem(batch)["loss"])
    return {"losses": losses, "ohem_loss": ohem_loss,
            "thresholds": thresholds, "before": before, "grads": grads,
            "after_first": after_first, "after_ce": after_ce,
            "after": snapshot()}


def dp_oracle_grads(torch, F, K):
    """The first weighted-CE step's gradient in f64 on the card (one
    process, the model and batch of ``train_setup`` in f64, K3's plain
    version, which keeps f64), per parameter, as f32 on the CPU: the
    oracle both f32 runs are held to."""
    model, opt, batch, cw = train_setup(torch, F)
    model.double()
    step = train_step(torch, model, opt, cw, torch.float64)
    with plain_versions(K):
        step(batch)
    grads = {n: p.grad.detach().float().cpu().clone()
             for n, p in model.named_parameters()}
    del model, opt, step, batch
    torch.cuda.empty_cache()
    return grads


def dp_eval_batch():
    """DP_EVAL_VALID seeded uint8 images (NHWC) and labels at config 5,
    with a band of ignored rows."""
    import numpy as np
    rng = np.random.RandomState(5)
    h, w = IMAGE_HW
    images = rng.randint(0, 256, (DP_EVAL_VALID, h // 16, w // 16, 3)
                         ).astype(np.uint8).repeat(16, 1).repeat(16, 2)
    labels = rng.randint(0, CLASSES, (DP_EVAL_VALID, h // 64, w // 64)
                         ).astype(np.int32).repeat(64, 1).repeat(64, 2)
    labels[:, :32] = IGNORE
    return images, labels


class _OneBatch(list):
    """A loader of one batch whose fixed eval batch is BATCH."""
    batch_size = BATCH


def dp_eval(torch, K, eval_state):
    """``run_eval`` (bf16) of the seeded Fast-SCNN over one val batch of
    DP_EVAL_VALID images padded to BATCH: the confusion matrix, every
    real row's prediction (rank 0's ``per_image``; gathered under a
    group), the kernel launches of ``run_eval`` (from zero), and this
    rank's rows' low-res logits."""
    import numpy as np

    from esn_tpu_torch.data.augment import make_eval_transform
    from esn_tpu_torch.models import build_model
    from esn_tpu_torch.parallel import mesh
    from esn_tpu_torch.train.evaluation import run_eval
    from esn_tpu_torch.train.step import make_eval_step
    model = build_model("fastscnn", CLASSES, device="cuda")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in eval_state.items()})
    step = make_eval_step(model, CLASSES, ignore_index=IGNORE,
                          compute_dtype=torch.bfloat16)
    images, labels = dp_eval_batch()
    transform = make_eval_transform(mean=np.float32([73.2, 82.9, 72.4]))
    preds = []
    K.reset_launches()
    cm = run_eval(step, _OneBatch([{"image": images, "label": labels}]),
                  transform, CLASSES,
                  per_image=lambda i, pred, batch: preds.append(pred))
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    padded, _ = mesh.pad_batch_to({"image": images}, BATCH)
    mine = mesh.shard_batch(padded)["image"]
    with torch.inference_mode():
        x = transform(torch.from_numpy(mine).cuda()).to(torch.bfloat16)
        logits = model.logits_lowres(x).permute(0, 2, 3, 1).float().cpu()
    return {"cm": cm, "preds": np.stack(preds) if preds else None,
            "launches": launches, "logits": logits.numpy()}




def dp_select(torch):
    """The min_kept-th smallest of a config-5 batch of probabilities with
    ties everywhere (multiples of 2^-12, so the tie at the answer spans
    the ranks) and an ignored band: ``ohem_threshold`` with thresh 0 (the
    radix select under a group, topk in one process), its ms."""
    from esn_tpu_torch.parallel import mesh
    from esn_tpu_torch.train import losses as L
    gen = torch.Generator(device="cuda").manual_seed(11)
    p = torch.floor(torch.rand((BATCH, *IMAGE_HW), generator=gen,
                               device="cuda") * 4096) / 4096
    p[:, :8] = 2.0
    mine = mesh.shard_batch({"p": p})["p"].reshape(-1)
    k = p.numel() // 16
    value = float(L.ohem_threshold(mine, 0.0, k))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    L.ohem_threshold(mine, 0.0, k)
    torch.cuda.synchronize()
    return {"min_kept": k, "kth": value,
            "ms": 1e3 * (time.perf_counter() - t0)}


@contextlib.contextmanager
def recorded_all_reduces():
    """Every ``torch.distributed.all_reduce`` inside, in order: (numel,
    dtype, host seconds of the call, its group: None for the world, a
    model group under spatial sharding, the tensor's device type: the
    row counts of uneven shards are host integers). ``parallel.mesh``
    looks the function up at call time; a gloo all-reduce returns once
    the exchange is done,
    so a call's seconds hold its own cost and any wait (for this rank's
    queued kernels, before gloo copies a card's tensor to the host, and
    for the peer)."""
    import torch.distributed as dist
    calls, real = [], dist.all_reduce

    def record(t, *args, **kwargs):
        t0 = time.perf_counter()
        out = real(t, *args, **kwargs)
        calls.append((t.numel(), t.dtype, time.perf_counter() - t0,
                      kwargs.get("group"), t.device.type))
        return out
    dist.all_reduce = record
    try:
        yield calls
    finally:
        dist.all_reduce = real


def _aligned(torch, fn):
    """Seconds of ``fn()`` after a barrier with the card idle, to the
    card's end."""
    from esn_tpu_torch.parallel import mesh
    mesh.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def collective_costs(torch, fn):
    """``fn()`` (a step) once with its all-reduces recorded
    (``recorded_all_reduces``): its ms, the collectives' count and MB, and
    the host ms this rank spent in them. Then the same all-reduces
    replayed back to back on buffers on the card, the ranks aligned by a
    barrier and the card idle: their own cost (the copies between card
    and host, the exchange, the sum). The step's host ms less the
    replay's is waiting, for this rank's kernels and for the peer, which
    shares the card."""
    import torch.distributed as dist
    with recorded_all_reduces() as calls:
        wall = _aligned(torch, fn)
    bufs = [(torch.ones(n, dtype=dt, device=dev), group)
            for n, dt, _, group, dev in calls]
    with recorded_all_reduces() as replayed:
        replay_wall = _aligned(torch, lambda: [
            dist.all_reduce(b) if g is None else dist.all_reduce(b, group=g)
            for b, g in bufs])
    host, own = (1e3 * sum(c[2] for c in cs) for cs in (calls, replayed))
    return {"ms": 1e3 * wall, "collectives": len(calls),
            "mb": sum(b.numel() * b.element_size() for b, _ in bufs) / 1e6,
            "host_ms": host, "own_ms": own, "wait_ms": host - own,
            "replay_ms": 1e3 * replay_wall}


def traced_ranges(torch, fn):
    """``fn()`` under ``torch.profiler`` (host and card), after a barrier
    with the card idle: its ms, and from the trace gloo's all-reduce
    ranges (``gloo:all_reduce``; gloo's thread, from the exchange's start
    to its end) by category (``user_annotation`` on the host,
    ``gpu_user_annotation`` their copies' span on the card) and the
    host-card copies (``gpu_memcpy``): count and summed ms of each."""
    import os

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        wall = _aligned(torch, fn)
    with tempfile.TemporaryDirectory(prefix="esn_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X"]
    out = {"ms": 1e3 * wall}
    for e in events:
        key = e.get("cat") if e.get("name") == "gloo:all_reduce" else \
            "gpu_memcpy" if e.get("cat") == "gpu_memcpy" else None
        if key is not None:
            n, ms = out.get(key, (0, 0.0))
            out[key] = (n + 1, ms + e["dur"] / 1e3)
    return out


def dp_timing(torch, F):
    """ms a bf16 weighted-CE step at config 5 on this rank's rows
    (``timed_steps``), and under a group one more step's
    ``collective_costs`` and one more traced (``traced_ranges``)."""
    from esn_tpu_torch.parallel import mesh
    model, opt, batch, cw = train_setup(torch, F)
    step = train_step(torch, model, opt, cw, torch.bfloat16)
    batch = mesh.shard_batch(batch)
    out = {"ms_per_step": 1e3 * timed_steps(torch, step, batch,
                                             DP_TIMED_STEPS),
           "rows": int(batch["image"].shape[0])}
    if mesh.active():
        out["collectives"] = collective_costs(torch, lambda: step(batch))
        out["trace"] = traced_ranges(torch, lambda: step(batch))
    return out


def dp_lovasz(torch, F):
    """A bf16 Lovász (sort) adam step at config 5 on this rank's rows,
    then a second one timed (under a group with its ``collective_costs``):
    the sort gathers every rank's errors and labels
    (``mesh.gather_rows``), whose size is returned."""
    from esn_tpu_torch.parallel import mesh
    model, opt, batch, cw = train_setup(torch, F)
    step = train_step(torch, model, opt, cw, torch.bfloat16, loss="lovasz")
    batch = mesh.shard_batch(batch)
    out = {"loss": float(step(batch)["loss"])}
    if not mesh.active():
        out["ms"] = 1e3 * _aligned(torch, lambda: step(batch))
        return out
    n = BATCH * IMAGE_HW[0] * IMAGE_HW[1]
    out["gather_mb"] = (n * CLASSES * 4 + n * 8) / 1e6
    out["collectives"] = collective_costs(torch, lambda: step(batch))
    out["ms"] = out["collectives"]["ms"]
    return out


def dp_rank_main(eval_state):
    """One rank of the data_parallel phase (or, with no group, the
    one-process run it is held against): the f32 (TF32 off) and bf16
    steps of ``dp_steps`` on this rank's rows of the same seeded batch and
    weights, the eval of ``dp_eval``, the select of ``dp_select`` and the
    step times of ``dp_timing`` and ``dp_lovasz``; the kernel launch
    counts of the steps and of the eval, each from zero; each part's
    seconds."""
    import torch
    import torch.nn.functional as F

    from esn_tpu_torch.ops import kernels as K
    from esn_tpu_torch.parallel import mesh
    w = mesh.world()
    out = {"rank": w.rank, "size": w.size, "backend": w.backend,
           "devices": mesh.rank_devices(), "seconds": {}}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        value = fn(*args)
        torch.cuda.synchronize()
        out["seconds"][name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        return value
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    K.reset_launches()
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        model, opt, batch, cw = train_setup(torch, F)
        out[name] = part(name, dp_steps, torch, model, opt,
                         mesh.shard_batch(batch), cw, dtype)
        del model, opt, batch
    out["train_launches"] = dict(K.LAUNCHES)
    torch.backends.cudnn.allow_tf32 = True      # the library default
    out["eval"] = part("eval", dp_eval, torch, K, eval_state)
    out["eval_launches"] = out["eval"].pop("launches")
    out["select"] = part("select", dp_select, torch)
    out["timing"] = part("timing", dp_timing, torch, F)
    out["lovasz"] = part("lovasz", dp_lovasz, torch, F)
    return out


def dp_nccl_main():
    """The f32 steps of ``dp_steps`` in a one-rank NCCL group (every
    collective through NCCL), and their launch counts."""
    import torch
    import torch.nn.functional as F

    from esn_tpu_torch.ops import kernels as K
    from esn_tpu_torch.parallel import mesh
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    K.reset_launches()
    model, opt, batch, cw = train_setup(torch, F)
    out = dp_steps(torch, model, opt, mesh.shard_batch(batch), cw,
                   torch.float32)
    torch.cuda.synchronize()
    return {"float32": out, "backend": mesh.world().backend,
            "launches": dict(K.LAUNCHES)}


def dp_readings(got, want, skip, oracle):
    """How far the steps ``got`` lie from ``want``, both from equal
    weights. The first CE step: its loss (relative), the update of all BN
    running statistics together (rel-L2), each run's gradient's distance
    to the f64 ``oracle`` and their ratio (all parameters together). The
    OHEM step: its loss and the statistics' update. The leaves in
    ``skip`` are left out (``_epoch2_gaps``' readings)."""
    import torch
    keys = [k for k in want["before"] if k not in skip]
    stats = [k for k in keys if "running_" in k]
    params = [k for k in keys if "running_" not in k]

    def update(run, at):
        return torch.cat([(run[at][k] - run["before"][k]).double()
                          .flatten() for k in stats])

    def grad(run):
        return torch.cat([run["grads"][k].double().flatten()
                          for k in params])
    g64 = grad({"grads": oracle})
    ce = {"loss_rel": abs(got["losses"][0] - want["losses"][0])
          / abs(want["losses"][0]),
          "stats_rel": _rel(update(got, "after_first"),
                            update(want, "after_first")),
          "grad_to_f64": _rel(grad(got), g64),
          "one_process_grad_to_f64": _rel(grad(want), g64)}
    ce["grad_to_f64_ratio"] = ce["grad_to_f64"] / ce["one_process_grad_to_f64"]
    ohem = {"loss_rel": abs(got["ohem_loss"] - want["ohem_loss"])
            / abs(want["ohem_loss"]),
            "stats_rel": _rel(update(got, "after"), update(want, "after")),
            "threshold_rel": abs(got["thresholds"][0]
                                 - want["thresholds"][0])
            / abs(want["thresholds"][0])}
    return {"ce_first": ce, "ohem_first": ohem}


def dp_check(name, got, want, skip, oracle):
    r = dp_readings(got, want, skip, oracle)
    row = {**r, "bounds": DP_BOUNDS}
    print(f"data_parallel {name}", json.dumps(row))
    check(all(r[part][k] <= DP_BOUNDS[part][k]
              for part in DP_BOUNDS for k in DP_BOUNDS[part]),
          f"data_parallel {name} beyond its bounds: {row}")
    return row


def dp_eval_check(torch, F, ranks, one):
    """The 2-rank eval against one process: each rank's summed confusion
    matrix is the matrix of rank 0's gathered predictions; where a
    prediction differs from the one-process one, the two classes' f32
    upsampled logits lie within twice the largest low-res logit
    difference plus the bf16 argmax gap (the predict phases' near-tie
    rule), at no more than PREDICT_MISMATCH_MAX of the pixels."""
    import numpy as np

    from esn_tpu_torch.train.metrics import confusion_matrix
    _, labels = dp_eval_batch()
    lab = torch.from_numpy(labels)
    pred1 = torch.from_numpy(one["eval"]["preds"])
    pred2 = torch.from_numpy(ranks[0]["eval"]["preds"])
    cm_of = lambda p: confusion_matrix(p, lab, CLASSES, IGNORE).numpy()
    for r in ranks:
        check(np.array_equal(r["eval"]["cm"], cm_of(pred2)),
              "a rank's summed confusion matrix is not that of the "
              "gathered predictions")
    check(np.array_equal(one["eval"]["cm"], cm_of(pred1)),
          "the one-process confusion matrix is not that of its predictions")
    y1 = torch.from_numpy(one["eval"]["logits"][:DP_EVAL_VALID]).cuda()
    y2 = torch.from_numpy(np.concatenate(
        [r["eval"]["logits"] for r in ranks])[:DP_EVAL_VALID]).cuda()
    delta = float((y2 - y1).abs().max())
    mismatch = (pred1 != pred2).cuda()
    gap, mag = upsampled_gap(torch, F, y1, 8, pred1.cuda(), pred2.cuda())
    near = bool((gap <= 2 * delta + ARGMAX_GAP["bfloat16"] * mag)
                [mismatch].all())
    std = float(y1.std())
    row = {"mismatch_rate": float(mismatch.float().mean()),
           "mismatch_max": PREDICT_MISMATCH_MAX["bfloat16"],
           "cm_abs_diff": int(np.abs(ranks[0]["eval"]["cm"]
                                     - one["eval"]["cm"]).sum()),
           "lowres_logit_max_abs_diff": delta,
           "lowres_diff_max": LOWRES_DIFF_MAX["bfloat16"] * std,
           "near_ties_only": near}
    print("data_parallel eval", json.dumps(row))
    check(row["mismatch_rate"] <= row["mismatch_max"]
          and delta <= row["lowres_diff_max"] and near,
          f"data_parallel eval disagrees with one process: {row}")
    return row


def run_command(cmd, env, timeout):
    """``cmd`` in its own session from the repo root: (exit code, output);
    on its time limit the whole session is killed and the phase fails."""
    import os
    import signal
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise SmokeFailure(f"{' '.join(cmd[:8])} did not finish within "
                           f"{timeout:.0f} s")
    return proc.returncode, out


def dp_cli_phase(torch):
    """``torchrun --nproc_per_node 2 -m esn_tpu_torch.cli.train`` (two
    ranks on the one card: gloo) on synthetic data, 2 epochs of one step,
    beside the same run in one process, and a 2-rank resume from the
    torchrun's epoch-1 checkpoint, started as soon as that checkpoint is
    on disk: the log names 2 ranks and gloo; epoch 1's loss (the first
    step, from equal weights) lies within DP_LOSS_REL of one process's,
    the resumed epoch 2's within DP_LOSS_REL of the straight run's, and
    epoch 2's within DP_CLI_STEP2_REL of one process's."""
    import os
    tmp = tempfile.mkdtemp(prefix="esn_dp_cli_")
    env = dict(os.environ, NVIDIA_TF32_OVERRIDE="0",
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    h, w = DP_CLI_HW
    args = ["--model", "FastSCNN", "--dataset", "cityscapes",
            "--input_size", f"{h},{w}", "--synthetic_hw", f"{h}x{w}",
            "--batch_size", "8", "--synthetic_len", "8",
            "--max_epochs", "2",
            "--val_epochs", "1", "--num_workers", "2",
            "--compute_dtype", "float32",
            "--data_root", os.path.join(tmp, "nodata")]
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", str(DP_RANKS), "-m",
                "esn_tpu_torch.cli.train"]
    one_cmd = [sys.executable, "-m", "esn_tpu_torch.cli.train"]

    def run_dir(savedir, ranks):
        return os.path.join(tmp, savedir, "cityscapes",
                            f"FastSCNNbs8gpu{ranks}_train")

    def events(path):
        with open(os.path.join(path, "events.jsonl")) as f:
            return [json.loads(line) for line in f]

    first_ckpt = os.path.join(run_dir("two", 2), "model_1.ckpt")

    def resume():
        # the checkpoint is written whole (renamed into place)
        deadline = time.monotonic() + DP_LIMIT
        while not os.path.exists(first_ckpt):
            check(time.monotonic() < deadline and not two.done(),
                  "torchrun cli.train wrote no epoch-1 checkpoint")
            time.sleep(0.2)
        return run_command(torchrun + args + [
            "--savedir", os.path.join(tmp, "resumed"),
            "--resume", first_ckpt], env, DP_LIMIT)

    t0 = time.perf_counter()
    with concurrent_runs() as pool:
        two = pool.submit(run_command, torchrun + args + [
            "--savedir", os.path.join(tmp, "two")], env, DP_LIMIT)
        one = pool.submit(run_command, one_cmd + args + [
            "--savedir", os.path.join(tmp, "one")], env, DP_LIMIT)
        resumed = pool.submit(resume)
        for run, what in ((two, "torchrun cli.train"), (one, "cli.train"),
                          (resumed, "torchrun cli.train --resume")):
            rc, out = run.result()
            check(rc == 0, f"{what} exited {rc}: {out[-3000:]}")
    seconds = time.perf_counter() - t0
    with open(os.path.join(run_dir("two", 2), "log.txt")) as f:
        header = f.read().splitlines()[2]
    e1, e2 = events(run_dir("one", 1)), events(run_dir("two", 2))
    e3 = events(run_dir("resumed", 2))
    rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
           for a, b in zip(e2, e1)]
    resume_rel = abs(e3[0]["loss"] - e2[1]["loss"]) / abs(e2[1]["loss"])
    row = {"header": header, "one_losses": [e["loss"] for e in e1],
           "two_losses": [e["loss"] for e in e2],
           "resumed_losses": [e["loss"] for e in e3],
           "loss_rel": rel, "resume_loss_rel": resume_rel,
           "bounds": {"epoch1": DP_LOSS_REL, "epoch2": DP_CLI_STEP2_REL,
                      "resumed": DP_LOSS_REL},
           "miou": [[e["miou"] for e in e1], [e["miou"] for e in e2]],
           "seconds": seconds}
    print("data_parallel torchrun", json.dumps(row))
    check(header.startswith(f"world: {DP_RANKS} rank(s)  backend: gloo"),
          f"torchrun log header: {header!r}")
    check([e["epoch"] for e in e2] == [1, 2]
          and [e["epoch"] for e in e3] == [2],
          f"torchrun epochs {[e['epoch'] for e in e2]}, resumed "
          f"{[e['epoch'] for e in e3]}")
    check(rel[0] <= DP_LOSS_REL and rel[1] <= DP_CLI_STEP2_REL
          and resume_rel <= DP_LOSS_REL,
          f"torchrun losses beyond their f32 bounds: {row}")
    return row


@contextlib.contextmanager
def concurrent_runs():
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(4) as pool:
        yield pool


def data_parallel_phase(torch, F, K, BatchNorm, build_model):
    """Data parallelism on the one card (see the module docstring): the
    one-process run, the DP_RANKS-rank run (each rank's kernel launches
    reported back), a one-rank NCCL group, torchrun."""
    from esn_tpu_torch.parallel import launch
    _, skip = zero_gradient_leaves(torch, F)
    oracle = dp_oracle_grads(torch, F, K)
    eval_model = seeded_model(torch, F, build_model, BatchNorm, 5)
    eval_state = {k: v.detach().cpu().numpy()
                  for k, v in eval_model.state_dict().items()}
    del eval_model
    t0 = time.perf_counter()
    one = launch.to_numpy(dp_rank_main(eval_state))
    one_s = time.perf_counter() - t0
    one = {**one, **{d: dp_rank_main_tensors(torch, one[d])
                     for d in ("float32", "bfloat16")}}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch.run_ranks(dp_rank_main, DP_RANKS, eval_state,
                             device="cuda", timeout=DP_LIMIT, threads=None)
    spawn_s = time.perf_counter() - t0
    for r in ranks:
        for d in ("float32", "bfloat16"):
            r[d] = dp_rank_main_tensors(torch, r[d])
    check([r["backend"] for r in ranks] == ["gloo"] * DP_RANKS
          and ranks[0]["devices"] == ["cuda:0"] * DP_RANKS,
          f"ranks' backends {[r['backend'] for r in ranks]}, devices "
          f"{ranks[0]['devices']}")
    rows = {}
    for r in ranks:
        for d in ("float32", "bfloat16"):
            rows[f"rank{r['rank']}_{d}"] = dp_check(
                f"rank {r['rank']} {d}", r[d], one[d], skip, oracle)
    # the ranks took the same steps: the same state bit for bit, the same
    # OHEM threshold
    for d in ("float32", "bfloat16"):
        for at in ("after_ce", "after"):
            for k, v in ranks[0][d][at].items():
                check(all(torch.equal(r[d][at][k], v) for r in ranks),
                      f"{d}: the ranks' {k} differ ({at})")
        check(all(r[d]["thresholds"] == ranks[0][d]["thresholds"]
                  for r in ranks), f"{d}: the ranks' OHEM thresholds differ")
    select = {"one": one["select"], "ranks": [r["select"] for r in ranks]}
    print("data_parallel select", json.dumps(select))
    check(all(r["select"]["kth"] == one["select"]["kth"] for r in ranks),
          f"the global select is not the one-process topk bit for bit: "
          f"{select}")
    eval_row = dp_eval_check(torch, F, ranks, one)
    lovasz = {"one": one["lovasz"], "ranks": [r["lovasz"] for r in ranks]}
    print("data_parallel lovasz (both ranks share the one card)",
          json.dumps(lovasz))
    check(all(abs(r["lovasz"]["loss"] - one["lovasz"]["loss"])
              <= DP_LOSS_REL * abs(one["lovasz"]["loss"]) for r in ranks),
          f"the Lovász step's loss at {DP_RANKS} ranks is not the "
          f"one-process loss: {lovasz}")
    for r in ranks:
        check(r["train_launches"]["resize_ce_fwd"] == 2 * DP_CE_STEPS
              and r["train_launches"]["resize_ce_bwd"] == 2 * DP_CE_STEPS,
              f"rank {r['rank']}: K3 launches over the f32 and bf16 steps "
              f"{r['train_launches']}")
        check(r["train_launches"]["resize_bilinear_bwd"] > 0
              and r["train_launches"]["adaptive_pool_bwd"] > 0,
              f"rank {r['rank']}: no K5/K6 launch over its steps "
              f"{r['train_launches']}")
        check(r["eval_launches"]["dsconv"] == 4
              and r["eval_launches"]["resize_argmax"] == 1,
              f"rank {r['rank']}: eval launches {r['eval_launches']}")
    # one rank, NCCL: every collective of the f32 steps through NCCL,
    # beside the torchrun runs (the card has room for all of them)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with concurrent_runs() as pool:
        nccl = pool.submit(launch.run_ranks, dp_nccl_main, 1, device="cuda",
                           timeout=DP_LIMIT, threads=None)
        cli = dp_cli_phase(torch)
        nccl = nccl.result()[0]
    last_s = time.perf_counter() - t0
    check(nccl["backend"] == "nccl", f"one-rank group backend "
          f"{nccl['backend']}")
    rows["nccl_float32"] = dp_check(
        "one-rank nccl f32", dp_rank_main_tensors(torch, nccl["float32"]),
        one["float32"], skip, oracle)
    timing = {"one_process": one["timing"],
              "ranks": [r["timing"] for r in ranks]}
    print("data_parallel timing (both ranks share the one card)",
          json.dumps(timing))
    seconds = {"one_process": one_s, "ranks": spawn_s,
               "nccl_and_torchrun": last_s,
               "one_process_parts": one["seconds"],
               "rank_parts": [r["seconds"] for r in ranks]}
    print("data_parallel seconds", json.dumps(seconds))
    launches = {"ranks_train": {}, "ranks_eval": {}, "nccl_rank":
                nccl["launches"]}
    for r in ranks:
        for key, part in (("train_launches", "ranks_train"),
                          ("eval_launches", "ranks_eval")):
            for name, n in r[key].items():
                launches[part][name] = launches[part].get(name, 0) + n
    return {"seconds": seconds, "readings": rows, "eval": eval_row,
            "lovasz": lovasz,
            "select": select, "torchrun": cli, "timing": timing,
            "launches": launches, "skip": sorted(skip),
            "one_process_launches": {"train": one["train_launches"],
                                     "eval": one["eval_launches"]},
            "thresholds": {d: [r[d]["thresholds"] for r in ranks]
                           + [one[d]["thresholds"]]
                           for d in ("float32", "bfloat16")}}


def dp_rank_main_tensors(torch, steps):
    """``dp_steps``' states as tensors again (they cross the process
    boundary as numpy)."""
    return {**steps, **{k: {n: torch.as_tensor(v) for n, v in steps[k].items()}
                        for k in ("before", "grads", "after_first",
                                  "after_ce", "after")}}


def plain_ce_step(torch, model, opt, cw, dtype):
    """Class-weighted CE on the model's full-resolution logits
    (``fwd_method`` None): the spatial route, and the one-process step it
    is held against; poly lr, dropout masks from a seeded generator."""
    from esn_tpu_torch.train.losses import cross_entropy
    from esn_tpu_torch.train.schedules import build_schedule
    from esn_tpu_torch.train.step import make_train_step
    device = next(model.parameters()).device
    loss = functools.partial(cross_entropy, num_classes=cw.numel(),
                             class_weights=cw.to(device),
                             ignore_index=IGNORE)
    return make_train_step(
        model, loss, opt,
        schedule=build_schedule("poly", TRAIN_LR, TRAIN_TOTAL_STEPS),
        compute_dtype=dtype, fwd_method=None,
        generator=torch.Generator(device=device).manual_seed(3))


def _snapshot(model):
    return {k: v.detach().float().cpu().numpy().copy()
            for k, v in model.state_dict().items()}


def _my_rows(torch, batch):
    """This rank's batch rows' image rows (``spatial.shard_batch_spatial``;
    the batch itself in one process), as tensors of their own, the global
    batch freed."""
    from esn_tpu_torch.parallel import spatial
    mine = {k: v.contiguous() for k, v in
            spatial.shard_batch_spatial(batch).items()}
    batch.clear()
    torch.cuda.empty_cache()
    return mine


def sp_first_step(torch, F, arch, hw, dtype):
    """One plain-CE adam step of ``arch`` at ``hw`` from the seeded weights
    on this rank's rows: the loss, the gradient (summed over the ranks)
    and the state before and after (f32 numpy)."""
    model, opt, batch, cw = train_setup(torch, F, arch, hw)
    before = _snapshot(model)
    step = plain_ce_step(torch, model, opt, cw, dtype)
    loss = float(step(_my_rows(torch, batch))["loss"])
    return {"loss": loss, "before": before, "after": _snapshot(model),
            "grads": {n: p.grad.detach().float().cpu().numpy()
                      for n, p in model.named_parameters()}}


def sp_oracle(torch, F, arch, hw):
    """The first plain-CE step in f64 on the card (one process): its
    loss, gradient and state before and after (f32 numpy)."""
    model, opt, batch, cw = train_setup(torch, F, arch, hw)
    model.double()
    before = _snapshot(model)
    loss = float(plain_ce_step(torch, model, opt, cw, torch.float64)(
        batch)["loss"])
    out = {"loss": loss, "before": before, "after": _snapshot(model),
           "grads": {n: p.grad.detach().float().cpu().numpy()
                     for n, p in model.named_parameters()}}
    del model, opt, batch
    torch.cuda.empty_cache()
    return out


def sp_timing(torch, F, arch, hw):
    """The bf16 plain-CE step on this rank's rows: its ms
    (``timed_steps``), the peak memory allocated over those steps, from a
    reset after the set-up, and the row-count sums a step made
    (``spatial.ROW_SUMS``: count, host ms, share of the step); under a
    group one more step's ``collective_costs``."""
    from esn_tpu_torch.parallel import mesh, spatial
    model, opt, batch, cw = train_setup(torch, F, arch, hw)
    step = plain_ce_step(torch, model, opt, cw, torch.bfloat16)
    batch = _my_rows(torch, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    spatial.ROW_SUMS[:] = [0, 0.0]
    out = {"ms": 1e3 * timed_steps(torch, step, batch, SP_TIMED_STEPS),
           "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
           "rows": list(batch["image"].shape)}
    # the row-count sums of a step (the warm-up's too: SP_TIMED_STEPS + 1)
    calls, secs = spatial.ROW_SUMS
    out["row_sums"] = {"a_step": calls / (SP_TIMED_STEPS + 1),
                       "ms_a_step": 1e3 * secs / (SP_TIMED_STEPS + 1)}
    out["row_sums"]["share"] = out["row_sums"]["ms_a_step"] / out["ms"]
    if mesh.active():
        out["collectives"] = collective_costs(torch, lambda: step(batch))
    return out


SP_MODELS = (("fastscnn", IMAGE_HW), ("enet", SP_ENET_HW))


def sp_rank_main(models=SP_MODELS):
    """One rank of the spatial phase (with no group, the one-process run
    it is held against): under a group the world laid out as (1,
    SP_RANKS); for each model of ``models`` the f32 (TF32 off) and bf16
    first steps of ``sp_first_step`` and the bf16 timing of
    ``sp_timing``; the kernel launches of the steps; each part's
    seconds."""
    import torch
    import torch.nn.functional as F

    from esn_tpu_torch.ops import kernels as K
    from esn_tpu_torch.parallel import mesh, spatial
    if mesh.active():
        spatial.make_spatial_mesh(mesh.world().size // SP_RANKS, SP_RANKS)
    w = mesh.world()
    out = {"rank": w.rank, "spatial": w.spatial, "backend": w.backend,
           "seconds": {}}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        value = fn(*args)
        torch.cuda.synchronize()
        out["seconds"][name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        return value
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    K.reset_launches()
    for arch, hw in models:
        out[arch] = {d: part(f"{arch}_{d}", sp_first_step, torch, F, arch,
                             hw, getattr(torch, d))
                     for d in ("float32", "bfloat16")}
    torch.backends.cudnn.allow_tf32 = True      # the library default
    for arch, hw in models:
        out[arch]["timing"] = part(f"{arch}_timing", sp_timing, torch, F,
                                   arch, hw)
    out["launches"] = dict(K.LAUNCHES)
    return out


def _np_rel(a, b) -> float:
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def sp_readings(got, want, skip, oracle):
    """The data_parallel gate's first-step readings (``dp_readings``'
    ``ce_first``) of ``got`` against ``want``, their losses' distances
    to the f64 step ``oracle``'s, and the ratio of their statistics'
    updates' distances to its, numpy."""
    import numpy as np
    keys = [k for k in want["before"] if k not in skip]
    stats = [k for k in keys if "running_" in k]
    params = [k for k in keys if "running_" not in k]

    def update(run):
        return np.concatenate([(run["after"][k] - run["before"][k])
                               .astype(np.float64).ravel() for k in stats])

    def grad(grads):
        return np.concatenate([np.asarray(grads[k], np.float64).ravel()
                               for k in params])
    g64, u64, l64 = grad(oracle["grads"]), update(oracle), oracle["loss"]
    r = {"loss_rel": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
         "stats_rel": _np_rel(update(got), update(want)),
         "grad_to_f64": _np_rel(grad(got["grads"]), g64),
         "one_process_grad_to_f64": _np_rel(grad(want["grads"]), g64),
         "loss_to_f64": abs(got["loss"] - l64) / abs(l64),
         "one_process_loss_to_f64": abs(want["loss"] - l64) / abs(l64),
         "stats_to_f64_ratio": _np_rel(update(got), u64)
         / max(_np_rel(update(want), u64), 1e-30)}
    r["grad_to_f64_ratio"] = r["grad_to_f64"] / r["one_process_grad_to_f64"]
    return r


def sp_check(ranks, one, skip, oracle, models, gates, label):
    """Hold the ranks of ``sp_rank_main`` (``ranks``) against the
    one-process run ``one`` and the f64 steps ``oracle``: each rank's
    first-step readings (``sp_readings``) within ``gates[arch][dtype]``
    (a model whose gates are None is read, not held), the ranks' states
    equal bit for bit, no kernel launched on the spatial route. Returns
    the readings by rank, model and dtype."""
    import numpy as np
    check([(r["backend"], r["spatial"]) for r in ranks]
          == [("gloo", SP_RANKS)] * SP_RANKS,
          f"{label} ranks: {[(r['backend'], r['spatial']) for r in ranks]}")
    rows = {}
    for r in ranks:
        for arch, _ in models:
            for d in ("float32", "bfloat16"):
                got = sp_readings(r[arch][d], one[arch][d], skip[arch],
                                  oracle[arch])
                gate = None if gates[arch] is None else gates[arch][d]
                row = {**got, "bounds": gate}
                rows[f"rank{r['rank']}_{arch}_{d}"] = row
                print(f"{label} rank {r['rank']} {arch} {d}",
                      json.dumps(row))
                check(gate is None or all(got[k] <= v
                                          for k, v in gate.items()),
                      f"{label} rank {r['rank']} {arch} {d} beyond its "
                      f"bounds: {row}")
    for arch, _ in models:
        for d in ("float32", "bfloat16"):
            for k, v in ranks[0][arch][d]["after"].items():
                check(all(np.array_equal(r[arch][d]["after"][k], v)
                          for r in ranks),
                      f"{label} {arch} {d}: the ranks' {k} differ")
    for run in (one, *ranks):
        check(not any(tpu_launches(run["launches"]).values()),
              f"the {label} route launched K1-K4: {run['launches']}")
        for arch, _ in models:
            want = bwd_launches(arch, 1, full=True)
            check(all(run["launches"][k] >= n for k, n in want.items()),
                  f"the {label} route of {arch} launched K5/K6 "
                  f"{run['launches']}, at least {want} a step")
    return rows


def spatial_phase(torch, F, K):
    """Spatial sharding on the one card (see SP_RANKS): the torchrun
    check beside the f64 oracles, then the one-process run and the
    SP_RANKS-rank run of ``sp_rank_main``, held by the data_parallel
    gate; the ranks' states equal bit for bit; no kernel launched on the
    spatial route."""
    from esn_tpu_torch.parallel import launch
    t0 = time.perf_counter()
    with concurrent_runs() as pool:
        cli = pool.submit(sp_cli_phase, torch)
        skip = {arch: zero_gradient_leaves(torch, F, arch)[1]
                for arch, _ in SP_MODELS}
        oracle = {arch: sp_oracle(torch, F, arch, hw)
                  for arch, hw in SP_MODELS}
        cli = cli.result()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    one = launch.to_numpy(sp_rank_main())
    one_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch.run_ranks(sp_rank_main, SP_RANKS, device="cuda",
                             timeout=DP_LIMIT, threads=None)
    spawn_s = time.perf_counter() - t0
    rows = sp_check(ranks, one, skip, oracle, SP_MODELS, SP_GATES,
                    "spatial")
    timing = {arch: {"one_process": one[arch]["timing"],
                     "ranks": [r[arch]["timing"] for r in ranks]}
              for arch, _ in SP_MODELS}
    print("spatial timing (both ranks share the one card)",
          json.dumps(timing))
    seconds = {"torchrun_and_oracles": first_s, "one_process": one_s,
               "ranks": spawn_s, "one_process_parts": one["seconds"],
               "rank_parts": [r["seconds"] for r in ranks]}
    print("spatial seconds", json.dumps(seconds))
    return {"readings": rows, "timing": timing, "torchrun": cli,
            "seconds": seconds, "launches": cli_launches(cli),
            "skip": {a: sorted(v) for a, v in skip.items()}}



def spu_kernel_checks(torch, F, K):
    """K2 at Fast-SCNN's four eval DSConvs and K1 at its predict tail at
    CamVid's 720x960 (SPU_DSCONV, SPU_ARGMAX), bf16 and f32, each against
    its plain version at the kernel phase's tolerances, and timed."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for model, name, shape, cout, stride in SPU_DSCONV:
            row = dsconv_case(K, torch, gen, shape, cout, stride, dtype)
            row.update(kernel="fused_dsconv", model=model, layer=name)
            rows.append(row)
        row = resize_argmax_case(K, torch, F, gen, SPU_ARGMAX, 8, dtype)
        row.update(kernel="resize_argmax", model="fastscnn",
                   layer="predict tail")
        rows.append(row)
    torch.backends.cudnn.allow_tf32 = True      # the library default
    torch.backends.cuda.matmul.allow_tf32 = False
    for row in rows:
        print("spatial_uneven kernel", json.dumps(row))
    bad = [r for r in rows if not (r["within_tol"] and r["bit_identical"])]
    check(not bad, f"kernel at CamVid's width outside tolerance: {bad}")
    return rows


def cli_rank_main(out_dir, argv) -> int:
    """``esn_tpu_torch.cli.train.main(argv)`` with the kernel launches
    counted from zero, written to ``out_dir/launches_rank{RANK}.json``:
    what ``torchrun ... chip_smoke.py --cli-launches OUT ARGS`` runs on
    each rank (and ``python3 chip_smoke.py --cli-launches OUT ARGS`` in
    one process)."""
    import os
    sys.path.insert(0, str(REPO))
    from esn_tpu_torch.cli.train import main as train_main
    from esn_tpu_torch.ops import kernels as K
    K.reset_launches()
    rc = train_main(argv)
    rank = int(os.environ.get("RANK", "0"))
    Path(out_dir, f"launches_rank{rank}.json").write_text(
        json.dumps(dict(K.LAUNCHES)))
    return rc


def sp_cli_phase(torch, hw=SP_CLI_HW, label="spatial"):
    """``torchrun --nproc_per_node SP_RANKS`` of ``cli.train --spatial
    SP_RANKS`` (through ``cli_rank_main``, which counts each rank's
    launches) on synthetic 19-class data at ``hw``, one epoch of one step
    (f32, TF32 off) and its validation pass, beside the same run in one
    process: the log names the mesh, the epoch's loss (the first step,
    from equal weights) lies within DP_LOSS_REL of one process's (which
    takes K3: the same loss to f32 rounding), and each rank's validation
    (its whole images, Fast-SCNN's predict) launched K1, and K2 four
    times a K1."""
    import os
    tmp = tempfile.mkdtemp(prefix="esn_sp_cli_")
    env = dict(os.environ, NVIDIA_TF32_OVERRIDE="0",
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    h, w = hw
    args = ["--model", "FastSCNN", "--dataset", "cityscapes",
            "--input_size", f"{h},{w}", "--synthetic_hw", f"{h}x{w}",
            "--batch_size", "8", "--synthetic_len", "8", "--max_epochs", "1",
            "--val_epochs", "1", "--num_workers", "2",
            "--compute_dtype", "float32",
            "--data_root", os.path.join(tmp, "nodata")]
    me = [str(REPO / "chip_smoke.py"), "--cli-launches"]
    cmds = {"sharded": [sys.executable, "-m", "torch.distributed.run",
                        "--standalone", "--nproc_per_node", str(SP_RANKS)]
            + me + [os.path.join(tmp, "sharded"), "--spatial",
                    str(SP_RANKS)],
            "one": [sys.executable] + me + [os.path.join(tmp, "one")]}
    t0 = time.perf_counter()
    with concurrent_runs() as pool:
        runs = {}
        for name, cmd in cmds.items():
            os.makedirs(os.path.join(tmp, name))
            runs[name] = pool.submit(run_command, cmd + args + [
                "--savedir", os.path.join(tmp, name)], env, DP_LIMIT)
        for name, run in runs.items():
            rc, out = run.result()
            check(rc == 0, f"{name} cli.train exited {rc}: {out[-3000:]}")
    seconds = time.perf_counter() - t0

    def run_dir(name, ranks):
        return os.path.join(tmp, name, "cityscapes",
                            f"FastSCNNbs8gpu{ranks}_train")

    def events(path):
        with open(os.path.join(path, "events.jsonl")) as f:
            return [json.loads(line) for line in f]

    def launches(name, ranks):
        return [json.loads(Path(tmp, name, f"launches_rank{r}.json")
                           .read_text()) for r in range(ranks)]
    with open(os.path.join(run_dir("sharded", SP_RANKS), "log.txt")) as f:
        header = f.read().splitlines()[2]
    e1, e2 = events(run_dir("one", 1)), events(run_dir("sharded", SP_RANKS))
    rel = abs(e2[0]["loss"] - e1[0]["loss"]) / abs(e1[0]["loss"])
    row = {"header": header, "one_loss": e1[0]["loss"],
           "sharded_loss": e2[0]["loss"], "loss_rel": rel,
           "bound": DP_LOSS_REL, "miou": [e1[0]["miou"], e2[0]["miou"]],
           "launches": {"ranks": launches("sharded", SP_RANKS),
                        "one_process": launches("one", 1)[0]},
           "seconds": seconds}
    print(f"{label} torchrun", json.dumps(row))
    check(header.endswith(f"mesh: 1 data x {SP_RANKS} model"),
          f"torchrun --spatial log header: {header!r}")
    check(rel <= DP_LOSS_REL, f"torchrun --spatial at {h}x{w}: loss beyond "
          f"its bound: {row}")
    for r, n in enumerate(row["launches"]["ranks"]):
        check(n["resize_argmax"] >= 1
              and n["dsconv"] == 4 * n["resize_argmax"]
              and n["resize_ce_fwd"] == n["resize_ce_bwd"] == 0,
              f"torchrun --spatial at {h}x{w}: rank {r} launched {n}")
    return row


def cli_launches(cli):
    """``sp_cli_phase``'s launches by run, for ``launches by model``."""
    return {**{f"cli_rank{r}": n
               for r, n in enumerate(cli["launches"]["ranks"])},
            "cli_one_process": cli["launches"]["one_process"]}


def spatial_uneven_phase(torch, F, K):
    """Uneven spatial shards on the one card (see CAMVID_HW): K1 and K2
    at CamVid's width against their plain versions, the torchrun check
    beside the f64 oracles, then ``sp_rank_main`` over SPU_MODELS in one
    process and on SP_RANKS ranks, held by SPU_GATES (``sp_check``)."""
    from esn_tpu_torch.parallel import launch
    t0 = time.perf_counter()
    kernel_rows = spu_kernel_checks(torch, F, K)
    kernels_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with concurrent_runs() as pool:
        cli = pool.submit(sp_cli_phase, torch, SPU_CLI_HW, "spatial_uneven")
        skip = {arch: zero_gradient_leaves(torch, F, arch)[1]
                for arch, _ in SPU_MODELS}
        oracle = {arch: sp_oracle(torch, F, arch, hw)
                  for arch, hw in SPU_MODELS}
        cli = cli.result()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    one = launch.to_numpy(sp_rank_main(SPU_MODELS))
    one_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch.run_ranks(sp_rank_main, SP_RANKS, SPU_MODELS,
                             device="cuda", timeout=DP_LIMIT, threads=None)
    spawn_s = time.perf_counter() - t0
    rows = sp_check(ranks, one, skip, oracle, SPU_MODELS, SPU_GATES,
                    "spatial_uneven")
    timing = {arch: {"one_process": one[arch]["timing"],
                     "ranks": [r[arch]["timing"] for r in ranks]}
              for arch, _ in SPU_MODELS}
    print("spatial_uneven timing (both ranks share the one card)",
          json.dumps(timing))
    seconds = {"kernels": kernels_s, "torchrun_and_oracles": first_s,
               "one_process": one_s, "ranks": spawn_s,
               "one_process_parts": one["seconds"],
               "rank_parts": [r["seconds"] for r in ranks]}
    print("spatial_uneven seconds", json.dumps(seconds))
    return {"kernels": kernel_rows, "readings": rows, "timing": timing,
            "torchrun": cli, "seconds": seconds,
            "launches": cli_launches(cli),
            "skip": {a: sorted(v) for a, v in skip.items()}}


# --- the port's decoder, and the golden runs -----------------------------

# decode: images and labels at Cityscapes' size, as PNG files written by
# the phase's own encoder with row filters 0-4 in turn
DECODE_HW = (1024, 2048)
DECODE_RECORDS = 8
DECODE_WORKERS = (1, 4, 8)
# what a b8 Fast-SCNN train step consumes: 8 images at ~90 ms a step
# (PERF.md section 5, NVIDIA H100 80GB HBM3, 700 W)
FASTSCNN_STEP_IMG_S = 89.0
DECODE_ODD_HW = (383, 769)
# the decoder's fixtures (tests/_jpeg_fixtures.py writes them where an
# encoder is; this machine has none): JPEGs of every kind the decoder
# reads and an Adam7 PNG, with the sha256 of the reference's decodes, and
# a 2048x1024 4:2:0 JPEG for the rate
JPEG_FIXTURES = REPO / "tests" / "data" / "jpeg"
JPEG_RATE_FILE = "cityscapes_2048x1024_420.jpg"
JPEG_RATE_PASSES = 16


def _png_file(path, image):
    """``image`` ((H, W) or (H, W, 3) uint8, RGB) as an 8-bit PNG whose
    row y carries filter y % 5: None, Sub, Up, Average, Paeth."""
    import struct
    import zlib

    import numpy as np
    h, w = image.shape[:2]
    bpp = 1 if image.ndim == 2 else 3
    raw = image.reshape(h, w * bpp).astype(np.int16)
    up = np.concatenate([np.zeros((1, w * bpp), np.int16), raw[:-1]])
    left = np.concatenate([np.zeros((h, bpp), np.int16), raw[:, :-bpp]], 1)
    upleft = np.concatenate([np.zeros((h, bpp), np.int16), up[:, :-bpp]], 1)
    p = left + up - upleft
    pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    preds = [np.zeros_like(raw), left, up, (left + up) // 2, paeth]
    kind = np.arange(h) % 5
    pred = np.choose(kind[:, None], preds)
    rows = np.concatenate([kind[:, None], (raw - pred) % 256], 1)

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xffffffff))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                             0 if bpp == 1 else 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(
                    rows.astype(np.uint8).tobytes(), 6))
                + chunk(b"IEND", b""))


def _bilinear_oracle(np, src, hw):
    """The reference's bilinear resize (native/esn_native.cc), in float32
    numpy: half-pixel centres, +0.5 rounding."""
    f32 = np.float32
    sh, sw = src.shape[:2]

    def axis(n_src, n_dst):
        f = ((np.arange(n_dst, dtype=f32) + f32(0.5))
             * (f32(n_src) / f32(n_dst)) - f32(0.5))
        i0 = np.floor(f).astype(np.int64)
        wt = f - i0.astype(f32)
        neg = i0 < 0
        i1 = np.where(neg, 0, i0 + 1)
        i0, wt = np.where(neg, 0, i0), np.where(neg, f32(0), wt)
        return np.minimum(i0, n_src - 1), np.minimum(i1, n_src - 1), wt

    y0, y1, wy = axis(sh, hw[0])
    x0, x1, wx = axis(sw, hw[1])
    s = src.astype(f32)
    wy, wx, one = wy[:, None, None], wx[None, :, None], f32(1)
    v = (s[y0][:, x0] * (one - wy) * (one - wx)
         + s[y0][:, x1] * (one - wy) * wx
         + s[y1][:, x0] * wy * (one - wx) + s[y1][:, x1] * wy * wx)
    return (v + f32(0.5)).astype(np.uint8)


def _nearest_oracle(np, src, hw):
    f32 = np.float32
    sh, sw = src.shape
    ys = np.minimum((np.arange(hw[0], dtype=f32)
                     * (f32(sh) / f32(hw[0]))).astype(np.int64), sh - 1)
    xs = np.minimum((np.arange(hw[1], dtype=f32)
                     * (f32(sw) / f32(hw[1]))).astype(np.int64), sw - 1)
    return src[ys][:, xs]


def decode_phase(torch):
    """The port's image decoder (``data/native.py``) on the card's host:

    1. DECODE_RECORDS Cityscapes-sized records (2048x1024 RGB images of
       8x8 blocks plus noise, grey labels of 32x32 blocks), written by
       ``_png_file`` with every row filter; each decodes equal to the
       array written (``decode_bgr`` the BGR of it, ``decode_grey`` the
       label);
    2. the resizes against a numpy oracle of the reference's formulas,
       at half size and at an odd size (bit for bit);
    3. decoded records a second on one thread (image and label, as
       ``ManifestDataset`` reads them), through ``BatchLoader`` at batch
       8 with ``num_workers`` DECODE_WORKERS, and through
       ``NativePipeline`` on 8 threads, beside FASTSCNN_STEP_IMG_S;
    4. the fixtures of JPEG_FIXTURES (every JPEG kind the port's decoder
       reads, an Adam7 PNG) decode, BGR and grey, to the sha256 of the
       reference's decodes recorded beside them;
    5. the 2048x1024 JPEG decoded images a second on one thread and
       through ``NativePipeline`` on 8 threads (JPEG_RATE_PASSES images
       each), beside one PNG image of the same size on one thread.
    """
    import hashlib
    import os

    import numpy as np

    from esn_tpu_torch.data import CAMVID, BatchLoader, native
    from esn_tpu_torch.data.datasets import ManifestDataset

    h, w = DECODE_HW
    rng = np.random.RandomState(0)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        written, records = [], []
        for i in range(DECODE_RECORDS):
            base = rng.randint(0, 256, (h // 8, w // 8, 3)).astype(np.uint8)
            img = (base.repeat(8, 0).repeat(8, 1).astype(np.int16)
                   + rng.randint(-12, 13, (h, w, 3))).clip(0, 255).astype(
                       np.uint8)
            lab = rng.randint(0, CLASSES, (h // 32, w // 32)).astype(
                np.uint8).repeat(32, 0).repeat(32, 1)
            lab[rng.rand(h, w) < 0.02] = IGNORE
            ip, lp = f"{tmp}/img_{i}.png", f"{tmp}/lab_{i}.png"
            _png_file(ip, img)
            _png_file(lp, lab)
            written.append((img, lab))
            records.append((ip, lp))
        write_s = time.perf_counter() - t0
        build_t0 = time.perf_counter()
        native.library()
        build_s = time.perf_counter() - build_t0
        for (ip, lp), (img, lab) in zip(records, written):
            check(np.array_equal(native.decode_bgr(ip), img[..., ::-1]),
                  f"decode: {ip} differs from the array written")
            check(np.array_equal(native.decode_grey(lp), lab),
                  f"decode: {lp} differs from the array written")
        img, lab = written[0]
        for hw in ((h // 2, w // 2), DECODE_ODD_HW):
            check(np.array_equal(native.decode_bgr(records[0][0], hw),
                                 _bilinear_oracle(np, img[..., ::-1], hw)),
                  f"decode: bilinear resize to {hw} differs from the "
                  "reference's formula")
            check(np.array_equal(native.decode_grey(records[0][1], hw),
                                 _nearest_oracle(np, lab, hw)),
                  f"decode: nearest resize to {hw} differs from the "
                  "reference's formula")
        ds = ManifestDataset(records * 2, CAMVID)
        t1 = time.perf_counter()
        for i in range(len(ds)):
            ds[i]
        rates = {"one_thread": len(ds) / (time.perf_counter() - t1)}
        for n in DECODE_WORKERS:
            loader = BatchLoader(ds, BATCH, num_workers=n)
            t1 = time.perf_counter()
            count = sum(len(b["image"]) for b in loader)
            rates[f"batch_loader_{n}"] = count / (time.perf_counter() - t1)
        with native.NativePipeline(records * 2, DECODE_HW, threads=8) as pipe:
            t1 = time.perf_counter()
            count = sum(1 for _ in pipe.epoch())
            rates["native_pipeline_8"] = count / (time.perf_counter() - t1)
        t1 = time.perf_counter()
        for ip, _ in records:
            native.decode_bgr(ip)
        png_image_s = len(records) / (time.perf_counter() - t1)
    rates = {k: round(v, 3) for k, v in rates.items()}
    print(f"decode: records/s at {w}x{h} (image + label)", json.dumps(rates),
          f"beside a b8 Fast-SCNN step's ~{FASTSCNN_STEP_IMG_S} img/s")

    # 4. the fixtures against the reference's hashes
    want = json.loads((JPEG_FIXTURES / "SHA256.json").read_text())

    def sha(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
    for name, rec in want.items():
        path = str(JPEG_FIXTURES / name)
        bgr, grey = native.decode_bgr(path), native.decode_grey(path)
        check(list(bgr.shape[:2]) == rec["hw"] and sha(bgr) == rec["bgr"]
              and sha(grey) == rec["grey"],
              f"decode: {name} differs from the reference's decode")

    # 5. the JPEG rate
    jpeg = str(JPEG_FIXTURES / JPEG_RATE_FILE)
    check(native.image_info(jpeg) == DECODE_HW, f"{jpeg}: not {DECODE_HW}")
    jpeg_rates = {"png_image_one_thread": png_image_s}
    t1 = time.perf_counter()
    for _ in range(JPEG_RATE_PASSES):
        native.decode_bgr(jpeg)
    jpeg_rates["jpeg_one_thread"] = JPEG_RATE_PASSES / (time.perf_counter()
                                                        - t1)
    with native.NativePipeline([(jpeg, None)] * JPEG_RATE_PASSES, DECODE_HW,
                               threads=8) as pipe:
        t1 = time.perf_counter()
        count = sum(1 for _ in pipe.epoch())
        jpeg_rates["jpeg_native_pipeline_8"] = count / (time.perf_counter()
                                                        - t1)
    jpeg_rates = {k: round(v, 3) for k, v in jpeg_rates.items()}
    print(f"decode: {len(want)} fixtures equal to the reference's decodes; "
          f"images/s at {w}x{h}", json.dumps(jpeg_rates))
    return {"records_per_s": rates, "images_per_s": jpeg_rates,
            "fixtures_equal": len(want),
            "fastscnn_step_img_s": FASTSCNN_STEP_IMG_S, "cpus": os.cpu_count(),
            "write_s": write_s, "build_s": build_s}


# golden: the four GOLDEN.json configs through the port's Trainer on the
# card at golden_run.SEEDS, f32 (TF32 off) and bf16, each held to the
# reference's spread over seeds (esn_tpu_torch/tools/golden_spread.json,
# the bound the CPU tests hold: a majority of the runs within the ranges
# and over the mIoU floor); bf16 also against f32 (golden_run.check_gap:
# the gap between the medians over the seeds within BF16_GAP). Fast-SCNN's
# weighted-CE steps launch K3 once forward and once backward (24 epochs
# of 2 steps a run), its validation K2 4 times and K1 once (one val batch
# of 4); ENet and ERFNet launch none.
GOLDEN_LAUNCHES = {
    "fastscnn": {"dsconv": 4, "resize_argmax": 1, "resize_ce_fwd": 48,
                 "resize_ce_bwd": 48, **bwd_launches("fastscnn", 48)},
    **{name: {"subpixel_argmax": 1} for name in ("enet", "enet_ohem",
                                                   "erfnet")}}


def golden_phase(torch, K):
    """The golden runs on the card (see GOLDEN_LAUNCHES): the fixture
    written as PNG files and read back through ``ManifestDataset`` (equal
    to the arrays written), then every config at each seed in f32 and in
    bf16: one ``tools/golden_run.py`` process a config and dtype, all
    started together (the runs are host-bound: in turns they took ~290 s
    of the script's 1200), each running its seeds in turn and reporting
    its runs and its launches."""
    import numpy as np

    from esn_tpu_torch.data import CAMVID
    from esn_tpu_torch.data.datasets import ManifestDataset, read_manifest
    from esn_tpu_torch.tools import golden_run as G

    bounds = G.load_spread()["bounds"]
    runs = {"float32": {}, "bfloat16": {}}
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = G.build_fixture(f"{tmp}/ds")
        sets = {split: ManifestDataset(read_manifest(
            f"{root}/camvid/camvid_{split}_list.txt"), CAMVID)
            for split in ("train", "val")}
        for split, i, img, lab in G.fixture_items():
            item = sets[split][i]
            check(np.array_equal(item["image"], img)
                  and np.array_equal(item["label"], lab),
                  f"golden fixture: {split} {i} decodes otherwise")
        procs = {}
        for dtype in runs:
            for name in G.CONFIGS:
                out = f"{tmp}/{dtype}_{name}.json"
                procs[dtype, name] = (out, subprocess.Popen(
                    [sys.executable, "-m", "esn_tpu_torch.tools.golden_run",
                     "--device", "cuda", "--configs", name, "--dtype", dtype,
                     "--data_root", root, "--savedir",
                     f"{tmp}/ckpt/{dtype}_{name}", "--threads", "1",
                     "--out", out],
                    cwd=REPO, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True))
        for (dtype, name), (out, proc) in procs.items():
            log = proc.communicate()[0]
            # 1: a config broke its bound, which is held below
            check(proc.returncode in (0, 1) and Path(out).exists(),
                  f"golden {name} {dtype}: rc {proc.returncode}\n"
                  f"{log[-3000:]}")
            got = json.loads(Path(out).read_text())
            rs = got["results"][name]
            launches[f"{name}_{dtype}"] = got["launches"]
            for r in rs:
                r["tail_loss"] = G.tail_loss(r["losses"])
                r["bound_failures"] = G.check(r, bounds[name])
                print(f"golden {name} {dtype} seed {r['seed']}: mIoU "
                      f"{r['miou']:.4f}, last-quarter loss "
                      f"{r['tail_loss']:.4f}, {r['seconds']:.1f} s"
                      + (f"; out of its bound: {r['bound_failures']}"
                         if r["bound_failures"] else ""))
            runs[dtype][name] = rs
            print(f"golden {name} {dtype}: launches "
                  f"{json.dumps(launches[f'{name}_{dtype}'])}")
    gaps = {}
    for name in G.CONFIGS:
        low, f32 = (G.medians(runs[d][name]) for d in ("bfloat16", "float32"))
        gaps[name] = {"miou": low["miou"] - f32["miou"],
                      "tail_loss": low["tail_loss"] - f32["tail_loss"],
                      "limit": G.BF16_GAP[name],
                      "failures": G.check_gap(runs["bfloat16"][name],
                                              runs["float32"][name],
                                              G.BF16_GAP[name])}
    print("golden bf16 - f32 medians", json.dumps(gaps))
    n = len(G.SEEDS)
    for dtype, by_name in runs.items():
        for name, rs in by_name.items():
            got = launches[f"{name}_{dtype}"]
            want = {k: n * v for k, v in GOLDEN_LAUNCHES.get(
                name, {}).items()}
            check(launches_equal(got, want), f"golden {name} {dtype}: "
                  f"launches {got}, want {want}")
            bad = G.check_runs(rs, bounds[name])
            check(not bad, f"golden {name} {dtype}: {bad}")
    for name, gap in gaps.items():
        check(not gap["failures"], f"golden {name}: bf16 against f32: "
              f"{gap['failures']}")
    return {"runs": runs, "bf16_minus_f32": gaps, "launches": launches}


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--cli-launches":
        return cli_rank_main(sys.argv[2], sys.argv[3:])
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (REPO / "esn_tpu_torch").is_dir():
        print(f"chip_smoke: no esn_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import torch.nn.functional as F

    from esn_tpu_torch.models import build_model
    from esn_tpu_torch.nn import BatchNorm
    from esn_tpu_torch.ops import kernels as K
    from esn_tpu_torch.ops.kernels import _build
    from esn_tpu_torch.train.step import make_predict_step

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)

    info = _build.build()
    _build.library()
    print(f"build: {info.path.relative_to(REPO)} in {info.seconds:.1f} s "
          f"({'compiled' if info.built else 'cached'})")
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "ptxas.log").write_text(info.log)

    seconds = {}

    def phase(name, fn, *args, **kw):
        """``fn(*args, **kw)``, its seconds printed and kept; the cache
        emptied after it."""
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        print(f"phase {name}: {seconds[name]:.1f} s")
        torch.cuda.empty_cache()
        return out

    dsconv_rows, argmax_rows, subpixel_rows, ties = phase(
        "kernels", kernel_phase, torch, F, K)
    ce_rows = phase("resize_ce", resize_ce_phase, torch, K)
    cg_rows = phase("cgblock", cgblock_phase, torch, K)
    bwd = phase("resize_pool_bwd", bwd_phase, torch, F, K)
    dw_rows = phase("depthwise_bf16", depthwise_bf16_phase, torch)
    none = {"dsconv": 0, "resize_argmax": 0, "resize_ce_fwd": 0,
            "resize_ce_bwd": 0, "cgblock": 0}
    result = phase("fastscnn_predict", predict_phase, torch, F, K,
                   build_model, BatchNorm, make_predict_step, "fastscnn",
                   {**none, "dsconv": 4, "resize_argmax": 1})
    trained = phase("fastscnn_train", train_phase, torch, F, K, BatchNorm)
    cgnet = phase("cgnet_predict", predict_phase, torch, F, K, build_model,
                  BatchNorm, make_predict_step, "cgnet",
                  {**none, "resize_argmax": 1, "cgblock": 22})

    interleaved = {
        arch: phase(f"{arch}_predict_after_train", interleaved_phase, torch,
                    F, K, build_model, make_predict_step, arch, launches)
        for arch, launches in (("fastscnn", result["launches"]),
                               ("cgnet", cgnet["launches"]))}

    pool_rows = phase("pool_unpool", pool_phase, torch)
    enet_model, enet_images, enet_predict = phase(
        "enet_predict", enet_predict_phase, torch, F, K, build_model,
        BatchNorm, make_predict_step)
    enet_eval = phase("enet_eval", enet_eval_phase, torch, K, build_model,
                      enet_model, enet_images)
    del enet_model, enet_images
    enet_train = phase("enet_train", enet_train_phase, torch, F, K,
                       BatchNorm)
    fastscnn_config5 = phase("fastscnn_config5", config5_ab_phase, torch, F,
                             K, BatchNorm, "fastscnn")

    # ContextNet-19, config 5: K2 x5 and K1 a predict, K3 a train step
    contextnet = {"predict": phase(
        "contextnet_predict", predict_phase, torch, F, K, build_model,
        BatchNorm, make_predict_step, "contextnet",
        {**none, "dsconv": 5, "resize_argmax": 1})}
    contextnet["train"] = phase("contextnet_train", train_phase, torch, F, K,
                                BatchNorm, "contextnet")
    contextnet["config5"] = phase("contextnet_config5", config5_ab_phase,
                                  torch, F, K, BatchNorm, "contextnet")
    interleaved["contextnet"] = phase(
        "contextnet_predict_after_train", interleaved_phase, torch, F, K,
        build_model, make_predict_step, "contextnet",
        contextnet["predict"]["launches"])
    # EDANet-19, config 3 (512x1024): K1 a predict, K3 a train step
    edanet = {"predict": phase(
        "edanet_predict", predict_phase, torch, F, K, build_model, BatchNorm,
        make_predict_step, "edanet", {**none, "resize_argmax": 1},
        hw=CONFIG3_HW)}
    edanet["train"] = phase("edanet_train", train_phase, torch, F, K,
                            BatchNorm, "edanet", hw=CONFIG3_HW)
    # LEDNet-19, config 3 (512x1024): K1 a predict, K3 a train step; its
    # f32 predict also against the CPU
    lednet = {"predict": phase(
        "lednet_predict", predict_phase, torch, F, K, build_model, BatchNorm,
        make_predict_step, "lednet", {**none, "resize_argmax": 1},
        hw=CONFIG3_HW, vs_cpu=True)}
    lednet["train"] = phase("lednet_train", train_phase, torch, F, K,
                            BatchNorm, "lednet", hw=CONFIG3_HW)
    # ESPNetv2-19 and DABNet-19, config 4 (768x1536): K1 a predict, K3 a
    # train step; their f32 predict also against the CPU
    config4 = {}
    for arch in ("espnetv2", "dabnet"):
        config4[arch] = {"predict": phase(
            f"{arch}_predict", predict_phase, torch, F, K, build_model,
            BatchNorm, make_predict_step, arch, {**none, "resize_argmax": 1},
            hw=CONFIG4_HW, vs_cpu=True)}
        config4[arch]["train"] = phase(f"{arch}_train", train_phase, torch, F,
                                       K, BatchNorm, arch, hw=CONFIG4_HW)
    # CGNet-19 at config 4: five train steps (K3 1 + 1 a step, no K4: the
    # composed blocks), then a predict built before a train step and
    # called after it at batch 8 (K4 x22 at config 4's two shapes, K1)
    config4["cgnet"] = {"train": phase("cgnet_train", train_phase, torch, F,
                                       K, BatchNorm, "cgnet", hw=CONFIG4_HW)}
    interleaved["cgnet_config4"] = phase(
        "cgnet_config4_predict_after_train", interleaved_phase, torch, F, K,
        build_model, make_predict_step, "cgnet", cgnet["launches"],
        batch_size=BATCH, hw=CONFIG4_HW)
    # ESPNet-C-19 (config 3's size): K1 a predict, K3 a train step; its
    # checkpoint is the encoder that load_encoder grafts into ESPNet-19,
    # which launches no kernel and is held against the CPU
    espnet_c = {"predict": phase(
        "espnet_c_predict", predict_phase, torch, F, K, build_model,
        BatchNorm, make_predict_step, "espnet_c",
        {**none, "resize_argmax": 1}, hw=CONFIG3_HW)}
    espnet_c["train"] = phase("espnet_c_train", train_phase, torch, F, K,
                              BatchNorm, "espnet_c", hw=CONFIG3_HW)
    donor_dir = tempfile.TemporaryDirectory()
    donor = phase("espnet_c_checkpoint", espnet_c_checkpoint, torch, F,
                  build_model, BatchNorm, donor_dir.name)
    zoo = {"espnet": phase("espnet", zoo_conv_phase, torch, F, K, BatchNorm,
                           build_model, make_predict_step, "espnet",
                           prepare=functools.partial(graft_encoder, torch,
                                                     donor))}
    donor_dir.cleanup()
    # ERFNet, ESNet, FPENet, FSSNet, SQNet and UNet (config 3), SegNet and
    # LinkNet (config 2): K7 a predict (ERFNet, ESNet, FSSNet, SQNet,
    # LinkNet), K1 at r = 2 (FPENet), none (SegNet, UNet)
    for arch in ("erfnet", "segnet", "linknet", "esnet", "fpenet", "fssnet",
                 "sqnet", "unet"):
        zoo[arch] = phase(arch, zoo_conv_phase, torch, F, K, BatchNorm,
                          build_model, make_predict_step, arch)
    # the rest of the training surface, Fast-SCNN-19 at config 5: radam and
    # ranger (K3 1 + 1 a step), focal and the Lovász losses (no kernel),
    # remat (K3 1 + 1 a weighted-CE step)
    optims = phase("radam_ranger", optim_phase, torch, F, K)
    losses = phase("focal_lovasz", loss_phase, torch, F, K, BatchNorm)
    remat = phase("remat", remat_phase, torch, F, K)
    cli = phase("cli", cli_phase, torch, K)
    # data parallelism: two ranks on the one card against one process, a
    # one-rank NCCL group, torchrun
    dp = phase("data_parallel", data_parallel_phase, torch, F, K, BatchNorm,
               build_model)
    # spatial sharding: image height over two ranks on the one card
    # against one process, Fast-SCNN at config 5 and ENet at config 3's
    # size; torchrun cli.train --spatial 2
    sp = phase("spatial", spatial_phase, torch, F, K)
    # uneven shards: Fast-SCNN-19 and LEDNet-19 at CamVid's 720x960 over
    # two ranks on the one card; torchrun cli.train --spatial 2 there,
    # whose validation launches K1 and K2 on each rank
    spu = phase("spatial_uneven", spatial_uneven_phase, torch, F, K)
    # the port's PNG decoder at Cityscapes' size, then the four golden
    # trainings through it, f32 and bf16
    decode = phase("decode", decode_phase, torch)
    golden = phase("golden", golden_phase, torch, K)

    launches = {
        "fastscnn": {"predict": result["launches"],
                     "train_5_steps": trained["launches"],
                     "config5_5_steps": fastscnn_config5["launches"],
                     "predict_after_train":
                         interleaved["fastscnn"]["launches"],
                     **{f"{name}_{OPTIM_STEPS}_steps": optims[name]["launches"]
                        for name in ("radam", "ranger")},
                     **{f"{name}_{TRAIN_STEPS}_steps":
                        losses[name]["train"]["launches"]
                        for name in LOSS_NAMES},
                     **{f"remat_{loss}_step": remat[loss]["launches"]
                        for loss in ("ce", "ce_ohem")}},
        "cgnet": {"predict": cgnet["launches"],
                  "predict_after_train": interleaved["cgnet"]["launches"],
                  "config4_train_5_steps": config4["cgnet"]["train"]
                  ["launches"],
                  "config4_predict_after_train":
                      interleaved["cgnet_config4"]["launches"]},
        "enet": {"predict": enet_predict["launches"],
                 "config5_5_steps": enet_train["launches"]},
        "contextnet": {"predict": contextnet["predict"]["launches"],
                       "train_5_steps": contextnet["train"]["launches"],
                       "config5_5_steps": contextnet["config5"]["launches"],
                       "predict_after_train":
                           interleaved["contextnet"]["launches"]},
        **{arch: {"predict": r["predict"]["launches"],
                  "train_5_steps": r["train"]["launches"]}
           for arch, r in (("edanet", edanet), ("lednet", lednet),
                           ("espnetv2", config4["espnetv2"]),
                           ("dabnet", config4["dabnet"]),
                           ("espnet_c", espnet_c), *zoo.items())},
        "cli_fastscnn": {"train": cli["launches"],
                         "test": cli["test"]["launches"],
                         "predict": cli["predict"]["launches"],
                         "train_ranger_lovasz_remat":
                             cli["ranger_lovasz_remat"]["launches"]},
        "data_parallel_fastscnn": dp["launches"],
        "spatial_cli_fastscnn": sp["launches"],
        "spatial_uneven_cli_fastscnn": spu["launches"],
        "golden": golden["launches"]}
    print("launches by model", json.dumps(launches))
    # each kernel's launches summed over every path above
    total = {}
    for paths in launches.values():
        for counts in paths.values():
            for name, n in counts.items():
                total[name] = total.get(name, 0) + n

    ds_main = [r for r in dsconv_rows
               if r["dtype"] == "bfloat16" and r.get("model") == "fastscnn"]
    tail = next(r for r in argmax_rows
                if r["dtype"] == "bfloat16" and r["layer"] == "predict tail")
    # K7 at ENet's head, config 5, bf16: the path's largest launch
    k7 = next(r for r in subpixel_rows
              if r["dtype"] == "bfloat16" and r["models"] == "enet")
    cg_main = [r for r in cg_rows if r["dtype"] == "bfloat16"
               and r["layer"] in {m[0] for m in CGBLOCK_MAIN}]
    # K5's and K6's launches of one weighted-CE step at config 5, bf16
    # (K6 pools in f32), each at its own shape
    bwd_main = {kind: [r for r in bwd["rows"] if r["main"]
                       and r["kind"] == kind] for kind in ("resize", "pool")}

    def by(rows):
        return max(rows, key=lambda r: r["bound_ms"])["bound_by"]

    def step_sum(rows, key):
        return sum(r[key] for r in rows)

    # library_ms: no single PyTorch call computes any of the four (K1 is
    # interpolate then argmax, K3 interpolate then cross_entropy, K2 and
    # K4 chains of convolutions); for K7 the two-call route
    # (conv_transpose2d then argmax), since no single call computes it
    kernels = [
        {"name": "fused_dsconv", "route": "cuda",
         "source": "esn_tpu_torch/csrc/dsconv.cu",
         "replaces": "esn_tpu/ops/pallas/dsconv.py:198",
         "launches": total["dsconv"],
         "max_abs_err": max(r["max_abs_err"] for r in ds_main),
         "ms": sum(r["ms"] for r in ds_main),
         "plain_ms": sum(r["plain_ms"] for r in ds_main),
         "bound_ms": sum(r["bound_ms"] for r in ds_main),
         "bound_by": by(ds_main), "library_ms": None},
        {"name": "resize_argmax", "route": "cuda",
         "source": "esn_tpu_torch/csrc/resize_argmax.cu",
         "replaces": "esn_tpu/ops/pallas/resize_argmax.py:123",
         "launches": total["resize_argmax"],
         "max_abs_err": tail["max_abs_err"],
         "ms": tail["ms"], "plain_ms": tail["plain_ms"],
         "bound_ms": tail["bound_ms"], "bound_by": tail["bound_by"],
         "library_ms": None},
        {"name": "resize_ce_sums", "route": "cuda",
         "source": "esn_tpu_torch/csrc/resize_ce.cu",
         "replaces": "esn_tpu/ops/pallas/resize_ce.py:199,237",
         "launches": total["resize_ce_fwd"] + total["resize_ce_bwd"],
         "max_abs_err": ce_rows[0]["dz_max_abs_err"],
         "ms": ce_rows[0]["ms"], "plain_ms": ce_rows[0]["plain_ms"],
         "bound_ms": ce_rows[0]["bound_ms"],
         "bound_by": ce_rows[0]["bound_by"], "library_ms": None},
        {"name": "fused_cgblock_pre", "route": "cuda",
         "source": "esn_tpu_torch/csrc/cgblock.cu",
         "replaces": "esn_tpu/ops/pallas/cgblock.py:174",
         "launches": total["cgblock"],
         "max_abs_err": max(r["max_abs_err"] for r in cg_main),
         "ms": sum(r["launches_per_predict"] * r["ms"] for r in cg_main),
         "plain_ms": sum(r["launches_per_predict"] * r["plain_ms"]
                         for r in cg_main),
         "bound_ms": sum(r["launches_per_predict"] * r["bound_ms"]
                         for r in cg_main),
         "bound_by": by(cg_main), "library_ms": None},
        *({"name": name, "route": "cuda",
           "source": f"esn_tpu_torch/csrc/{name}.cu", "replaces": replaces,
           "launches": total[name],
           "max_abs_err": max(r["max_abs_err"] for r in bwd_main[kind]),
           "ms": step_sum(bwd_main[kind], "ms"),
           "plain_ms": step_sum(bwd_main[kind], "plain_ms"),
           "bound_ms": step_sum(bwd_main[kind], "bound_ms"),
           "bound_by": by(bwd_main[kind]),
           "library_ms": step_sum(bwd_main[kind], "library_ms")}
          for name, kind, replaces in (
              ("resize_bilinear_bwd", "resize", "esn_tpu/ops/resize.py:16"),
              ("adaptive_pool_bwd", "pool", "esn_tpu/ops/pooling.py:122"))),
        {"name": "subpixel_argmax", "route": "cuda",
         "source": "esn_tpu_torch/csrc/subpixel_argmax.cu",
         "replaces": "esn_tpu/ops/classify.py:130",
         "launches": total["subpixel_argmax"],
         "max_abs_err": k7["max_abs_err"], "ms": k7["ms"],
         "plain_ms": k7["plain_ms"], "bound_ms": k7["bound_ms"],
         "bound_by": k7["bound_by"], "library_ms": k7["library_ms"]},
    ]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"nvidia_smi": smi, "torch": torch.__version__,
         "cuda": torch.version.cuda, "build_seconds": info.seconds,
         "dsconv": dsconv_rows, "resize_argmax": argmax_rows,
         "subpixel_argmax": subpixel_rows, "subpixel_argmax_ties": ties,
         "resize_ce_sums": ce_rows, "fused_cgblock_pre": cg_rows,
         "resize_pool_bwd": bwd,
         "depthwise_bf16": dw_rows,
         "predict": result, "train": trained, "cgnet_predict": cgnet,
         "predict_after_train": interleaved, "pool_unpool": pool_rows,
         "enet_predict": enet_predict, "enet_eval": enet_eval,
         "enet_train": enet_train, "fastscnn_config5_train": fastscnn_config5,
         "contextnet": contextnet, "edanet": edanet, "lednet": lednet,
         **config4,
         "espnet_c": espnet_c, **zoo, "radam_ranger": optims,
         "focal_lovasz": losses, "remat": remat, "cli": cli,
         "data_parallel": dp, "spatial": sp, "spatial_uneven": spu,
         "decode": decode,
         "golden": golden,
         "launches_total": total,
         "launches": launches, "phase_seconds": seconds,
         "kernels": kernels, "device": device}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
