"""Trainer (counterpart of ``esn_tpu/train/trainer.py``).

Config -> data, model, class weights, loss, LR schedule, optimizer, train
and eval steps -> an epoch loop with augmentation on the device, batches
prefetched to it one step ahead, periodic validation, a checkpoint every
epoch, ``log.txt`` (with per-class IoU lines at val epochs), the curve
PNGs where matplotlib exists, and ``events.jsonl``.

Randomness is explicit and folded from ``cfg.seed``: the model's init
from ``torch.Generator().manual_seed(seed)``; an epoch's step ``i`` draws
its augmentation from ``fold_in(seed, epoch, i)``; dropout masks come
from the train step's generator, folded with the global step count. A
resumed run therefore draws what the unbroken run drew.

``encoder_checkpoint`` grafts a trained ESPNet-C's checkpoint (either
package's) into the model's ``enc`` before training (ESPNet's two-stage
recipe, ``checkpoint.load_encoder``).

``optim`` takes every optimizer of the reference (``sgd``, ``adam``,
``adamw``, ``radam``, ``ranger``), ``loss`` every loss (``ce``,
``label_smoothing``, ``ohem``, ``focal``, ``lovasz``, ``lovasz_hist``),
and ``remat`` recomputes the forward during the backward.

Data parallelism, the reference's ``data`` mesh: launched at ``W`` ranks
(``WORLD_SIZE > 1`` in the environment, as ``torchrun`` sets it, or a
group already up), the Trainer joins the group (``parallel.mesh``), and
each rank loads and augments its rows of every global batch (the
augmentation drawn at the global batch's shape), takes the global-batch
step (``train.step``), validates its rows of each eval batch and sums the
confusion matrices. A batch size that ``W x grad_accum`` does not divide
raises. Rank 0 writes the log, the events and the checkpoints, and every
rank reads a resume; ``run_dir`` says ``gpu{W}``.

Spatial sharding, the reference's ``(data, model)`` mesh
(``spatial = S > 1``, ``parallel.spatial``): the world is laid out as
``n_data = W / S`` data ranks by ``S`` model ranks. Each rank loads and
augments its data index's rows of every global batch at full height
(augmentation runs outside the sharded context, so its resizes exchange
nothing), keeps its model index's ``H / S`` image rows, and takes the
global-batch step with every op exchanging the rows it reads across the
model group. As in the reference the step takes the model's full
forward and the plain loss, not the fused resize-CE route. Evaluation
runs as under data parallelism: whole images split over all ``W`` ranks.
The checks are the reference's: the envelope
(``spatial.check_spatial_config``), then ``W`` divisible by ``S``, then
the batch divisible by ``n_data x grad_accum``; where the reference
would use fewer devices, the port raises, since a launched world cannot
shrink. The reference's retry of a step that failed to compile on the
TPU has no counterpart: the step is called directly.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from functools import partial
from typing import Optional, Tuple

import numpy as np
import torch

from ..data import builders as data_builders
from ..data.datasets import get_spec
from ..data.loader import device_prefetch
from ..data.palettes import CAMVID_CLASSES, CITYSCAPES_CLASSES
from ..models import build_model
from ..parallel import mesh, spatial
from ..utils import profiling
from ..utils.params import count_params
from ..utils.seed import setup_seed
from . import checkpoint as ckpt
from .evaluation import run_eval
from .losses import build_loss, fused_resize_ce_spec
from .metrics import iou_from_confusion
from .optimizers import build_optimizer
from .schedules import build_schedule
from .state import TrainState
from .step import fold_in, make_eval_step, make_train_step

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class TrainConfig:
    model: str = "ENet"
    dataset: str = "camvid"
    input_size: Tuple[int, int] = (360, 480)
    max_epochs: int = 300
    batch_size: int = 8
    lr: float = 4.5e-4
    optim: str = "adam"
    lr_schedule: str = "poly"
    poly_exp: float = 0.9
    warmup_iters: int = 500
    warmup_factor: float = 1.0 / 3.0
    weight_decay: float = 1e-4
    loss: str = "ce"  # ce | label_smoothing | ohem | focal | lovasz | lovasz_hist
    random_scale: bool = True
    random_mirror: bool = True
    aug_mode: str = "batch"     # batch | reference (per-image scale)
    num_workers: int = 4
    train_type: str = "train"   # train | trainval
    resume: str = ""
    savedir: str = "./checkpoint"
    log_file: str = "log.txt"
    seed: int = 1
    val_epochs: int = 50        # validate every N epochs
    compute_dtype: Optional[str] = None  # None: bf16 on cuda, f32 on cpu
    grad_accum: int = 1
    data_root: str = data_builders.DEFAULT_ROOT
    synthetic_len: int = 64     # only used when real data is absent
    use_class_weights: bool = True
    val_size: Optional[Tuple[int, int]] = None  # None = source resolution
    synthetic_hw: Optional[Tuple[int, int]] = None  # shrink synthetic source
    profile_dir: str = ""       # trace the first epoch's steps
    remat: bool = False
    spatial: int = 1
    encoder_checkpoint: str = ""
    device: str = "cuda"        # "cpu" runs the plain versions of the kernels

    @property
    def run_dir(self) -> str:
        # the reference's layout {ds}/{model}bs{B}gpu{N}_{type}, N = the
        # devices used: the data-parallel world's ranks
        return os.path.join(self.savedir, self.dataset,
                            f"{self.model}bs{self.batch_size}"
                            f"gpu{mesh.world().size}_{self.train_type}")


def check_config(cfg: TrainConfig) -> None:
    """The checks that need no world: the augmentation mode, and with
    ``spatial > 1`` the reference's envelope."""
    if cfg.aug_mode not in ("batch", "reference"):
        raise ValueError(f"aug_mode {cfg.aug_mode!r}: batch or reference")
    if cfg.spatial < 1:
        raise ValueError(f"spatial={cfg.spatial} must be >= 1")
    if cfg.spatial > 1:
        spatial.check_spatial_config(cfg.input_size, cfg.spatial)


def resolve_device(name: str) -> torch.device:
    """``name`` as a device; a CUDA device that is not there raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; run on the CPU with device='cpu' "
                           "(the CLIs' --cuda False)")
    return device


def resolve_compute_dtype(name: Optional[str], device) -> torch.dtype:
    """``name`` ("float32" | "bfloat16") as a dtype; None is bfloat16 on
    the CUDA device and float32 on the CPU."""
    if name is None:
        return torch.bfloat16 if torch.device(device).type == "cuda" \
            else torch.float32
    return COMPUTE_DTYPES[name]


class Trainer:
    def __init__(self, cfg: TrainConfig):
        check_config(cfg)
        self.cfg = cfg
        self.spec = get_spec(cfg.dataset)
        mesh.init_data_parallel(cfg.device)
        # the (data, model) layout: W divisible by S (a launched world
        # cannot shrink), then the batch by n_data (rank_rows)
        mesh.set_spatial(cfg.spatial)
        self.world = mesh.world(cfg.device)
        self.device = resolve_device(str(self.world.device))
        # this rank's rows of each global batch (all of them in one
        # process): its data index's rows
        self._rows = mesh.rank_rows(cfg.batch_size, max(cfg.grad_accum, 1),
                                    self.world) \
            if self.world.n_data > 1 else None
        setup_seed(cfg.seed)

        (self.datas, self.train_loader, self.val_loader, self.augment,
         self.eval_transform) = data_builders.build_dataset_train(
            cfg.dataset, cfg.input_size, cfg.batch_size,
            train_type=cfg.train_type, random_scale=cfg.random_scale,
            random_mirror=cfg.random_mirror, aug_mode=cfg.aug_mode,
            num_workers=cfg.num_workers, root=cfg.data_root,
            synthetic_len=cfg.synthetic_len, val_size=cfg.val_size,
            synthetic_hw=cfg.synthetic_hw)
        self.train_loader.rows = self._rows

        self.model = build_model(
            cfg.model, self.spec.num_classes, device=self.device,
            generator=torch.Generator().manual_seed(cfg.seed))
        if cfg.encoder_checkpoint:
            ckpt.load_encoder(cfg.encoder_checkpoint, self.model)
        spatial.check_model(self.model, cfg.input_size, cfg.spatial)
        self.n_params = count_params(self.model)

        weights = torch.from_numpy(np.asarray(
            self.datas["classWeights"], np.float32)).to(self.device) \
            if cfg.use_class_weights else None
        loss_kwargs = dict(num_classes=self.spec.num_classes,
                           ignore_index=self.spec.ignore_label)
        # a CE-family loss on a resize-tail model owns the x8 upsample:
        # the fused resize-CE kernel, on logits_lowres; not under spatial
        # sharding, as in the reference (the full forward, the plain loss)
        fused, fwd_method = (None, None) if cfg.spatial > 1 else \
            fused_resize_ce_spec(self.model, cfg.loss)
        self.loss_fn = partial(fused or build_loss(cfg.loss),
                               class_weights=weights, **loss_kwargs)
        total_steps = cfg.max_epochs * max(len(self.train_loader), 1)
        self.schedule = build_schedule(
            cfg.lr_schedule, cfg.lr, total_steps, power=cfg.poly_exp,
            warmup_steps=cfg.warmup_iters, warmup_factor=cfg.warmup_factor)
        self.optimizer = build_optimizer(cfg.optim, self.model.parameters(),
                                         weight_decay=cfg.weight_decay)
        self.compute_dtype = compute_dtype = resolve_compute_dtype(
            cfg.compute_dtype, self.device)
        self.train_step = make_train_step(
            self.model, self.loss_fn, self.optimizer, schedule=self.schedule,
            compute_dtype=compute_dtype, grad_accum=cfg.grad_accum,
            fwd_method=fwd_method, remat=cfg.remat,
            generator=torch.Generator().manual_seed(cfg.seed))
        self.eval_step = make_eval_step(
            self.model, self.spec.num_classes,
            ignore_index=self.spec.ignore_label, compute_dtype=compute_dtype)

        self.start_epoch = 0
        if cfg.resume:
            state, meta = ckpt.load_checkpoint(cfg.resume, self.state)
            self.train_step.count = state.step
            self.start_epoch = int(meta.get("epoch", 0))
        # every rank starts from rank 0's parameters, statistics and
        # optimizer state
        mesh.broadcast_state(self.model, self.optimizer)
        self._writer = self.world.rank == 0

        os.makedirs(cfg.run_dir, exist_ok=True)
        self._log_path = os.path.join(cfg.run_dir, cfg.log_file)
        self._jsonl_path = os.path.join(cfg.run_dir, "events.jsonl")
        self._history = []  # (epoch, loss, lr, miou or None)
        self.step_timer = profiling.StepTimer()
        self._log_header()

    @property
    def state(self) -> TrainState:
        """The model, the optimizer and the step count, for checkpoints."""
        return TrainState(self.model, self.optimizer, self.train_step.count)

    # ------------------------------------------------------------------ log
    def _log_header(self):
        name = torch.cuda.get_device_name(self.device) \
            if self.device.type == "cuda" else "cpu"
        devices = mesh.rank_devices()   # a collective: every rank calls it
        if not self._writer:
            return
        with open(self._log_path, "a" if self.start_epoch else "w") as f:
            f.write(f"Model: {self.cfg.model}  dataset: {self.cfg.dataset}  "
                    f"params: {self.n_params}\n")
            f.write(f"device: {self.device} ({name})  "
                    f"compute_dtype: {self.compute_dtype}\n")
            f.write(f"world: {self.world.size} rank(s)  backend: "
                    f"{self.world.backend or 'none'}  devices: "
                    f"{' '.join(devices)}"
                    + (f"  mesh: {self.world.n_data} data x "
                       f"{self.world.spatial} model"
                       if self.world.spatial > 1 else "") + "\n")
            f.write("epoch\tlr\tloss_train\tmIoU_val\ttime_s\n")

    def _class_names(self):
        names = CITYSCAPES_CLASSES if self.cfg.dataset == "cityscapes" \
            else CAMVID_CLASSES
        return [names[i] if i < len(names) else f"class{i}"
                for i in range(self.spec.num_classes)]

    def _log_epoch(self, epoch, loss, lr, miou, seconds, iou=None, **walls):
        if not self._writer:
            self.step_timer.reset()
            return
        miou_s = f"{miou:.4f}" if miou is not None else "-"
        with open(self._log_path, "a") as f:
            f.write(f"{epoch}\t{lr:.6f}\t{loss:.4f}\t{miou_s}\t"
                    f"{seconds:.1f}\n")
            if iou is not None:
                for name, v in zip(self._class_names(), iou):
                    f.write(f"  {name:>15s} IoU: {float(v):.4f}\n")
        event = {"epoch": epoch, "loss": loss, "lr": lr, "miou": miou,
                 "time_s": seconds, **walls}
        if iou is not None:
            event["per_class_iou"] = [round(float(v), 6) for v in iou]
        # host times, not device: augment + step dispatch, the wait for
        # each batch, the epoch's closing synchronize
        for key, part in (("host_step", "step"), ("wait_step", "wait"),
                          ("sync", "sync")):
            summary = self.step_timer.summary(part)
            if summary:
                event[key] = summary
        self.step_timer.reset()
        with open(self._jsonl_path, "a") as f:
            f.write(json.dumps(event) + "\n")

    # ---------------------------------------------------------------- train
    def train_epoch(self, epoch: int) -> Tuple[float, float]:
        """One epoch; returns (mean loss, last lr). The losses stay on the
        device until the epoch's end. The step timer takes each step's
        host time, its wait for the batch and the closing synchronize."""
        cfg = self.cfg
        self.train_loader.set_epoch(epoch)
        losses, lr = [], 0.0
        do_trace = bool(cfg.profile_dir) and epoch == self.start_epoch
        batches = self.step_timer.iterate(device_prefetch(
            iter(self.train_loader), self.device, size=2), "wait")
        with profiling.trace(cfg.profile_dir if do_trace else None):
            for i, batch in enumerate(batches):
                with self.step_timer.step():
                    images, labels = batch["image"], batch["label"]
                    gen = torch.Generator().manual_seed(
                        fold_in(cfg.seed, epoch, i))
                    with profiling.annotate("augment"):
                        # drawn for the global batch; this rank's rows
                        draws = self.augment.draw(
                            gen, images.shape[0] * self.world.n_data)
                        if self._rows is not None:
                            draws = draws.take(self._rows)
                        x, y = self.augment(images, labels, draws)
                        if self.world.spatial > 1:
                            # this rank's image rows
                            w = self.world
                            x = spatial.shard_rows(x, w.spatial,
                                                   w.model_index, 2)
                            y = spatial.shard_rows(y, w.spatial,
                                                   w.model_index, 1)
                    with profiling.annotate("train_step"):
                        metrics = self.train_step({"image": x, "label": y})
                    losses.append(metrics["loss"])
                    lr = metrics.get("lr", cfg.lr)
        with self.step_timer.step("sync"):
            mean_loss = float(torch.stack(losses).mean()) if losses else 0.0
        return mean_loss, float(lr)

    def validate(self) -> Tuple[np.ndarray, float]:
        cm = run_eval(self.eval_step, self.val_loader, self.eval_transform,
                      self.spec.num_classes)
        iou, miou = iou_from_confusion(torch.from_numpy(cm))
        return iou.numpy(), float(miou)

    def fit(self, epochs: Optional[int] = None) -> float:
        cfg = self.cfg
        end_epoch = min(self.start_epoch + epochs, cfg.max_epochs) \
            if epochs is not None else cfg.max_epochs
        last_miou = None
        for epoch in range(self.start_epoch, end_epoch):
            t0 = time.perf_counter()
            loss, lr = self.train_epoch(epoch)
            train_s = time.perf_counter() - t0
            miou = iou_vec = val_s = None
            if ((epoch + 1) % cfg.val_epochs == 0
                    or epoch + 1 == cfg.max_epochs):
                t1 = time.perf_counter()
                iou_vec, miou = self.validate()
                val_s = time.perf_counter() - t1
                last_miou = miou
            dt = time.perf_counter() - t0
            self._log_epoch(epoch + 1, loss, lr, miou, dt, iou=iou_vec,
                            train_s=train_s, val_s=val_s)
            if self._writer:
                ckpt.save_checkpoint(
                    cfg.run_dir, epoch + 1, self.state,
                    {"mIoU": miou if miou is not None else -1.0,
                     "loss": loss})
            mesh.barrier()      # the checkpoint is on disk for every rank
            self._history.append((epoch + 1, loss, lr, miou))
            if not self._writer:
                continue
            print(f"epoch {epoch + 1}/{cfg.max_epochs} loss {loss:.4f} "
                  f"lr {lr:.6f}"
                  + (f" mIoU {miou:.4f}" if miou is not None else "")
                  + f" ({dt:.1f}s)")
        self._plot_curves()
        if last_miou is None:
            _, last_miou = self.validate()
        return last_miou

    def _plot_curves(self):
        """loss/IoU PNGs where matplotlib exists, as the reference."""
        if not self._history or not self._writer:
            return
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        epochs = [h[0] for h in self._history]
        fig, ax = plt.subplots()
        ax.plot(epochs, [h[1] for h in self._history])
        ax.set_xlabel("epoch"), ax.set_ylabel("train loss")
        fig.savefig(os.path.join(self.cfg.run_dir, "loss_vs_epochs.png"))
        plt.close(fig)
        pts = [(e, m) for (e, _, _, m) in self._history if m is not None]
        if pts:
            fig, ax = plt.subplots()
            ax.plot([p[0] for p in pts], [p[1] for p in pts], marker="o")
            ax.set_xlabel("epoch"), ax.set_ylabel("val mIoU")
            fig.savefig(os.path.join(self.cfg.run_dir, "iou_vs_epochs.png"))
            plt.close(fig)
