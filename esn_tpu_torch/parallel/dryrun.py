"""Dry run of data parallelism on the CPU (the counterpart of the
reference's ``__graft_entry__.dryrun_multichip``):

    python -m esn_tpu_torch.parallel.dryrun [N]

``N`` gloo ranks (default 2) on the CPU, each in a process of its own,
take one global-batch step (2 images a rank, 64x64) of Fast-SCNN-19 with
class-weighted CE plus a gradient-carrying OHEM term, adam and poly LR,
then of ENet-19, whose max-unpool indices run under the same world. At
4 or more ranks, an even number, the reference's second pass follows:
the world laid out as ``(N/2, 2)``, image height sharded 2-way over the
``model`` axis (``parallel.spatial``), one Fast-SCNN-19 step at 128x128
(4 rows a shard at the deepest stage, the envelope's least), one image a
data rank. Each step's loss must be finite and the same on every rank,
and every rank's parameters and BN statistics after it the same bit for
bit.
"""
from __future__ import annotations

import hashlib
import sys

import numpy as np
import torch

CLASSES = 19


def _digest(model: torch.nn.Module) -> str:
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _step(arch: str, seed: int, hw: int = 64, n_spatial: int = 1):
    from ..models import build_model
    from ..train import losses as L
    from ..train.optimizers import build_optimizer
    from ..train.schedules import build_schedule
    from ..train.step import make_train_step
    from . import mesh, spatial

    weights = torch.ones(CLASSES)

    def loss_fn(logits, labels):
        return (L.cross_entropy(logits, labels, num_classes=CLASSES,
                                class_weights=weights)
                + L.ohem_cross_entropy(logits, labels, num_classes=CLASSES))

    w = mesh.set_spatial(n_spatial)
    if n_spatial > 1:
        spatial.check_spatial_config((hw, hw), n_spatial)
    model = build_model(arch, CLASSES, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    opt = build_optimizer("adam", model.parameters())
    mesh.broadcast_state(model, opt)
    step = make_train_step(model, loss_fn, opt,
                           schedule=build_schedule("poly", 1e-3, 100),
                           generator=torch.Generator().manual_seed(seed))
    b = 2 * w.size if n_spatial == 1 else w.n_data
    rng = np.random.RandomState(0)
    batch = spatial.shard_batch_spatial({
        "image": torch.from_numpy(rng.rand(b, 3, hw, hw).astype(np.float32)),
        "label": torch.from_numpy(rng.randint(0, CLASSES, (b, hw, hw)))})
    loss = float(step(batch)["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"{arch}: non-finite loss {loss}")
    if step.count != 1:
        raise RuntimeError(f"{arch}: step count {step.count}")
    return loss, _digest(model)


def rank_main():
    """One rank's part: the Fast-SCNN and the ENet step, then at 4 or more
    ranks (an even number) the spatial Fast-SCNN step."""
    from . import mesh
    out = {arch: _step(arch, seed)
           for arch, seed in (("fastscnn", 0), ("enet", 1))}
    size = mesh.world().size
    if size >= 4 and size % 2 == 0:
        out["spatial"] = _step("fastscnn", 2, hw=128, n_spatial=2)
    return out


def dryrun_multichip(n_devices: int = 2, timeout: float = 120.0) -> dict:
    """Run the dry run at ``n_devices`` ranks; raises on any failure or
    disagreement between the ranks. Returns rank 0's losses."""
    from .launch import run_ranks
    out = run_ranks(rank_main, n_devices, timeout=timeout)
    for part in out[0]:
        if any(o[part] != out[0][part] for o in out):
            raise RuntimeError(f"dryrun_multichip({n_devices}): the ranks "
                               f"disagree after the {part} step: "
                               f"{[o[part] for o in out]}")
    loss, enet = out[0]["fastscnn"][0], out[0]["enet"][0]
    print(f"dryrun_multichip({n_devices}): dp ok (ce+ohem loss), "
          f"loss={loss:.4f}")
    print(f"dryrun_multichip({n_devices}): dp enet ok (max-unpool side "
          f"channel), loss={enet:.4f}")
    losses = {"fastscnn": loss, "enet": enet}
    if "spatial" in out[0]:
        losses["spatial"] = out[0]["spatial"][0]
        print(f"dryrun_multichip({n_devices}): dp x spatial ok "
              f"({n_devices // 2} data x 2 model), "
              f"loss={losses['spatial']:.4f}")
    return losses


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
