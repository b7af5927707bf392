"""The slice against the reference: the port's Trainer and the JAX
package's fit one epoch of Fast-SCNN-19 with class-weighted CE, on the
CPU, f32, from the same JAX checkpoint; then the port's test CLI and the
reference test.py's ``evaluate`` score a checkpoint the JAX Trainer
wrote.

Both Trainers run with ``random_scale=False``, ``random_mirror=False``
and crops the size of the synthetic sources, so augmentation is the
identity up to normalization, and with the classifier's dropout off. The
JAX Trainer saves its initial state as a checkpoint; the port's Trainer
resumes from it (the JAX checkpoint reader) and trains on the same
batches. The reference takes CE of its materialized full-resolution
logits (its fused path is off by default); the port takes K3's plain
version (the same function, in another order).

SGD with momentum (lr 1e-2): its update is proportional to the gradient,
where adam's first step is lr times the gradient's sign, which flips on
the small gradients that f32 gets wrong at this size (ROADMAP Queue 3:
the reference's own f32 gradients lie up to 3.9e-2 per leaf from an f64
oracle here, BN over 2 images in the PPM).

Tolerances (CPU readings while writing this test in brackets): the
epoch's mean loss within LOSS_REL [1.0e-4; the first step's loss agrees
to 4e-6, the second sees parameters updated from the two packages' f32
gradients]; the epoch's update of each parameter and BN statistic within
UPDATE_REL rel-L2 of the reference's [worst 0.116, median 1.9e-2], the
median leaf within UPDATE_MEDIAN; leaves whose gradient is zero in exact
arithmetic (a projection's BN bias feeding a train-mode BN, which takes
out any per-channel shift, and the running means downstream) move by
rounding noise only, under ZERO_UPDATE in both packages [2e-9 and 1.2e-7];
the validation confusion matrices equal up to CM_MISMATCH of the pixels
[0], and mIoU within 1e-3; the test CLIs' mIoU on a JAX checkpoint within
1e-3.
"""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from flax import serialization

from esn_tpu_torch import convert
from esn_tpu_torch.cli import test as port_test_cli
from esn_tpu_torch.train.evaluation import run_eval
from esn_tpu_torch.train.trainer import TrainConfig, Trainer

SMALL = dict(dataset="cityscapes", input_size=(64, 128), batch_size=2,
             max_epochs=1, val_epochs=1, lr=1e-2, optim="sgd", synthetic_len=4,
             synthetic_hw=(64, 128), num_workers=2, random_scale=False,
             random_mirror=False, compute_dtype="float32", loss="ce")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_REL, UPDATE_REL, UPDATE_MEDIAN, ZERO_UPDATE, CM_MISMATCH = (
    5e-4, 0.15, 0.05, 1e-6, 1e-3)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's tests: the quick tier runs six
    workers on a few cores, and torch's OpenMP threads, one team per
    worker, then spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_JAX_RUN = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from esn_tpu.train import checkpoint as ckpt
from esn_tpu.train.evaluation import run_eval
from esn_tpu.train.trainer import TrainConfig, Trainer
kw, init_dir = json.loads(sys.argv[1]), sys.argv[2]
for key in ("input_size", "synthetic_hw"):
    kw[key] = tuple(kw[key])
trainer = Trainer(TrainConfig(**kw))
assert jax.device_count() == 1
trainer.model.head.drop.rate = 0.0
ckpt.save_checkpoint(init_dir, 0, jax.device_get(trainer.state))
trainer.fit()
cm = run_eval(trainer.eval_step, trainer.state.variables, trainer.val_loader,
              trainer.eval_transform, 19, mesh=trainer.mesh)
np.save(init_dir + "/cm.npy", cm)
import test as test_cli
from esn_tpu.data import build_dataset_test
_, loader, transform = build_dataset_test(
    "cityscapes", root=kw["data_root"], batch_size=2, synthetic_len=2,
    synthetic_hw=kw["synthetic_hw"])
variables, _ = ckpt.load_variables(sys.argv[3], trainer.state.variables)
iou, miou = test_cli.evaluate(trainer.model, variables, loader, transform,
                              trainer.spec, eval_step=trainer.eval_step,
                              mesh=trainer.mesh)
with open(init_dir + "/test_cli.json", "w") as f:
    json.dump({"miou": miou, "iou": iou.tolist()}, f)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX Trainer in a fresh interpreter on one CPU device (this
    process has 8 virtual ones, over which it would shard the batch),
    then the port's Trainer from the JAX run's initial checkpoint."""
    d = tmp_path_factory.mktemp("parity")
    kw = dict(SMALL, model="FastSCNN", savedir=str(d / "jax"),
              data_root=str(d / "nodata"))
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    jax_run_dir = os.path.join(str(d / "jax"), "cityscapes",
                               "FastSCNNbs2gpu1_train")
    final = os.path.join(jax_run_dir, "model_1.ckpt")
    test_args = ["--model", "FastSCNN", "--dataset", "cityscapes",
                 "--checkpoint", final,
                 "--synthetic_len", "2", "--synthetic_hw", "64,128",
                 "--data_root", str(d / "nodata"), "--compute_dtype",
                 "float32", "--batch_size", "2"]
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_RUN, json.dumps(kw), str(d / "init"),
         final],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    init = str(d / "init" / "model_0.ckpt")
    pcfg = TrainConfig(model="FastSCNN", savedir=str(d / "port"),
                       data_root=str(d / "nodata"), resume=init,
                       device="cpu", **SMALL)
    pt = Trainer(pcfg)
    pt.model.head.drop.rate = 0.0
    pt.fit()
    return dict(d=d, pt=pt, pcfg=pcfg, jax_run_dir=jax_run_dir,
                start=_restore(init), end=_restore(final),
                cm_ref=np.load(str(d / "init" / "cm.npy")),
                test_args=test_args,
                test_cli=json.loads((d / "init" / "test_cli.json").read_text()))


def _restore(path):
    with open(path, "rb") as f:
        payload = serialization.msgpack_restore(f.read())
    return payload["state"], payload["meta"]


def _events(run_dir):
    with open(os.path.join(run_dir, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_epoch_loss_and_params_match_the_reference(runs):
    pt = runs["pt"]
    end, meta = runs["end"]
    assert pt.start_epoch == 0
    assert pt.train_step.count == int(end["step"]) == 2 and meta["epoch"] == 1
    (je,), (pe,) = _events(runs["jax_run_dir"]), _events(runs["pcfg"].run_dir)
    assert abs(pe["loss"] - je["loss"]) <= LOSS_REL * abs(je["loss"])
    assert pe["lr"] == pytest.approx(je["lr"], rel=1e-6)

    def port_layout(state):
        return convert.to_state_dict(
            {"params": state["params"], "stats": state["stats"]}, pt.model)
    start, want, got = (port_layout(runs["start"][0]), port_layout(end),
                        pt.model.state_dict())
    assert set(got) == set(want)
    rel = {}
    for k in want:
        u_ref = want[k].double() - start[k].double()
        u = got[k].double() - start[k].double()
        if float(u_ref.abs().max()) <= ZERO_UPDATE:
            assert float(u.abs().max()) <= ZERO_UPDATE, k
            continue
        rel[k] = float((u - u_ref).norm() / u_ref.norm())
    assert len(rel) > 0.8 * len(want)
    assert max(rel.values()) <= UPDATE_REL, max(rel, key=rel.get)
    assert float(np.median(list(rel.values()))) <= UPDATE_MEDIAN


def test_validation_matches_the_reference(runs):
    pt, cm_ref = runs["pt"], runs["cm_ref"]
    cm = run_eval(pt.eval_step, pt.val_loader, pt.eval_transform, 19)
    assert cm.sum() == cm_ref.sum() > 0
    mismatch = np.abs(cm - cm_ref).sum() / 2 / cm_ref.sum()
    assert mismatch <= CM_MISMATCH
    (je,), (pe,) = _events(runs["jax_run_dir"]), _events(runs["pcfg"].run_dir)
    assert abs(pe["miou"] - je["miou"]) <= 1e-3


def _mean_iou(text):
    return float(re.search(r"meanIoU: ([0-9.]+)", text).group(1))


def test_port_test_cli_scores_a_jax_checkpoint_as_the_reference(runs, capsys):
    """The port's test CLI on the checkpoint the JAX Trainer wrote, against
    the reference test.py's ``evaluate`` on the same split (run beside the
    JAX Trainer, with its compiled eval step)."""
    assert port_test_cli.main(runs["test_args"] + ["--cuda", "False"]) == 0
    out = capsys.readouterr().out
    assert abs(_mean_iou(out) - runs["test_cli"]["miou"]) <= 1e-3
    assert out.count(": ") >= 19
