"""The port's Trainer on ENet-CamVid at the reference end-to-end test's
TINY size, f32, on the CPU: what it writes (the first epoch's Chrome
trace with the program's spans among it), and an exact resume (two
straight epochs against one epoch, a resume from its checkpoint and a
second epoch: parameters, BN statistics, adam state and logged losses
bit for bit)."""
import json
import os

import numpy as np
import pytest
import torch

from esn_tpu_torch.train.trainer import TrainConfig, Trainer
from esn_tpu_torch.utils import profiling

TINY = dict(
    dataset="camvid", input_size=(72, 96), max_epochs=2, batch_size=2,
    lr=2e-3, val_epochs=1, synthetic_len=6, synthetic_hw=(144, 192),
    num_workers=2, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's tests: the quick tier runs six
    workers on a few cores, and torch's OpenMP threads, one team per
    worker, then spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_cfg(tmp_path, sub, **over):
    kw = dict(TINY, model="ENet")
    kw.update(over)
    return TrainConfig(savedir=str(tmp_path / sub),
                       data_root=str(tmp_path / "nodata"), **kw)


def _events(cfg):
    with open(os.path.join(cfg.run_dir, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("straight")
    cfg = make_cfg(tmp, "ck", profile_dir=str(tmp / "profile"))
    trainer = Trainer(cfg)
    miou = trainer.fit()
    return cfg, trainer, miou


def test_trainer_end_to_end(straight):
    cfg, trainer, miou = straight
    assert trainer.n_params > 100_000
    assert 0.0 <= miou <= 1.0
    run = cfg.run_dir
    assert run.endswith(os.path.join("camvid", "ENetbs2gpu1_train"))
    for name in ("log.txt", "events.jsonl", "model_1.ckpt", "model_2.ckpt",
                 "loss_vs_epochs.png", "iou_vs_epochs.png"):
        assert os.path.exists(os.path.join(run, name)), name
    events = _events(cfg)
    assert [e["epoch"] for e in events] == [1, 2]
    assert all(np.isfinite(e["loss"]) for e in events)
    assert all(len(e["per_class_iou"]) == 11 for e in events)
    assert events[-1]["miou"] == miou
    with open(os.path.join(run, "log.txt")) as f:
        log = f.read()
    assert log.startswith("Model: ENet  dataset: camvid")
    assert log.count(" IoU: ") == 2 * 11
    assert trainer.train_step.count == 2 * len(trainer.train_loader) == 6
    # the first epoch's Chrome trace, with the program's spans in it
    with open(os.path.join(cfg.profile_dir, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"train.augment", "train.step", "train.prepare", "train.forward",
            "train.loss", "train.backward", "train.optimizer", "bn"} <= names


def test_trainer_logs_host_times_and_resolves_its_dtype(straight):
    """Each epoch's event has the step timer's parts: 3 steps' host call
    and wait for the batch, one closing sync; no dtype given is f32 on
    the CPU."""
    cfg, trainer, _ = straight
    assert cfg.compute_dtype is None and trainer.compute_dtype == torch.float32
    for e in _events(cfg):
        assert e["host_step"]["steps"] == e["wait_step"]["steps"] == 3
        assert e["sync"]["steps"] == 1
        assert all(e[k]["mean_ms"] >= 0.0
                   for k in ("host_step", "wait_step", "sync"))
    with open(os.path.join(cfg.run_dir, "log.txt")) as f:
        assert "compute_dtype: torch.float32" in f.read()


def test_step_timer_parts():
    timer = profiling.StepTimer()
    seen = []
    for item in timer.iterate(range(4), "wait"):
        with timer.step():
            seen.append(item)
    with timer.step("sync"):
        pass
    assert seen == [0, 1, 2, 3] and len(timer) == 4
    assert timer.summary("wait")["steps"] == 4
    assert timer.summary()["steps"] == 4 and timer.summary("sync")["steps"] == 1
    assert timer.summary("other") is None
    closed = []

    def source():
        try:
            yield from range(10)
        finally:
            closed.append(True)
    it = timer.iterate(source())
    next(it)
    it.close()
    assert closed == [True]
    timer.reset()
    assert timer.summary() is None and timer.summary("wait") is None


def test_resume_is_exact(straight, tmp_path):
    cfg, trainer, _ = straight
    first = Trainer(make_cfg(tmp_path, "first"))
    first.fit(epochs=1)
    ck = os.path.join(first.cfg.run_dir, "model_1.ckpt")
    resumed = Trainer(make_cfg(tmp_path, "resumed", resume=ck))
    assert resumed.start_epoch == 1
    assert resumed.train_step.count == first.train_step.count == 3
    resumed.fit()
    for (k, a), (k2, b) in zip(trainer.model.state_dict().items(),
                               resumed.model.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
    sa = trainer.optimizer.state_dict()["state"]
    sb = resumed.optimizer.state_dict()["state"]
    assert set(sa) == set(sb)
    for i in sa:
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[i][key], sb[i][key]), (i, key)
    want = _events(cfg)[1]
    got = _events(resumed.cfg)
    assert len(got) == 1
    for key in ("epoch", "loss", "lr", "miou", "per_class_iou"):
        assert got[0][key] == want[key], key


@pytest.mark.parametrize("hw,spatial", [((64, 64), 2), ((160, 160), 4),
                                        ((256, 96), 3)])
def test_spatial_outside_the_envelope_raises_the_reference_s_error(
        tmp_path, hw, spatial):
    with pytest.raises(ValueError, match=r"need >=4 rows divisible by"):
        Trainer(make_cfg(tmp_path, "x", input_size=hw, spatial=spatial))


def test_spatial_on_a_world_it_does_not_divide_raises(tmp_path):
    """Inside the envelope, one process cannot hold a model axis of 2:
    where the reference asserts, the port raises and says why; a later
    Trainer in the same process is data-parallel again."""
    with pytest.raises(ValueError, match=r"1 rank\(s\) are not divisible by "
                                         r"spatial=2.*cannot shrink"):
        Trainer(make_cfg(tmp_path, "x", input_size=(128, 128), spatial=2))
    trainer = Trainer(make_cfg(tmp_path, "y", synthetic_len=2,
                               max_epochs=1))
    assert trainer.world.spatial == 1


@pytest.mark.parametrize("over", [
    dict(remat=True), dict(optim="radam"), dict(optim="ranger"),
    dict(loss="focal"), dict(loss="lovasz"), dict(loss="lovasz_hist")],
    ids=["remat", "radam", "ranger", "focal", "lovasz", "lovasz_hist"])
def test_training_surface_options_train_a_step(tmp_path, over):
    """The rest of the reference's training surface (ROADMAP item 8): one
    CPU step of ENet with each option, through the optimizer, the loss and
    the recomputing step that the option names."""
    from esn_tpu_torch.train.losses import LOSS_REGISTRY
    from esn_tpu_torch.train.optimizers import RAdam, Ranger
    trainer = Trainer(make_cfg(tmp_path, "x", synthetic_len=2, max_epochs=1,
                               **over))
    kinds = {"radam": RAdam, "ranger": Ranger}
    assert type(trainer.optimizer) is kinds.get(trainer.cfg.optim,
                                                torch.optim.Adam)
    assert trainer.loss_fn.func is LOSS_REGISTRY[trainer.cfg.loss]
    assert (trainer.train_step.recompute is not None) == trainer.cfg.remat
    loss, _ = trainer.train_epoch(0)
    assert trainer.train_step.count == 1 and np.isfinite(loss)


def test_ranger_lovasz_remat_resume_is_exact(tmp_path):
    """ranger + Lovász + remat: two straight epochs of three steps against
    one epoch, a resume from its checkpoint and the second: bit for bit,
    the resumed epoch crossing Lookahead's sync at step 6 from the
    checkpoint's slow weights."""
    over = dict(optim="ranger", loss="lovasz", remat=True, val_epochs=2)
    straight = Trainer(make_cfg(tmp_path, "straight", **over))
    straight.fit()
    first = Trainer(make_cfg(tmp_path, "first", **over))
    first.fit(epochs=1)
    resumed = Trainer(make_cfg(
        tmp_path, "resumed", resume=os.path.join(first.cfg.run_dir,
                                                 "model_1.ckpt"), **over))
    resumed.fit()
    assert straight.train_step.count == resumed.train_step.count == 6
    for (k, a), (k2, b) in zip(straight.model.state_dict().items(),
                               resumed.model.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
    sa = straight.optimizer.state_dict()["state"]
    sb = resumed.optimizer.state_dict()["state"]
    for i in sa:
        for key in ("step", "exp_avg", "exp_avg_sq", "slow"):
            assert torch.equal(sa[i][key], sb[i][key]), (i, key)
    assert _events(resumed.cfg)[0]["loss"] == _events(straight.cfg)[1]["loss"]


def test_trainer_grafts_an_encoder(tmp_path):
    """``encoder_checkpoint``: an ESPNet-C trained one epoch by the Trainer
    is grafted into ESPNet's ``enc`` (parameters and BN statistics bit for
    bit, its classifier left out, the decoder the seeded init), and ESPNet
    then trains and validates an epoch."""
    donor = Trainer(make_cfg(tmp_path, "donor", model="ESPNet_C",
                             max_epochs=1))
    donor.fit()
    path = os.path.join(donor.cfg.run_dir, "model_1.ckpt")
    trainer = Trainer(make_cfg(tmp_path, "espnet", model="ESPNet",
                               max_epochs=1, encoder_checkpoint=path))
    want = donor.model.state_dict()
    fresh = Trainer(make_cfg(tmp_path, "fresh", model="ESPNet",
                             max_epochs=1)).model.state_dict()
    for key, value in trainer.model.state_dict().items():
        if key.startswith("enc."):
            assert torch.equal(value, want[key[len("enc."):]]), key
        else:
            assert torch.equal(value, fresh[key]), key
    assert "head.weight" in want
    miou = trainer.fit()
    assert 0.0 <= miou <= 1.0
    assert all(np.isfinite(e["loss"]) for e in _events(trainer.cfg))


def test_trainer_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(make_cfg(tmp_path, "x", device="cuda"))
