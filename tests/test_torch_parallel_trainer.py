"""The Trainer, the CLIs and the dry run at 2 ranks on the CPU under gloo.

A 2-epoch synthetic ENet run (the Trainer's TINY size, adam, its spatial
dropout on) at 2 ranks against the same run in one process, in f64 (the
test doubles the Trainer's model and steps: in f32 the two runs' losses
already differ by 1.2e-4 relative with the lr at 1e-12, because BN's
shifted moments, centred on a running mean still at 0, cancel in f32 at
this size and the sums over the ranks round in another order): the
logged losses and mIoU, the checkpoint's parameters and statistics, and
a resume from epoch 1 (bit for bit the straight 2-rank run, as a
one-process resume is the straight one-process run). What rank 0 writes:
``gpu2`` in the run dir, the world in the log's header. ``cli.train``
then ``cli.test`` at 2 ranks against ``cli.test`` in one process on the
same checkpoint. ``dryrun_multichip(2)``.

One spawn of 2 ranks (``file://`` rendezvous, one torch thread a rank,
its own time limit) runs the Trainer and CLI cases; the dry run spawns
its own.
"""
import os
import re

import numpy as np
import pytest
import torch

import _torch_parallel as TP
from esn_tpu_torch.parallel import dryrun, launch

TINY = dict(model="ENet", dataset="camvid", input_size=(72, 96),
            max_epochs=2, batch_size=2, lr=2e-3, val_epochs=1,
            synthetic_len=6, synthetic_hw=(144, 192), num_workers=2,
            device="cpu")
# f64 at 2 ranks against one process, as in
# tests/test_torch_parallel_train.py: the epochs' mean losses within
# 1e-10 relative, mIoU equal, each checkpoint value within 1e-10 of the
# largest value of the state
F64 = 1e-10
LIMIT = 120.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cli_args(savedir, data):
    common = ["--model", "ENet", "--dataset", "camvid", "--cuda", "False",
              "--data_root", data, "--synthetic_hw", "144x192",
              "--num_workers", "2"]
    train = common + ["--input_size", "72,96", "--batch_size", "2",
                      "--max_epochs", "1", "--synthetic_len", "4",
                      "--savedir", savedir, "--lr", "2e-3"]
    ckpt = os.path.join(savedir, "camvid", "ENetbs2gpu2_train",
                        "model_1.ckpt")
    test = common + ["--checkpoint", ckpt, "--batch_size", "3",
                     "--synthetic_len", "5"]
    return train, test


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_trainer")
    cfg = dict(TINY, data_root=str(tmp / "nodata"))
    one = TP.trainer_case(cfg, str(tmp / "one"), f64=True)
    one_resumed = TP.trainer_case(cfg, str(tmp / "one"), resume_epoch=1,
                                  f64=True)
    train_argv, test_argv = _cli_args(str(tmp / "cli"), str(tmp / "nodata"))
    calls = [("trainer_case", (cfg, str(tmp / "two")), {"f64": True}),
             ("trainer_case", (cfg, str(tmp / "two")),
              {"resume_epoch": 1, "f64": True}),
             ("cli_case", (train_argv, test_argv), {})]
    two = launch.run_ranks(TP.many_case, 2, calls, timeout=LIMIT)
    return dict(one=one, one_resumed=one_resumed, two=two, tmp=tmp,
                test_argv=test_argv)


def _same_run(got, want, epochs):
    assert [e["epoch"] for e in got["events"]] == epochs
    for g, w in zip(got["events"], want["events"][-len(epochs):]):
        assert abs(g["loss"] - w["loss"]) <= F64 * abs(w["loss"])
        assert g["miou"] == w["miou"]
        assert g["per_class_iou"] == w["per_class_iou"]
        assert g["lr"] == w["lr"]
    scale = max(float(np.abs(v).max()) for v in want["state"].values())
    for k, v in want["state"].items():
        np.testing.assert_allclose(got["state"][k], v, rtol=0,
                                   atol=F64 * scale, err_msg=k)


def test_trainer_at_2_ranks_matches_one_process(runs):
    two = runs["two"]
    for r in range(2):
        _same_run(two[r][0], runs["one"], [1, 2])
        assert two[r][0]["count"] == runs["one"]["count"] == 6
    np.testing.assert_array_equal(two[0][0]["rows"], [0])
    np.testing.assert_array_equal(two[1][0]["rows"], [1])
    launch.assert_ranks_equal([o[0]["state"] for o in two])


def test_trainer_resume_at_2_ranks(runs):
    """The resume from epoch 1 is the straight 2-rank run bit for bit,
    and within the bounds of the one-process resume."""
    two = runs["two"]
    for r in range(2):
        got, straight = two[r][1], two[r][0]
        assert [e["epoch"] for e in got["events"]] == [2]
        for key in ("loss", "lr", "miou", "per_class_iou"):
            assert got["events"][0][key] == straight["events"][1][key], key
        for k, v in straight["state"].items():
            np.testing.assert_array_equal(got["state"][k], v, err_msg=k)
        _same_run(got, runs["one_resumed"], [2])


def test_rank_0_writes_the_run(runs):
    two = runs["two"][0][0]
    assert two["run_dir"].endswith(os.path.join("camvid",
                                                "ENetbs2gpu2_train"))
    assert runs["one"]["run_dir"].endswith("ENetbs2gpu1_train")
    assert {"log.txt", "events.jsonl", "model_1.ckpt", "model_2.ckpt"} \
        <= set(two["files"])
    assert two["header"][2] == "world: 2 rank(s)  backend: gloo  " \
                               "devices: cpu cpu"
    assert runs["one"]["header"][2] == "world: 1 rank(s)  backend: none  " \
                                       "devices: cpu"
    assert not any(f.endswith(".tmp") for f in two["files"])


def _miou(lines):
    return float(next(re.findall(r"meanIoU: ([0-9.]+)", line)[0]
                      for line in lines if "meanIoU" in line))


def test_cli_train_and_test_at_2_ranks(runs, capsys):
    """cli.train then cli.test at 2 ranks (rank 0 prints the report)
    against cli.test in one process on the checkpoint they wrote."""
    from esn_tpu_torch.cli import test as test_cli
    lines = [o[2]["lines"] for o in runs["two"]]
    assert any("meanIoU" in line for line in lines[0])
    assert not any("meanIoU" in line for line in lines[1])
    test_cli.main(runs["test_argv"])
    one = capsys.readouterr().out.splitlines()
    assert _miou(lines[0]) == _miou(one)


def test_dryrun_multichip_2(capsys):
    losses = dryrun.dryrun_multichip(2, timeout=LIMIT)
    assert all(np.isfinite(v) for v in losses.values())
    out = capsys.readouterr().out
    assert "dp ok (ce+ohem loss)" in out and "dp enet ok" in out
    assert "item 10" in out
