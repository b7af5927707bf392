"""Spatial sharding through the Trainer, the CLIs and the dry run on the
CPU under gloo, and the data-parallel path left as it was.

- ``Trainer(spatial=2)`` at (1, 2) ranks: one epoch of synthetic ENet at
  128x128 (the envelope's least height; its spatial dropout on, adam)
  and a validation, against the same run in one process, in f64 (the
  test doubles the Trainer's model and steps, as
  ``tests/test_torch_parallel_trainer.py`` does): the logged loss within
  1e-10, the mIoU and per-class IoU equal, the checkpoint's parameters
  and statistics within 1e-10 of the largest value; rank 0's log names
  the mesh.
- ``cli.train --spatial 2`` then ``cli.test`` at 2 ranks against
  ``cli.test`` in one process on the checkpoint they wrote.
- ``dryrun_multichip(4)``: its second pass, Fast-SCNN at 128x128 on a
  (2, 2) layout.
- At S = 1 a 2-rank data-parallel step makes no exchange, no group sum
  and no collective over a model group.
"""
import os
import re

import numpy as np
import pytest
import torch

import _torch_parallel as TP
import _torch_spatial as TS
from esn_tpu_torch.parallel import dryrun, launch

RUN = dict(model="ENet", dataset="camvid", input_size=(128, 128),
           max_epochs=1, batch_size=2, lr=2e-3, val_epochs=1,
           synthetic_len=4, synthetic_hw=(160, 192), num_workers=2,
           device="cpu")
F64 = 1e-10
LIMIT = 180.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cli_args(savedir, data):
    common = ["--model", "ENet", "--dataset", "camvid", "--cuda", "False",
              "--data_root", data, "--synthetic_hw", "160x192",
              "--num_workers", "2"]
    train = common + ["--input_size", "128,128", "--batch_size", "2",
                      "--max_epochs", "1", "--synthetic_len", "4",
                      "--savedir", savedir, "--lr", "2e-3", "--spatial", "2"]
    ckpt = os.path.join(savedir, "camvid", "ENetbs2gpu2_train",
                        "model_1.ckpt")
    test = common + ["--checkpoint", ckpt, "--batch_size", "3",
                     "--synthetic_len", "5"]
    return train, test


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spatial_trainer")
    cfg = dict(RUN, data_root=str(tmp / "nodata"))
    one = TP.trainer_case(cfg, str(tmp / "one"), f64=True)
    train_argv, test_argv = _cli_args(str(tmp / "cli"), str(tmp / "nodata"))
    img = np.random.RandomState(0).randn(4, 3, 64, 64)
    lab = np.random.RandomState(1).randint(0, TP.CLASSES, (4, 64, 64))
    calls = [("trainer_case", (dict(cfg, spatial=2), str(tmp / "two")),
              {"f64": True}),
             ("cli_case", (train_argv, test_argv), {}),
             ("no_model_axis_case", (img.astype(np.float32), lab,
                                     np.ones(TP.CLASSES, np.float32)), {})]
    two = launch.run_ranks(TS.many_case, 2, calls, timeout=LIMIT)
    return dict(one=one, two=two, test_argv=test_argv)


def test_trainer_at_spatial_2_matches_one_process(runs):
    want = runs["one"]
    for got in (o[0] for o in runs["two"]):
        assert [e["epoch"] for e in got["events"]] == [1]
        g, w = got["events"][0], want["events"][0]
        assert abs(g["loss"] - w["loss"]) <= F64 * abs(w["loss"])
        for key in ("miou", "per_class_iou", "lr"):
            assert g[key] == w[key], key
        assert got["count"] == want["count"] == 2
        scale = max(float(np.abs(v).max()) for v in want["state"].values())
        for k, v in want["state"].items():
            np.testing.assert_allclose(got["state"][k], v, rtol=0,
                                       atol=F64 * scale, err_msg=k)
    # both ranks load image 0 and 1 (one data rank), keep their rows
    assert runs["two"][0][0]["rows"] is None
    launch.assert_ranks_equal([o[0]["state"] for o in runs["two"]])
    assert runs["two"][0][0]["header"][2] == (
        "world: 2 rank(s)  backend: gloo  devices: cpu cpu  "
        "mesh: 1 data x 2 model")


def _miou(lines):
    return float(next(re.findall(r"meanIoU: ([0-9.]+)", line)[0]
                      for line in lines if "meanIoU" in line))


def test_cli_train_spatial_2_and_test(runs, capsys):
    from esn_tpu_torch.cli import test as test_cli
    lines = [o[1]["lines"] for o in runs["two"]]
    assert any("meanIoU" in line for line in lines[0])
    assert not any("meanIoU" in line for line in lines[1])
    test_cli.main(runs["test_argv"])
    one = capsys.readouterr().out.splitlines()
    assert _miou(lines[0]) == _miou(one)


def test_no_model_axis_no_new_collective(runs):
    """With S = 1 the data-parallel step takes the parent's path: no row
    exchange, no group sum, every all-reduce over the whole world."""
    for o in runs["two"]:
        seen = o[2]
        assert seen["fetch"] == seen["group_sum"] == seen["grouped"] == 0
        assert seen["all_reduce"] > 0


def test_dryrun_multichip_4_takes_the_spatial_pass(capsys):
    losses = dryrun.dryrun_multichip(4, timeout=LIMIT)
    assert set(losses) == {"fastscnn", "enet", "spatial"}
    assert all(np.isfinite(v) for v in losses.values())
    out = capsys.readouterr().out
    assert "dp x spatial ok (2 data x 2 model)" in out
    assert "item 10" not in out
