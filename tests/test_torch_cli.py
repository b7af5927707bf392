"""The port's CLIs, ``python -m esn_tpu_torch.cli.{train,test,predict}``:
the reference's flags, ``--cuda`` as a boolean, and the train -> test
(``--checkpoint``, ``--best``, ``--save``) -> predict flow on the CPU, as
``tests/test_e2e_cli.py`` drives the reference's."""
import argparse
import os
import runpy
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import predict as ref_predict_cli
import test as ref_test_cli
import train as ref_train_cli
from esn_tpu_torch.cli import predict as predict_cli
from esn_tpu_torch.cli import str2bool
from esn_tpu_torch.cli import test as test_cli
from esn_tpu_torch.cli import train as train_cli
from esn_tpu_torch.models import build_model
from esn_tpu_torch.train import checkpoint as ckpt
from esn_tpu_torch.train.step import make_predict_step
from esn_tpu_torch.train.trainer import resolve_compute_dtype


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's tests: the quick tier runs six
    workers on a few cores, and torch's OpenMP threads, one team per
    worker, then spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("ref,port", [
    (ref_train_cli, train_cli), (ref_test_cli, test_cli),
    (ref_predict_cli, predict_cli)])
def test_every_reference_flag_is_accepted(ref, port):
    """The same flags with the same defaults (``--cuda`` True in both, a
    real boolean in the port; ``--compute_dtype`` None in both: bf16 on
    the card, f32 on the CPU)."""
    assert vars(port.parse_args([])) == vars(ref.parse_args([]))


@pytest.mark.parametrize("text,value", [
    ("False", False), ("false", False), ("0", False), ("no", False),
    ("True", True), ("1", True), ("yes", True)])
def test_cuda_flag_is_a_boolean(text, value):
    assert train_cli.parse_args(["--cuda", text]).cuda is value
    assert test_cli.parse_args(["--cuda", text]).cuda is value
    assert predict_cli.parse_args(["--cuda", text]).cuda is value
    assert train_cli.parse_args(["--random_mirror", text]).random_mirror \
        is value
    with pytest.raises(argparse.ArgumentTypeError):
        str2bool("maybe")


def test_config_from_args():
    cfg = train_cli.config_from_args(train_cli.parse_args(
        ["--model", "FastSCNN", "--dataset", "cityscapes", "--use_ohem",
         "--cuda", "False", "--synthetic_hw", "64x128"]))
    assert (cfg.input_size, cfg.loss, cfg.device, cfg.compute_dtype) == (
        (512, 1024), "ohem", "cpu", None)
    assert resolve_compute_dtype(cfg.compute_dtype, cfg.device) \
        == torch.float32
    assert cfg.synthetic_hw == (64, 128)
    cfg = train_cli.config_from_args(train_cli.parse_args(["--input_size",
                                                           "72,96"]))
    assert (cfg.device, cfg.compute_dtype, cfg.input_size) == (
        "cuda", None, (72, 96))
    assert resolve_compute_dtype(cfg.compute_dtype, cfg.device) \
        == torch.bfloat16
    assert resolve_compute_dtype("float32", "cuda") == torch.float32


@pytest.mark.parametrize("size,spatial", [("64,64", 2), ("160,160", 4),
                                          ("96,128", 2)])
def test_spatial_outside_the_envelope_raises_the_reference_s_error(
        tmp_path, size, spatial):
    """``--spatial`` runs (tests/test_torch_spatial_trainer.py); outside
    the reference's envelope it raises the reference's ValueError before
    anything is built."""
    with pytest.raises(ValueError, match=r"need >=4 rows divisible by"):
        train_cli.main(["--spatial", str(spatial), "--input_size", size,
                        "--cuda", "False", "--savedir", str(tmp_path)])


def test_spatial_on_a_world_it_does_not_divide_raises(tmp_path):
    """One process cannot hold a model axis of 2: where the reference
    asserts its devices divide, the port says to launch more ranks."""
    with pytest.raises(ValueError, match=r"1 rank\(s\) are not divisible by "
                                         r"spatial=2.*cannot shrink"):
        train_cli.main(["--spatial", "2", "--input_size", "128,128",
                        "--cuda", "False", "--savedir", str(tmp_path),
                        "--data_root", str(tmp_path / "none")])


@pytest.mark.parametrize("flags,loss", [
    (["--remat"], "ce"), (["--use_focal"], "focal"),
    (["--use_lovaszsoftmax"], "lovasz"), (["--optim", "ranger"], "ce")],
    ids=["remat", "focal", "lovasz", "ranger"])
def test_training_surface_flags_train_a_step(tmp_path, monkeypatch, capsys,
                                             flags, loss):
    """Each flag of the reference's training surface (ROADMAP item 8)
    trains one CPU step of ENet through ``cli.train`` and writes its
    checkpoint; ranger's optimizer state holds its slow weights."""
    monkeypatch.chdir(tmp_path)
    assert train_cli.main(flags + [
        "--model", "ENet", "--dataset", "camvid", "--synthetic_hw",
        "144,192", "--data_root", str(tmp_path / "none"), "--cuda", "False",
        "--input_size", "72,96", "--max_epochs", "1", "--batch_size", "2",
        "--synthetic_len", "2", "--num_workers", "2", "--savedir",
        str(tmp_path / "ck")]) == 0
    assert f"loss {loss}," in capsys.readouterr().out
    state = torch.load(str(tmp_path / "ck" / "camvid" /
                           "ENetbs2gpu1_train" / "model_1.ckpt"),
                       weights_only=True)["state"]
    assert state["step"] == 1
    slow = ["slow" in s for s in state["optimizer"]["state"].values()]
    assert all(slow) if "ranger" in flags else not any(slow)


def test_cli_runs_on_the_card_unless_told_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    for main, out in ((train_cli.main, "--savedir"),
                      (test_cli.main, "--savedir"),
                      (predict_cli.main, "--save_seg_dir")):
        with pytest.raises(RuntimeError, match="--cuda False"):
            main([out, str(tmp_path)])


def test_cli_train_test_predict(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    common = ["--model", "ENet", "--dataset", "camvid", "--synthetic_hw",
              "144,192", "--data_root", str(tmp_path / "none"), "--cuda",
              "False"]
    assert train_cli.main(common + [
        "--input_size", "72,96", "--max_epochs", "2", "--batch_size", "2",
        "--val_epochs", "2", "--synthetic_len", "4", "--num_workers", "2",
        "--savedir", str(tmp_path / "ck")]) == 0
    run_dir = tmp_path / "ck" / "camvid" / "ENetbs2gpu1_train"
    assert {"events.jsonl", "log.txt", "model_1.ckpt",
            "model_2.ckpt"} <= set(os.listdir(run_dir))
    ck = str(run_dir / "model_2.ckpt")
    capsys.readouterr()

    assert test_cli.main(common + [
        "--checkpoint", ck, "--synthetic_len", "2", "--save",
        "--save_seg_dir", str(tmp_path / "eval_saves")]) == 0
    saves = sorted(os.listdir(tmp_path / "eval_saves"))
    assert saves == ["synthetic_00000_color.png", "synthetic_00001_color.png"]
    single = capsys.readouterr().out
    assert "meanIoU" in single and single.count(": ") >= 11

    # --best sweeps every model_*.ckpt of the run dir, from the
    # checkpoint's directory or rebuilt from --savedir and the batch size
    for where in (["--checkpoint", ck],
                  ["--savedir", str(tmp_path / "ck"),
                   "--train_batch_size", "2"]):
        assert test_cli.main(common + where + [
            "--best", "--synthetic_len", "2"]) == 0
        out = capsys.readouterr().out
        assert "model_1.ckpt (epoch 1)" in out and "model_2.ckpt (epoch 2)" in out
        assert "=> best: model_" in out

    assert predict_cli.main(common + [
        "--checkpoint", ck, "--synthetic_len", "2", "--batch_size", "2",
        "--save_seg_dir", str(tmp_path / "preds")]) == 0
    preds = sorted(os.listdir(tmp_path / "preds"))
    assert preds == ["synthetic_00000.png", "synthetic_00000_color.png",
                     "synthetic_00001.png", "synthetic_00001_color.png"]
    # the grey PNGs are the predict step's maps of the checkpoint's model
    from esn_tpu_torch.data import build_dataset_test
    _, loader, transform = build_dataset_test(
        "camvid", none_gt=True, root=str(tmp_path / "none"), batch_size=2,
        synthetic_len=2, synthetic_hw=(144, 192))
    model = build_model("enet", 11, device="cpu")
    ckpt.load_variables(ck, model)
    batch = next(iter(loader))
    maps = make_predict_step(model)(transform(torch.from_numpy(
        batch["image"]))).numpy()
    for i, name in enumerate(batch["name"]):
        with Image.open(tmp_path / "preds" / name) as im:
            np.testing.assert_array_equal(np.asarray(im), maps[i])


@pytest.mark.parametrize("model, dataset, source, crop", [
    ("ContextNet", "cityscapes", "128,256", "128,256"),
    ("SegNet", "camvid", "96,128", "64,96"),
    ("ESPNetv2", "cityscapes", "64,128", "64,128"),
    ("DABNet", "cityscapes", "64,128", "64,128"),
    ("LEDNet", "cityscapes", "64,128", "64,128"),
    ("FPENet", "cityscapes", "64,128", "64,128"),
])
def test_cli_train_predict_new_models(tmp_path, monkeypatch, model, dataset,
                                      source, crop):
    """A tiny CPU run of ``cli.train`` (one epoch of one step, with
    validation) and ``cli.predict`` for ContextNet, ESPNetv2, DABNet and
    LEDNet (resize-tail models: their CE trains through ``logits_lowres``),
    FPENet (a resize tail without ``logits_lowres``: plain CE) and
    SegNet (CamVid's 11 classes, sides multiples of 32); the grey PNGs are
    the predict step's maps of the checkpoint's model."""
    monkeypatch.chdir(tmp_path)
    common = ["--model", model, "--dataset", dataset, "--synthetic_hw",
              source, "--data_root", str(tmp_path / "none"), "--cuda",
              "False"]
    assert train_cli.main(common + [
        "--input_size", crop, "--max_epochs", "1", "--batch_size", "2",
        "--val_epochs", "1", "--synthetic_len", "2", "--num_workers", "0",
        "--savedir", str(tmp_path / "ck")]) == 0
    ck = tmp_path / "ck" / dataset / f"{model}bs2gpu1_train" / "model_1.ckpt"
    assert ck.is_file()
    assert predict_cli.main(common + [
        "--checkpoint", str(ck), "--synthetic_len", "2", "--batch_size", "2",
        "--num_workers", "0", "--save_seg_dir", str(tmp_path / "preds")]) == 0
    from esn_tpu_torch.data import build_dataset_test
    from esn_tpu_torch.data.palettes import trainid_to_labelid
    _, loader, transform = build_dataset_test(
        dataset, none_gt=True, root=str(tmp_path / "none"), batch_size=2,
        synthetic_len=2, synthetic_hw=tuple(int(v) for v in source.split(",")))
    net = build_model(model, 19 if dataset == "cityscapes" else 11,
                      device="cpu")
    ckpt.load_variables(str(ck), net)
    batch = next(iter(loader))
    maps = make_predict_step(net)(transform(torch.from_numpy(
        batch["image"]))).numpy()
    for i, name in enumerate(batch["name"]):
        with Image.open(tmp_path / "preds" / name) as im:
            grey = np.asarray(im)
        want = trainid_to_labelid(maps[i]) if dataset == "cityscapes" \
            else maps[i]
        np.testing.assert_array_equal(grey, want)


def test_cli_train_grafts_an_encoder(tmp_path, monkeypatch):
    """``cli.train --model ESPNet --encoder_checkpoint`` with a trained
    ESPNet-C's checkpoint written by the JAX package's ``save_checkpoint``:
    one epoch at lr 0 (adam then leaves every parameter where it
    started) saves a model whose encoder parameters are the donor's bit
    for bit, and whose decoder is the port's seeded init."""
    import jax

    from esn_tpu.train import checkpoint as jax_ckpt
    from esn_tpu.train import optimizers as jax_optimizers
    from esn_tpu.train.state import TrainState as JaxTrainState
    from esn_tpu_torch import convert

    monkeypatch.chdir(tmp_path)
    donor = build_model("espnet_c", 11, device="cpu",
                        generator=torch.Generator().manual_seed(5))
    variables = convert.to_variables(donor.state_dict(), donor)
    path = jax_ckpt.save_checkpoint(
        str(tmp_path / "donor"), 9, JaxTrainState.create(
            jax.tree_util.tree_map(np.asarray, variables),
            jax_optimizers.build_optimizer("adam", 1e-3)))
    assert train_cli.main([
        "--model", "ESPNet", "--dataset", "camvid", "--synthetic_hw",
        "96,128", "--data_root", str(tmp_path / "none"), "--cuda", "False",
        "--input_size", "64,96", "--max_epochs", "1", "--batch_size", "2",
        "--val_epochs", "1", "--synthetic_len", "2", "--num_workers", "0",
        "--lr", "0", "--encoder_checkpoint", path,
        "--savedir", str(tmp_path / "ck")]) == 0
    ck = tmp_path / "ck" / "camvid" / "ESPNetbs2gpu1_train" / "model_1.ckpt"
    trained = build_model("espnet", 11, device="cpu")
    ckpt.load_variables(str(ck), trained)
    fresh = build_model("espnet", 11, device="cpu",
                        generator=torch.Generator().manual_seed(1))
    donor_params = dict(donor.named_parameters())
    fresh_params = dict(fresh.named_parameters())
    for name, value in trained.named_parameters():
        want = (donor_params[name[len("enc."):]] if name.startswith("enc.")
                else fresh_params[name])
        assert torch.equal(value, want), name


@pytest.mark.parametrize("name", ["train", "test", "predict"])
def test_cli_module_entry_points(name, monkeypatch, capsys):
    """``python -m esn_tpu_torch.cli.<name> --help`` runs the module's
    ``main`` (here through ``runpy``, as ``-m`` does)."""
    monkeypatch.setattr(sys, "argv", [name, "--help"])
    monkeypatch.delitem(sys.modules, f"esn_tpu_torch.cli.{name}")
    with pytest.raises(SystemExit) as done:
        runpy.run_module(f"esn_tpu_torch.cli.{name}", run_name="__main__")
    assert done.value.code == 0
    out = capsys.readouterr().out
    assert "--cuda" in out and "--model" in out
