"""The port's metrics, eval step and evaluation loop against the JAX
reference, on the CPU.

The same seeded numpy inputs go through ``esn_tpu.train.metrics`` /
``make_eval_step`` / ``run_eval`` and their counterparts in the port;
model weights are the port's seeded init with calibrated BN statistics,
converted with ``esn_tpu_torch.convert``. The reference's jitted steps
run un-jitted (``jax.disable_jit``): the same operations without the
compile. Tolerances are stated per test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esn_tpu.models import build_model as jax_build_model
from esn_tpu.train import evaluation as JEV
from esn_tpu.train import metrics as JM
from esn_tpu.train.step import make_eval_step as jax_make_eval_step

from esn_tpu_torch import convert
from esn_tpu_torch.models import build_model
from esn_tpu_torch.nn import BatchNorm, Dropout
from esn_tpu_torch.train import evaluation as EV
from esn_tpu_torch.train import metrics as M
from esn_tpu_torch.train.step import make_eval_step

CLASSES = 19
HW = (64, 128)


# --- metrics -----------------------------------------------------------------

def _maps(seed, shape=(3, 17, 23), k=CLASSES):
    """Prediction and label maps with ignored (255), negative and
    out-of-range labels and out-of-range predictions."""
    rng = np.random.RandomState(seed)
    pred = rng.randint(-2, k + 3, shape).astype(np.int32)
    gt = rng.randint(0, k, shape).astype(np.int32)
    mark = rng.rand(*shape)
    gt[mark < 0.1] = 255
    gt[(mark >= 0.1) & (mark < 0.15)] = -1
    gt[(mark >= 0.15) & (mark < 0.2)] = k + 4
    return pred, gt


@pytest.mark.parametrize("seed, k, label_dtype", [
    (0, CLASSES, np.int32), (1, 11, np.int64), (2, 3, np.int32)])
def test_confusion_matrix_matches_reference(seed, k, label_dtype):
    """Equal, element for element; rows are the ground truth."""
    pred, gt = _maps(seed, k=k)
    want = np.asarray(JM.confusion_matrix(jnp.asarray(pred), jnp.asarray(gt),
                                          k))
    got = M.confusion_matrix(torch.from_numpy(pred),
                             torch.from_numpy(gt.astype(label_dtype)), k)
    assert got.dtype == torch.int64 and tuple(got.shape) == (k, k)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == int(((gt >= 0) & (gt < k)).sum())
    assert int(got[1, 0]) == int(((gt == 1) & (pred <= 0)).sum())


def test_confusion_matrix_of_uint8_labels_and_another_ignore_index():
    pred, gt = _maps(3)
    gt = np.where((gt < 0) | (gt > 255), 255, gt).astype(np.uint8)
    for ignore in (255, 7):
        want = np.asarray(JM.confusion_matrix(
            jnp.asarray(pred), jnp.asarray(gt), CLASSES, ignore))
        got = M.confusion_matrix(torch.from_numpy(pred),
                                 torch.from_numpy(gt), CLASSES, ignore)
        np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[7].sum()) == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_iou_and_pixel_accuracy_match_reference(seed):
    """Within 1e-6; a class that is absent from labels and predictions
    has no union and stays out of the mean."""
    pred, gt = _maps(seed)
    pred[pred == 5], gt[gt == 5] = 4, 4               # class 5 is absent
    cm = M.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(gt),
                            CLASSES)
    jcm = jnp.asarray(cm.numpy().astype(np.int32))
    want_iou, want_miou = JM.iou_from_confusion(jcm)
    iou, miou = M.iou_from_confusion(cm)
    np.testing.assert_allclose(iou.numpy(), np.asarray(want_iou), atol=1e-6)
    assert float(miou) == pytest.approx(float(want_miou), abs=1e-6)
    assert float(iou[5]) == 0.0
    present = np.delete(iou.numpy(), 5)
    assert float(miou) == pytest.approx(present.mean(), abs=1e-12)
    assert float(M.pixel_accuracy(cm)) == pytest.approx(
        float(JM.pixel_accuracy(jcm)), abs=1e-6)
    empty = torch.zeros((CLASSES, CLASSES), dtype=torch.int64)
    assert float(M.iou_from_confusion(empty)[1]) == 0.0
    assert float(M.pixel_accuracy(empty)) == 0.0


def test_mean_iou_and_get_iou_match_reference(tmp_path, capsys):
    """The streaming evaluator over three batches, and the CLI-parity
    ``get_iou`` with its report file."""
    batches = [_maps(s) for s in (4, 5, 6)]
    jev, ev = JM.MeanIoU(CLASSES), M.MeanIoU(CLASSES)
    assert ev.matrix.shape == (CLASSES, CLASSES) and ev.matrix.sum() == 0
    for pred, gt in batches:
        jev.update(jnp.asarray(pred), jnp.asarray(gt))
        ev.update(torch.from_numpy(pred), torch.from_numpy(gt))
    np.testing.assert_array_equal(ev.matrix, jev.matrix)
    (iou, miou), (want_iou, want_miou) = ev.result(), jev.result()
    np.testing.assert_allclose(iou, want_iou, atol=1e-6)
    assert miou == pytest.approx(want_miou, abs=1e-6)
    ev.reset()
    assert ev.matrix.sum() == 0

    pairs = [(gt, pred) for pred, gt in batches]
    want = JM.get_iou(pairs, CLASSES, str(tmp_path / "ref.txt"))
    got = M.get_iou(pairs, CLASSES, str(tmp_path / "port.txt"))
    assert got[0] == pytest.approx(want[0], abs=1e-6)
    np.testing.assert_allclose(got[1], want[1], atol=1e-6)
    assert (tmp_path / "port.txt").read_text() \
        == (tmp_path / "ref.txt").read_text()
    assert "meanIoU" in capsys.readouterr().out


# --- the eval step -----------------------------------------------------------

def _calibrated(arch, seed=0):
    """The port's model from a seed, BN running statistics from one
    momentum-1 train pass (dropout off) over seeded images; the JAX model
    and the converted variables."""
    model = build_model(arch, CLASSES, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    rates = {m: m.rate for m in model.modules() if isinstance(m, Dropout)}
    for bn in bns:
        bn.momentum = 1.0
    for drop in rates:
        drop.rate = 0.0
    calib = np.random.RandomState(5).randn(2, 3, *HW).astype(np.float32)
    with torch.no_grad():
        model.train()(torch.from_numpy(calib))
    for bn in bns:
        bn.momentum = 0.1
    for drop, rate in rates.items():
        drop.rate = rate
    model.eval()
    return (jax_build_model(arch, CLASSES),
            convert.to_variables(model.state_dict(), model), model)


@pytest.fixture(scope="module", params=["enet", "fastscnn"])
def arch_pair(request):
    return _calibrated(request.param)


def _batch(seed, n=2, hw=HW):
    rng = np.random.RandomState(seed)
    img = rng.randn(n, 3, *hw).astype(np.float32)
    lab = rng.randint(0, CLASSES, (n, *hw)).astype(np.int32)
    lab[:, hw[0] // 2 - 2:hw[0] // 2 + 2] = 255
    return img, lab


def _both_eval_steps(arch_pair, img, lab, valid=None):
    jmodel, variables, model = arch_pair
    jbatch = {"image": jnp.asarray(img.transpose(0, 2, 3, 1)),
              "label": jnp.asarray(lab)}
    tbatch = {"image": torch.from_numpy(img), "label": torch.from_numpy(lab)}
    if valid is not None:
        jbatch["valid"], tbatch["valid"] = np.int32(valid), valid
    with jax.disable_jit():
        want = jax_make_eval_step(jmodel, CLASSES)(variables, jbatch)
    return want, make_eval_step(model, CLASSES)(tbatch)


@pytest.mark.parametrize("valid", [None, 1])
def test_eval_step_matches_reference(arch_pair, valid):
    """The class map agrees with the reference's but for near-ties (rate
    <= 1e-4); the confusion matrices are equal where the maps agree, and
    otherwise differ by two entries a mismatched pixel; with ``valid``
    the rows past it count for nothing."""
    img, lab = _batch(1)
    (want_pred, want_cm), (pred, cm) = _both_eval_steps(arch_pair, img, lab,
                                                        valid)
    want_pred, want_cm = np.asarray(want_pred), np.asarray(want_cm)
    assert pred.dtype == torch.int32 and tuple(pred.shape) == (2, *HW)
    assert cm.dtype == torch.int64 and tuple(cm.shape) == (CLASSES, CLASSES)
    assert len(np.unique(want_pred)) > 3
    mismatched = int((pred.numpy() != want_pred).sum())
    assert mismatched <= 1e-4 * want_pred.size
    assert int(np.abs(cm.numpy() - want_cm).sum()) <= 2 * mismatched
    rows = lab if valid is None else lab[:valid]
    assert int(cm.sum()) == int((rows != 255).sum())
    assert not arch_pair[2].training


def test_eval_step_shape_error_is_the_references(arch_pair):
    img, lab = _batch(2)
    lab = lab[:, :-8]
    with pytest.raises(ValueError) as want:
        _both_eval_steps((arch_pair[0], arch_pair[1], None), img, lab)
    with pytest.raises(ValueError) as got:
        make_eval_step(arch_pair[2], CLASSES)(
            {"image": torch.from_numpy(img), "label": torch.from_numpy(lab)})
    assert str(got.value) == str(want.value)
    assert "model output (64, 128) != label (56, 128)" in str(got.value)


# --- run_eval ----------------------------------------------------------------

class _Loader(list):
    batch_size = 3


def test_run_eval_matches_reference():
    """Three batches of 3, 3 and 1 images (the last one padded to 3 and
    masked by ``valid``), one without labels that is skipped: the
    confusion matrix equals the reference's but for near-tie pixels, and
    equals the sum over the un-padded batches; ``per_image`` sees each
    real row once."""
    jmodel, variables, model = _calibrated("fastscnn", seed=1)
    img, lab = _batch(3, n=7)
    nhwc = img.transpose(0, 2, 3, 1)
    loader = _Loader([{"image": nhwc[0:3], "label": lab[0:3]},
                      {"image": nhwc[3:6]},
                      {"image": nhwc[3:6], "label": lab[3:6]},
                      {"image": nhwc[6:7], "label": lab[6:7]}])
    with jax.disable_jit():
        want = JEV.run_eval(jax_make_eval_step(jmodel, CLASSES), variables,
                            loader, lambda x: x, CLASSES)
    seen = []
    step = make_eval_step(model, CLASSES)
    got = EV.run_eval(step, loader, lambda x: x.permute(0, 3, 1, 2), CLASSES,
                      per_image=lambda i, p, b: seen.append((i, p.shape)))
    assert got.dtype == np.int64 and got.shape == (CLASSES, CLASSES)
    assert int(got.sum()) == int((lab != 255).sum())
    assert int(np.abs(got - want).sum()) <= 2 * 1e-4 * lab.size
    assert seen == [(i, HW) for i in (0, 1, 2, 0, 1, 2, 0)]
    direct = sum(step({"image": torch.from_numpy(img[s]),
                       "label": torch.from_numpy(lab[s])})[1].numpy()
                 for s in (slice(0, 3), slice(3, 6), slice(6, 7)))
    np.testing.assert_array_equal(got, direct)
    # a plain list of batches: the first batch's size is the eval batch
    np.testing.assert_array_equal(
        EV.run_eval(step, list(loader), lambda x: x.permute(0, 3, 1, 2),
                    CLASSES), got)


def test_pad_batch_to_and_eval_batch_size():
    batch = {"image": np.arange(2 * 3, dtype=np.float32).reshape(2, 3),
             "label": np.arange(2, dtype=np.int32), "name": "x"}
    padded, real = EV.pad_batch_to(batch, 4)
    assert real == 2 and padded["name"] == "x"
    np.testing.assert_array_equal(padded["label"], [0, 1, 1, 1])
    np.testing.assert_array_equal(padded["image"][2:], batch["image"][[1, 1]])
    assert EV.pad_batch_to(batch, 2)[0]["image"] is batch["image"]
    with pytest.raises(ValueError, match="exceeds"):
        EV.pad_batch_to(batch, 1)
    assert EV.eval_batch_size(5) == JEV.eval_batch_size(5) == 5
