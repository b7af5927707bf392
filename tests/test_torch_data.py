"""The port's data pipeline against the reference's, on the CPU, from the
same seeds.

Equal: synthetic items, packed manifest records, the inform statistics
(and their pickle cache across packages), the loader's batches over two
epochs, cv2-nearest label resizing, augmented labels, the builders'
statistics and loader lengths. Augmented images: within AUG_REL of the
reference's largest magnitude, given the reference's own draws (a
jax.random key's scale branch, crop offsets and mirror flags, replayed
here). The eval transform: within EVAL_REL of it. PNGs: PIL reads back
the port's writer's pixels.
"""
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from esn_tpu.data import augment as JA
from esn_tpu.data import builders as JBLD
from esn_tpu.data import datasets as JD
from esn_tpu.data import inform as JI
from esn_tpu.data import loader as JL
from esn_tpu.data import palettes as JP
from esn_tpu.ops.resize import resize_nearest_cv2 as jax_resize_nearest_cv2
from esn_tpu_torch.data import augment as PA
from esn_tpu_torch.data import builders as PBLD
from esn_tpu_torch.data import datasets as PD
from esn_tpu_torch.data import inform as PI
from esn_tpu_torch.data import loader as PL
from esn_tpu_torch.data import palettes as PP
from esn_tpu_torch.data import native
from esn_tpu_torch.data.png import write_png
from esn_tpu_torch.ops.resize import resize_nearest_cv2

# Normalized images reach ~150; the two packages' bilinear resizes weight
# the same two taps, computed in other orders in f32. Read on the CPU:
# 3.7e-6 of the largest magnitude at the minifying scales of reference
# mode, 1.6e-6 in batch mode, one f32 ulp in the eval transform.
AUG_REL, EVAL_REL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's tests: the quick tier runs six
    workers on a few cores, and torch's OpenMP threads, one team per
    worker, then spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _equal_items(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("name,hw,labels", [
    ("cityscapes", (100, 150), True), ("cityscapes", (64, 128), False),
    ("camvid", (72, 96), True), ("camvid", (37, 53), True)])
def test_synthetic_items_equal(name, hw, labels):
    ref = JD.SyntheticDataset(JD.get_spec(name), length=3, hw=hw, seed=7,
                              with_labels=labels)
    port = PD.SyntheticDataset(PD.get_spec(name), length=3, hw=hw, seed=7,
                               with_labels=labels)
    assert len(port) == len(ref) and port.hw == ref.hw
    for i in range(3):
        _equal_items(ref[i], port[i])
    with pytest.raises(IndexError):
        port[3]


def test_specs_equal():
    for name in ("cityscapes", "camvid", "CamVid"):
        assert PD.get_spec(name).__dict__ == JD.get_spec(name).__dict__
    with pytest.raises(KeyError):
        PD.get_spec("ade20k")


def test_packed_manifest_equal(tmp_path):
    """Packed ``.npy`` records (image + label channel, unlabeled, and a
    separate label file) and the list file read the same in both."""
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (24, 32, 3)).astype(np.uint8)
    lab = rng.randint(0, 19, (24, 32)).astype(np.uint8)
    np.save(tmp_path / "a.npy", np.concatenate([img, lab[..., None]], -1))
    np.save(tmp_path / "b.npy", img)
    np.save(tmp_path / "b_lab.npy", lab)
    (tmp_path / "list.txt").write_text("a.npy\nb.npy\n\nb.npy b_lab.npy\n")
    ref = JD.ManifestDataset.from_list_file(str(tmp_path / "list.txt"),
                                            JD.CITYSCAPES)
    port = PD.ManifestDataset.from_list_file(str(tmp_path / "list.txt"),
                                             PD.CITYSCAPES)
    assert port.records == ref.records and len(port) == 3
    for i in range(3):
        _equal_items(ref[i], port[i])
    assert "label" not in port[1]


def test_inform_equal_and_cache_shared(tmp_path):
    ds = PD.SyntheticDataset(PD.CAMVID, length=4, hw=(48, 64), seed=3)
    ref = JI.collect_stats(ds.stats_samples(), 11, 11)
    port = PI.collect_stats(ds.stats_samples(), 11, 11)
    for k in ("classWeights", "mean", "std"):
        assert port[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(port[k], ref[k])
    hist = np.array([5, 0, 17, 3], np.int64)
    np.testing.assert_array_equal(PI.compute_class_weights(hist),
                                  JI.compute_class_weights(hist))
    with pytest.raises(ValueError):
        PI.collect_stats([(np.zeros((2, 2, 3)), np.full((2, 2), 12))], 11, 11)
    # a cache the reference wrote serves the port
    cache = str(tmp_path / "inform" / "camvid_inform.pkl")
    JI.load_or_compute_inform(cache, ds.stats_samples, 11, 11)
    cached = PI.load_or_compute_inform(cache, lambda: iter(()), 11, 11)
    np.testing.assert_array_equal(cached["classWeights"], ref["classWeights"])


def test_batch_loader_two_epochs_equal():
    ref_ds = JD.SyntheticDataset(JD.CAMVID, length=7, hw=(32, 48), seed=2)
    port_ds = PD.SyntheticDataset(PD.CAMVID, length=7, hw=(32, 48), seed=2)
    for drop_last in (True, False):
        ref = JL.BatchLoader(ref_ds, 3, shuffle=True, drop_last=drop_last,
                             num_workers=2)
        port = PL.BatchLoader(port_ds, 3, shuffle=True, drop_last=drop_last,
                              num_workers=2)
        assert len(port) == len(ref)
        for epoch in (0, 1):
            ref.set_epoch(epoch)
            port.set_epoch(epoch)
            got, want = list(port), list(ref)
            assert len(got) == len(want)
            for a, b in zip(want, got):
                _equal_items(a, b)


def test_device_prefetch_cpu_yields_the_loader_batches():
    loader = PL.BatchLoader(PD.SyntheticDataset(PD.CAMVID, length=5,
                                                hw=(16, 24)), 2)
    got = list(PL.device_prefetch(iter(loader), "cpu"))
    want = list(loader)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert isinstance(a["image"], torch.Tensor)
        assert isinstance(a["label"], torch.Tensor)
        np.testing.assert_array_equal(a["image"].numpy(), b["image"])
        np.testing.assert_array_equal(a["label"].numpy(), b["label"])
        assert a["name"] == b["name"]


def test_device_prefetch_retires_producer_and_raises_its_error():
    batches = [{"image": np.full((1, 2), i)} for i in range(50)]
    before = set(threading.enumerate())
    gen = PL.device_prefetch(iter(batches), "cpu", size=2)
    assert int(next(gen)["image"][0, 0]) == 0
    gen.close()         # the consumer leaves early
    assert not [t for t in set(threading.enumerate()) - before
                if t.is_alive()]

    def failing():
        yield {"image": np.zeros(1)}
        raise OSError("decode failed")
    gen = PL.device_prefetch(failing(), "cpu")
    next(gen)
    with pytest.raises(OSError, match="decode failed"):
        next(gen)


@pytest.mark.parametrize("h,w,oh,ow", [
    (7, 9, 13, 5), (720, 960, 683, 1365), (144, 192, 72, 96),
    (100, 300, 37, 999), (48, 64, 96, 128), (1024, 2048, 1792, 3584)])
def test_resize_nearest_cv2_equal(h, w, oh, ow):
    x = np.random.RandomState(h).randint(0, 255, (2, h, w)).astype(np.int32)
    want = np.asarray(jax_resize_nearest_cv2(jnp.asarray(x), (oh, ow)))
    got = resize_nearest_cv2(torch.from_numpy(x), (oh, ow))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


SOURCE, CROP, B = (48, 64), (32, 48), 4
MEAN = np.array([101.5, 87.25, 120.0], np.float32)


def _reference_draws(key, *, scales, per_image, random_mirror):
    """The scale branch, crop corner and mirror flag of each image that
    the reference's jitted augment draws from ``key``."""
    k_scale, k_crop, k_mirror = jax.random.split(key, 3)
    (ch, cw), (h, w) = CROP, SOURCE

    def room(k):
        s = scales[k]
        if per_image:
            hs, ws = int(np.floor(h * s + 0.5)), int(np.floor(w * s + 0.5))
            return max(hs, ch) - ch + 1, max(ws, cw) - cw + 1
        sh, sw = int(round(ch / s)), int(round(cw / s))
        return max(h, sh) - sh + 1, max(w, sw) - sw + 1

    def corners(key, k):
        ky, kx = jax.random.split(key)
        ry, rx = room(k)
        return (np.asarray(jax.random.randint(ky, (B,), 0, ry)),
                np.asarray(jax.random.randint(kx, (B,), 0, rx)))

    n = len(scales)
    if n == 1:
        idx = [0] * B
        y0, x0 = corners(k_crop, 0)
    elif per_image:
        idx = np.asarray(jax.random.randint(k_scale, (B,), 0, n)).tolist()
        per = [corners(jax.random.fold_in(k_crop, k), k) for k in range(n)]
        y0 = [per[k][0][i] for i, k in enumerate(idx)]
        x0 = [per[k][1][i] for i, k in enumerate(idx)]
    else:
        k = int(jax.random.randint(k_scale, (), 0, n))
        idx = [k] * B
        y0, x0 = corners(k_crop, k)
    flip = np.asarray(jax.random.bernoulli(k_mirror, 0.5, (B,))).tolist() \
        if random_mirror else [False] * B
    return PA.Draws([int(v) for v in idx], [int(v) for v in y0],
                    [int(v) for v in x0], [bool(v) for v in flip])


@pytest.mark.parametrize("mode,random_scale,random_mirror", [
    ("batch", True, True), ("reference", True, True),
    ("batch", False, True), ("reference", False, False)])
def test_augment_matches_reference_given_its_draws(mode, random_scale,
                                                   random_mirror):
    rng = np.random.RandomState(11)
    images = rng.randint(0, 256, (B,) + SOURCE + (3,)).astype(np.uint8)
    labels = rng.randint(0, 19, (B,) + SOURCE).astype(np.int32)
    labels[:, :5] = 255
    kw = dict(crop_hw=CROP, source_hw=SOURCE, mean=MEAN, ignore_label=255,
              random_scale=random_scale, random_mirror=random_mirror,
              per_image_scale=(mode == "reference"))
    ref = JA.make_augment_fn(**kw)
    port = PA.make_augment_fn(**kw)
    flips, branches = 0, set()
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        draws = _reference_draws(key, scales=port.scales,
                                 per_image=(mode == "reference"),
                                 random_mirror=random_mirror)
        want_x, want_y = (np.asarray(v) for v in
                          ref(key, jnp.asarray(images), jnp.asarray(labels)))
        x, y = port(torch.from_numpy(images), torch.from_numpy(labels), draws)
        assert x.shape == (B, 3) + CROP and x.dtype == torch.float32
        assert x.is_contiguous(memory_format=torch.channels_last)
        assert y.dtype == torch.int32
        np.testing.assert_array_equal(y.numpy(), want_y)
        np.testing.assert_allclose(x.permute(0, 2, 3, 1).numpy(), want_x,
                                   rtol=0,
                                   atol=AUG_REL * np.abs(want_x).max())
        flips += sum(draws.flip)
        branches.update(draws.scale)
    # the keys reached several scale branches and both mirror states
    assert len(branches) >= (3 if random_scale else 1)
    assert (0 < flips < 6 * B) if random_mirror else flips == 0


def test_augment_draws_are_seeded_and_in_range():
    aug = PA.make_augment_fn(crop_hw=CROP, source_hw=SOURCE, mean=MEAN,
                             per_image_scale=True)
    a = aug.draw(torch.Generator().manual_seed(3), 16)
    b = aug.draw(torch.Generator().manual_seed(3), 16)
    assert a == b and len(set(a.scale)) > 1
    for s, y0, x0 in zip(a.scale, a.y0, a.x0):
        assert 0 <= y0 < aug._room[s][0] and 0 <= x0 < aug._room[s][1]
    one = PA.make_augment_fn(crop_hw=CROP, source_hw=SOURCE, mean=MEAN)
    assert len(set(one.draw(torch.Generator().manual_seed(1), 8).scale)) == 1


@pytest.mark.parametrize("resize_hw", [None, (24, 40), (64, 96)])
def test_eval_transform_matches_reference(resize_hw):
    images = np.random.RandomState(5).randint(
        0, 256, (2,) + SOURCE + (3,)).astype(np.uint8)
    want = np.asarray(JA.make_eval_transform(mean=MEAN, resize_hw=resize_hw)(
        jnp.asarray(images)))
    got = PA.make_eval_transform(mean=MEAN, resize_hw=resize_hw)(
        torch.from_numpy(images))
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0,
                               atol=EVAL_REL * np.abs(want).max())


def test_builders_synthetic_fallback_equal(tmp_path):
    root = str(tmp_path / "nodata")
    kw = dict(root=root, synthetic_len=6, synthetic_hw=(32, 48),
              num_workers=2)
    ref = JBLD.build_dataset_train("camvid", (16, 24), 2, **kw)
    port = PBLD.build_dataset_train("camvid", (16, 24), 2, **kw)
    for k in ("classWeights", "mean", "std"):
        np.testing.assert_array_equal(port[0][k], ref[0][k])
    assert (len(port[1]), len(port[2])) == (len(ref[1]), len(ref[2])) == (3, 4)
    assert port[3].source_hw == (32, 48) and port[3].crop_hw == (16, 24)
    _equal_items(next(iter(ref[2])), next(iter(port[2])))
    ref_t = JBLD.build_dataset_test("camvid", none_gt=True, batch_size=3, **kw)
    port_t = PBLD.build_dataset_test("camvid", none_gt=True, batch_size=3,
                                     **kw)
    np.testing.assert_array_equal(port_t[0]["mean"], ref_t[0]["mean"])
    _equal_items(next(iter(ref_t[1])), next(iter(port_t[1])))


@pytest.mark.parametrize("shape", [(5, 7), (33, 20, 3), (1, 1)])
def test_png_writer_read_by_pil(tmp_path, shape):
    a = np.random.RandomState(sum(shape)).randint(
        0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "a.png")
    write_png(path, a)
    with Image.open(path) as im:
        assert im.mode == ("L" if a.ndim == 2 else "RGB")
        np.testing.assert_array_equal(np.asarray(im), a)
    back = native.decode_grey(path) if a.ndim == 2 else \
        native.decode_bgr(path)[..., ::-1]
    np.testing.assert_array_equal(back, a)
    with pytest.raises(ValueError):
        write_png(path, a.astype(np.int32))


@pytest.mark.parametrize("dataset", ["cityscapes", "camvid"])
def test_save_predict_writes_the_reference_pixels(tmp_path, dataset):
    rng = np.random.RandomState(1)
    pred = rng.randint(0, 19 if dataset == "cityscapes" else 11,
                       (12, 20)).astype(np.int32)
    pred[0, :4] = 255
    gt = rng.randint(0, 11, (12, 20)).astype(np.int32)
    kw = dict(output_grey=True, output_color=True, gt_color=True)
    JP.save_predict(pred, gt, "x_1.png", dataset, str(tmp_path / "ref"), **kw)
    PP.save_predict(pred, gt, "x_1.png", dataset, str(tmp_path / "port"), **kw)
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [
        "x_1.png", "x_1_color.png", "x_1_gt.png"]
    for name in names:
        with Image.open(tmp_path / "ref" / name) as a, \
                Image.open(tmp_path / "port" / name) as b:
            assert a.mode == b.mode
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(PP.trainid_to_labelid(pred),
                                  JP.trainid_to_labelid(pred))
