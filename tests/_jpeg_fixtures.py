"""The image fixtures of ``tests/data/jpeg/``: files the card's machine,
which has no encoder (no cv2, PIL or libjpeg), decodes in
``chip_smoke.py``'s decode phase, and the sha256 of the reference's
native decoder's output (libjpeg and libpng, ``esn_tpu.data.native``) for
each, BGR and grey, in ``SHA256.json`` (a colour PNG's grey is
``cv2.imread``'s, which the port follows and the reference's libpng
does not).

    python tests/_jpeg_fixtures.py [--check | --sweep]

writes the files and the hashes (``--check``: only compares the files'
decodes with the hashes; ``--sweep``: counts, over cv2's and PIL's JPEGs
at every quality, sampling and mode of ``tests/test_torch_jpeg.py``, the
port's decodes equal bit for bit to the reference's and to
``cv2.imread``'s). JPEGs written by cv2 (qualities 50/75/95/100,
4:2:0, 4:2:2, 4:4:0 and 4:4:4, progressive, restart intervals, optimised
tables) and by PIL (its subsampling, progressive, grey), at sizes that
are not multiples of the MCU; one Adam7-interlaced PNG; and one 2048x1024
4:2:0 JPEG for the decode rate.
"""
import hashlib
import json
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent / "data" / "jpeg"
RATE_FILE = "cityscapes_2048x1024_420.jpg"

# cv2's sampling-factor codes
SAMPLING = {"420": 0x221111, "422": 0x211111, "440": 0x121111,
            "444": 0x111111}
# name -> (writer, size (H, W), options)
CV2 = {
    "cv2_420_q75.jpg": ((37, 53), dict(q=75, s="420")),
    "cv2_420_q50_rst3.jpg": ((50, 70), dict(q=50, s="420", rst=3)),
    "cv2_422_q95_progressive.jpg": ((37, 53), dict(q=95, s="422", prog=1)),
    "cv2_440_q75_rst2.jpg": ((45, 61), dict(q=75, s="440", rst=2)),
    "cv2_440_q100_progressive.jpg": ((45, 61), dict(q=100, s="440",
                                                    prog=1)),
    "cv2_444_q100_progressive_rst1.jpg": ((29, 35), dict(q=100, s="444",
                                                         prog=1, rst=1)),
    "cv2_420_q95_optimize_progressive.jpg": ((61, 45), dict(
        q=95, s="420", prog=1, opt=1)),
    "cv2_420_tiny_3x5.jpg": ((3, 5), dict(q=90, s="420")),
    "cv2_422_tiny_17x3.jpg": ((17, 3), dict(q=90, s="422", prog=1)),
    "cv2_grey_q85.jpg": ((37, 53), dict(q=85, grey=True)),
    "cv2_grey_q50_progressive_rst2.jpg": ((37, 53), dict(q=50, grey=True,
                                                         prog=1, rst=2)),
    RATE_FILE: ((1024, 2048), dict(q=85, s="420", smooth=True)),
}
PIL = {
    "pil_420_progressive.jpg": ((45, 61), dict(subsampling=2,
                                               progressive=True)),
    "pil_422.jpg": ((45, 61), dict(subsampling=1)),
    "pil_444_q95.jpg": ((45, 61), dict(subsampling=0, quality=95)),
    "pil_grey.jpg": ((45, 61), dict(grey=True)),
}
ADAM7 = {"adam7_rgb8.png": (37, 53)}


def image(seed, hw, smooth=False):
    """A seeded RGB image: a random field at 1/8 of the size, upsampled
    bilinearly, plus noise (less of it where ``smooth``)."""
    rng = np.random.RandomState(seed)
    h, w = hw
    low = rng.randint(0, 256, (h // 8 + 2, w // 8 + 2, 3)).astype(np.float64)
    ys = np.linspace(0, low.shape[0] - 1.001, h)
    xs = np.linspace(0, low.shape[1] - 1.001, w)
    y0, x0 = ys.astype(int), xs.astype(int)
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    top = low[y0][:, x0] * (1 - fx) + low[y0][:, x0 + 1] * fx
    bot = low[y0 + 1][:, x0] * (1 - fx) + low[y0 + 1][:, x0 + 1] * fx
    img = top * (1 - fy) + bot * fy
    img += rng.randn(h, w, 3) * (3.0 if smooth else 12.0)
    return np.clip(img, 0, 255).astype(np.uint8)


def write(root=ROOT):
    """Write every fixture into ``root``."""
    import cv2
    from PIL import Image

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from test_torch_native import write_png
    root.mkdir(parents=True, exist_ok=True)
    for i, (name, (hw, o)) in enumerate(sorted(CV2.items())):
        img = image(i, hw, o.get("smooth", False))
        params = [cv2.IMWRITE_JPEG_QUALITY, o["q"],
                  cv2.IMWRITE_JPEG_PROGRESSIVE, o.get("prog", 0),
                  cv2.IMWRITE_JPEG_RST_INTERVAL, o.get("rst", 0),
                  cv2.IMWRITE_JPEG_OPTIMIZE, o.get("opt", 0)]
        if o.get("grey"):
            arr = img[..., 0]
        else:
            arr = img
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[o["s"]]]
        assert cv2.imwrite(str(root / name), arr, params)
    for i, (name, (hw, o)) in enumerate(sorted(PIL.items())):
        img = image(100 + i, hw)
        o = dict(o)
        if o.pop("grey", False):
            Image.fromarray(img[..., 1]).save(root / name, quality=85)
        else:
            Image.fromarray(img).save(root / name, **o)
    for i, (name, hw) in enumerate(sorted(ADAM7.items())):
        write_png(str(root / name), image(200 + i, hw), color=2, interlace=1)


def sha256(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def hashes(decode_bgr, decode_grey, colour_png_grey=None, root=ROOT):
    """{file: {"hw", "bgr", "grey"}} of each fixture's decodes; a colour
    PNG read as grey through ``colour_png_grey`` where given (the
    reference's libpng reads colour as grey otherwise than cv2, which the
    port follows: its grey hash is cv2's)."""
    out = {}
    for name in sorted(list(CV2) + list(PIL) + list(ADAM7)):
        path = str(root / name)
        grey_of = (colour_png_grey if name in ADAM7 and colour_png_grey
                   else decode_grey)
        bgr, grey = decode_bgr(path), grey_of(path)
        out[name] = {"hw": list(bgr.shape[:2]), "bgr": sha256(bgr),
                     "grey": sha256(grey)}
    return out


def cv2_grey(path):
    import cv2
    return cv2.imread(path, cv2.IMREAD_GRAYSCALE)


def recorded(root=ROOT):
    return json.loads((root / "SHA256.json").read_text())


def sweep(ref):
    """{"files", "decodes", "equal_reference", "equal_cv2"} over the
    sweep (BGR and grey of each file)."""
    import tempfile

    import cv2
    from PIL import Image

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from esn_tpu_torch.data import native
    modes = ({}, {"prog": 1}, {"rst": 3}, {"opt": 1}, {"prog": 1, "rst": 1})
    sizes = ((37, 53), (50, 70), (3, 5), (17, 3), (1024, 2048))
    count = {"files": 0, "decodes": 0, "equal_reference": 0, "equal_cv2": 0}
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for i, hw in enumerate(sizes):
            img = image(i, hw, smooth=hw[0] > 100)
            for q in (50, 75, 95, 100):
                for s in [None, *SAMPLING]:
                    for k, m in enumerate(modes):
                        path = f"{tmp}/{i}_{q}_{s}_{k}.jpg"
                        params = [
                            cv2.IMWRITE_JPEG_QUALITY, q,
                            cv2.IMWRITE_JPEG_PROGRESSIVE, m.get("prog", 0),
                            cv2.IMWRITE_JPEG_RST_INTERVAL, m.get("rst", 0),
                            cv2.IMWRITE_JPEG_OPTIMIZE, m.get("opt", 0)]
                        if s:
                            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                       SAMPLING[s]]
                        cv2.imwrite(path, img if s else img[..., 0], params)
                        paths.append(path)
            for sub in (0, 1, 2):
                for prog in (False, True):
                    path = f"{tmp}/pil_{i}_{sub}_{int(prog)}.jpg"
                    Image.fromarray(img).save(path, subsampling=sub,
                                              progressive=prog)
                    paths.append(path)
        for path in paths:
            count["files"] += 1
            for ours, theirs, flag in (
                    (native.decode_bgr, ref.decode_bgr, cv2.IMREAD_COLOR),
                    (native.decode_grey, ref.decode_grey,
                     cv2.IMREAD_GRAYSCALE)):
                got = ours(path)
                count["decodes"] += 1
                count["equal_reference"] += bool(np.array_equal(
                    got, theirs(path)))
                count["equal_cv2"] += bool(np.array_equal(
                    got, cv2.imread(path, flag)))
    return count


def main(argv):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from esn_tpu.data import native as ref
    if not ref.available():
        raise SystemExit("the reference's native library does not load")
    if "--sweep" in argv:
        print(json.dumps(sweep(ref)))
        return 0
    if "--check" not in argv:
        write()
        (ROOT / "SHA256.json").write_text(json.dumps(
            hashes(ref.decode_bgr, ref.decode_grey, cv2_grey), indent=1)
            + "\n")
    got = hashes(ref.decode_bgr, ref.decode_grey, cv2_grey)
    assert got == recorded(), "the fixtures decode otherwise than recorded"
    total = sum(os.path.getsize(ROOT / n) for n in os.listdir(ROOT))
    print(f"{len(got)} fixtures, {total} bytes in {ROOT}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
