"""The port's JPEG decoder (``esn_tpu_torch/native/jpeg.cc``) and its Adam7
PNGs (``native/esn_native.cc``), on the CPU, with no libjpeg in the port:

- JPEGs written here by cv2 (qualities 50/75/95/100; 4:2:0, 4:2:2, 4:4:0
  and 4:4:4; baseline, progressive, restart intervals, optimised tables)
  and by PIL (its subsampling, progressive, grey), at sizes that are not
  multiples of the MCU, down to chroma 1-2 columns wide: BGR and grey bit
  for bit against the reference's native decoder (``esn_tpu.data.native``
  on libjpeg-turbo), and against ``cv2.imread`` within the reference's own
  limits (``tests/test_native_loader.py``: mean < 1.5, max <= 16);
- the kinds it refuses, each by its named error: arithmetic coding,
  lossless and hierarchical frames, 12-bit samples, CMYK (and YCCK) and
  RGB files, other sampling factors; and corrupt files;
- Adam7-interlaced PNGs of every colour type and bit depth the decoder
  reads, at sizes whose passes are empty or ragged, bit for bit against
  ``cv2.imread`` (libpng) and the reference's native decoder;
- ``tests/data/jpeg/``, the card's fixtures, decode to the reference's
  hashes recorded beside them;
- planted faults in copies of the sources (an IDCT rounding, an
  upsampling bias off by one, the passes' rows one row down) break the
  bit-for-bit bounds;
- the library is keyed by every source it compiles; JPEG through the
  prefetch pipeline.
"""
import ctypes
import os
import shutil
import struct
import subprocess

import numpy as np
import pytest

import _jpeg_fixtures as JF
from esn_tpu_torch.data import native
from test_torch_native import ref_native, write_png  # noqa: F401

cv2 = pytest.importorskip("cv2")

SIZES = ((37, 53), (50, 70), (3, 5), (17, 3))
QUALITIES = (50, 75, 95, 100)
MODES = {"baseline": {}, "progressive": {"prog": 1}, "restart": {"rst": 3},
         "optimize": {"opt": 1}, "progressive_restart": {"prog": 1, "rst": 1}}


def _cv2_jpeg(path, img, q, sampling=None, prog=0, rst=0, opt=0):
    params = [cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_PROGRESSIVE, prog,
              cv2.IMWRITE_JPEG_RST_INTERVAL, rst, cv2.IMWRITE_JPEG_OPTIMIZE,
              opt]
    if sampling is not None:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, JF.SAMPLING[sampling]]
    assert cv2.imwrite(str(path), img, params)
    return str(path)


def _check(path, ref):
    """BGR and grey: bit for bit the reference's decode, within the
    reference's limits of cv2's; the header's size."""
    for decode, ref_decode, flag in (
            (native.decode_bgr, ref.decode_bgr, cv2.IMREAD_COLOR),
            (native.decode_grey, ref.decode_grey, cv2.IMREAD_GRAYSCALE)):
        got = decode(path)
        np.testing.assert_array_equal(got, ref_decode(path), err_msg=path)
        diff = np.abs(got.astype(int) - cv2.imread(path, flag).astype(int))
        assert diff.mean() < 1.5 and diff.max() <= 16, path
    assert native.image_info(path) == got.shape[:2]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("sampling", list(JF.SAMPLING))
def test_cv2_jpegs_bit_for_bit_against_the_reference(tmp_path, ref_native,
                                                     sampling, mode):
    for i, hw in enumerate(SIZES):
        img = JF.image(i, hw)
        for q in QUALITIES:
            _check(_cv2_jpeg(tmp_path / f"{hw}_{q}.jpg", img, q, sampling,
                             **MODES[mode]), ref_native)


@pytest.mark.parametrize("mode", list(MODES))
def test_grey_jpegs_bit_for_bit_against_the_reference(tmp_path, ref_native,
                                                      mode):
    for i, hw in enumerate(SIZES):
        img = JF.image(10 + i, hw)[..., 0]
        for q in QUALITIES:
            _check(_cv2_jpeg(tmp_path / f"{hw}_{q}.jpg", img, q,
                             **MODES[mode]), ref_native)


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("subsampling", [0, 1, 2, "grey"])
def test_pil_jpegs_bit_for_bit_against_the_reference(tmp_path, ref_native,
                                                     subsampling, progressive):
    Image = pytest.importorskip("PIL.Image")
    for i, hw in enumerate(SIZES):
        img = JF.image(20 + i, hw)
        path = str(tmp_path / f"{i}.jpg")
        if subsampling == "grey":
            Image.fromarray(img[..., 2]).save(path, progressive=progressive)
        else:
            Image.fromarray(img).save(path, subsampling=subsampling,
                                      progressive=progressive, quality=90)
        _check(path, ref_native)


# --- what it refuses ---------------------------------------------------------

def _marker_at(data, codes):
    i = 2
    while i < len(data):
        assert data[i] == 0xFF
        if data[i + 1] in codes:
            return i
        i += 2 + struct.unpack(">H", data[i + 2:i + 4])[0]
    raise AssertionError(f"no marker of {codes}")


def _edit(src, out, edit):
    data = bytearray(open(src, "rb").read())
    edit(data)
    with open(out, "wb") as f:
        f.write(bytes(data))
    return str(out)


def _refused(tmp_path):
    """name -> (path, message) of each file the decoder refuses."""
    src = _cv2_jpeg(tmp_path / "base.jpg", JF.image(30, (37, 53)), 90, "420")
    sof = _marker_at(open(src, "rb").read(), (0xC0,))

    def code(c):
        return lambda d: d.__setitem__(sof + 1, c)

    cases = {f"sof{c - 0xC0}": (code(c), m) for c, m in (
        (0xC9, "arithmetic"), (0xCA, "arithmetic"), (0xCB, "arithmetic"),
        (0xC3, "lossless"), (0xC5, "hierarchical"), (0xC7, "lossless"))}
    cases["12-bit"] = (lambda d: d.__setitem__(sof + 4, 12), "12-bit")
    cases["luma 4x1"] = (lambda d: d.__setitem__(sof + 11, 0x41),
                         "sampling")
    cases["chroma 2x1"] = (lambda d: d.__setitem__(sof + 14, 0x21),
                           "sampling")
    cases["no frame"] = (lambda d: d.__setitem__(sof + 1, 0xFE), "corrupt")
    cases["zero width"] = (lambda d: d.__setitem__(slice(sof + 7, sof + 9),
                                                   b"\0\0"), "corrupt")

    def rgb(d):     # no JFIF marker, components named R, G, B
        app0 = _marker_at(bytes(d), (0xE0,))
        n = 2 + struct.unpack(">H", bytes(d[app0 + 2:app0 + 4]))[0]
        at = _marker_at(bytes(d), (0xC0,)) - n
        del d[app0:app0 + n]
        for k, cid in enumerate(b"RGB"):
            d[at + 10 + 3 * k] = cid
        sos = _marker_at(bytes(d), (0xDA,))
        for k, cid in enumerate(b"RGB"):
            d[sos + 5 + 2 * k] = cid
    cases["rgb"] = (rgb, "YCbCr")
    out = {name: (_edit(src, tmp_path / f"{i}.jpg", edit), m)
           for i, (name, (edit, m)) in enumerate(cases.items())}
    try:
        from PIL import Image
        path = str(tmp_path / "cmyk.jpg")
        Image.fromarray(np.dstack([JF.image(31, (16, 24)),
                                   JF.image(32, (16, 24))[..., :1]]),
                        "CMYK").save(path)
        out["cmyk"] = (path, "CMYK")
    except ImportError:
        pass
    return out


REFUSED = ["sof9", "sof10", "sof11", "sof3", "sof5", "sof7", "12-bit",
           "luma 4x1", "chroma 2x1", "no frame", "zero width", "rgb", "cmyk"]


@pytest.mark.parametrize("name", REFUSED)
def test_refused_jpegs_raise_their_named_error(tmp_path, name):
    cases = _refused(tmp_path)
    if name not in cases:
        pytest.skip("PIL is needed to write a CMYK JPEG")
    path, message = cases[name]
    for decode in (native.decode_bgr, native.decode_grey):
        with pytest.raises(ValueError, match=message):
            decode(path)


def test_the_refused_codes_are_named():
    """Every error code of jpeg.h has its message in ``_ERRORS``."""
    header = (native.SRC_DIR / "jpeg.h").read_text()
    codes = [int(v) for v in
             __import__("re").findall(r"= (-\d+),", header)]
    assert codes and all(c in native._ERRORS for c in codes)
    assert -3 not in native._ERRORS and -6 not in native._ERRORS


# --- Adam7 -------------------------------------------------------------------

def _adam7_kinds():
    rng = np.random.RandomState(5)
    pal = rng.randint(0, 256, (256, 3))
    return {
        "rgb8": lambda hw: dict(samples=rng.randint(0, 256, hw + (3,)),
                                color=2),
        "rgb16": lambda hw: dict(samples=rng.randint(0, 65536, hw + (3,)),
                                 color=2, depth=16),
        "rgba8": lambda hw: dict(samples=rng.randint(0, 256, hw + (4,)),
                                 color=6),
        "grey8": lambda hw: dict(samples=rng.randint(0, 256, hw), color=0),
        "grey16": lambda hw: dict(samples=rng.randint(0, 65536, hw), color=0,
                                  depth=16),
        "greyalpha8": lambda hw: dict(samples=rng.randint(0, 256, hw + (2,)),
                                      color=4),
        **{f"grey{b}": (lambda b: lambda hw: dict(
            samples=rng.randint(0, 2 ** b, hw), color=0, depth=b))(b)
           for b in (1, 2, 4)},
        **{f"pal{b}": (lambda b: lambda hw: dict(
            samples=rng.randint(0, 2 ** b, hw), color=3, depth=b,
            palette=pal[:2 ** b]))(b) for b in (1, 2, 4, 8)},
    }


ADAM7_KINDS = sorted(_adam7_kinds())
ADAM7_SIZES = ((1, 1), (3, 5), (9, 13), (37, 53))


@pytest.mark.parametrize("hw", ADAM7_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ADAM7_KINDS)
def test_adam7_equals_cv2_imread(tmp_path, kind, hw):
    path = write_png(str(tmp_path / "a.png"), interlace=1,
                     **_adam7_kinds()[kind](hw))
    np.testing.assert_array_equal(native.decode_bgr(path),
                                  cv2.imread(path, cv2.IMREAD_COLOR))
    np.testing.assert_array_equal(native.decode_grey(path),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("kind", ["rgb8", "grey8"])
def test_adam7_equals_the_reference(tmp_path, ref_native, kind):
    for hw in ADAM7_SIZES:
        path = write_png(str(tmp_path / f"{hw}.png"), interlace=1,
                         **_adam7_kinds()[kind](hw))
        plain = write_png(str(tmp_path / f"{hw}_plain.png"),
                          **_adam7_kinds()[kind](hw))
        pairs = [(native.decode_bgr, ref_native.decode_bgr)]
        if kind == "grey8":     # the reference's libpng reads colour as
            pairs.append((native.decode_grey,   # grey otherwise than cv2
                          ref_native.decode_grey))
        for decode, ref_decode in pairs:
            np.testing.assert_array_equal(decode(path), ref_decode(path))
            np.testing.assert_array_equal(decode(plain), ref_decode(plain))


# --- the card's fixtures -----------------------------------------------------

FIXTURES = sorted(JF.recorded())


@pytest.mark.parametrize("name", FIXTURES)
def test_fixtures_decode_to_the_recorded_hashes(name):
    want = JF.recorded()[name]
    path = str(JF.ROOT / name)
    bgr, grey = native.decode_bgr(path), native.decode_grey(path)
    assert list(bgr.shape[:2]) == want["hw"]
    assert JF.sha256(bgr) == want["bgr"] and JF.sha256(grey) == want["grey"]


def test_the_recorded_hashes_are_the_reference_decoders(ref_native):
    assert JF.hashes(ref_native.decode_bgr, ref_native.decode_grey,
                     JF.cv2_grey) == JF.recorded()
    total = sum(os.path.getsize(JF.ROOT / n) for n in os.listdir(JF.ROOT))
    assert total < 1 << 20
    assert JF.recorded()[JF.RATE_FILE]["hw"] == [1024, 2048]


# --- planted faults ----------------------------------------------------------

MUTANTS = {
    # the IDCT's descaling truncated instead of rounded
    "idct_rounding": ("jpeg.cc",
                      "return (x + (int64_t(1) << (n - 1))) >> n;",
                      "return x >> n;"),
    # h2v2's bias of the even output column off by one
    "upsample_bias": ("jpeg.cc",
                      "colsum[c] * 3 + colsum[c - 1] + 8) >> 4",
                      "colsum[c] * 3 + colsum[c - 1] + 7) >> 4"),
    # each pass's rows scattered one row down (the byte counts unchanged)
    "adam7_pass": ("esn_native.cc", "const int y = ps.y0 + r * ps.dy;",
                   "const int y = std::min(ps.y0 + 1 + r * ps.dy, hd.h - 1);"),
}


class _Library:
    """A decoder library built from a copy of the sources; decodes like
    ``native.decode_bgr`` / ``decode_grey``."""

    def __init__(self, path):
        self.lib = ctypes.CDLL(path)
        for name, (args, res) in native._SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes, fn.restype = args, res

    def decode(self, path, channels):
        h, w = native.image_info(path)
        out = np.empty((h, w, channels) if channels == 3 else (h, w),
                       np.uint8)
        rc = self.lib.esn_decode(os.fsencode(path), channels, native._u8(out),
                                 -1, -1)
        assert rc >= 0, rc
        return out


@pytest.fixture(scope="module")
def mutants(tmp_path_factory):
    """name -> the library built from the sources with that one edit."""
    root = tmp_path_factory.mktemp("mutants")
    procs = {}
    for name, (source, old, new) in MUTANTS.items():
        src = root / name
        shutil.copytree(native.SRC_DIR, src)
        text = (src / source).read_text()
        assert text.count(old) == 1, (name, old)
        (src / source).write_text(text.replace(old, new))
        so = str(root / f"{name}.so")
        procs[name] = (so, subprocess.Popen(
            [native._compiler(), *native.CXX_FLAGS, "-o", so,
             *(str(src / s) for s in native.SOURCES)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate(timeout=300)[0]
        assert proc.returncode == 0, log
        out[name] = _Library(so)
    return out


def _mutant_files(tmp_path):
    img = JF.image(40, (37, 53))
    files = [_cv2_jpeg(tmp_path / f"{s}.jpg", img, 90, s)
             for s in ("420", "444")]
    files.append(write_png(str(tmp_path / "adam7.png"), img, color=2,
                           interlace=1))
    return files


@pytest.mark.parametrize("name", sorted(MUTANTS))
def test_planted_faults_break_the_bit_for_bit_bound(tmp_path, mutants,
                                                    ref_native, name):
    files = _mutant_files(tmp_path)
    differ = []
    for path in files:
        want = ref_native.decode_bgr(path)
        np.testing.assert_array_equal(native.decode_bgr(path), want)
        differ.append(not np.array_equal(mutants[name].decode(path, 3), want))
    # each fault shows where its code runs: the IDCT in both JPEGs, the
    # h2v2 bias in the 4:2:0 file alone, the pass in the PNG alone
    assert differ == {"idct_rounding": [True, True, False],
                      "upsample_bias": [True, False, False],
                      "adam7_pass": [False, False, True]}[name]


# --- the library, the pipeline -----------------------------------------------

def test_every_source_keys_the_library(tmp_path, monkeypatch):
    copy = tmp_path / "native"
    shutil.copytree(native.SRC_DIR, copy)
    monkeypatch.setattr(native, "SRC_DIR", copy)
    first = native.library_path()
    for name in ("jpeg.h", "jpeg.cc", "esn_native.cc"):
        with open(copy / name, "a") as f:
            f.write("\n// edited\n")
        now = native.library_path()
        assert now != first, name
        first = now


def test_jpeg_through_the_pipeline(tmp_path):
    paths = [_cv2_jpeg(tmp_path / f"{i}.jpg", JF.image(50 + i, (45, 61)), 85,
                       s, prog=i % 2)
             for i, s in enumerate(("420", "422", "440", "444"))]
    hw = (32, 48)
    with native.NativePipeline([(p, None) for p in paths], hw,
                               threads=3) as pipe:
        got = list(pipe.epoch([3, 1, 0, 2]))
    assert [r for r, _, _ in got] == [3, 1, 0, 2]
    for rec, img, lab in got:
        assert lab is None
        np.testing.assert_array_equal(img, native.decode_bgr(paths[rec], hw))
