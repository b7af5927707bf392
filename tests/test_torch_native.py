"""The port's image decoder, ``esn_tpu_torch/data/native.py`` and
``native/esn_native.cc``: its inflate on zlib's streams (through decode),
every kind of PNG
against ``cv2.imread`` bit for bit (fixtures written by cv2, by PIL and by
an encoder here that sets each row's filter), decode + resize against the
reference's native loader bit for bit and within 1 of ``cv2.resize``, the
files it refuses, JPEG within the reference's own limits, the prefetch
pipeline, ``ManifestDataset`` against the reference's, and the packing
tool.
"""
import os
import struct
import subprocess
import zlib

import numpy as np
import pytest

from esn_tpu_torch.data import native

cv2 = pytest.importorskip("cv2")

# --- a PNG encoder with a chosen filter for each row --------------------------


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xffffffff))


def _filter_row(row, prev, kind, bpp):
    """PNG filter ``kind`` (0-4) of one row of bytes (int arrays)."""
    left = np.concatenate([np.zeros(bpp, int), row[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, int), prev[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(row)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = prev
    elif kind == 3:
        pred = (left + prev) // 2
    else:
        p = left + prev - upleft
        pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, prev, upleft))
    return ((row - pred) % 256).astype(np.uint8)


# Adam7's passes: (x0, y0, dx, dy)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _raw_row(line, depth):
    """One row of samples (ints) as the bytes of a row of ``depth`` bits."""
    if depth == 16:
        return np.stack([line >> 8, line & 255], -1).reshape(-1)
    if depth == 8:
        return line
    per = 8 // depth
    pad = (-len(line)) % per
    v = np.concatenate([line, np.zeros(pad, np.int64)]).reshape(-1, per)
    return (v << (8 - depth * (np.arange(per) + 1))).sum(1)


def write_png(path, samples, *, color, depth=8, palette=None,
              filters=(0, 1, 2, 3, 4), interlace=0, level=6,
              strategy=zlib.Z_DEFAULT_STRATEGY):
    """Write ``samples`` ((H, W) or (H, W, C) ints, one per channel) as a
    PNG of ``color`` type and bit ``depth``; row y takes filter
    ``filters[y % len(filters)]`` (with ``interlace=1``, the passes of
    Adam7 in turn, each a sub-image whose first row is filtered against
    zeros, the filters counted on over all of them); zlib at ``level`` and
    ``strategy``."""
    s = np.asarray(samples)
    h, w = s.shape[:2]
    s = s.reshape(h, w, -1).astype(np.int64)
    ch = s.shape[2]
    bpp = max(1, ch * depth // 8)
    images = ([s[y0::dy, x0::dx] for x0, y0, dx, dy in ADAM7] if interlace
              else [s])
    out, y = [], 0
    for sub in images:
        if sub.shape[0] == 0 or sub.shape[1] == 0:
            continue            # an empty pass has no bytes at all
        rows = [_raw_row(sub[r].reshape(-1), depth).astype(int)
                for r in range(sub.shape[0])]
        prev = np.zeros_like(rows[0])
        for row in rows:
            kind = filters[y % len(filters)]
            out.append(bytes([kind])
                       + _filter_row(row, prev, kind, bpp).tobytes())
            prev = row
            y += 1
    data = b"\x89PNG\r\n\x1a\n" + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if palette is not None:
        data += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    c = zlib.compressobj(level, zlib.DEFLATED, 15, 9, strategy)
    data += _chunk(b"IDAT", c.compress(b"".join(out)) + c.flush())
    data += _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)
    return path


# --- inflate, through decode -------------------------------------------------

_STRATEGIES = {"default": zlib.Z_DEFAULT_STRATEGY, "filtered": zlib.Z_FILTERED,
               "huffman": zlib.Z_HUFFMAN_ONLY, "rle": zlib.Z_RLE,
               "fixed": zlib.Z_FIXED}


@pytest.mark.parametrize("level", [0, 1, 6, 9])
@pytest.mark.parametrize("strategy", sorted(_STRATEGIES))
def test_inflate_equals_zlib(tmp_path, level, strategy):
    """Grey images whose rows (filter None) are the payloads: zlib's
    streams at every level and strategy decode to them."""
    rng = np.random.RandomState(level)
    payloads = [b"a", b"ab" * 40000,
                rng.randint(0, 256, 70000).astype(np.uint8).tobytes(),
                (np.arange(200000) // 7 % 13).astype(np.uint8).tobytes(),
                # long runs next to noise: lengths up to 258, far distances
                np.repeat(rng.randint(0, 4, 3000), rng.randint(1, 300, 3000)
                          ).astype(np.uint8).tobytes()]
    for i, data in enumerate(payloads):
        a = np.frombuffer(data, np.uint8)
        w = min(len(a), 1000)
        img = np.resize(a, (-(-len(a) // w), w))
        path = write_png(str(tmp_path / f"{i}.png"), img, color=0,
                         filters=(0,), level=level,
                         strategy=_STRATEGIES[strategy])
        np.testing.assert_array_equal(native.decode_grey(path), img)


def test_inflate_refuses_bad_streams(tmp_path):
    """A PNG whose zlib stream is broken: a wrong Adler-32, cut short, a
    bad header, or holding more or less data than the image's rows."""
    img = np.tile(np.arange(256, dtype=np.uint8), (50, 1))
    good = write_png(str(tmp_path / "good.png"), img, color=0, filters=(0,))
    np.testing.assert_array_equal(native.decode_grey(good), img)
    z = _idat(good)
    raw = zlib.decompress(z)
    streams = {"adler": z[:-1] + bytes([z[-1] ^ 1]), "short": z[:len(z) // 2],
               "header": bytes([0x78, 0x9d]) + z[2:], "empty": b"\x00\x00",
               "long": zlib.compress(raw + b"\x00", 6),
               "less": zlib.compress(raw[:-1], 6)}
    head = open(good, "rb").read()
    head = head[:head.index(b"IDAT") - 4]
    for name, stream in streams.items():
        path = str(tmp_path / f"{name}.png")
        with open(path, "wb") as f:
            f.write(head + _chunk(b"IDAT", stream) + _chunk(b"IEND", b""))
        with pytest.raises(ValueError, match="corrupt"):
            native.decode_grey(path)


# --- PNG kinds against cv2.imread ---------------------------------------------

H, W = 37, 53


def _kinds(root):
    """name -> path of a PNG of each kind the decoder supports."""
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
    p = {}

    def at(name):
        return os.path.join(root, name + ".png")

    # cv2 (its own filter choice)
    for name, arr in (
            ("cv2_rgb8", img), ("cv2_grey8", img[..., 0]),
            ("cv2_rgba8", np.dstack([img, img[..., :1]])),
            ("cv2_rgb16", rng.randint(0, 65536, (H, W, 3)).astype(np.uint16)),
            ("cv2_grey16", rng.randint(0, 65536, (H, W)).astype(np.uint16)),
            ("cv2_rgba16", rng.randint(0, 65536, (H, W, 4)).astype(np.uint16)),
            # a colour image that is grey: rgb-to-grey passes it through
            ("cv2_rgb8_grey", np.repeat(img[..., :1], 3, -1))):
        cv2.imwrite(at(name), arr)
        p[name] = at(name)
    # this file's encoder: every filter type, each kind
    for name, kw in (
            ("enc_rgb8", dict(samples=img, color=2)),
            ("enc_grey8", dict(samples=img[..., 1], color=0)),
            ("enc_rgba8", dict(samples=np.dstack([img, img[..., 2:]]),
                               color=6)),
            ("enc_greyalpha8", dict(samples=img[..., :2], color=4)),
            ("enc_rgb16", dict(samples=rng.randint(0, 65536, (H, W, 3)),
                               color=2, depth=16)),
            ("enc_greyalpha16", dict(samples=rng.randint(0, 65536, (H, W, 2)),
                                     color=4, depth=16)),
            ("enc_grey1", dict(samples=rng.randint(0, 2, (H, W)), color=0,
                               depth=1)),
            ("enc_grey2", dict(samples=rng.randint(0, 4, (H, W)), color=0,
                               depth=2)),
            ("enc_grey4", dict(samples=rng.randint(0, 16, (H, W)), color=0,
                               depth=4)),
            ("enc_pal1", dict(samples=rng.randint(0, 2, (H, W)), color=3,
                              depth=1, palette=rng.randint(0, 256, (2, 3)))),
            ("enc_pal2", dict(samples=rng.randint(0, 4, (H, W)), color=3,
                              depth=2, palette=rng.randint(0, 256, (4, 3)))),
            ("enc_pal4", dict(samples=rng.randint(0, 16, (H, W)), color=3,
                              depth=4, palette=rng.randint(0, 256, (16, 3)))),
            ("enc_pal8", dict(samples=rng.randint(0, 256, (H, W)), color=3,
                              palette=rng.randint(0, 256, (256, 3)))),
            # indices past a short palette read black, as in libpng
            ("enc_pal8_short", dict(samples=rng.randint(0, 40, (H, W)),
                                    color=3, palette=rng.randint(
                                        0, 256, (30, 3)))),
            ("enc_rgb8_stored", dict(samples=img, color=2, level=0)),
            ("enc_rgb8_wide", dict(samples=np.tile(img, (2, 7, 1)), color=2,
                                   level=9))):
        p[name] = write_png(at(name), **kw)
    return p


@pytest.fixture(scope="module")
def kinds(tmp_path_factory):
    p = _kinds(str(tmp_path_factory.mktemp("kinds")))
    try:
        from PIL import Image
    except ImportError:
        return p
    rng = np.random.RandomState(1)
    root = os.path.dirname(next(iter(p.values())))
    for bits in (1, 2, 4, 8):
        im = Image.fromarray(rng.randint(0, 2 ** bits, (H, W)).astype(
            np.uint8), "P")
        im.putpalette(list(rng.randint(0, 256, 3 * 2 ** bits)))
        p[f"pil_pal{bits}"] = os.path.join(root, f"pil_pal{bits}.png")
        im.save(p[f"pil_pal{bits}"], bits=bits)
    for name, im in (
            ("pil_grey1", Image.fromarray(rng.randint(0, 2, (H, W)).astype(
                bool))),
            ("pil_grey16", Image.fromarray(rng.randint(0, 65536, (H, W))
                                           .astype(np.uint16))),
            ("pil_greyalpha", Image.fromarray(rng.randint(
                0, 256, (H, W, 2)).astype(np.uint8), "LA")),
            ("pil_rgba", Image.fromarray(rng.randint(
                0, 256, (H, W, 4)).astype(np.uint8), "RGBA")),
            ("pil_rgb_optimized", Image.fromarray(rng.randint(
                0, 256, (H, W, 3)).astype(np.uint8)))):
        p[name] = os.path.join(root, name + ".png")
        im.save(p[name], optimize=True)
    return p


KINDS = sorted([
    "cv2_rgb8", "cv2_grey8", "cv2_rgba8", "cv2_rgb16", "cv2_grey16",
    "cv2_rgba16", "cv2_rgb8_grey", "enc_rgb8", "enc_grey8", "enc_rgba8",
    "enc_greyalpha8", "enc_rgb16", "enc_greyalpha16", "enc_grey1",
    "enc_grey2", "enc_grey4", "enc_pal1", "enc_pal2", "enc_pal4", "enc_pal8",
    "enc_pal8_short", "enc_rgb8_stored", "enc_rgb8_wide", "pil_pal1",
    "pil_pal2", "pil_pal4", "pil_pal8", "pil_grey1", "pil_grey16",
    "pil_greyalpha", "pil_rgba", "pil_rgb_optimized"])


@pytest.mark.parametrize("kind", KINDS)
def test_decode_equals_cv2_imread(kinds, kind):
    if kind not in kinds:
        pytest.skip("PIL is not installed")
    path = kinds[kind]
    for flag, decode in ((cv2.IMREAD_COLOR, native.decode_bgr),
                         (cv2.IMREAD_GRAYSCALE, native.decode_grey)):
        want = cv2.imread(path, flag)
        got = decode(path)
        assert got.dtype == np.uint8 and got.shape == want.shape, flag
        np.testing.assert_array_equal(got, want, err_msg=f"{kind} {flag}")
    assert native.image_info(path) == want.shape[:2]


_GAMMA_CHUNKS = {"gama45455": _chunk(b"gAMA", struct.pack(">I", 45455)),
                 "gama220000": _chunk(b"gAMA", struct.pack(">I", 220000)),
                 "gama30000": _chunk(b"gAMA", struct.pack(">I", 30000)),
                 "gama97000": _chunk(b"gAMA", struct.pack(">I", 97000)),
                 "srgb": _chunk(b"sRGB", b"\x00"),
                 "srgb_gama": _chunk(b"sRGB", b"\x00")
                 + _chunk(b"gAMA", struct.pack(">I", 45455))}


def _with_chunk(path, chunk, before):
    data = open(path, "rb").read()
    at = data.index(before) - 4
    with open(path, "wb") as f:
        f.write(data[:at] + chunk + data[at:])
    return path


@pytest.mark.parametrize("chunk", sorted(_GAMMA_CHUNKS))
@pytest.mark.parametrize("kind,before", [
    ("rgb8", b"IDAT"), ("rgba8", b"IDAT"), ("pal8", b"PLTE"),
    ("pal4", b"PLTE"), ("pal8", b"IDAT")])
def test_gamma_chunks_equal_cv2(tmp_path, kind, before, chunk):
    """A gamma chunk leaves colour reads as cv2's. Read as grey, a gamma
    (gAMA, or sRGB's) more than 5% from 1 turns libpng's colour-to-grey
    linear, which the port does not reproduce: it raises. After PLTE or
    IDAT libpng ignores the chunk, and so does the port: cv2's grey."""
    rng = np.random.RandomState(5)
    pal = rng.randint(0, 256, (256, 3))
    kw = {"rgb8": dict(samples=rng.randint(0, 256, (H, W, 3)), color=2),
          "rgba8": dict(samples=rng.randint(0, 256, (H, W, 4)), color=6),
          "pal8": dict(samples=rng.randint(0, 256, (H, W)), color=3,
                       palette=pal),
          "pal4": dict(samples=rng.randint(0, 16, (H, W)), color=3, depth=4,
                       palette=pal[:16])}[kind]
    path = _with_chunk(write_png(str(tmp_path / "g.png"), **kw),
                       _GAMMA_CHUNKS[chunk], before)
    np.testing.assert_array_equal(native.decode_bgr(path),
                                  cv2.imread(path, cv2.IMREAD_COLOR))
    ignored = chunk == "gama97000" or (kind.startswith("pal")
                                       and before == b"IDAT")
    if ignored:
        np.testing.assert_array_equal(
            native.decode_grey(path), cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    else:
        with pytest.raises(ValueError, match="gAMA or sRGB"):
            native.decode_grey(path)


def test_16bit_colour_with_a_gamma_read_as_grey_raises(tmp_path):
    rng = np.random.RandomState(6)
    path = _with_chunk(write_png(str(tmp_path / "g16.png"),
                                 rng.randint(0, 65536, (H, W, 3)), color=2,
                                 depth=16),
                       _GAMMA_CHUNKS["srgb"], b"IDAT")
    np.testing.assert_array_equal(native.decode_bgr(path),
                                  cv2.imread(path, cv2.IMREAD_COLOR))
    with pytest.raises(ValueError, match="gAMA or sRGB"):
        native.decode_grey(path)


def test_every_filter_type_is_exercised(kinds):
    """The encoder's files hold rows of all five filters; cv2's of its
    own choice."""
    raw = zlib.decompress(_idat(kinds["enc_rgb8"]))
    firsts = {raw[y * (1 + 3 * W)] for y in range(H)}
    assert firsts == {0, 1, 2, 3, 4}


def _idat(path):
    data = open(path, "rb").read()
    pos, out = 8, b""
    while pos < len(data):
        n, kind = struct.unpack_from(">I4s", data, pos)
        if kind == b"IDAT":
            out += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    return out


# --- files it refuses ---------------------------------------------------------

def _corrupt(path, out, edit):
    data = bytearray(open(path, "rb").read())
    edit(data)
    with open(out, "wb") as f:
        f.write(bytes(data))
    return out


def test_refused_files_raise(kinds, tmp_path):
    rng = np.random.RandomState(3)
    interlaced = write_png(str(tmp_path / "adam7.png"),
                           rng.randint(0, 256, (8, 8, 3)), color=2,
                           interlace=1)
    # an Adam7 file decodes (tests/test_torch_jpeg.py holds every kind)
    np.testing.assert_array_equal(native.decode_bgr(interlaced),
                                  cv2.imread(interlaced, cv2.IMREAD_COLOR))
    np.testing.assert_array_equal(
        native.decode_grey(interlaced),
        cv2.imread(interlaced, cv2.IMREAD_GRAYSCALE))
    src = kinds["enc_rgb8"]
    idat_at = open(src, "rb").read().index(b"IDAT") + 40

    def flip(d):
        d[idat_at] ^= 0x55

    def depth3(d):
        d[24] = 3

    def colour5(d):
        d[25] = 5

    cases = {
        "corrupt": _corrupt(src, str(tmp_path / "flip.png"), flip),
        "unsupported": _corrupt(src, str(tmp_path / "d3.png"), depth3),
        "colour type": _corrupt(src, str(tmp_path / "c5.png"), colour5),
        "truncated": _corrupt(src, str(tmp_path / "cut.png"),
                              lambda d: d.__delitem__(slice(len(d) // 2,
                                                            None))),
        "not a PNG": _corrupt(src, str(tmp_path / "junk.png"),
                              lambda d: d.__setitem__(slice(0, 8),
                                                      b"GIF89a\0\0")),
    }
    for path in cases.values():
        with pytest.raises(ValueError):
            native.decode_bgr(path)
        with pytest.raises(ValueError):
            native.decode_grey(path, (4, 4))
    with pytest.raises(FileNotFoundError):
        native.decode_bgr(str(tmp_path / "missing.png"))
    with pytest.raises(FileNotFoundError):
        native.image_info(str(tmp_path / "missing.png"))
    # a bad filter type byte on row 3
    raw = bytearray(zlib.decompress(_idat(src)))
    raw[3 * (1 + 3 * W)] = 7
    bad = write_png(str(tmp_path / "filter7.png"), np.zeros((H, W, 3)),
                    color=2)
    data = open(bad, "rb").read()
    at = data.index(b"IDAT")
    n = struct.unpack_from(">I", data, at - 4)[0]
    with open(bad, "wb") as f:
        f.write(data[:at - 4] + _chunk(b"IDAT", zlib.compress(bytes(raw)))
                + data[at + 8 + n:])
    with pytest.raises(ValueError, match="filter"):
        native.decode_bgr(bad)


# --- resizes ------------------------------------------------------------------

SIZES = [(24, 32), (37, 53), (80, 100), (13, 97), (1, 1)]


@pytest.mark.parametrize("hw", SIZES)
def test_resizes_against_cv2(kinds, hw):
    path = kinds["cv2_rgb8"]
    src = cv2.imread(path, cv2.IMREAD_COLOR)
    want = cv2.resize(src, hw[::-1], interpolation=cv2.INTER_LINEAR)
    got = native.decode_bgr(path, hw)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    np.testing.assert_array_equal(native.resize_bilinear(src, hw), got)
    lab = cv2.imread(kinds["cv2_grey8"], cv2.IMREAD_GRAYSCALE)
    wantl = cv2.resize(lab, hw[::-1], interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(native.decode_grey(kinds["cv2_grey8"], hw),
                                  wantl)
    np.testing.assert_array_equal(native.resize_nearest(lab, hw), wantl)


def _bilinear_oracle(src, hw):
    """The reference's bilinear formula in float32 numpy."""
    sh, sw = src.shape[:2]
    dh, dw = hw
    f32 = np.float32
    sy, sx = f32(sh) / f32(dh), f32(sw) / f32(dw)
    fy = (np.arange(dh, dtype=f32) + f32(0.5)) * sy - f32(0.5)
    fx = (np.arange(dw, dtype=f32) + f32(0.5)) * sx - f32(0.5)

    def axis(f, n):
        i0 = np.floor(f).astype(int)
        wt = (f - i0).astype(f32)
        i1 = i0 + 1
        neg = i0 < 0
        i0, i1, wt = np.where(neg, 0, i0), np.where(neg, 0, i1), \
            np.where(neg, f32(0), wt)
        i1 = np.minimum(i1, n - 1)
        i0 = np.minimum(i0, n - 1)
        return i0, i1, wt

    y0, y1, wy = axis(fy, sh)
    x0, x1, wx = axis(fx, sw)
    s = src.astype(f32)
    wy, wx = wy[:, None, None], wx[None, :, None]
    one = f32(1)
    v = (s[y0][:, x0] * (one - wy) * (one - wx)
         + s[y0][:, x1] * (one - wy) * wx
         + s[y1][:, x0] * wy * (one - wx)
         + s[y1][:, x1] * wy * wx)
    return (v + f32(0.5)).astype(np.uint8)


@pytest.mark.parametrize("hw", SIZES)
def test_bilinear_is_the_reference_formula(kinds, hw):
    src = cv2.imread(kinds["cv2_rgb8"], cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(native.resize_bilinear(src, hw),
                                  _bilinear_oracle(src, hw))


# --- the reference's native loader --------------------------------------------

def _missing_headers(names=("png.h", "jpeglib.h")):
    """The headers of ``names`` that the C++ toolchain cannot include."""
    cxx = os.environ.get("CXX", "g++")
    missing = []
    for name in names:
        try:
            probe = subprocess.run([cxx, "-E", "-x", "c++", "-"],
                                   input=f"#include <{name}>\n", text=True,
                                   capture_output=True, timeout=60)
            ok = probe.returncode == 0
        except OSError:
            ok = False
        if not ok:
            missing.append(name)
    return missing


@pytest.fixture(scope="module")
def ref_native(tmp_path_factory):
    """The reference's loader on a library built here, for this module alone.

    The reference builds ``native/build`` lazily with no lock between
    processes and latches a failure for the life of the process, so a
    worker that collected ``tests/test_native_loader.py`` while another ran
    the same ``make`` may hold a failure that is not the toolchain's. This
    fixture builds ``native/esn_native.cc`` with its own Makefile into a
    directory of its own, points the reference's module there and clears
    the latch. It skips only where a header is missing; a build that fails
    with both headers present fails the tests."""
    missing = _missing_headers()
    if missing:
        pytest.skip("the toolchain lacks " + " and ".join(missing)
                    + ", which the reference's native library needs")
    return _load_reference_native(tmp_path_factory.mktemp("ref_native"))


def _load_reference_native(out):
    """The reference's native module, its library loaded: as it is, or
    built from ``native/`` into ``out`` with the latch cleared."""
    from esn_tpu.data import native as ref
    with ref._lib_lock:
        loaded = ref._lib is not None
    if not loaded:
        built = subprocess.run(["make", "-C", ref._NATIVE_DIR, f"BUILD={out}"],
                               capture_output=True, text=True, timeout=300)
        assert built.returncode == 0, built.stdout + built.stderr
        with ref._lib_lock:
            ref._LIB_PATH = str(out / "libesn_native.so")
            ref._lib_failed = False
            ref._build_attempted = False
    assert ref.available(), "the reference's native library does not load"
    return ref


def test_the_reference_loader_recovers_from_a_latched_failure(tmp_path,
                                                              monkeypatch):
    """A failure the reference latched (a concurrent ``make`` of another
    process, its library half written) does not outlive the fixture's
    build: with the latch set and the library path gone, the build into a
    directory of its own loads and decodes."""
    if _missing_headers():
        pytest.skip("the toolchain lacks " + " and ".join(_missing_headers()))
    from esn_tpu.data import native as ref
    monkeypatch.setattr(ref, "_lib", None)
    monkeypatch.setattr(ref, "_lib_failed", True)
    monkeypatch.setattr(ref, "_build_attempted", True)
    monkeypatch.setattr(ref, "_LIB_PATH", str(tmp_path / "gone.so"))
    assert not ref.available()
    got = _load_reference_native(tmp_path)
    assert got._LIB_PATH == str(tmp_path / "libesn_native.so")
    path = str(tmp_path / "a.png")
    cv2.imwrite(path, np.arange(48, dtype=np.uint8).reshape(4, 4, 3))
    np.testing.assert_array_equal(got.decode_bgr(path),
                                  cv2.imread(path, cv2.IMREAD_COLOR))


@pytest.mark.parametrize("kind", ["cv2_rgb8", "cv2_grey8", "enc_rgb8",
                                  "enc_grey8", "enc_rgb8_wide"])
@pytest.mark.parametrize("hw", [None] + SIZES)
def test_decode_equals_reference_native(kinds, ref_native, kind, hw):
    path = kinds[kind]
    np.testing.assert_array_equal(native.decode_bgr(path, hw),
                                  ref_native.decode_bgr(path, hw))
    if "grey" in kind:
        np.testing.assert_array_equal(native.decode_grey(path, hw),
                                      ref_native.decode_grey(path, hw))


# --- JPEG ---------------------------------------------------------------------

def test_jpeg_within_the_reference_limits(tmp_path):
    rng = np.random.RandomState(4)
    path = str(tmp_path / "img.jpg")
    cv2.imwrite(path, rng.randint(0, 255, (50, 70, 3), np.uint8),
                [cv2.IMWRITE_JPEG_QUALITY, 95])
    want = cv2.imread(path, cv2.IMREAD_COLOR)
    got = native.decode_bgr(path)
    assert got.shape == want.shape and native.image_info(path) == (50, 70)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.mean() < 1.5 and diff.max() <= 16
    grey = native.decode_grey(path, (25, 35))
    assert grey.shape == (25, 35)


# --- the prefetch pipeline ----------------------------------------------------

@pytest.fixture(scope="module")
def records(tmp_path_factory):
    root = tmp_path_factory.mktemp("recs")
    rng = np.random.RandomState(0)
    recs = []
    for i, (h, w) in enumerate([(37, 53), (64, 48), (128, 96), (40, 40),
                                (48, 48)]):
        ip, lp = str(root / f"img_{i}.png"), str(root / f"lab_{i}.png")
        cv2.imwrite(ip, rng.randint(0, 255, (h, w, 3), np.uint8))
        cv2.imwrite(lp, rng.randint(0, 19, (h, w), np.uint8))
        recs.append((ip, lp))
    return recs


@pytest.mark.parametrize("threads,capacity", [(1, 1), (3, 2), (8, 16)])
def test_pipeline_in_order(records, threads, capacity):
    with native.NativePipeline(records, (48, 48), threads=threads,
                               capacity=capacity) as pipe:
        seen = []
        for rec, img, lab in pipe.epoch():
            np.testing.assert_array_equal(
                img, native.decode_bgr(records[rec][0], (48, 48)))
            np.testing.assert_array_equal(
                lab, native.decode_grey(records[rec][1], (48, 48)))
            seen.append(rec)
    assert seen == list(range(len(records)))


def test_pipeline_shuffled_epochs(records):
    pipe = native.NativePipeline(records, (32, 32), threads=2, capacity=3)
    for order in ([2, 0, 4, 3, 1], [1, 3, 0, 2, 4], [4, 4, 0]):
        assert [r for r, _, _ in pipe.epoch(order)] == order
    # an epoch left early, then a new one
    it = pipe.epoch([3, 2, 1])
    assert next(it)[0] == 3
    assert [r for r, _, _ in pipe.epoch([0, 1])] == [0, 1]
    pipe.close()


def test_pipeline_without_labels_and_failures(records, tmp_path):
    recs = [(records[0][0], None), records[1]]
    with native.NativePipeline(recs, (40, 40), threads=2) as pipe:
        out = list(pipe.epoch())
    assert [r for r, _, _ in out] == [0, 1]
    assert out[0][2] is None and out[1][2].shape == (40, 40)
    for bad in ([records[0], (records[1][0], str(tmp_path / "gone.png"))],
                [records[0], (str(tmp_path / "gone.png"), records[1][1])]):
        with native.NativePipeline(bad, (40, 40), threads=2) as pipe:
            with pytest.raises(FileNotFoundError, match="gone"):
                list(pipe.epoch())


# --- ManifestDataset against the reference's ----------------------------------

@pytest.mark.parametrize("resize_hw", [None, (24, 32), (41, 27)])
def test_manifest_dataset_equals_reference(records, ref_native, resize_hw):
    from esn_tpu.data.datasets import ManifestDataset as RefDataset
    from esn_tpu.data.datasets import get_spec as ref_spec
    from esn_tpu_torch.data.datasets import ManifestDataset, get_spec
    recs = records[:2] + [(records[2][0], None)]
    ours = ManifestDataset(recs, get_spec("camvid"), resize_hw=resize_hw)
    ref = RefDataset(recs, ref_spec("camvid"), resize_hw=resize_hw)
    for i in range(len(recs)):
        a, b = ours[i], ref[i]
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
            assert np.asarray(a[key]).dtype == np.asarray(b[key]).dtype


def test_packed_records_resize(records, tmp_path):
    """Packed records go through the same resizes (the reference's packed
    path resizes with cv2: within 1 of it)."""
    from esn_tpu_torch.data.datasets import ManifestDataset, get_spec
    img = cv2.imread(records[2][0], cv2.IMREAD_COLOR)
    lab = cv2.imread(records[2][1], cv2.IMREAD_GRAYSCALE)
    packed = str(tmp_path / "r.npy")
    np.save(packed, np.concatenate([img, lab[..., None]], -1))
    item = ManifestDataset([(packed, None)], get_spec("camvid"),
                           resize_hw=(50, 30))[0]
    np.testing.assert_array_equal(item["image"],
                                  native.resize_bilinear(img, (50, 30)))
    assert np.abs(item["image"].astype(int) - cv2.resize(
        img, (30, 50), interpolation=cv2.INTER_LINEAR).astype(int)).max() <= 1
    np.testing.assert_array_equal(item["label"], cv2.resize(
        lab, (30, 50), interpolation=cv2.INTER_NEAREST))


# --- the golden fixture and the packing tool ----------------------------------

@pytest.fixture(scope="module")
def golden_root(tmp_path_factory):
    from esn_tpu_torch.tools import golden_run
    return golden_run.build_fixture(str(tmp_path_factory.mktemp("golden")))


def test_golden_fixture_equals_the_reference(golden_root, tmp_path):
    """The port's fixture (``write_png``, channels swapped) decodes to the
    pixels of the reference's (``cv2.imwrite``)."""
    from tools import golden_run as ref_golden
    ref_root = ref_golden.build_fixture(str(tmp_path))
    ours = sorted(os.listdir(os.path.join(golden_root, "camvid", "images")))
    assert ours == sorted(os.listdir(os.path.join(ref_root, "camvid",
                                                  "images")))
    assert len(ours) == 2 * (8 + 4)
    for name in ours:
        a = os.path.join(golden_root, "camvid", "images", name)
        b = os.path.join(ref_root, "camvid", "images", name)
        for flag in (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE):
            np.testing.assert_array_equal(cv2.imread(a, flag),
                                          cv2.imread(b, flag), err_msg=name)
    for split in ("train", "val"):
        lst = f"camvid/camvid_{split}_list.txt"
        assert open(os.path.join(golden_root, lst)).read() == \
            open(os.path.join(ref_root, lst)).read()


def test_pack_dataset_gives_the_same_batches(golden_root, tmp_path):
    """An epoch from the packed fixture gives the batches its PNGs give,
    and the records equal the reference packing tool's."""
    from esn_tpu_torch.data import BatchLoader
    from esn_tpu_torch.data.builders import _make_dataset
    from esn_tpu_torch.data.datasets import get_spec
    from esn_tpu_torch.tools import pack_dataset
    packed = str(tmp_path / "packed")
    assert pack_dataset.main(["--dataset", "camvid", "--root", golden_root,
                              "--out", packed, "--workers", "3"]) == 0
    spec = get_spec("camvid")
    for split in ("train", "val"):
        png, real = _make_dataset(golden_root, "camvid", split, spec, 0)
        npy, real_npy = _make_dataset(packed, "camvid", split, spec, 0)
        assert real and real_npy and len(png) == len(npy)
        assert all(r[0].endswith(".npy") for r in npy.records)
        pairs = list(zip(BatchLoader(png, 4, shuffle=True, seed=3),
                         BatchLoader(npy, 4, shuffle=True, seed=3)))
        assert len(pairs) == len(png) // 4
        for a, b in pairs:
            for key in ("image", "label", "size"):
                np.testing.assert_array_equal(a[key], b[key])
    from tools import pack_dataset as ref_pack
    ref_out = str(tmp_path / "ref_packed")
    assert ref_pack.pack_split(golden_root, ref_out, "camvid", "train") == 8
    for name in os.listdir(os.path.join(ref_out, "camvid", "packed")):
        np.testing.assert_array_equal(
            np.load(os.path.join(packed, "camvid", "packed", name)),
            np.load(os.path.join(ref_out, "camvid", "packed", name)))
