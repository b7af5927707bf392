"""The port's image decoder: ctypes bindings to ``native/esn_native.cc``
and ``native/jpeg.cc`` (counterpart of ``esn_tpu/data/native.py``).

PNG decode (an inflate and the row filters of its own, no libpng or zlib,
Adam7 interlacing included), JPEG decode (baseline, extended and
progressive Huffman, libjpeg's default decompression with no libjpeg),
the reference's two uint8 resizes, and a threaded, bounded, in-order
prefetch pipeline, in one C++ library built with the host C++ compiler
(``$CXX``, else ``c++``) at first use. The library lands in
``esn_tpu_torch/build/`` under a name keyed by a hash of every source and
the flags; nothing is built at import, and a failed build raises with the
compiler's output. There is no cv2 fallback: what the decoder cannot read
raises.

Decoding returns what ``cv2.imread`` returns: ``decode_bgr`` is
``IMREAD_COLOR``, (H, W, 3) uint8 BGR, and ``decode_grey`` is
``IMREAD_GRAYSCALE``, (H, W) uint8. With ``resize_hw`` the image is resized
bilinearly and the grey map by nearest neighbour, the reference's formulas,
so decode + resize equals the reference's native path bit for bit.

ctypes releases the GIL around every call, so threads decode in parallel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

PKG_DIR = Path(__file__).resolve().parents[1]
SRC_DIR = PKG_DIR / "native"
BUILD_DIR = PKG_DIR / "build"
# -ffp-contract=off: no fused multiply-adds in the bilinear resize, which
# then rounds as the reference's build does on any host
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra",
             "-ffp-contract=off", "-pthread", "-shared")

_ERRORS = {
    -2: "not a PNG or JPEG file",
    -4: "a PNG of an unsupported bit depth or colour type",
    -5: "corrupt PNG data (chunks, the zlib stream, its Adler-32 or a row "
        "filter)",
    -7: "corrupt JPEG data (markers, tables or the entropy-coded data)",
    -8: "a decoded size that is not the one asked for",
    -9: "a colour PNG with a gAMA or sRGB chunk read as grey (libpng's "
        "gamma-corrected colour-to-grey is not reproduced)",
    -10: "an arithmetic-coded JPEG (SOF9-11): the port decodes Huffman "
         "coding only",
    -11: "a lossless or hierarchical JPEG (SOF3, 5-7, 13-15)",
    -12: "a JPEG of other than 8-bit samples (12-bit data)",
    -13: "a JPEG of other than 1 component or 3 in YCbCr (CMYK, YCCK, "
         "RGB)",
    -14: "a JPEG with sampling factors other than luma 1-2 x 1-2 and 1x1 "
         "chroma",
}

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int)
_I32, _VP, _CP = ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p
_SIGNATURES = {
    "esn_image_info": ([_CP, _I32P, _I32P], _I32),
    "esn_decode": ([_CP, _I32, _U8P, _I32, _I32], _I32),
    "esn_resize_bilinear": ([_U8P, _I32, _I32, _U8P, _I32, _I32, _I32], None),
    "esn_resize_nearest": ([_U8P, _I32, _I32, _U8P, _I32, _I32], None),
    "esn_pipe_create": ([_I32, ctypes.POINTER(_CP), ctypes.POINTER(_CP), _I32,
                         _I32, _I32], _VP),
    "esn_pipe_epoch": ([_VP, _I32P, _I32, _I32], None),
    "esn_pipe_next": ([_VP, _U8P, _U8P, _I32P, _I32P, _I32P], _I32),
    "esn_pipe_destroy": ([_VP], None),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# the library's sources, compiled together; every file of native/ keys the
# build
SOURCES = ("esn_native.cc", "jpeg.cc")


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler ($CXX, c++ or g++): the port's "
                           "image decoder is built at first use")
    return cxx


def library_path() -> Path:
    """The library's file, named by a hash of the flags and of every file
    in ``native/`` (sources and headers), so that an edit to any of them
    rebuilds."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + SOURCES).encode())
    for path in sorted(SRC_DIR.iterdir()):
        if path.suffix in (".cc", ".h"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return BUILD_DIR / f"libesn_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless a build of its sources exists; the file
    is written under a temporary name and renamed, so concurrent builds in
    several processes are safe."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        so = str(Path(tmp) / out.name)
        cmd = [_compiler(), *CXX_FLAGS, "-o", so,
               *(str(SRC_DIR / source) for source in SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building the decoder failed "
                               f"({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(so, out)
    return out


def library() -> ctypes.CDLL:
    """The decoder's library, built and loaded on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _lib = lib
        return _lib


def _raise(code: int, path: str):
    if code == -1:
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        raise OSError(f"{path}: cannot be read")
    raise ValueError(f"{path}: {_ERRORS.get(code, f'error {code}')}")


def _u8(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def image_info(path: str) -> Tuple[int, int]:
    """(H, W) of a PNG or JPEG, from its header."""
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = library().esn_image_info(os.fsencode(path), ctypes.byref(h),
                                  ctypes.byref(w))
    if rc != 0:
        _raise(rc, path)
    return h.value, w.value


def _decode(path: str, channels: int,
            resize_hw: Optional[Tuple[int, int]]) -> np.ndarray:
    lib = library()
    if resize_hw is None:
        hw, (th, tw) = image_info(path), (-1, -1)
    else:
        hw = th, tw = (int(resize_hw[0]), int(resize_hw[1]))
    out = np.empty(hw + ((channels,) if channels == 3 else ()), np.uint8)
    rc = lib.esn_decode(os.fsencode(path), channels, _u8(out), th, tw)
    if rc < 0:
        _raise(rc, path)
    return out


def decode_bgr(path: str,
               resize_hw: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """A PNG or JPEG as (H, W, 3) uint8 BGR (``cv2.IMREAD_COLOR``),
    resized bilinearly to ``resize_hw`` when given."""
    return _decode(path, 3, resize_hw)


def decode_grey(path: str,
                resize_hw: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """A PNG or JPEG as (H, W) uint8 (``cv2.IMREAD_GRAYSCALE``; label
    maps), resized by nearest neighbour to ``resize_hw`` when given."""
    return _decode(path, 1, resize_hw)


def resize_bilinear(image: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """(H, W[, C]) uint8 to (h, w[, C]): half-pixel centres, +0.5 rounding
    (``cv2.INTER_LINEAR`` up to 1)."""
    src = np.ascontiguousarray(image, np.uint8)
    c = src.shape[2] if src.ndim == 3 else 1
    out = np.empty(tuple(hw) + src.shape[2:], np.uint8)
    library().esn_resize_bilinear(_u8(src), src.shape[0], src.shape[1],
                                  _u8(out), hw[0], hw[1], c)
    return out


def resize_nearest(label: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """(H, W) uint8 to (h, w), source pixel floor(dst * scale)
    (``cv2.INTER_NEAREST``)."""
    src = np.ascontiguousarray(label, np.uint8)
    if src.ndim != 2:
        raise ValueError(f"resize_nearest: want (H, W), got {src.shape}")
    out = np.empty(tuple(hw), np.uint8)
    library().esn_resize_nearest(_u8(src), src.shape[0], src.shape[1],
                                 _u8(out), hw[0], hw[1])
    return out


class NativePipeline:
    """Threaded decode and prefetch over a manifest, in the caller's order.

    :meth:`epoch` yields ``(record_index, image_bgr_u8, label_u8_or_None)``
    for each index of ``order``, each record decoded and resized to
    ``target_hw`` by one of ``threads`` C++ threads, at most ``capacity``
    records ahead of the consumer.
    """

    def __init__(self, records: Sequence[Tuple[str, Optional[str]]],
                 target_hw: Tuple[int, int], *, threads: Optional[int] = None,
                 capacity: int = 16):
        if threads is None:     # decode threads scale with host cores
            threads = max(1, min(8, os.cpu_count() or 1))
        self._lib = library()
        self._records = list(records)
        self._hw = (int(target_hw[0]), int(target_hw[1]))
        self._threads = threads
        n = len(self._records)
        self._img_paths = (_CP * n)(
            *[os.fsencode(r[0]) for r in self._records])
        self._lab_paths = (_CP * n)(
            *[os.fsencode(r[1]) if r[1] else None for r in self._records])
        self._handle = self._lib.esn_pipe_create(
            n, self._img_paths, self._lab_paths, self._hw[0], self._hw[1],
            capacity)
        if not self._handle:
            raise ValueError(f"NativePipeline: {n} records at {self._hw}")

    def epoch(self, order: Optional[Sequence[int]] = None
              ) -> Iterator[Tuple[int, np.ndarray, Optional[np.ndarray]]]:
        order = np.asarray(list(range(len(self._records)) if order is None
                                else order), np.int32)
        self._lib.esn_pipe_epoch(self._handle, order.ctypes.data_as(_I32P),
                                 len(order), self._threads)
        h, w = self._hw
        has_lab, status, of_label = (ctypes.c_int(0), ctypes.c_int(0),
                                     ctypes.c_int(0))
        for _ in range(len(order)):
            img = np.empty((h, w, 3), np.uint8)
            lab = np.empty((h, w), np.uint8)
            rec = self._lib.esn_pipe_next(
                self._handle, _u8(img), _u8(lab), ctypes.byref(has_lab),
                ctypes.byref(status), ctypes.byref(of_label))
            if rec < 0:
                return
            if status.value:
                _raise(status.value, self._records[rec][of_label.value])
            yield rec, img, (lab if has_lab.value else None)

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.esn_pipe_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()

