"""PNG writer and reader on the standard library (``zlib``, ``struct``).

The card's machine has no PIL, so prediction maps are written here: 8-bit
greyscale (colour type 0) for an ``(H, W)`` uint8 array and 8-bit RGB
(colour type 2) for ``(H, W, 3)``, the pixels that PIL's
``Image.fromarray(a).save(path)`` writes. Rows carry filter type 0 and
the image data is one zlib stream in one IDAT chunk. :func:`read_png`
reads back what :func:`write_png` writes (8-bit grey or RGB,
non-interlaced, rows unfiltered).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3}    # colour type -> channels


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xffffffff))


def write_png(path: str, image: np.ndarray) -> None:
    """Write ``image``, ``(H, W)`` or ``(H, W, 3)`` uint8, as a PNG."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or not (
            image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 3)):
        raise ValueError(f"write_png: want (H, W) or (H, W, 3) uint8, got "
                         f"{image.shape} {image.dtype}")
    h, w = image.shape[:2]
    color = 0 if image.ndim == 2 else 2
    rows = image.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit grey or RGB non-interlaced PNG: ``(H, W)`` or
    ``(H, W, 3)`` uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(f"{path}: only 8-bit grey/RGB non-interlaced PNGs "
                         f"(depth {depth}, colour type {color}, interlace "
                         f"{interlace})")
    c = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * c)
    if raw[:, 0].any():
        raise ValueError(f"{path}: rows with a filter other than None "
                         f"(write_png writes None only)")
    rows = raw[:, 1:]
    return rows.reshape(h, w, c) if c > 1 else rows.reshape(h, w)
