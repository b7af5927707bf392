"""A msgpack decoder on the standard library, and flax's array encoding
on top of it.

The JAX package writes its checkpoints with ``flax.serialization``
(msgpack, arrays as ext types); the card's machine has neither
``msgpack`` nor ``flax``, so the port reads them with this module.

- :func:`unpackb` decodes every msgpack type: nil, bool, ints (fixint,
  8-64 bit, signed and unsigned), float 32/64, str, bin, array, map and
  ext (fixext and ext 8/16/32). Lengths and numbers are big-endian.
  Arrays come back as lists, str as ``str`` (UTF-8), bin as ``bytes``,
  ext as :class:`ExtType` unless ``ext_hook`` maps it.
- :func:`restore` is ``flax.serialization.msgpack_restore``: ext type 1
  is an ndarray, ext type 3 a numpy scalar, each a msgpack
  ``(shape, dtype name, bytes)`` triple; ext type 2 a complex. Arrays
  that flax split into chunks are joined. ``bfloat16`` (no numpy dtype)
  is read as ``uint16`` bytes and viewed as a ``torch.bfloat16`` tensor.
"""
from __future__ import annotations

import struct
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

ExtHook = Callable[[int, bytes], Any]


class ExtType(NamedTuple):
    code: int
    data: bytes


# type byte -> struct format of a fixed-size number
_NUMBERS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
            0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
# type byte -> (struct format of the length, kind)
_SIZED = {0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
          0xc7: (">B", "ext"), 0xc8: (">H", "ext"), 0xc9: (">I", "ext"),
          0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
          0xdc: (">H", "array"), 0xdd: (">I", "array"),
          0xde: (">H", "map"), 0xdf: (">I", "map")}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_CONSTANTS = {0xc0: None, 0xc2: False, 0xc3: True}


def _decode(buf: memoryview, pos: int, hook: Optional[ExtHook]
            ) -> Tuple[Any, int]:
    b = buf[pos]
    pos += 1
    if b <= 0x7f:
        return b, pos
    if b >= 0xe0:
        return b - 0x100, pos
    if b <= 0x8f:
        return _container(buf, pos, b & 0x0f, "map", hook)
    if b <= 0x9f:
        return _container(buf, pos, b & 0x0f, "array", hook)
    if b <= 0xbf:
        n = b & 0x1f
        return str(buf[pos:pos + n], "utf-8"), pos + n
    if b in _CONSTANTS:
        return _CONSTANTS[b], pos
    if b in _NUMBERS:
        fmt = _NUMBERS[b]
        return struct.unpack_from(fmt, buf, pos)[0], pos + struct.calcsize(fmt)
    if b in _FIXEXT:
        return _ext(buf, pos, _FIXEXT[b], hook)
    if b in _SIZED:
        fmt, kind = _SIZED[b]
        n = struct.unpack_from(fmt, buf, pos)[0]
        pos += struct.calcsize(fmt)
        if kind == "bin":
            return bytes(buf[pos:pos + n]), pos + n
        if kind == "str":
            return str(buf[pos:pos + n], "utf-8"), pos + n
        if kind == "ext":
            return _ext(buf, pos, n, hook)
        return _container(buf, pos, n, kind, hook)
    raise ValueError(f"msgpack: unknown type byte 0x{b:02x} at {pos - 1}")


def _ext(buf, pos, n, hook):
    code = struct.unpack_from(">b", buf, pos)[0]
    data = bytes(buf[pos + 1:pos + 1 + n])
    if len(data) != n:
        raise ValueError("msgpack: truncated ext")
    return (hook(code, data) if hook else ExtType(code, data)), pos + 1 + n


def _container(buf, pos, n, kind, hook):
    if kind == "array":
        out = []
        for _ in range(n):
            item, pos = _decode(buf, pos, hook)
            out.append(item)
        return out, pos
    mapping = {}
    for _ in range(n):
        key, pos = _decode(buf, pos, hook)
        mapping[key], pos = _decode(buf, pos, hook)
    return mapping, pos


def unpackb(data: bytes, *, ext_hook: Optional[ExtHook] = None) -> Any:
    """Decode one msgpack object that fills ``data``."""
    buf = memoryview(data)
    try:
        value, end = _decode(buf, 0, ext_hook)
    except (IndexError, struct.error) as e:
        raise ValueError(f"msgpack: truncated data ({e})") from e
    if end != len(buf):
        raise ValueError(f"msgpack: {len(buf) - end} bytes after the object")
    return value


def _array(data: bytes):
    """flax's ndarray encoding: a msgpack ``(shape, dtype name, bytes)``."""
    shape, dtype, buffer = unpackb(data)
    shape = tuple(shape)
    if dtype == "bfloat16":
        arr = np.frombuffer(buffer, np.uint16).reshape(shape).copy()
        return torch.from_numpy(arr).view(torch.bfloat16)
    return np.frombuffer(buffer, np.dtype(dtype)).reshape(shape).copy()


def _flax_ext(code: int, data: bytes) -> Any:
    if code == 1:
        return _array(data)
    if code == 2:
        re, im = unpackb(data)
        return complex(re, im)
    if code == 3:
        arr = _array(data)
        return arr if isinstance(arr, torch.Tensor) else arr[()]
    return ExtType(code, data)


def _unchunk(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    if "__msgpack_chunked_array__" in node:
        shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
        chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in node.items()}


def restore(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore``: nested dicts with numpy
    array leaves (``torch.bfloat16`` tensors for bfloat16)."""
    return _unchunk(unpackb(data, ext_hook=_flax_ext))
