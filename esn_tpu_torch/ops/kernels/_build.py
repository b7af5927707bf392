"""Build and load the hand-written CUDA kernels.

Each of ``esn_tpu_torch/csrc/*.cu`` compiles with its own ``nvcc`` for
``sm_90a``, all started together, and one more ``nvcc`` links the objects
into one shared library with a plain C interface, loaded with ``ctypes``.
The library lands in ``esn_tpu_torch/build/`` under a name keyed by a hash
of the sources and flags, so an edit rebuilds and an unchanged tree
reuses the file. Nothing is built at import: the first kernel launch
builds, and a process without ``nvcc`` that never launches a kernel
never needs it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple, Optional

PKG_DIR = Path(__file__).resolve().parents[2]
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
# -Xptxas=-v puts each kernel's registers, shared memory and spills in the
# build log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libesn_kernels-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "kernels of esn_tpu_torch are built at first use")


class BuildInfo(NamedTuple):
    """What ``build`` did: the library, seconds, compiler log, and whether
    it compiled (False: a build of the same sources was there)."""
    path: Path
    seconds: float
    log: str
    built: bool


def build() -> BuildInfo:
    """Compile the library unless a build of the same sources exists."""
    out = library_path()
    if out.exists():
        return BuildInfo(out, 0.0, "", built=False)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cu = [s for s in sources() if s.suffix == ".cu"]
        objs = [str(Path(tmp) / f"{s.stem}.o") for s in cu]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(s)]
                for s, o in zip(cu, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        outs = [p.communicate()[0] for p in procs]
        so = str(Path(tmp) / out.name)
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", so, *objs]
        log = "".join(outs)
        failed = [(c, p.returncode) for c, p in zip(cmds, procs)
                  if p.returncode != 0]
        if not failed:
            proc = subprocess.run(link, capture_output=True, text=True)
            log += proc.stdout + proc.stderr
            if proc.returncode != 0:
                failed = [(link, proc.returncode)]
        if failed:
            cmd, rc = failed[0]
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n"
                               f"{log}")
        os.replace(so, out)
    return BuildInfo(out, time.perf_counter() - t0, log, built=True)


_VP, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (argtypes, restype) of each C entry point of the library
SIGNATURES = {
    "esn_cuda_error_string": ([_I32], ctypes.c_char_p),
    "esn_dsconv_forward": ([_VP] * 8 + [_I32] * 11 + [_VP], _I32),
    "esn_resize_argmax": ([_VP, _VP] + [_I32] * 6 + [_VP], _I32),
    "esn_resize_ce_fwd_scratch": ([_I32] * 5, ctypes.c_longlong),
    "esn_resize_ce_fwd": ([_VP] * 6 + [_I32] * 6 + [_F32, _VP], _I32),
    "esn_resize_ce_bwd_scratch": ([_I32] * 5, ctypes.c_longlong),
    "esn_resize_ce_bwd": ([_VP] * 6 + [_I32] * 6 + [_F32, _VP], _I32),
    "esn_cgblock_pre_tiles": ([_I32] * 6, _I32),
    "esn_cgblock_pre_tune": ([_I32] * 4, None),
    "esn_cgblock_pre": ([_VP] * 13 + [_I32] * 7 + [_VP], _I32),
    "esn_resize_bilinear_bwd": ([_VP] * 4, _I32),
    "esn_adaptive_pool_bwd": ([_VP] * 4, _I32),
    "esn_subpixel_argmax": ([_VP] * 4 + [_I32, _VP, _VP], _I32),
}

_LIB: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in this process)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build().path))
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        _LIB = lib
    return _LIB


def stream(index: int) -> int:
    """The raw current CUDA stream of card ``index`` (a launch's last
    argument), by the cheapest call this torch has."""
    import torch
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        msg = library().esn_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
