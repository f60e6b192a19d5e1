"""ctypes loader of the native data-path library (``transform.cpp``).

PyTorch-port counterpart of ``probabilisticdeepdiffusionmodels_tpu/data/native``.
At first use ``transform.cpp`` is compiled with ``g++ -O3 -shared -fPIC``
into ``build/native/`` at the root of the checkout (the directory
``ops/_build.py`` builds the kernels under), named by a hash of the source
and the flags and reused while they are unchanged; nothing is written into
the package.  A missing compiler or a failed build raises with the
compiler's output: there is no numpy fallback behind the caller's back
(``Transform(...)(..., use_native=False)`` asks for the numpy executor).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Optional

import numpy as np

__all__ = ["build", "get_lib", "transform_batch_native"]

_SRC = pathlib.Path(__file__).resolve().parent / "transform.cpp"
_BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "native"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-ffp-contract=off"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_U8 = ctypes.POINTER(ctypes.c_uint8)
_F32 = ctypes.POINTER(ctypes.c_float)
_I32 = ctypes.POINTER(ctypes.c_int32)


def build() -> pathlib.Path:
    """Compile ``transform.cpp`` (or find its build) and return the
    library's path; raises ``RuntimeError`` when the compiler fails or is
    missing."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    out = _BUILD_DIR / f"libpddm_native_{digest[:16]}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a private name, renamed when complete: concurrent builds never read
    # a half-written library
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(_SRC)]
    try:
        done = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"building the native transform ({' '.join(cmd)}) failed: {e}") from e
    if done.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native transform ({' '.join(cmd)}) failed with exit "
                           f"code {done.returncode}:\n{done.stdout}{done.stderr}")
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded library, built at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.transform_batch.restype = None
            lib.transform_batch.argtypes = [
                _U8, _F32,                                   # in, out
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # b h w c
                _I32,                                        # flip flags
                ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,  # crop?, pad, crop size
                _I32, _I32,                                  # crop rows, crop columns
                _F32, _F32,                                  # mean, std
            ]
            _lib = lib
    return _lib


def _int32(a: Optional[np.ndarray], b: int) -> np.ndarray:
    return np.ascontiguousarray(np.zeros(b, np.int32) if a is None else a, dtype=np.int32)


def transform_batch_native(
    images: np.ndarray,
    flip_flags: Optional[np.ndarray],
    do_crop: bool,
    pad: int,
    crop_size: int,
    crop_ys: Optional[np.ndarray],
    crop_xs: Optional[np.ndarray],
    mean: np.ndarray,
    std: np.ndarray,
) -> np.ndarray:
    """One pass of flip + pad/crop + normalize over uint8 NHWC ``images``:
    float32 [B, CS, CS, C] (CS = ``crop_size`` when cropping, else H x W)."""
    lib = get_lib()
    images = np.ascontiguousarray(images, dtype=np.uint8)
    b, h, w, c = images.shape
    out = np.empty((b, crop_size if do_crop else h, crop_size if do_crop else w, c), np.float32)
    ff, ys, xs = _int32(flip_flags, b), _int32(crop_ys, b), _int32(crop_xs, b)
    mean = np.ascontiguousarray(np.broadcast_to(mean, (c,)), dtype=np.float32)
    std = np.ascontiguousarray(np.broadcast_to(std, (c,)), dtype=np.float32)
    lib.transform_batch(
        images.ctypes.data_as(_U8), out.ctypes.data_as(_F32), b, h, w, c,
        ff.ctypes.data_as(_I32), 1 if do_crop else 0, int(pad), int(crop_size),
        ys.ctypes.data_as(_I32), xs.ctypes.data_as(_I32),
        mean.ctypes.data_as(_F32), std.ctypes.data_as(_F32),
    )
    return out
