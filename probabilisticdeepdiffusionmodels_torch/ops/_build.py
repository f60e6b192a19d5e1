"""Build the CUDA kernels under ``csrc/`` and bind them with ctypes.

At first use every ``csrc/*.cu`` is compiled for ``sm_90a`` by its own
``nvcc`` process, all started together, and the objects are linked into one
shared library with a plain C interface (no PyTorch headers, so the build
takes seconds).  The library lands in ``build/kernels/`` at the root of
the checkout, named by a hash of the sources, and is reused while the sources
are unchanged.  A missing ``nvcc`` or a failed build raises with the
compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Optional

import torch

_CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point -> argtypes; every entry point returns cudaGetLastError().
_SIGNATURES = {
    # qkv, out, B, T, heads, ch, scale, is_bf16, stream
    "pddm_qkv_attention": [_P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _P],
    # x, gamma, beta, out, B, N, C, groups, eps, silu, is_bf16, V, cvb, stream
    "pddm_group_norm_silu": [_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float,
                             _I, _I, _I, _I, _P],
    # x, gamma, beta, cond0, cond1, ao, ws, counters, B, N, C, groups, eps, mode,
    # stride0, stride1, cond_is_bf16, is_bf16, V, cvb, splits, rows, fold, stream
    "pddm_gn_moments_fold": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float,
                             _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, ao, gamma, beta, cond0, cond1, ga, goff, dx, shares, dcond0, dcond1, dgamma,
    # dbeta, B, N, C, groups, eps, mode, stride0, stride1, cond_is_bf16, is_bf16, V, cvb,
    # splits, rows, stream
    "pddm_gn_affine_bwd": [*[_P] * 14, _I, _I, _I, _I, ctypes.c_float, *[_I] * 9, _P],
    # ao, gamma, beta, cond0, cond1, ga, goff, g, B, N, C, groups, eps, mode, stride0,
    # stride1, cond_is_bf16, stream
    "pddm_gn_fold_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float,
                         _I, _I, _I, _I, _P],
    # moments, gamma, beta, cond0, cond1, ao, B, C, groups, eps, mode, stride0, stride1,
    # cond_is_bf16, stream
    "pddm_gn_fold": [_P, _P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _I, _I, _I, _I, _P],
    # x, ao, out, B, N, C, silu, is_bf16, V, cvb, splits, rows, stream
    "pddm_gn_apply": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, a, off, w, bias, out, B, H, W, Cin, Cout, is_bf16, design, stream
    "pddm_gn_silu_conv3x3": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # a, b, out, is_bf16, stream
    "pddm_probe_mma": [_P, _P, _P, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
library_path: Optional[pathlib.Path] = None


def _sources():
    return sorted(p for p in _CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cuda.exists():
        return str(cuda)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME or /usr/local/cuda); "
        "the CUDA kernels cannot be built"
    )


def build() -> pathlib.Path:
    """Compile the kernels if the sources changed; return the library path."""
    srcs = _sources()
    digest = hashlib.sha256()
    for p in srcs:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = _BUILD_DIR / f"pddm_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
    nvcc = _nvcc()
    jobs = []
    for src in (p for p in srcs if p.suffix == ".cu"):
        obj = _BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    log = ""
    failed = []
    for cmd, _, proc in jobs:
        text = proc.communicate()[0]
        log += f"$ {' '.join(cmd)}\n{text}"
        if proc.returncode != 0:
            failed.append(proc.returncode)
    objs = [str(obj) for _, obj, _ in jobs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log += f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        if proc.returncode != 0:
            failed.append(proc.returncode)
    for obj in objs:
        pathlib.Path(obj).unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed (exit {failed[0]}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib, library_path
    with _lock:
        if _lib is None:
            path = build()
            handle = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _entry[name] = fn
            _lib, library_path = handle, path
        return _lib


_entry = {}  # C entry point name -> bound function, filled by lib()
# the current stream's handle without building a torch.cuda.Stream object
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream() -> int:
    if _raw_stream is not None:
        return _raw_stream(torch.cuda.current_device())
    return torch.cuda.current_stream().cuda_stream


def launch(name: str, *args) -> None:
    """Call C entry point ``name`` on the current stream; raise on a launch
    error (``cudaGetLastError()`` != 0)."""
    fn = _entry.get(name)
    if fn is None:
        lib()
        fn = _entry[name]
    err = fn(*args, _stream())
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
