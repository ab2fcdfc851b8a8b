"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

The kernels are compiled with ``nvcc`` for Hopper (``sm_90a``), one ``nvcc``
process per source, all started together, and linked into one shared
library with a plain C interface under ``build/flowtrack_tpu_torch/`` beside
the package (``build_dir``: the user's cache directory when that cannot be
written, as in an installed package), at first use and again whenever a source or a flag changes
(the file name carries their hash); ``ptxas -v`` reports each kernel's
registers, spills and shared memory into ``<library>.ptxas.txt`` beside it.
The library is loaded with
``ctypes``; each entry point launches on the stream it is given and returns
the launch's ``cudaError_t``, which :func:`check` turns into an exception.

There is no CPU fallback here: :func:`library` raises ``RuntimeError`` when
there is no CUDA device or no ``nvcc``. The ops modules route CPU tensors to
their plain PyTorch versions before they ever ask for the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("crop.cu", "correlation.cu", "resample2d.cu", "fused_stage.cu",
           "stamp.cu")
HEADERS = ("hopper.cuh",)
CHECKOUT_BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
                      / "flowtrack_tpu_torch")


def _writable(path: Path) -> bool:
    """Whether ``path`` can be made or written: its nearest existing
    ancestor is a writable directory."""
    while not path.exists() and path != path.parent:
        path = path.parent
    return path.is_dir() and os.access(path, os.W_OK)


def build_dir(default: Path = CHECKOUT_BUILD_DIR) -> Path:
    """Where the kernels and the native NMS are built: ``default``
    (``build/flowtrack_tpu_torch`` beside the package, in a checkout) when
    it can be written, else ``flowtrack_tpu_torch`` in the user's cache
    directory ($XDG_CACHE_HOME, or ~/.cache)."""
    if _writable(default):
        return default
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return Path(cache) / "flowtrack_tpu_torch"


BUILD_DIR = build_dir()
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "ft_crop_resize_normalize": [_P, _I, _I, _I, _I, _P, _I, _P, _P, _I, _I,
                                 _I, _F, _F, _F, _F, _F, _F, _F, _F, _P, _I,
                                 _P, _P],
    "ft_correlation_forward": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                               _P],
    "ft_resample2d_forward": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "ft_correlation_mma": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "ft_fused_conv_wgmma": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _I, _I, _I, _I, _P],
    "ft_fused_block": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                       _I, _I, _I, _P],
    "ft_stamp": [_P, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found is None and CUDA_HOME:
        candidate = Path(CUDA_HOME) / "bin" / "nvcc"
        found = str(candidate) if candidate.exists() else None
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "flowtrack_tpu_torch are built with the CUDA "
                           "toolkit's nvcc")
    return found


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        digest.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libflowtrack_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library of the same sources exists.
    Raises RuntimeError without a CUDA device or without nvcc."""
    if not torch.cuda.is_available():
        raise RuntimeError("flowtrack_tpu_torch kernels need a CUDA device; "
                           "CPU tensors take the plain PyTorch versions")
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(CSRC / src)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for src, obj in zip(SOURCES, objs)]
    failed, report = [], []
    for src, proc in zip(SOURCES, procs):
        _, err = proc.communicate()
        report.append(f"==== {src}\n{err}")
        if proc.returncode != 0:
            failed.append(f"{src} ({proc.returncode}):\n{err}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = out.with_name(f"{tag}.tmp")
    proc = subprocess.run([nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    for obj in objs:
        obj.unlink()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{proc.stderr}")
    out.with_suffix(".ptxas.txt").write_text("\n".join(report))
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.ft_error_string.argtypes = [ctypes.c_int]
        lib.ft_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = library().ft_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({err})")
