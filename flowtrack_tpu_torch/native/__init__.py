"""Host NMS in C++: ``cpu_nms`` and ``cpu_oks_nms``.

Port of ``flowtrack_tpu/native/__init__.py`` (:28-128) over the port's own
copy of ``nms.cc``. The source is compiled with ``g++`` at first use (a
plain C interface bound through ctypes, no Python.h) into
``build/flowtrack_tpu_torch/`` beside the package, under a name that
carries the source's hash, so an edited source is built again; nothing is
written beside the source. This is host code, not a card kernel: without
``g++`` (or the source) the numpy versions of ``ops/nms.py`` answer, with
a logged warning, and give the same indices.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from flowtrack_tpu_torch.config import COCO_SIGMAS
from flowtrack_tpu_torch.kernels import BUILD_DIR
from flowtrack_tpu_torch.ops.nms import nms_boxes_np, oks_nms_np

log = logging.getLogger("flowtrack.native")

SRC = Path(__file__).resolve().parent / "nms.cc"
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path() -> Path:
    """Where the library built from the current ``nms.cc`` lives."""
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libnms_{digest}.so"


def _build(path: Path) -> Optional[Path]:
    # built under a name of this process's own, then renamed, so that
    # processes building at once never load a half-written file
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(SRC),
           "-o", str(tmp)]
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
        return path
    except Exception as e:  # noqa: BLE001 - any toolchain failure
        log.warning("native nms build failed (%s); using numpy fallback", e)
        tmp.unlink(missing_ok=True)
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    try:
        want = library_path()
    except OSError as e:  # no source beside the package
        log.warning("native nms source missing (%s); using numpy "
                    "fallback", e)
        _build_failed = True
        return None
    path = want if want.exists() else _build(want)
    if path is None:
        _build_failed = True
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:  # a library for another machine: build it once more
        path.unlink(missing_ok=True)
        path = _build(want)
        if path is None:
            _build_failed = True
            return None
        lib = ctypes.CDLL(str(path))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.cpu_nms.restype = ctypes.c_int
    lib.cpu_nms.argtypes = [f32p, f32p, ctypes.c_int, ctypes.c_float, i32p]
    lib.cpu_oks_nms.restype = ctypes.c_int
    lib.cpu_oks_nms.argtypes = [f32p, f32p, f32p, ctypes.c_int,
                                ctypes.c_int, f32p, ctypes.c_float,
                                ctypes.c_float, ctypes.c_int, i32p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def cpu_nms(dets: np.ndarray, thresh: float):
    """dets: (N, 5) [x1, y1, x2, y2, score] -> kept indices (desc score).

    C++ when the toolchain is there, numpy otherwise (the same indices)."""
    dets = np.ascontiguousarray(dets, np.float32)
    n = len(dets)
    if n == 0:
        return []
    lib = _load()
    if lib is None:
        return nms_boxes_np(dets.astype(np.float64), thresh)
    keep = np.zeros(n, np.int32)
    boxes = np.ascontiguousarray(dets[:, :4])
    scores = np.ascontiguousarray(dets[:, 4])
    m = lib.cpu_nms(boxes, scores, n, float(thresh), keep)
    return keep[:m].tolist()


def cpu_oks_nms(kpts_list, thresh: float, sigmas=None, in_vis_thre=None):
    """The lineage's oks_nms (``ops/nms.oks_nms_np``) in C++."""
    n = len(kpts_list)
    if n == 0:
        return []
    lib = _load()
    if lib is None:
        return oks_nms_np(kpts_list, thresh, sigmas, in_vis_thre)
    kpts = np.ascontiguousarray(
        [np.asarray(d["keypoints"], np.float32).reshape(-1)
         for d in kpts_list], np.float32)
    scores = np.ascontiguousarray([d["score"] for d in kpts_list],
                                  np.float32)
    areas = np.ascontiguousarray([d["area"] for d in kpts_list], np.float32)
    k = kpts.shape[1] // 3
    sig = np.ascontiguousarray(sigmas if sigmas is not None else COCO_SIGMAS,
                               np.float32)
    keep = np.zeros(n, np.int32)
    m = lib.cpu_oks_nms(kpts, scores, areas, n, k, sig, float(thresh),
                        float(in_vis_thre or 0.0),
                        1 if in_vis_thre is not None else 0, keep)
    return keep[:m].tolist()
