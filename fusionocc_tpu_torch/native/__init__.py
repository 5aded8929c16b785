"""ctypes bindings of the host point-cloud library (``pointops.cpp``).

The port's copy of ``fusionocc_tpu/native``.  The first call in a process
compiles ``pointops.cpp`` with ``g++ -O3 -shared -fPIC -fopenmp`` into
``fusionocc_tpu_torch/_build/`` (named by a hash of the source and flags,
so an edit rebuilds), never next to the source, and loads it.  Each entry
point has a numpy version with the same semantics (``*_np``), which the
tests hold the library against; where the build fails (no compiler), the
entry points take the numpy versions.  ``STATS`` says whether the library
was built and counts the calls that went through it, so a run can show
that it used it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / 'pointops.cpp'
BUILD_DIR = Path(__file__).resolve().parent.parent / '_build'
GXX_FLAGS = ['-O3', '-shared', '-fPIC', '-fopenmp', '-std=c++17']


class NativeStats:
    """Whether the library was built (None: not tried yet) and the calls of
    each entry point that went through it."""

    def __init__(self):
        self.built: Optional[bool] = None
        self.path: Optional[str] = None
        self.error: Optional[str] = None
        self.calls: Dict[str, int] = {}
        self._lock = threading.Lock()     # the loader calls from threads

    def count(self, name: str) -> None:
        with self._lock:
            self.calls[name] = self.calls.get(name, 0) + 1


STATS = NativeStats()
_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _build() -> Optional[Path]:
    digest = hashlib.sha256(_SRC.read_bytes()
                            + ' '.join(GXX_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f'libpointops_{digest}.so'
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f'.{os.getpid()}.tmp')
    try:
        subprocess.run(['g++', *GXX_FLAGS, str(_SRC), '-o', str(tmp)],
                       check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        STATS.error = f'{type(e).__name__}: {getattr(e, "stderr", e)}'
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, so)
    return so


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built at the first call; None if it cannot be
    built."""
    global _lib
    with _lock:
        if STATS.built is None:
            so = _build()
            STATS.built = so is not None
            if so is not None:
                lib = ctypes.CDLL(str(so))
                f32p = ctypes.POINTER(ctypes.c_float)
                f64p = ctypes.POINTER(ctypes.c_double)
                u8p = ctypes.POINTER(ctypes.c_uint8)
                i64 = ctypes.c_int64
                lib.zbuffer_depth.argtypes = [f32p, i64, i64, i64,
                                              ctypes.c_float, ctypes.c_float,
                                              f32p]
                lib.transform_points.argtypes = [f32p, i64, i64, f64p, f32p]
                lib.range_filter_mask.argtypes = [f32p, i64, i64, f32p, f32p,
                                                  ctypes.c_float, u8p]
                lib.project_points.argtypes = [f32p, i64, i64, f64p, f64p,
                                               f64p, f32p]
                for fn in (lib.zbuffer_depth, lib.transform_points,
                           lib.range_filter_mask, lib.project_points):
                    fn.restype = None
                STATS.path, _lib = str(so), lib
    return _lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def zbuffer_depth_np(uvd: np.ndarray, height: int, width: int,
                     depth_range) -> np.ndarray:
    from ..data.pipeline import points_to_depthmap_np
    return points_to_depthmap_np(np.asarray(uvd, np.float32), height, width,
                                 depth_range)


def transform_points_np(pts: np.ndarray, T: np.ndarray) -> np.ndarray:
    pts = np.asarray(pts, np.float32)
    out = pts.copy()
    out[:, :3] = (pts[:, :3].astype(np.float64) @ T[:3, :3].T
                  + T[:3, 3]).astype(np.float32)
    return out


def range_filter_mask_np(pts: np.ndarray, pcr, eps: float = 1e-3
                         ) -> np.ndarray:
    pts = np.asarray(pts, np.float32)
    lo = np.asarray(pcr[:3], np.float32)
    hi = np.asarray(pcr[3:], np.float32)
    return np.all((pts[:, :3] >= lo + eps) & (pts[:, :3] <= hi - eps), axis=1)


def project_points_np(pts: np.ndarray, lidar2img: np.ndarray,
                      post_rot: np.ndarray, post_tran: np.ndarray
                      ) -> np.ndarray:
    from ..data.pipeline import project_points_to_cam
    return project_points_to_cam(np.asarray(pts, np.float32),
                                 lidar2img.astype(np.float32),
                                 np.eye(3, dtype=np.float32),
                                 post_rot.astype(np.float32),
                                 post_tran.astype(np.float32))


def zbuffer_depth(uvd: np.ndarray, height: int, width: int,
                  depth_range) -> np.ndarray:
    """Min-depth z-buffer (height, width) of (P, 3) (u, v, depth): each
    point rounds to its pixel (half to even), the nearest depth in
    [lo, hi) wins, 0 where none lands."""
    lib = get_lib()
    uvd = np.ascontiguousarray(uvd, np.float32)
    if lib is None:
        return zbuffer_depth_np(uvd, height, width, depth_range)
    out = np.empty((height, width), np.float32)
    lib.zbuffer_depth(_ptr(uvd, ctypes.c_float), len(uvd), height, width,
                      float(depth_range[0]), float(depth_range[1]),
                      _ptr(out, ctypes.c_float))
    STATS.count('zbuffer_depth')
    return out


def transform_points(pts: np.ndarray, T: np.ndarray) -> np.ndarray:
    """The xyz of (P, D) points through the 4x4 ``T`` (float64 math);
    the other columns copied."""
    lib = get_lib()
    pts = np.ascontiguousarray(pts, np.float32)
    if lib is None:
        return transform_points_np(pts, T)
    out = np.empty_like(pts)
    T64 = np.ascontiguousarray(T, np.float64)
    lib.transform_points(_ptr(pts, ctypes.c_float), len(pts), pts.shape[1],
                         _ptr(T64, ctypes.c_double),
                         _ptr(out, ctypes.c_float))
    STATS.count('transform_points')
    return out


def range_filter_mask(pts: np.ndarray, pcr, eps: float = 1e-3) -> np.ndarray:
    """(P,) bool: xyz inside the point-cloud range shrunk by ``eps``."""
    lib = get_lib()
    pts = np.ascontiguousarray(pts, np.float32)
    if lib is None:
        return range_filter_mask_np(pts, pcr, eps)
    lo = np.asarray(pcr[:3], np.float32)
    hi = np.asarray(pcr[3:], np.float32)
    out = np.empty(len(pts), np.uint8)
    lib.range_filter_mask(_ptr(pts, ctypes.c_float), len(pts), pts.shape[1],
                          _ptr(lo, ctypes.c_float), _ptr(hi, ctypes.c_float),
                          eps, _ptr(out, ctypes.c_uint8))
    STATS.count('range_filter_mask')
    return out.astype(bool)


def project_points(pts: np.ndarray, lidar2img: np.ndarray,
                   post_rot: np.ndarray, post_tran: np.ndarray) -> np.ndarray:
    """(P, 3) (u, v, depth) through the full lidar2img (intrinsics folded
    in) and the augmentation homography, in float64."""
    lib = get_lib()
    pts = np.ascontiguousarray(pts, np.float32)
    if lib is None:
        return project_points_np(pts, lidar2img, post_rot, post_tran)
    l2c = np.ascontiguousarray(lidar2img[:3, :4], np.float64)
    pr = np.ascontiguousarray(post_rot, np.float64)
    pt = np.ascontiguousarray(post_tran, np.float64)
    out = np.empty((len(pts), 3), np.float32)
    lib.project_points(_ptr(pts, ctypes.c_float), len(pts), pts.shape[1],
                       _ptr(l2c, ctypes.c_double), _ptr(pr, ctypes.c_double),
                       _ptr(pt, ctypes.c_double), _ptr(out, ctypes.c_float))
    STATS.count('project_points')
    return out
