"""ctypes bindings for the port's host image library
(``csrc/host_image_ops.cpp``).

Counterpart of ``distributedpytorch_tpu/native_ops.py``: the hot per-sample
CPU ops of the data pipeline and of serving's ``prepare`` — resize, affine
warp, fused crop + resize, horizontal flip, the gaussian point heatmap and
the n-ellipse — as a C++ library loaded through ctypes.  The library is
built at first use from the port's own source by ``ops/_build.py`` (the
host C++ compiler, into ``build/kernels/``); a failed build raises.  No
other library is ever loaded: not ``native/libdptpu_host.so``, not a path
from the environment.

The numpy forms in :mod:`.imaging`, :mod:`.utils.helpers` and
:mod:`.data.guidance` are the plain versions each op is held against.
Those modules route to this library unless ``DPTPU_NATIVE=0``
(:func:`enabled`), which selects the numpy forms, as in the JAX package;
nothing else does.  Every wrapper takes and returns float32 numpy arrays
(HW or HWC, C-contiguous) and adds one to its entry of :data:`calls`.
This module imports only ctypes, numpy and the standard library.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from .ops import _build

NEAREST, BILINEAR, BICUBIC = 0, 1, 2
LIBRARY = "host_image_ops"

_lib = None
#: library calls in this process, by op
calls = {"resize": 0, "warp_affine": 0, "crop_resize": 0, "hflip": 0,
         "gaussian_hm": 0, "nellipse": 0}


def reset_calls() -> None:
    for k in calls:
        calls[k] = 0


def _bind(lib):
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    i = ctypes.c_int
    f = ctypes.c_float
    lib.resize_f32.argtypes = [f32p, i, i, i, f32p, i, i, i]
    lib.warp_affine_f32.argtypes = [f32p, i, i, i, f32p, i, i, f64p, i, f]
    lib.crop_resize_f32.argtypes = [f32p, i, i, i, i, i, i, i, f32p, i, i, i]
    lib.hflip_f32.argtypes = [f32p, i, i, i, f32p]
    lib.gaussian_hm_f32.argtypes = [f32p, i, i, i, f, f32p]
    lib.nellipse_f32.argtypes = [f32p, i, i, i, f, f32p]
    for fn in (lib.resize_f32, lib.warp_affine_f32, lib.crop_resize_f32,
               lib.hflip_f32, lib.gaussian_hm_f32, lib.nellipse_f32):
        fn.restype = None
    return lib


def load():
    """The library, built from ``csrc/host_image_ops.cpp`` on first use."""
    global _lib
    if _lib is None:
        _lib = _bind(_build.library(LIBRARY))
    return _lib


def enabled() -> bool:
    """Whether the host ops route here: unless ``DPTPU_NATIVE=0``."""
    return os.environ.get("DPTPU_NATIVE") != "0"


def _prep(arr: np.ndarray) -> tuple[np.ndarray, int, int, int, bool]:
    """-> (contiguous f32 array, h, w, c, had_channel_dim)."""
    a = np.ascontiguousarray(arr, dtype=np.float32)
    if a.ndim == 2:
        h, w = a.shape
        return a, h, w, 1, False
    if a.ndim == 3:
        h, w, c = a.shape
        return a, h, w, c, True
    raise ValueError(f"expected HW or HWC array, got shape {arr.shape}")


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def resize(arr: np.ndarray, size: tuple[int, int],
           mode: int = BILINEAR) -> np.ndarray:
    """Resize to (H, W) with nearest/bilinear/bicubic (cv2 conventions)."""
    lib = load()
    a, h, w, c, chan = _prep(arr)
    dh, dw = size
    out = np.empty((dh, dw, c), np.float32)
    calls["resize"] += 1
    lib.resize_f32(_ptr(a), h, w, c, _ptr(out), dh, dw, mode)
    return out if chan else out[..., 0]


def warp_affine(arr: np.ndarray, m: np.ndarray, size: tuple[int, int],
                mode: int = BICUBIC, border: float = 0.0) -> np.ndarray:
    """cv2.warpAffine-convention warp: ``m`` is the 2x3 forward matrix."""
    lib = load()
    a, h, w, c, chan = _prep(arr)
    dh, dw = size
    m64 = np.ascontiguousarray(m, dtype=np.float64).reshape(6)
    out = np.empty((dh, dw, c), np.float32)
    calls["warp_affine"] += 1
    lib.warp_affine_f32(_ptr(a), h, w, c, _ptr(out), dh, dw,
                        m64.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                        mode, border)
    return out if chan else out[..., 0]


def crop_resize(arr: np.ndarray, bbox, size: tuple[int, int],
                mode: int = BICUBIC) -> np.ndarray:
    """Fused crop-to-bbox + resize: the inclusive window ``bbox``
    (x0, y0, x1, y1; may extend beyond the image — the overhang reads 0,
    the zero-pad crop convention) resized to ``size`` without materializing
    the intermediate crop."""
    lib = load()
    a, h, w, c, chan = _prep(arr)
    x0, y0, x1, y1 = (int(v) for v in bbox)
    dh, dw = size
    out = np.empty((dh, dw, c), np.float32)
    calls["crop_resize"] += 1
    lib.crop_resize_f32(_ptr(a), h, w, c, x0, y0, x1, y1,
                        _ptr(out), dh, dw, mode)
    return out if chan else out[..., 0]


def hflip(arr: np.ndarray) -> np.ndarray:
    lib = load()
    a, h, w, c, chan = _prep(arr)
    out = np.empty_like(a).reshape(h, w, c)
    calls["hflip"] += 1
    lib.hflip_f32(_ptr(a), h, w, c, _ptr(out))
    return out if chan else out[..., 0]


def gaussian_hm(points_xy, size: tuple[int, int],
                sigma: float = 10.0) -> np.ndarray:
    """Max-combined FWHM-``sigma`` gaussian bumps (helpers.make_gt)."""
    lib = load()
    pts = np.ascontiguousarray(points_xy, dtype=np.float32).reshape(-1, 2)
    h, w = size
    out = np.empty((h, w), np.float32)
    calls["gaussian_hm"] += 1
    lib.gaussian_hm_f32(_ptr(pts), pts.shape[0], h, w, float(sigma),
                        _ptr(out))
    return out


def nellipse(points_xy, size: tuple[int, int],
             softness: float = 0.05) -> np.ndarray:
    """Soft n-ellipse indicator (guidance.compute_nellipse)."""
    lib = load()
    pts = np.ascontiguousarray(points_xy, dtype=np.float32).reshape(-1, 2)
    h, w = size
    out = np.empty((h, w), np.float32)
    calls["nellipse"] += 1
    lib.nellipse_f32(_ptr(pts), pts.shape[0], h, w, float(softness),
                     _ptr(out))
    return out
