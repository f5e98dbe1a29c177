"""Host image ops with OpenCV's conventions, in numpy.

Counterpart of ``distributedpytorch_tpu/imaging.py`` (``resize``,
``warp_affine``, ``flip_h``, ``rotation_matrix``).  The card's machine has
no OpenCV, so the port keeps its own ops with cv2's conventions.

``resize``: the conventions ``native/image_ops.cpp`` pins to cv2's —
pixel-centre sampling (``src = (dst + 0.5) * scale - 0.5``) for linear and
cubic, ``floor(dst * scale)`` for nearest, the a = -0.75 bicubic kernel,
and replicated borders.  Each axis becomes a dense (dst x src)
interpolation matrix, so a resize is two matrix products; an out-of-range
tap is clamped to the edge pixel, which is how the replicated border
arises.

``warp_affine``: the arithmetic of OpenCV 5's ``warpAffine`` with a
constant border — the inverse map in float64, each output pixel's source
coordinate rounded to float32, nearest taking the pixel at the rounded
coordinate, cubic the 4 x 4 taps of the a = -0.75 kernel at the exact
fractional offset, rounded and saturated to an integer output type.
(OpenCV 4's fixed-point warp, 1/32-pixel steps and 15-bit weights, differs
from it by a grey level on a few percent of pixels.)
"""

from __future__ import annotations

import numpy as np

#: interpolation modes (the JAX package's values)
NEAREST, LINEAR, CUBIC = 0, 1, 2


def _cubic_weight(x: np.ndarray) -> np.ndarray:
    a = np.float32(-0.75)
    x = np.abs(x)
    near = ((a + 2) * x - (a + 3)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x <= 1, near, np.where(x < 2, far, 0)).astype(np.float32)


def _axis_matrix(dst: int, src: int, interp: int) -> np.ndarray:
    """(dst, src) float32 matrix mapping one source axis to one output axis."""
    mat = np.zeros((dst, src), np.float32)
    rows = np.arange(dst)
    if interp == NEAREST:
        idx = np.minimum(np.floor(rows * (1.0 / (dst / src))).astype(np.int64),
                         src - 1)
        mat[rows, idx] = 1.0
        return mat
    # cv2 takes the source coordinate in double and rounds it to float
    f = ((rows + 0.5) * (src / dst) - 0.5).astype(np.float32)
    base = np.floor(f).astype(np.int64)
    if interp == LINEAR:
        frac = (f - base).astype(np.float32)
        taps = ((base, 1 - frac), (base + 1, frac))
    elif interp == CUBIC:
        taps = tuple((base - 1 + t, _cubic_weight(f - (base - 1 + t)))
                     for t in range(4))
    else:
        raise ValueError(f"unknown interpolation {interp} (0 nearest, "
                         "1 linear, 2 cubic)")
    for idx, w in taps:
        np.add.at(mat, (rows, np.clip(idx, 0, src - 1)), w)
    return mat


def resize(arr: np.ndarray, size: tuple[int, int],
           interp: int = CUBIC) -> np.ndarray:
    """Resize an (H, W) or (H, W, C) array to ``size`` = (H, W).

    Float32 in, float32 out (other float types compute in float32 and cast
    back); integer arrays are rounded and saturated to their type, as cv2
    does."""
    arr = np.asarray(arr)
    if arr.ndim not in (2, 3):
        raise ValueError(f"expected (H, W) or (H, W, C), got {arr.shape}")
    h, w = arr.shape[:2]
    out_h, out_w = int(size[0]), int(size[1])
    wy = _axis_matrix(out_h, h, interp)
    wx = _axis_matrix(out_w, w, interp)
    src = arr.astype(np.float32, copy=False)
    if arr.ndim == 2:
        out = wy @ src @ wx.T
    else:
        out = np.einsum("yh,hwc,xw->yxc", wy, src, wx, optimize=True)
    out = out.astype(np.float32, copy=False)
    if np.issubdtype(arr.dtype, np.integer):
        info = np.iinfo(arr.dtype)
        return np.clip(np.rint(out), info.min, info.max).astype(arr.dtype)
    return out if arr.dtype == np.float32 else out.astype(arr.dtype)


def rotation_matrix(center: tuple[float, float], angle_deg: float,
                    scale: float) -> np.ndarray:
    """2 x 3 rotation + scale about ``center`` (x, y), positive angle
    counter-clockwise: ``cv2.getRotationMatrix2D``."""
    a = np.deg2rad(angle_deg)
    alpha, beta = scale * np.cos(a), scale * np.sin(a)
    cx, cy = (float(np.float32(c)) for c in center)  # cv2 takes a Point2f
    return np.array([
        [alpha, beta, (1 - alpha) * cx - beta * cy],
        [-beta, alpha, beta * cx + (1 - alpha) * cy],
    ], dtype=np.float64)


def flip_h(arr: np.ndarray) -> np.ndarray:
    """Left-right flip (``cv2.flip(arr, 1)``), as a new array."""
    return np.ascontiguousarray(np.asarray(arr)[:, ::-1])


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """cv2's inverse of a 2 x 3 affine map (a singular one maps to 0)."""
    m = np.asarray(m, np.float64).reshape(2, 3)
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a12, a21, a22 = m[1, 1] * d, -m[0, 1] * d, -m[1, 0] * d, m[0, 0] * d
    return np.array([[a11, a12, -a11 * m[0, 2] - a12 * m[1, 2]],
                     [a21, a22, -a21 * m[0, 2] - a22 * m[1, 2]]])


def warp_affine(arr: np.ndarray, m: np.ndarray, size: tuple[int, int],
                interp: int = CUBIC, border: float = 0.0) -> np.ndarray:
    """Warp ``arr`` (H, W[, C]) by the forward 2 x 3 matrix ``m`` to
    ``size`` = (H, W), pixels that map outside taking ``border``:
    ``cv2.warpAffine`` with ``BORDER_CONSTANT``, NEAREST or CUBIC.  The
    output keeps ``arr``'s dtype (integers rounded and saturated)."""
    if interp not in (NEAREST, CUBIC):
        raise ValueError(f"warp_affine supports nearest (0) and cubic (2), "
                         f"got {interp}")
    arr = np.asarray(arr)
    if arr.ndim not in (2, 3):
        raise ValueError(f"expected (H, W) or (H, W, C), got {arr.shape}")
    h, w = arr.shape[:2]
    inv = _invert_affine(m)
    ys, xs = np.mgrid[0:int(size[0]), 0:int(size[1])].astype(np.float64)
    sx = (inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]).astype(np.float32)
    sy = (inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]).astype(np.float32)
    src = arr if arr.ndim == 3 else arr[..., None]
    if interp == NEAREST:
        ix, iy = np.rint(sx).astype(np.int64), np.rint(sy).astype(np.int64)
        inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        out = np.where(inside[..., None],
                       src[np.clip(iy, 0, h - 1), np.clip(ix, 0, w - 1)],
                       np.asarray(border).astype(arr.dtype))
    else:
        # 4 x 4 taps from (x0 - 1, y0 - 1); a border of 4 pixels holds
        # every tap of a pixel that maps near or outside the image
        pad = 4
        padded = np.pad(src, ((pad, pad), (pad, pad), (0, 0)),
                        constant_values=np.asarray(border).astype(arr.dtype))
        x0, y0 = np.floor(sx), np.floor(sy)
        wx, wy = _cubic_taps(sx - x0), _cubic_taps(sy - y0)
        x0 = x0.astype(np.int64) - 1 + pad
        y0 = y0.astype(np.int64) - 1 + pad
        acc = np.zeros(sx.shape + (src.shape[2],), np.float64)
        for i in range(4):
            rows = np.clip(y0 + i, 0, padded.shape[0] - 1)
            for j in range(4):
                cols = np.clip(x0 + j, 0, padded.shape[1] - 1)
                acc += padded[rows, cols] * (wy[..., i] * wx[..., j])[..., None]
        if np.issubdtype(arr.dtype, np.integer):
            info = np.iinfo(arr.dtype)
            acc = np.clip(np.rint(acc), info.min, info.max)
        out = acc.astype(arr.dtype)
    return out if arr.ndim == 3 else out[..., 0]


def _cubic_taps(x: np.ndarray) -> np.ndarray:
    """The 4 weights of the a = -0.75 kernel at offset ``x`` in [0, 1),
    float32, as cv2's ``interpolateCubic``."""
    a = np.float32(-0.75)
    c0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + 1
    c2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
    return np.stack([c0, c1, c2, 1 - c0 - c1 - c2], -1).astype(np.float32)
