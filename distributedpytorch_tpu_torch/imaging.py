"""Host image resize with OpenCV's conventions, in numpy.

Counterpart of ``distributedpytorch_tpu/imaging.py``'s ``resize``.  The
card's machine has no OpenCV, so the port keeps its own resize with the
conventions ``native/image_ops.cpp`` pins to cv2's: pixel-centre sampling
(``src = (dst + 0.5) * scale - 0.5``) for linear and cubic, ``floor(dst *
scale)`` for nearest, the a = -0.75 bicubic kernel, and replicated borders.

Each axis becomes a dense (dst x src) interpolation matrix, so a resize is
two matrix products; an out-of-range tap is clamped to the edge pixel,
which is how the replicated border arises.
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
