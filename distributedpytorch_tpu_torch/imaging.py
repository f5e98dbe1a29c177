"""Host image ops with OpenCV's conventions.

Counterpart of ``distributedpytorch_tpu/imaging.py`` (``resize``,
``warp_affine``, ``flip_h``, ``rotation_matrix``, ``backend``), plus
``crop_resize``, the fused zero-padded crop + resize of
``data.fused_crop_resize``.  The
card's machine is not promised OpenCV, so the port has no cv2 backend:
``resize``, ``warp_affine``, ``flip_h`` and ``crop_resize`` run on the
port's host library (:mod:`.native_ops`, built at first use) unless
``DPTPU_NATIVE=0``, which selects their numpy forms (``resize_numpy``,
``warp_affine_numpy``,
``flip_h_numpy``, ``crop_resize_numpy``) — the plain versions the library
is held against.  Through the library, arrays compute in float32 and
integer outputs are rounded and saturated as in the numpy forms; a flip of
an array that float32 does not hold exactly takes the numpy form.

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

from . import native_ops

#: interpolation modes (the JAX package's values)
NEAREST, LINEAR, CUBIC = 0, 1, 2
#: dtypes that float32 holds exactly (a flip through the library is exact)
_FLOAT32_EXACT = (np.float32, np.uint8, np.int8, np.uint16, np.int16, np.bool_)


def backend() -> str:
    """The name of the host ops' implementation: the port's library
    (``port-native``) or its numpy forms (``port-numpy``,
    ``DPTPU_NATIVE=0``).  The prepared cache's fingerprint names it, as the
    two differ in the last bits of a cubic tap."""
    return "port-native" if native_ops.enabled() else "port-numpy"


def _like(out: np.ndarray, dtype: np.dtype) -> np.ndarray:
    """The library's float32 result in ``dtype``: integers rounded and
    saturated, as the numpy forms do."""
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return np.clip(np.rint(out), info.min, info.max).astype(dtype)
    return out if dtype == np.float32 else out.astype(dtype)


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
    if native_ops.enabled():
        arr = np.asarray(arr)
        if interp not in (NEAREST, LINEAR, CUBIC):
            raise ValueError(f"unknown interpolation {interp} (0 nearest, "
                             "1 linear, 2 cubic)")
        return _like(native_ops.resize(arr, (int(size[0]), int(size[1])),
                                       interp), arr.dtype)
    return resize_numpy(arr, size, interp)


def resize_numpy(arr: np.ndarray, size: tuple[int, int],
                 interp: int = CUBIC) -> np.ndarray:
    """:func:`resize`'s numpy form."""
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
    arr = np.asarray(arr)
    if native_ops.enabled() and arr.ndim in (2, 3) \
            and arr.dtype.type in _FLOAT32_EXACT:
        return native_ops.hflip(arr).astype(arr.dtype, copy=False)
    return flip_h_numpy(arr)


def flip_h_numpy(arr: np.ndarray) -> np.ndarray:
    """:func:`flip_h`'s numpy form."""
    return np.ascontiguousarray(np.asarray(arr)[:, ::-1])


def crop_resize(arr: np.ndarray, bbox, size: tuple[int, int],
                interp: int = CUBIC) -> np.ndarray:
    """The inclusive window ``bbox`` = (x0, y0, x1, y1) of ``arr`` (H, W[,
    C]), zero where it leaves the image, resized to ``size`` = (H, W):
    ``helpers.crop_from_bbox(zero_pad=True)`` then :func:`resize`, in one
    pass on the library.  Always float32."""
    if native_ops.enabled():
        return native_ops.crop_resize(arr, bbox, (int(size[0]), int(size[1])),
                                      interp)
    return crop_resize_numpy(arr, bbox, size, interp)


def crop_resize_numpy(arr: np.ndarray, bbox, size: tuple[int, int],
                      interp: int = CUBIC) -> np.ndarray:
    """:func:`crop_resize`'s numpy form: the zero-padded crop in float32,
    then :func:`resize_numpy`."""
    arr = np.asarray(arr)
    x0, y0, x1, y1 = (int(v) for v in bbox)
    h, w = arr.shape[:2]
    crop = np.zeros((y1 - y0 + 1, x1 - x0 + 1) + arr.shape[2:], np.float32)
    ys, xs = max(y0, 0), max(x0, 0)
    ye, xe = min(y1, h - 1), min(x1, w - 1)
    if ye >= ys and xe >= xs:
        crop[ys - y0:ye - y0 + 1, xs - x0:xe - x0 + 1] = arr[ys:ye + 1, xs:xe + 1]
    return resize_numpy(crop, size, interp)


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
    if native_ops.enabled():
        arr = np.asarray(arr)
        border = float(np.asarray(border).astype(arr.dtype))
        return _like(native_ops.warp_affine(
            arr, m, (int(size[0]), int(size[1])), interp, border), arr.dtype)
    return warp_affine_numpy(arr, m, size, interp, border)


def warp_affine_numpy(arr: np.ndarray, m: np.ndarray, size: tuple[int, int],
                      interp: int = CUBIC, border: float = 0.0) -> np.ndarray:
    """:func:`warp_affine`'s numpy form.  Cubic taps add in float64; an
    integer output is rounded from the float32 sum, as the library's is."""
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
            acc = np.clip(np.rint(acc.astype(np.float32)), info.min, info.max)
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
