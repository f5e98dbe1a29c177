"""Guidance channels: extreme points of a mask, n-ellipse, gaussian point
heatmaps and their combination, in crop coordinates, and the
confidence-map family (skewed-axes L1+L2 and multivariate gaussian).

Copies of ``distributedpytorch_tpu/data/guidance.py``'s extreme points
(consuming the same ``np.random.Generator`` draws in the same order),
click families and confidence maps, kept here so the port never imports
the JAX package.  The
tests pin them to the originals.  As in the JAX package, the n-ellipse on
a full pixel grid runs on the port's host library (:mod:`..native_ops`)
unless ``DPTPU_NATIVE=0``, which selects the numpy form.
"""

from __future__ import annotations

import numpy as np

from .. import native_ops
from ..utils.helpers import make_gt


def _extreme_point_candidates(mask: np.ndarray, pert: int):
    """For each side (left, top, right, bottom), the mask pixels within
    ``pert`` px of that side's extreme coordinate."""
    ys, xs = np.where(mask > 0.5)
    out = []
    for vals, other, extreme in ((xs, ys, xs.min()), (ys, xs, ys.min()),
                                 (xs, ys, xs.max()), (ys, xs, ys.max())):
        sel = np.abs(vals - extreme) <= pert
        out.append((vals[sel], other[sel]))
    return out


def extreme_points(mask: np.ndarray, pert: int,
                   rng: np.random.Generator | None = None) -> np.ndarray:
    """Randomized 4 extreme points (x, y) of ``mask``: one candidate of each
    side drawn uniformly from ``rng``."""
    rng = rng or np.random.default_rng()
    pts = []
    for i, (vals, other) in enumerate(_extreme_point_candidates(mask, pert)):
        k = int(rng.integers(0, len(vals)))
        v, o = int(vals[k]), int(other[k])
        pts.append((v, o) if i in (0, 2) else (o, v))
    return np.asarray(pts, dtype=np.int64)


def extreme_points_fixed(mask: np.ndarray, pert: int = 0) -> np.ndarray:
    """Deterministic 4 extreme points (x, y): the median candidate of each
    side."""
    pts = []
    for i, (vals, other) in enumerate(_extreme_point_candidates(mask, pert)):
        k = len(vals) // 2
        order = np.argsort(other)
        v, o = int(vals[order[k]]), int(other[order[k]])
        pts.append((v, o) if i in (0, 2) else (o, v))
    return np.asarray(pts, dtype=np.int64)


def _sum_of_distances(x_range, y_range, points) -> np.ndarray:
    """d[i, j] = sum_k || (x_j, y_i) - p_k || over the focal points."""
    xx = np.asarray(x_range, dtype=np.float32)
    yy = np.asarray(y_range, dtype=np.float32)
    X, Y = np.meshgrid(xx, yy)
    d = np.zeros_like(X)
    for px, py in np.asarray(points, dtype=np.float32):
        d += np.sqrt((X - px) ** 2 + (Y - py) ** 2)
    return d


def compute_nellipse(x_range, y_range, points,
                     softness: float = 0.05) -> np.ndarray:
    """Soft indicator in [0, 1] of the n-ellipse with foci at ``points``,
    whose boundary passes through the outermost point; the edge decays
    with relative width ``softness``."""
    points = np.asarray(points, dtype=np.float32)
    if points.size == 0:
        raise ValueError("compute_nellipse requires at least one focal point")
    xx, yy = np.asarray(x_range), np.asarray(y_range)
    if (native_ops.enabled() and xx.ndim == 1 and yy.ndim == 1
            and xx.size and yy.size
            and np.array_equal(xx, np.arange(xx.size))
            and np.array_equal(yy, np.arange(yy.size))):
        # full 0-based pixel grids: every call site of the pipeline and
        # of serving
        return native_ops.nellipse(points[:, :2], (yy.size, xx.size),
                                   softness)
    d = _sum_of_distances(x_range, y_range, points)
    per_point = [
        sum(np.hypot(px - qx, py - qy) for qx, qy in points) for px, py in points
    ]
    c = float(max(per_point))
    if c <= 0:  # degenerate: all points coincide
        z = np.zeros_like(d)
        z[d == 0] = 1.0
        return z
    tau = softness * c
    z = 1.0 / (1.0 + np.exp(np.clip((d - c) / tau, -50.0, 50.0)))
    return z.astype(np.float32)


def compute_nellipse_gaussian_hm(x_range, y_range, points, sigma: float = 10.0,
                                 softness: float = 0.05
                                 ) -> tuple[np.ndarray, np.ndarray]:
    """(n-ellipse indicator, gaussian point heatmap), both in [0, 1]."""
    z1 = compute_nellipse(x_range, y_range, points, softness=softness)
    size = (len(y_range), len(x_range))
    z2 = make_gt(np.zeros(size, np.float32), points, sigma=sigma)
    return z1, z2


def nellipse_map(shape_hw: tuple[int, int], points) -> np.ndarray:
    """The n-ellipse guidance channel, float32 in [0, 255]."""
    h, w = shape_hw
    z = compute_nellipse(np.arange(w), np.arange(h),
                         np.asarray(points, np.float64))
    return (z * 255.0).astype(np.float32)


def extreme_points_map(shape_hw: tuple[int, int], points,
                       sigma: float = 10.0) -> np.ndarray:
    """The gaussian extreme-point heatmap channel, float32 in [0, 1]."""
    return make_gt(np.zeros(shape_hw, np.float32), points, sigma=sigma)


def nellipse_gaussians_map(shape_hw: tuple[int, int], points,
                           alpha: float = 0.6,
                           sigma: float = 10.0) -> np.ndarray:
    """The served guidance channel: ``z1 + alpha * z2`` rescaled to peak at
    exactly 255, float32 in [0, 255]."""
    h, w = shape_hw
    z1, z2 = compute_nellipse_gaussian_hm(
        np.arange(w), np.arange(h), np.asarray(points, np.float64),
        sigma=sigma)
    z = z1 * 255.0 + z2 * 255.0 * alpha
    z *= 255.0 / z.max()
    return np.clip(z, 0.0, 255.0).astype(np.float32)


#: guidance families computable from the 4 clicks alone
POINT_GUIDANCE = {
    "nellipse_gaussians":
        lambda shape, pts, alpha: nellipse_gaussians_map(shape, pts, alpha=alpha),
    "nellipse":
        lambda shape, pts, alpha: nellipse_map(shape, pts),
    "extreme_points":
        lambda shape, pts, alpha: extreme_points_map(shape, pts),
}


def guidance_from_points(shape_hw: tuple[int, int], points: np.ndarray,
                         alpha: float = 0.6,
                         family: str = "nellipse_gaussians") -> np.ndarray:
    """Crop-space guidance map of one of :data:`POINT_GUIDANCE`, float32."""
    points = np.asarray(points, np.float64)
    try:
        build = POINT_GUIDANCE[family]
    except KeyError:
        raise ValueError(
            f"unknown guidance family: {family!r} "
            f"({' | '.join(POINT_GUIDANCE)})") from None
    return build(shape_hw, points, alpha)


def scale_points_to_crop(points: np.ndarray, bbox: tuple[int, int, int, int],
                         resolution: tuple[int, int]) -> np.ndarray:
    """Full-image xy points into resized-crop coordinates, clipped to it."""
    points = np.asarray(points, np.float64)
    res_h, res_w = resolution
    scale = np.array([res_w / (bbox[2] - bbox[0] + 1),
                      res_h / (bbox[3] - bbox[1] + 1)])
    crop_pts = (points - np.array([bbox[0], bbox[1]])) * scale
    return np.clip(crop_pts, 0, [res_w - 1, res_h - 1])


def crop_point_guidance(points: np.ndarray, bbox: tuple[int, int, int, int],
                        resolution: tuple[int, int], alpha: float = 0.6,
                        family: str = "nellipse_gaussians") -> np.ndarray:
    """Full-image clicks + crop bbox -> the crop-space guidance channel at
    ``resolution``: :func:`scale_points_to_crop` then
    :func:`guidance_from_points`."""
    crop_pts = scale_points_to_crop(points, bbox, resolution)
    return guidance_from_points(resolution, crop_pts, alpha=alpha,
                                family=family)


def normalize_wt_map(wt_map: np.ndarray) -> np.ndarray:
    """Min-max normalise a weight map to [0, 1]."""
    lo, hi = float(wt_map.min()), float(wt_map.max())
    return (wt_map - lo) / (hi - lo + 1e-10)


def generate_mvgauss_image(mask: np.ndarray, FULL_IMAGE_WEIGHTS: int = 1,
                           tau: float = 0.5) -> np.ndarray:
    """Multivariate gaussian confidence map of the mask's pixel cloud: its
    first and second moments, the unnormalised density over the whole
    image raised to ``tau``; float32."""
    ys, xs = np.where(mask > 0.5)
    pts = np.stack([xs, ys], axis=1).astype(np.float64)
    mean = pts.mean(axis=0)
    if pts.shape[0] < 2:
        # one pixel has no sample covariance (np.cov gives NaN): an
        # isotropic unit covariance centred on it
        cov = np.eye(2)
    else:
        cov = np.cov(pts.T) + np.eye(2) * 1e-3
    icov = np.linalg.inv(cov)
    h, w = mask.shape[:2]
    X, Y = np.meshgrid(np.arange(w), np.arange(h))
    dx = X - mean[0]
    dy = Y - mean[1]
    m = icov[0, 0] * dx * dx + (icov[0, 1] + icov[1, 0]) * dx * dy \
        + icov[1, 1] * dy * dy
    out = np.exp(-0.5 * tau * m)
    if not FULL_IMAGE_WEIGHTS:
        out = out * (mask > 0.5)
    return out.astype(np.float32)


def generate_mv_l1l2_image_skewed_axes(mask: np.ndarray,
                                       extreme_points: np.ndarray,
                                       FULL_IMAGE_WEIGHTS: int = 1,
                                       d2_THRESH: float | None = None,
                                       tau: float = 1.0):
    """L1+L2 confidence map along the skewed axes of the extreme points
    (left -> right and top -> bottom chords): each pixel's affine
    coordinates (u, v) on those axes weigh ``exp(-tau ((|u| + |v|) +
    sqrt(u² + v²)) / 2)``.  Returns ``(h_map, u, v)``, float32."""
    pts = np.asarray(extreme_points, dtype=np.float64)
    left, top, right, bottom = pts[0], pts[1], pts[2], pts[3]
    center = pts.mean(axis=0)
    a1 = (right - left) / 2.0
    a2 = (bottom - top) / 2.0
    A = np.stack([a1, a2], axis=1)  # columns are the axes
    if abs(np.linalg.det(A)) < 1e-6:  # near-singular axis pair
        A = A + np.eye(2) * 1e-3
    Ainv = np.linalg.inv(A)

    h, w = mask.shape[:2]
    X, Y = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    dx = X - center[0]
    dy = Y - center[1]
    u = Ainv[0, 0] * dx + Ainv[0, 1] * dy
    v = Ainv[1, 0] * dx + Ainv[1, 1] * dy

    l1 = np.abs(u) + np.abs(v)
    l2 = np.sqrt(u * u + v * v)
    h_map = np.exp(-tau * (l1 + l2) / 2.0)
    if d2_THRESH is not None:
        h_map = np.where(l2 > d2_THRESH, 0.0, h_map)
    if not FULL_IMAGE_WEIGHTS:
        h_map = h_map * (mask > 0.5)
    return h_map.astype(np.float32), u.astype(np.float32), v.astype(np.float32)
