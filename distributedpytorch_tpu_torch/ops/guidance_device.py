"""Guidance synthesis on the device, the counterpart of
``distributedpytorch_tpu/ops/guidance_device.py``.

The 4th input channel (extreme points -> n-ellipse + gaussian heatmap, or
one of the other families) computed from ``crop_gt`` inside the step, so
the host ships only the image channels.  Plain PyTorch on the device (the
JAX module was XLA, not a Pallas kernel), batched over the samples and the
four sides: no per-sample Python loop, and no host synchronisation.

* :func:`extreme_points_from_ranks` — the draw-free core of the random
  extreme points: on each side, the candidate of the given rank in
  row-major order (the JAX cumsum rank-pick);
  :func:`extreme_points_random` draws the ranks uniformly from a
  ``torch.Generator``; :func:`extreme_points_fixed` takes each side's
  median candidate ordered by the other coordinate (the host's val rule);
* :func:`guidance_map` — the (B, H, W) channel of any of :data:`FAMILIES`;
* :func:`make_device_guidance` — the stage that appends it to ``concat``
  (NCHW) from ``crop_gt``.

A mask here is (B, H, W); a point set is (B, 4, 2) float32 (x, y) in the
order left, top, right, bottom.  Random draws come from an explicit
generator as uniforms, turned into ranks against each side's candidate
count, so the law is the JAX module's (a uniform candidate per side) on a
different stream; the tests feed JAX's own ranks through
:func:`extreme_points_from_ranks`.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

#: families this module synthesises on the device
FAMILIES = ("nellipse_gaussians", "nellipse", "extreme_points",
            "confidence_l1l2", "confidence_gaussian")

#: the JAX module's sentinel for "no candidate" in min/sort keys
_BIG = 1 << 30
#: -4 ln 2 in float32, as the JAX form evaluates ``-4.0 * jnp.log(2.0)``
_NEG_4_LN2 = float(np.float32(-4.0) * np.log(np.float32(2.0)))


def _grids(h: int, w: int, device, dtype=torch.int64):
    """(1, 1, W) x and (1, H, 1) y coordinate grids."""
    x = torch.arange(w, dtype=dtype, device=device)[None, None, :]
    y = torch.arange(h, dtype=dtype, device=device)[None, :, None]
    return x, y


def _side_candidates(mask: torch.Tensor, pert: int) -> torch.Tensor:
    """(B, 4, H, W) boolean candidates of (left, top, right, bottom): the
    foreground pixels within ``pert`` px of each side's extreme
    coordinate."""
    fg = mask > 0.5
    b, h, w = fg.shape
    x, y = _grids(h, w, mask.device)
    xmin = torch.where(fg, x, _BIG).amin(dim=(1, 2))[:, None, None]
    ymin = torch.where(fg, y, _BIG).amin(dim=(1, 2))[:, None, None]
    xmax = torch.where(fg, x, -1).amax(dim=(1, 2))[:, None, None]
    ymax = torch.where(fg, y, -1).amax(dim=(1, 2))[:, None, None]
    return torch.stack([fg & ((x - xmin).abs() <= pert),
                        fg & ((y - ymin).abs() <= pert),
                        fg & ((x - xmax).abs() <= pert),
                        fg & ((y - ymax).abs() <= pert)], dim=1)


def _pick(cands: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """For each row of ``cands`` (N, L) bool, the flat index of its
    ``ranks``-th (0-based) True, 0 where it has no such entry (the JAX
    ``argmax`` over an all-false row)."""
    csum = cands.cumsum(-1, dtype=torch.int32)
    want = (ranks.to(torch.int32) + 1)[:, None].contiguous()
    idx = torch.searchsorted(csum, want).squeeze(-1)
    return torch.where(idx < cands.shape[-1], idx, torch.zeros_like(idx))


def ranks_from_uniform(u: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Uniform ranks in ``[0, max(count, 1))`` from uniforms ``u`` in
    [0, 1) (the law of the JAX ``randint(0, maximum(counts, 1))``)."""
    n = counts.clamp(min=1)
    k = torch.floor(u.to(torch.float64) * n.to(torch.float64)).to(torch.int64)
    return torch.minimum(k, n - 1)


def _points_from_flat(idx: torch.Tensor, w: int) -> torch.Tensor:
    return torch.stack([idx % w, idx // w], dim=-1).to(torch.float32)


def extreme_points_from_ranks(mask: torch.Tensor, ranks: torch.Tensor,
                              pert: int = 0) -> torch.Tensor:
    """(B, 4, 2) float32 extreme points: on each side the candidate of rank
    ``ranks`` (B, 4) in row-major order — the JAX
    ``extreme_points_random`` given its ``randint`` draws."""
    b, h, w = mask.shape
    cands = _side_candidates(mask, pert).reshape(b * 4, h * w)
    idx = _pick(cands, ranks.reshape(-1)).reshape(b, 4)
    return _points_from_flat(idx, w)


def extreme_points_random(mask: torch.Tensor,
                          generator: torch.Generator | None = None,
                          pert: int = 0,
                          u: torch.Tensor | None = None) -> torch.Tensor:
    """Randomised (B, 4, 2) extreme points: a uniform candidate of each
    side (the training-time jitter), from ``generator`` (or the uniforms
    ``u``, (B, 4)).  Undefined but finite for an empty mask."""
    b, h, w = mask.shape
    cands = _side_candidates(mask, pert).reshape(b * 4, h * w)
    if u is None:
        u = torch.rand((b, 4), generator=generator, dtype=torch.float64,
                       device=mask.device)
    ranks = ranks_from_uniform(u.reshape(-1), cands.sum(-1))
    return _points_from_flat(_pick(cands, ranks).reshape(b, 4), w)


def extreme_points_fixed(mask: torch.Tensor, pert: int = 0) -> torch.Tensor:
    """Deterministic (B, 4, 2) extreme points: per side, the candidate of
    median rank ordered by the other coordinate (then by its own), as the
    JAX form's sort of packed keys — here the (n // 2)-th candidate in
    row-major order for left/right and in column-major order for
    top/bottom.  An empty side gives the JAX sentinel key's point."""
    b, h, w = mask.shape
    cands = _side_candidates(mask, pert)
    lr = cands[:, 0::2].reshape(b * 2, h * w)
    tb = cands[:, 1::2].transpose(-1, -2).reshape(b * 2, h * w)
    n_lr, n_tb = lr.sum(-1), tb.sum(-1)
    big = torch.full_like(n_lr, _BIG)
    sel_lr = torch.where(n_lr > 0, _pick(lr, n_lr // 2), big).reshape(b, 2)
    sel_tb = torch.where(n_tb > 0, _pick(tb, n_tb // 2), big).reshape(b, 2)
    left_right = torch.stack([sel_lr % w, sel_lr // w], dim=-1)
    top_bottom = torch.stack([sel_tb // h, sel_tb % h], dim=-1)
    pts = torch.stack([left_right[:, 0], top_bottom[:, 0],
                       left_right[:, 1], top_bottom[:, 1]], dim=1)
    return pts.to(torch.float32)


def _float_grids(h: int, w: int, device):
    """(1, 1, 1, W) and (1, 1, H, 1) float32 grids, against (B, 4) points."""
    x = torch.arange(w, dtype=torch.float32, device=device)[None, None, None, :]
    y = torch.arange(h, dtype=torch.float32, device=device)[None, None, :, None]
    return x, y


def _nellipse_z(shape_hw, pts: torch.Tensor, softness: float) -> torch.Tensor:
    """(B, H, W) soft n-ellipse indicator in [0, 1]: boundary at the
    multifocal level set through the outermost focal point, sigmoid falloff
    of relative width ``softness``, exponent clipped to +-50."""
    h, w = shape_hw
    xx, yy = _float_grids(h, w, pts.device)
    px, py = pts[..., 0, None, None], pts[..., 1, None, None]
    d = torch.sqrt((xx - px) ** 2 + (yy - py) ** 2).sum(dim=1)
    pair = torch.sqrt(((pts[:, :, None, :] - pts[:, None, :, :]) ** 2).sum(-1))
    c = pair.sum(dim=2).amax(dim=1)[:, None, None]
    live = c > 0
    tau = torch.where(live, softness * c, torch.ones_like(c))
    z = 1.0 / (1.0 + torch.exp(torch.clamp((d - c) / tau, -50.0, 50.0)))
    return torch.where(live, z, (d == 0).to(torch.float32))


def _gaussian_hm(shape_hw, pts: torch.Tensor, sigma: float) -> torch.Tensor:
    """(B, H, W) max-combined gaussian bumps at ``pts`` in [0, 1]
    (``exp(-4 ln2 r^2 / sigma^2)``)."""
    h, w = shape_hw
    xx, yy = _float_grids(h, w, pts.device)
    px, py = pts[..., 0, None, None], pts[..., 1, None, None]
    r2 = (xx - px) ** 2 + (yy - py) ** 2
    return torch.exp(_NEG_4_LN2 * r2 / sigma ** 2).amax(dim=1)


def _inv2x2(m: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (B, 2, 2) matrices."""
    a, b, c, d = m[:, 0, 0], m[:, 0, 1], m[:, 1, 0], m[:, 1, 1]
    det = a * d - b * c
    return torch.stack([torch.stack([d, -b], -1),
                        torch.stack([-c, a], -1)], -2) / det[:, None, None]


def _minmax_255(z: torch.Tensor) -> torch.Tensor:
    """Per sample: min-max normalise to [0, 1], then x 255."""
    lo = z.amin(dim=(1, 2), keepdim=True)
    hi = z.amax(dim=(1, 2), keepdim=True)
    return (z - lo) / (hi - lo + 1e-10) * 255.0


def _l1l2_map(shape_hw, pts: torch.Tensor, tau: float) -> torch.Tensor:
    """(B, H, W) skewed-axes L1+L2 confidence map: affine (u, v)
    coordinates along the left->right and top->bottom chords, weight
    ``exp(-tau (|u| + |v| + sqrt(u^2 + v^2)) / 2)``."""
    h, w = shape_hw
    left, top, right, bottom = pts[:, 0], pts[:, 1], pts[:, 2], pts[:, 3]
    center = pts.mean(dim=1)
    a1 = (right - left) / 2.0
    a2 = (bottom - top) / 2.0
    A = torch.stack([a1, a2], dim=2)  # columns are the axes
    det = A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]
    eye = torch.eye(2, dtype=A.dtype, device=A.device)
    A = torch.where((det.abs() < 1e-6)[:, None, None], A + eye * 1e-3, A)
    ainv = _inv2x2(A)[..., None, None]
    xx = torch.arange(w, dtype=torch.float32, device=pts.device)[None, None, :]
    yy = torch.arange(h, dtype=torch.float32, device=pts.device)[None, :, None]
    dx = xx - center[:, 0, None, None]
    dy = yy - center[:, 1, None, None]
    u = ainv[:, 0, 0] * dx + ainv[:, 0, 1] * dy
    v = ainv[:, 1, 0] * dx + ainv[:, 1, 1] * dy
    l1 = u.abs() + v.abs()
    l2 = torch.sqrt(u * u + v * v)
    return torch.exp(-tau * (l1 + l2) / 2.0)


def _mvgauss_map(mask: torch.Tensor, tau: float) -> torch.Tensor:
    """(B, H, W) multivariate-gaussian confidence map from the mask's
    pixel-cloud moments: the sample (ddof = 1) covariance + 1e-3 I, the
    unit matrix for masks of fewer than 2 pixels."""
    b, h, w = mask.shape
    fg = (mask > 0.5).to(torch.float32)
    n = fg.sum(dim=(1, 2))
    xx = torch.arange(w, dtype=torch.float32, device=mask.device)[None, None, :]
    yy = torch.arange(h, dtype=torch.float32, device=mask.device)[None, :, None]
    xx, yy = xx.expand(1, h, w), yy.expand(1, h, w)
    n_safe = n.clamp(min=1.0)
    mx = (fg * xx).sum(dim=(1, 2)) / n_safe
    my = (fg * yy).sum(dim=(1, 2)) / n_safe
    dof = (n - 1.0).clamp(min=1.0)
    dx = xx - mx[:, None, None]
    dy = yy - my[:, None, None]
    sxx = (fg * dx ** 2).sum(dim=(1, 2)) / dof
    syy = (fg * dy ** 2).sum(dim=(1, 2)) / dof
    sxy = (fg * dx * dy).sum(dim=(1, 2)) / dof
    eye = torch.eye(2, dtype=torch.float32, device=mask.device)
    cov = torch.stack([torch.stack([sxx, sxy], -1),
                       torch.stack([sxy, syy], -1)], -2) + eye * 1e-3
    cov = torch.where((n < 2.0)[:, None, None], eye.expand_as(cov), cov)
    icov = _inv2x2(cov)[..., None, None]
    m = (icov[:, 0, 0] * dx * dx + (icov[:, 0, 1] + icov[:, 1, 0]) * dx * dy
         + icov[:, 1, 1] * dy * dy)
    return torch.exp(-0.5 * tau * m)


def _check_family(family: str) -> None:
    if family not in FAMILIES:
        raise ValueError(f"family {family!r} not device-supported {FAMILIES}")


def guidance_map(mask: torch.Tensor, generator: torch.Generator | None = None,
                 family: str = "nellipse_gaussians", alpha: float = 0.6,
                 sigma: float = 10.0, softness: float = 0.05, pert: int = 0,
                 is_val: bool = False, tau: float = 1.0,
                 ranks: torch.Tensor | None = None,
                 u: torch.Tensor | None = None) -> torch.Tensor:
    """The (B, H, W) float32 guidance channel of binary masks (B, H, W).

    Families and scaling as the host transforms: ``nellipse_gaussians``
    z1 + alpha z2 rescaled to peak 255; ``nellipse`` the indicator x 255;
    ``extreme_points`` the unscaled [0, 1] heatmap; ``confidence_l1l2`` /
    ``confidence_gaussian`` min-max normalised x 255 (the gaussian branch
    at tau 0.5).  A degenerate mask gives a zero map: empty for the point
    families, empty or full for the confidence families.  In training
    (``is_val`` false) the points are random: the ``ranks`` (B, 4) given,
    else drawn from ``u`` or ``generator``."""
    _check_family(family)
    shape = tuple(mask.shape[1:])
    if family == "confidence_gaussian":
        pts = None  # moments only
    elif is_val:
        pts = extreme_points_fixed(mask, pert)
    elif ranks is not None:
        pts = extreme_points_from_ranks(mask, ranks, pert)
    else:
        if generator is None and u is None:
            raise ValueError("training-mode guidance_map needs a generator")
        pts = extreme_points_random(mask, generator, pert, u=u)
    if family == "extreme_points":
        z = _gaussian_hm(shape, pts, sigma)
    elif family == "nellipse":
        z = _nellipse_z(shape, pts, softness) * 255.0
    elif family == "confidence_l1l2":
        z = _minmax_255(_l1l2_map(shape, pts, tau))
    elif family == "confidence_gaussian":
        z = _minmax_255(_mvgauss_map(mask, 0.5))
    else:
        z1 = _nellipse_z(shape, pts, softness)
        z2 = _gaussian_hm(shape, pts, sigma)
        z = z1 * 255.0 + z2 * (255.0 * alpha)
        peak = z.amax(dim=(1, 2), keepdim=True).clamp(min=1e-12)
        z = torch.clamp(z * (255.0 / peak), 0.0, 255.0)
    fg = mask > 0.5
    live = fg.flatten(1).any(dim=1)
    if family.startswith("confidence"):
        live = live & (~fg).flatten(1).any(dim=1)
    return torch.where(live[:, None, None], z,
                       torch.zeros_like(z)).to(torch.float32)


class DeviceGuidance:
    """The ``(batch, generator) -> batch`` stage that appends the guidance
    channel to ``concat`` (B, C, H, W) from ``crop_gt`` ((B, 1, H, W) or
    (B, H, W)); see :func:`make_device_guidance`.  :meth:`apply` takes the
    draws explicitly: the uniforms ``u`` (B, 4) or the ``ranks`` (B, 4)."""

    def __init__(self, family: str, alpha: float, sigma: float,
                 softness: float, pert: int, is_val: bool, tau: float):
        self.family, self.alpha, self.sigma = family, alpha, sigma
        self.softness, self.pert, self.is_val, self.tau = \
            softness, pert, is_val, tau

    @property
    def random(self) -> bool:
        """Whether the stage draws (training-mode point families)."""
        return not self.is_val and self.family != "confidence_gaussian"

    def draw(self, n: int, generator: torch.Generator | None,
             device) -> torch.Tensor | None:
        """The stage's (n, 4) float64 uniforms, None when it draws none."""
        if not self.random:
            return None
        return torch.rand((n, 4), generator=generator, dtype=torch.float64,
                          device=device)

    def apply(self, batch: Mapping, u: torch.Tensor | None = None,
              ranks: torch.Tensor | None = None) -> dict:
        x = batch["concat"]
        gt = batch["crop_gt"]
        mask = gt[:, 0] if gt.dim() == 4 else gt
        maps = guidance_map(mask, None, family=self.family, alpha=self.alpha,
                            sigma=self.sigma, softness=self.softness,
                            pert=self.pert, is_val=self.is_val, tau=self.tau,
                            ranks=ranks, u=u)
        out = dict(batch)
        out["concat"] = torch.cat([x, maps[:, None].to(x.dtype)], dim=1)
        return out

    def __call__(self, batch: Mapping,
                 generator: torch.Generator | None = None) -> dict:
        x = batch["concat"]
        return self.apply(batch, u=self.draw(x.shape[0], generator, x.device))


def make_device_guidance(family: str = "nellipse_gaussians",
                         alpha: float = 0.6, sigma: float = 10.0,
                         softness: float = 0.05, pert: int | None = None,
                         is_val: bool = False,
                         tau: float = 1.0) -> DeviceGuidance:
    """The stage appending the guidance channel to ``concat`` from
    ``crop_gt``.  ``pert=None`` is each family's pipeline default: 5 px of
    point jitter for ``extreme_points`` and the confidence families in
    training, 0 otherwise.  Feed the host pipeline ``guidance='none'`` so
    ``concat`` arrives with the bare image channels."""
    _check_family(family)
    if pert is None:
        jittered = family in ("extreme_points", "confidence_l1l2",
                              "confidence_gaussian")
        pert = 5 if (jittered and not is_val) else 0
    return DeviceGuidance(family, alpha, sigma, softness, pert, is_val, tau)
