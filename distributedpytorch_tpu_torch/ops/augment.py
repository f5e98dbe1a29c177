"""Batch augmentation on the device, the counterpart of
``distributedpytorch_tpu/ops/augment.py``.

The fixed-shape augmentations run inside the train step on NCHW tensors
(the JAX module's were XLA, not Pallas kernels, so these are plain
PyTorch on the device):

* :func:`random_hflip` — per-sample coin-flip horizontal mirror;
* :func:`random_crop` — reflect-pad, then a random same-size window;
* :func:`random_scale_rotate` — per-sample rotation + scale about the
  centre by inverse mapping, with the arithmetic of
  ``jax.scipy.ndimage.map_coordinates`` in mode ``constant``: bilinear for
  the input channels (the four corners gathered, each out-of-range corner
  replaced by ``cval``, the weights multiplied and the terms summed in
  JAX's order), nearest for the masks (the source coordinate rounded half
  away from zero, as ``lax.round``, and gathered; out of range gives
  ``cval``);
* :func:`normalize` / :func:`make_preprocess` — channel mean/std;
* :func:`make_device_augment` — the composed stage for
  ``make_train_step(augment=...)``.

Label-coupled ops move ``concat``, ``crop_gt`` and ``crop_void`` together.
Each op takes its draws as tensors, so the tests can feed it the JAX
module's own; :class:`DeviceAugment` draws them from a ``torch.Generator``
in a fixed order — flips, angles, scales, crop offsets, then the guidance
stage's uniforms — whatever stages are on, so turning guidance (or any
stage) on or off leaves the other stages' draws unchanged, the property
the JAX module gets from ``split`` and ``fold_in``.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping, Sequence

import torch
import torch.nn.functional as F

#: keys flipped/warped together (input, label and void stay aligned)
_SPATIAL_KEYS = ("concat", "crop_gt", "crop_void")
#: keys sampled nearest (exact values) rather than bilinear
_MASK_KEYS = ("crop_gt", "crop_void", "gt", "void_pixels")


def _spatial(batch: Mapping) -> list[str]:
    return [k for k in _SPATIAL_KEYS if k in batch]


def _per_sample(v: torch.Tensor, n: int) -> tuple[int, ...]:
    return (n,) + (1,) * (v.dim() - 1)


def random_hflip(batch: Mapping, coins: torch.Tensor) -> dict:
    """Mirror sample i left-right where ``coins[i]`` (B,) is true, the same
    coin across input, label and void."""
    out = dict(batch)
    n = coins.shape[0]
    for k in _spatial(batch):
        v = batch[k]
        out[k] = torch.where(coins.reshape(_per_sample(v, n)), v.flip(-1), v)
    return out


def random_crop(batch: Mapping, oy: torch.Tensor, ox: torch.Tensor,
                pad: int = 16) -> dict:
    """Translation jitter: reflect-pad by ``pad``, then take the window at
    row ``oy[i]``, column ``ox[i]`` (each in ``[0, 2 pad]``) of sample i;
    label and void crop at the same offsets."""
    out = dict(batch)
    for k in _spatial(batch):
        v = batch[k]
        squeeze = v.dim() == 3
        vv = v[:, None] if squeeze else v
        b, c, h, w = vv.shape
        vp = F.pad(vv, (pad, pad, pad, pad), mode="reflect")
        rows = oy[:, None] + torch.arange(h, device=v.device)
        cols = ox[:, None] + torch.arange(w, device=v.device)
        vp = vp.gather(2, rows[:, None, :, None].expand(b, c, h, w + 2 * pad))
        cropped = vp.gather(3, cols[:, None, None, :].expand(b, c, h, w))
        out[k] = cropped[:, 0] if squeeze else cropped
    return out


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Round half away from zero, exactly (``lax.round``'s default)."""
    t = torch.trunc(x)
    return torch.where((x - t).abs() == 0.5, t + torch.sign(x), torch.round(x))


def _source_coords(h: int, w: int, angles: torch.Tensor,
                   scales: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) float32 source row and column of each output pixel: the
    inverse map (rotate by -angle, scale by 1/s) about ((h-1)/2, (w-1)/2)."""
    device = angles.device
    yy = torch.arange(h, dtype=torch.float32, device=device)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, None, :]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    cos = (torch.cos(angles) / scales)[:, None, None]
    sin = (torch.sin(angles) / scales)[:, None, None]
    sy = cy + (-sin) * (xx - cx) + cos * (yy - cy)
    sx = cx + cos * (xx - cx) + sin * (yy - cy)
    return sy, sx


def _corner(v: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
            cval: float) -> torch.Tensor:
    """``v`` (B, C, H, W) at the integer source pixels (B, H, W), ``cval``
    where a pixel lies outside."""
    b, c, h, w = v.shape
    valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    flat = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).reshape(b, 1, h * w)
    got = v.reshape(b, c, h * w).gather(2, flat.expand(b, c, h * w))
    return torch.where(valid[:, None], got.reshape(b, c, h, w),
                       torch.full_like(v, cval))


def _warp_bilinear(v: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                   cval: float) -> torch.Tensor:
    def nodes(coord):
        lower = torch.floor(coord)
        upper_w = coord - lower
        index = lower.to(torch.int64)
        return ((index, 1 - upper_w), (index + 1, upper_w))

    out = None
    for iy, wy in nodes(sy):
        for ix, wx in nodes(sx):
            term = (wy * wx)[:, None] * _corner(v, iy, ix, cval)
            out = term if out is None else out + term
    return out


def _warp_nearest(v: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                  cval: float) -> torch.Tensor:
    return _corner(v, _round_half_away(sy).to(torch.int64),
                   _round_half_away(sx).to(torch.int64), cval)


def random_scale_rotate(batch: Mapping, angles: torch.Tensor,
                        scales: torch.Tensor, semantic: bool = False) -> dict:
    """Rotate sample i by ``angles[i]`` radians and scale it by
    ``scales[i]`` about its centre (the fixed-shape form of the host
    ScaleNRotate).  Input channels bilinear with 0 fill; masks nearest:
    binary masks (``semantic`` false) filled with 0 and re-binarised at
    0.5; with ``semantic`` the class ids pass through exactly and the
    warped-out ``crop_gt`` ring is 255 (void, ignored by the loss)."""
    keys = _spatial(batch)
    h, w = batch[keys[0]].shape[-2:]
    sy, sx = _source_coords(h, w, angles, scales)
    out = dict(batch)
    for k in keys:
        v = batch[k]
        squeeze = v.dim() == 3
        vv = (v[:, None] if squeeze else v).to(torch.float32)
        is_mask = k in _MASK_KEYS
        cval = 255.0 if (is_mask and semantic and k in ("crop_gt", "gt")) \
            else 0.0
        if is_mask:
            warped = _warp_nearest(vv, sy, sx, cval)
            if not semantic:
                warped = warped > 0.5
        else:
            warped = _warp_bilinear(vv, sy, sx, cval)
        warped = warped.to(v.dtype)
        out[k] = warped[:, 0] if squeeze else warped
    return out


def normalize(batch: Mapping, mean: Sequence[float] = (0.0,),
              std: Sequence[float] = (255.0,)) -> dict:
    """Channel-wise ``(x - mean) / std`` on the input (NCHW) only."""
    out = dict(batch)
    x = batch["concat"]
    m = torch.as_tensor(mean, dtype=x.dtype, device=x.device).reshape(-1, 1, 1)
    s = torch.as_tensor(std, dtype=x.dtype, device=x.device).reshape(-1, 1, 1)
    out["concat"] = (x - m) / s
    return out


def make_preprocess(mean: Sequence[float] = (0.0,),
                    std: Sequence[float] = (255.0,)
                    ) -> Callable[[Mapping], dict]:
    """Deterministic input preprocessing shared by train and eval: pass it
    to ``make_eval_step(preprocess=...)`` whenever the train augment
    normalises, or validation sees other inputs than training."""

    def preprocess(batch: Mapping) -> dict:
        return normalize(batch, mean, std)

    return preprocess


class DeviceAugment:
    """The composed ``(batch, generator) -> batch`` stage; see
    :func:`make_device_augment`.  :meth:`draw` takes every draw from the
    generator, :meth:`apply` runs the stages on given draws."""

    def __init__(self, hflip: bool, crop_pad: int, scale_rotate: bool,
                 rots: tuple[float, float], scales: tuple[float, float],
                 semantic: bool, mean, std, guidance_fn):
        self.hflip, self.crop_pad, self.scale_rotate = hflip, crop_pad, \
            scale_rotate
        self.rots, self.scales, self.semantic = tuple(rots), tuple(scales), \
            semantic
        self.mean, self.std = mean, std
        self.guidance_fn = guidance_fn

    def draw(self, batch: Mapping, generator: torch.Generator | None) -> dict:
        """Every stage's draws, in a fixed order whatever is enabled:
        ``flip`` (B,) bool, ``angle`` (B,) radians, ``scale`` (B,),
        ``oy``/``ox`` (B,) crop offsets, then the guidance stage's."""
        x = batch["concat"]
        n, device = x.shape[0], x.device

        def uniform(lo: float, hi: float) -> torch.Tensor:
            u = torch.rand(n, generator=generator, device=device)
            return lo + u * (hi - lo)

        draws = {"flip": torch.rand(n, generator=generator, device=device) < 0.5,
                 "angle": uniform(*self.rots) * (math.pi / 180.0),
                 "scale": uniform(*self.scales)}
        span = 2 * self.crop_pad + 1
        draws["oy"] = torch.randint(0, span, (n,), generator=generator,
                                    device=device)
        draws["ox"] = torch.randint(0, span, (n,), generator=generator,
                                    device=device)
        if self.guidance_fn is not None:
            draws["guidance_u"] = self.guidance_fn.draw(n, generator, device)
        return draws

    def apply(self, batch: Mapping, draws: Mapping) -> dict:
        """The enabled stages on ``draws``: flip, scale-rotate, crop, then
        guidance (after the geometry, so the channel is derived from the
        label the model sees; ``draws["guidance_ranks"]`` overrides the
        uniforms), then normalisation."""
        b = dict(batch)
        if self.hflip:
            b = random_hflip(b, draws["flip"])
        if self.scale_rotate:
            b = random_scale_rotate(b, draws["angle"], draws["scale"],
                                    semantic=self.semantic)
        if self.crop_pad:
            b = random_crop(b, draws["oy"], draws["ox"], pad=self.crop_pad)
        if self.guidance_fn is not None:
            b = self.guidance_fn.apply(b, u=draws.get("guidance_u"),
                                       ranks=draws.get("guidance_ranks"))
        if self.mean is not None or self.std is not None:
            b = normalize(b, self.mean if self.mean is not None else (0.0,),
                          self.std if self.std is not None else (255.0,))
        return b

    def __call__(self, batch: Mapping,
                 generator: torch.Generator | None = None) -> dict:
        return self.apply(batch, self.draw(batch, generator))


def make_device_augment(hflip: bool = True, crop_pad: int = 0,
                        scale_rotate: bool = False,
                        rots: tuple[float, float] = (-20.0, 20.0),
                        scales: tuple[float, float] = (0.75, 1.25),
                        semantic: bool = False,
                        mean: Sequence[float] | None = None,
                        std: Sequence[float] | None = None,
                        guidance_fn=None) -> DeviceAugment:
    """Compose the enabled stages into one stage for
    ``make_train_step(augment=...)``.  ``guidance_fn``
    (:func:`.guidance_device.make_device_guidance`) runs after the
    geometric stages and before normalisation.  With ``mean``/``std``,
    also pass ``make_preprocess(mean, std)`` to ``make_eval_step``;
    an omitted ``std`` is 255."""
    return DeviceAugment(hflip, crop_pad, scale_rotate, rots, scales,
                         semantic, mean, std, guidance_fn)
