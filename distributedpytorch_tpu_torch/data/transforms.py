"""Host-side transforms over dict samples, the counterpart of
``distributedpytorch_tpu/data/transforms.py`` for the default train and
val stacks.

A sample is a ``dict`` of numpy arrays (HWC, as in the JAX package, so the
two can be compared bit for bit) flowing through a :class:`Compose` chain
with the reference's key names (``image``, ``gt``, ``void_pixels``,
``crop_image``, ``crop_gt``, ``nellipseWithGaussians``, ``concat``).
Randomness comes from the ``np.random.Generator`` passed to ``__call__``,
drawn in the JAX package's order.  Keys ``id``/``meta`` are metadata;
``bbox`` and ``crop_relax`` are coordinate payloads.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

from .. import imaging
from ..utils import helpers
from . import guidance

#: sample keys that are never treated as image arrays
META_KEYS = ("id", "meta")


def _is_meta(key: str) -> bool:
    return key in META_KEYS


def _require_rng(rng: np.random.Generator | None) -> np.random.Generator:
    return rng if rng is not None else np.random.default_rng()


class Transform:
    """Base: ``__call__(sample, rng) -> sample``; deterministic transforms
    ignore ``rng``."""

    def __call__(self, sample: dict,
                 rng: np.random.Generator | None = None) -> dict:
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}()"


class Compose(Transform):
    """Chain transforms, threading one RNG through the stochastic ones."""

    def __init__(self, transforms: Sequence[Transform]):
        self.transforms = list(transforms)

    def __call__(self, sample, rng=None):
        for t in self.transforms:
            sample = t(sample, rng)
        return sample

    def __repr__(self):
        return f"Compose([{', '.join(repr(t) for t in self.transforms)}])"


class RandomHorizontalFlip(Transform):
    """Left-right flip of every array key with probability ``p``."""

    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, sample, rng=None):
        if _require_rng(rng).random() < self.p:
            for key, val in sample.items():
                if not _is_meta(key):
                    sample[key] = imaging.flip_h(val)
        return sample

    def __repr__(self):
        return f"RandomHorizontalFlip(p={self.p})"


def _warp_interpolation(key: str, arr: np.ndarray, semseg: bool) -> int:
    """Nearest for arrays valued in {0, 1, 255} (masks) and, with
    ``semseg``, for the class-id ``gt`` keys; cubic otherwise."""
    if ((arr == 0) | (arr == 1) | (arr == 255)).all():
        return imaging.NEAREST
    if semseg and "gt" in key:
        return imaging.NEAREST
    return imaging.CUBIC


class ScaleNRotate(Transform):
    """Random rotation and isotropic zoom about the image centre: tuples
    draw uniformly from the range (rotation first), lists pick an entry.
    Every array key is cast to uint8 and warped with a 0 border, a
    ``bb_mask`` key with a 255 border.  With ``semseg`` the class-id
    ``gt`` keys warp nearest with a 255 (void) border, so the padding the
    warp brings in is ignored by the loss, not learnt as class 0."""

    def __init__(self, rots=(-30, 30), scales=(0.75, 1.25),
                 semseg: bool = False):
        if isinstance(rots, tuple) != isinstance(scales, tuple):
            raise TypeError("rots and scales must both be ranges or both be lists")
        self.rots = rots
        self.scales = scales
        self.semseg = semseg

    def _draw(self, rng: np.random.Generator) -> tuple[float, float]:
        if isinstance(self.rots, tuple):
            rot = float(rng.uniform(self.rots[0], self.rots[1]))
            sc = float(rng.uniform(self.scales[0], self.scales[1]))
        else:
            rot = float(self.rots[rng.integers(0, len(self.rots))])
            sc = float(self.scales[rng.integers(0, len(self.scales))])
        return rot, sc

    def __call__(self, sample, rng=None):
        rot, sc = self._draw(_require_rng(rng))
        for key in list(sample.keys()):
            if _is_meta(key):
                continue
            arr = sample[key]
            h, w = arr.shape[:2]
            m = imaging.rotation_matrix((w / 2, h / 2), rot, sc)
            void_border = "bb_mask" in key or (self.semseg and "gt" in key)
            sample[key] = imaging.warp_affine(
                arr.astype(np.uint8), m, (h, w),
                _warp_interpolation(key, arr, self.semseg),
                255 if void_border else 0)
        return sample

    def __repr__(self):
        return f"ScaleNRotate(rots={self.rots}, scales={self.scales})"


class FixedResize(Transform):
    """Resize each key to ``resolutions[key]``: ``None`` passes a key
    through untouched (the val stack's full-resolution ``gt``/
    ``void_pixels``/``gt_full``), and keys absent from ``resolutions`` are
    deleted.  ``flagvals[key]`` fixes a key's interpolation (the semantic
    stacks' nearest ``gt``), else it follows the array's values.
    ``meta``/``bbox``/``crop_relax`` keys are exempt."""

    def __init__(self, resolutions: Mapping[str, tuple[int, int] | None]
                 | None = None,
                 flagvals: Mapping[str, int | None] | None = None):
        if flagvals is not None and resolutions is not None \
                and set(flagvals) != set(resolutions):
            raise ValueError("flagvals must name the keys of resolutions")
        self.resolutions = resolutions
        self.flagvals = flagvals

    def __call__(self, sample, rng=None):
        if self.resolutions is None:
            return sample
        for key in list(sample.keys()):
            if "meta" in key or "bbox" in key or "crop_relax" in key:
                continue
            if key not in self.resolutions:
                del sample[key]
                continue
            res = self.resolutions[key]
            if res is not None:
                flag = None if self.flagvals is None else self.flagvals[key]
                sample[key] = helpers.fixed_resize(sample[key], res, flag)
        return sample

    def __repr__(self):
        return f"FixedResize({self.resolutions})"


class CropFromMaskStatic(Transform):
    """Crop each of ``crop_elems`` to the ``mask_elem`` bbox grown by
    ``relax``, zero-padding past the image with ``zero_pad``, into
    ``crop_<elem>``; records the crop's ``bbox`` (the whole image for an
    empty mask, whose crops are zeros)."""

    def __init__(self, crop_elems=("image", "gt"), mask_elem="gt", relax=0,
                 zero_pad=False):
        self.crop_elems = crop_elems
        self.mask_elem = mask_elem
        self.relax = relax
        self.zero_pad = zero_pad

    def __call__(self, sample, rng=None):
        mask = sample[self.mask_elem]
        if mask.ndim != 2:
            raise ValueError("CropFromMaskStatic takes a single-object 2-D mask")
        for elem in self.crop_elems:
            img = sample[elem]
            sample["crop_" + elem] = np.zeros(img.shape, img.dtype) \
                if mask.max() == 0 else helpers.crop_from_mask(
                    img, mask, relax=self.relax, zero_pad=self.zero_pad)
        bbox = helpers.get_bbox(mask, pad=self.relax, zero_pad=self.zero_pad)
        if bbox is None:
            bbox = (0, 0, mask.shape[1] - 1, mask.shape[0] - 1)
        sample["bbox"] = np.asarray(bbox, dtype=np.int64)
        return sample

    def __repr__(self):
        return (f"CropFromMaskStatic(elems={self.crop_elems}, "
                f"relax={self.relax}, zero_pad={self.zero_pad})")


class FusedCropResize(Transform):
    """``CropFromMaskStatic`` + ``FixedResize`` in one pass
    (``data.fused_crop_resize``): each of ``crop_elems`` is resized
    straight from its relaxed, zero-padded bbox window to ``size`` by
    ``imaging.crop_resize`` (the host library's fused kernel), never
    materializing the crop.  The pair's output contract: ``crop_<elem>``
    keys at ``size`` (float32 here: the image is not rounded to uint8 on
    the way, so a ``ClampRange`` follows it), the recorded ``bbox``,
    ``FixedResize``'s pruning rule and its per-element interpolation
    (nearest for binary or 255-valued windows, cubic otherwise)."""

    def __init__(self, crop_elems=("image", "gt"), mask_elem="gt", relax=0,
                 zero_pad=False, size=(512, 512)):
        self.crop_elems = crop_elems
        self.mask_elem = mask_elem
        self.relax = relax
        self.zero_pad = zero_pad
        self.size = tuple(size)

    def __call__(self, sample, rng=None):
        mask = sample[self.mask_elem]
        if mask.ndim != 2:
            raise ValueError("FusedCropResize takes a single-object 2-D mask")
        bbox = helpers.get_bbox(mask, pad=self.relax, zero_pad=self.zero_pad)
        for elem in self.crop_elems:
            arr = sample[elem]
            if bbox is None:  # empty mask: zeros at the output size
                sample["crop_" + elem] = np.zeros(self.size + arr.shape[2:],
                                                  np.float32)
                continue
            # the interpolation rule on the in-image part of the window
            # (the zero padding never changes binary-ness)
            win = arr[max(bbox[1], 0):bbox[3] + 1, max(bbox[0], 0):bbox[2] + 1]
            sample["crop_" + elem] = imaging.crop_resize(
                arr, bbox, self.size, helpers.resize_interp_flag(win))
        if bbox is None:
            bbox = (0, 0, mask.shape[1] - 1, mask.shape[0] - 1)
        sample["bbox"] = np.asarray(bbox, dtype=np.int64)
        produced = {"crop_" + e for e in self.crop_elems}
        for key in list(sample.keys()):
            if key in produced or "meta" in key or "bbox" in key \
                    or "crop_relax" in key:
                continue
            del sample[key]
        return sample

    def __repr__(self):
        return (f"FusedCropResize(elems={self.crop_elems}, relax={self.relax},"
                f" zero_pad={self.zero_pad}, size={self.size})")


class NEllipseWithGaussians(Transform):
    """The guidance channel: n-ellipse plus gaussian bumps at the extreme
    points of ``crop_gt`` (random at train, the median candidates at val),
    ``z1 + alpha z2`` rescaled to peak at 255, into
    ``sample['nellipseWithGaussians']``."""

    def __init__(self, alpha: float = 0.6, is_val: bool = True):
        self.alpha = alpha
        self.is_val = is_val

    def __call__(self, sample, rng=None):
        target = sample["crop_gt"]
        if target.max() == 0:
            sample["nellipseWithGaussians"] = np.zeros(target.shape,
                                                       dtype=target.dtype)
            return sample
        pts = guidance.extreme_points_fixed(target, 0) if self.is_val \
            else guidance.extreme_points(target, 0, rng=_require_rng(rng))
        sample["nellipseWithGaussians"] = guidance.nellipse_gaussians_map(
            target.shape[:2], pts, alpha=self.alpha)
        return sample

    def __repr__(self):
        return f"NEllipseWithGaussians(alpha={self.alpha}, is_val={self.is_val})"


class ConcatInputs(Transform):
    """Channel-concatenate named elements into ``sample['concat']``."""

    def __init__(self, elems=("image", "point")):
        self.elems = elems

    def __call__(self, sample, rng=None):
        base = sample[self.elems[0]]
        parts = [np.atleast_3d(base)]
        for elem in self.elems[1:]:
            if sample[elem].shape[:2] != base.shape[:2]:
                raise ValueError(
                    f"ConcatInputs: {elem} spatial shape "
                    f"{sample[elem].shape[:2]} != {self.elems[0]} "
                    f"{base.shape[:2]}")
            parts.append(np.atleast_3d(sample[elem]))
        sample["concat"] = parts[0] if len(parts) == 1 \
            else np.concatenate(parts, axis=2)
        return sample

    def __repr__(self):
        return f"ConcatInputs({self.elems})"


class Duplicate(Transform):
    """Copy keys (``{src: dst}``): the semantic val stack keeps the
    full-resolution ``gt`` as ``gt_full`` before the resize takes ``gt``."""

    def __init__(self, mapping: Mapping[str, str]):
        self.mapping = dict(mapping)

    def __call__(self, sample, rng=None):
        for src, dst in self.mapping.items():
            if src in sample:
                sample[dst] = sample[src]
        return sample

    def __repr__(self):
        return f"Duplicate({self.mapping})"


class Rename(Transform):
    """Rename keys (``{old: new}``): the semantic stacks' ``image``/``gt``
    onto the step's ``concat``/``crop_gt``."""

    def __init__(self, mapping: Mapping[str, str]):
        self.mapping = dict(mapping)

    def __call__(self, sample, rng=None):
        for old, new in self.mapping.items():
            if old in sample:
                sample[new] = sample.pop(old)
        return sample

    def __repr__(self):
        return f"Rename({self.mapping})"


class ClampRange(Transform):
    """Clamp named elements into ``[lo, hi]`` (cubic resizes overshoot)."""

    def __init__(self, elems: Sequence[str], lo: float = 0.0,
                 hi: float = 255.0):
        self.elems = tuple(elems)
        self.lo, self.hi = lo, hi

    def __call__(self, sample, rng=None):
        for k in self.elems:
            if k in sample:
                sample[k] = np.clip(sample[k], self.lo, self.hi)
        return sample

    def __repr__(self):
        return f"ClampRange({self.elems}, {self.lo}, {self.hi})"


class ToArray(Transform):
    """Terminal transform: every array key to float32 HWC (2-D arrays get a
    channel axis); ``bbox`` as an array, ``crop_relax`` and meta as they
    are.  The NCHW torch layout is made once, at the train step."""

    def __call__(self, sample, rng=None):
        for key, val in sample.items():
            if _is_meta(key) or "crop_relax" in key:
                continue
            if "bbox" in key:
                sample[key] = np.asarray(val)
                continue
            arr = np.asarray(val).astype(np.float32, copy=False)
            sample[key] = arr[:, :, np.newaxis] if arr.ndim == 2 else arr
        return sample
