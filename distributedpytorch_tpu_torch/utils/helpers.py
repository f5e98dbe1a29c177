"""Host-side numpy helpers of the click-to-mask path: bounding boxes, crops,
paste-back and gaussian point heatmaps.

Copies of ``distributedpytorch_tpu/utils/helpers.py`` (``get_bbox``,
``crop_from_bbox``, ``crop_from_mask``, ``resize_interp_flag``,
``fixed_resize``, ``crop2fullmask``, ``tens2image``, ``make_gaussian``,
``make_gt``), kept here so the port never imports the JAX package; the
tests pin them to the originals.  ``make_gt``'s max-combined heatmap runs
on the port's host library (:mod:`..native_ops`) unless ``DPTPU_NATIVE=0``,
as the JAX package's does.  A bbox is ``(x_min, y_min, x_max, y_max)`` with inclusive
max coordinates, x = column, y = row; images are (H, W[, C]) numpy arrays.
"""

from __future__ import annotations

import numpy as np

from .. import imaging, native_ops


def get_bbox(mask: np.ndarray, points=None, pad: int = 0,
             zero_pad: bool = False):
    """Tight bounding box of a binary mask (or of ``points``, xy), padded by
    ``pad``; ``None`` for an empty mask.  With ``zero_pad`` the box may
    leave the image, otherwise it is clamped to it."""
    if points is not None:
        inds = np.flipud(np.asarray(points).T)  # rows = (y, x)
    else:
        inds = np.where(mask > 0)
        if inds[0].size == 0:
            return None
    h, w = mask.shape[:2]
    if zero_pad:
        x_min_bound, y_min_bound = -np.inf, -np.inf
        x_max_bound, y_max_bound = np.inf, np.inf
    else:
        x_min_bound, y_min_bound = 0, 0
        x_max_bound, y_max_bound = w - 1, h - 1

    x_min = max(inds[1].min() - pad, x_min_bound)
    y_min = max(inds[0].min() - pad, y_min_bound)
    x_max = min(inds[1].max() + pad, x_max_bound)
    y_max = min(inds[0].max() + pad, y_max_bound)
    return int(x_min), int(y_min), int(x_max), int(y_max)


def crop_from_bbox(img: np.ndarray, bbox, zero_pad: bool = False) -> np.ndarray:
    """Crop ``img`` to ``bbox``; with ``zero_pad`` the part outside the
    image is filled with 0."""
    bounds = (0, 0, img.shape[1] - 1, img.shape[0] - 1)
    bbox_valid = (
        max(bbox[0], bounds[0]),
        max(bbox[1], bounds[1]),
        min(bbox[2], bounds[2]),
        min(bbox[3], bounds[3]),
    )
    if zero_pad:
        crop_shape = (bbox[3] - bbox[1] + 1, bbox[2] - bbox[0] + 1) + img.shape[2:]
        offsets = (-bbox[0], -bbox[1])
    else:
        if tuple(bbox) != bbox_valid:
            raise ValueError("out-of-bounds crop requires zero_pad=True")
        crop_shape = (
            bbox_valid[3] - bbox_valid[1] + 1,
            bbox_valid[2] - bbox_valid[0] + 1,
        ) + img.shape[2:]
        offsets = (-bbox_valid[0], -bbox_valid[1])
    crop = np.zeros(crop_shape, dtype=img.dtype)

    inds_x = (bbox_valid[0] + offsets[0], bbox_valid[2] + offsets[0])
    inds_y = (bbox_valid[1] + offsets[1], bbox_valid[3] + offsets[1])
    crop[inds_y[0]:inds_y[1] + 1, inds_x[0]:inds_x[1] + 1, ...] = img[
        bbox_valid[1]:bbox_valid[3] + 1, bbox_valid[0]:bbox_valid[2] + 1, ...
    ]
    return crop


def crop_from_mask(img: np.ndarray, mask: np.ndarray, relax: int = 0,
                   zero_pad: bool = False) -> np.ndarray:
    """Crop ``img`` to the bbox of ``mask`` grown by ``relax`` pixels (the
    mask nearest-resized to the image first if their sizes differ)."""
    if mask.shape[:2] != img.shape[:2]:
        mask = imaging.resize(mask, (img.shape[0], img.shape[1]),
                              imaging.NEAREST)
    bbox = get_bbox(mask, pad=relax, zero_pad=zero_pad)
    if bbox is None:
        return np.zeros(img.shape, dtype=img.dtype)
    return crop_from_bbox(img, bbox, zero_pad=zero_pad)


def resize_interp_flag(arr: np.ndarray) -> int:
    """Nearest for {0, 1}- or {0, 255}-valued arrays (masks), cubic
    otherwise."""
    if ((arr == 0) | (arr == 1)).all() or ((arr == 0) | (arr == 255)).all():
        return imaging.NEAREST
    return imaging.CUBIC


def fixed_resize(sample: np.ndarray, resolution,
                 flagval: int | None = None) -> np.ndarray:
    """Resize to ``resolution`` (an int scales the shortest side to it, a
    tuple is (H, W)); the interpolation defaults to
    :func:`resize_interp_flag`.  Arrays of other than 1 or 3 channels are
    resized channel by channel into float32."""
    if flagval is None:
        flagval = resize_interp_flag(sample)
    if isinstance(resolution, int):
        tmp = [resolution, resolution]
        tmp[int(np.argmax(sample.shape[:2]))] = int(
            round(resolution * np.max(sample.shape[:2])
                  / np.min(sample.shape[:2])))
        resolution = tuple(tmp)
    if sample.ndim == 2 or (sample.ndim == 3 and sample.shape[2] == 3):
        return imaging.resize(sample, tuple(resolution), flagval)
    out = np.zeros(tuple(resolution) + (sample.shape[2],), dtype=np.float32)
    for ii in range(sample.shape[2]):
        out[:, :, ii] = imaging.resize(sample[:, :, ii], tuple(resolution),
                                       flagval)
    return out


def tens2image(tens) -> np.ndarray:
    """(H, W), (H, W, C), (C, H, W) or a batch of one -> an HW(C) numpy
    image: the batch axis squeezed, a small leading channel axis moved
    last, a single channel dropped."""
    arr = np.asarray(tens)
    if arr.ndim == 4:
        if arr.shape[0] != 1:
            raise ValueError(f"tens2image expects batch size 1, got {arr.shape}")
        arr = arr[0]
    if arr.ndim == 3 and arr.shape[0] in (1, 3, 4) and arr.shape[0] < arr.shape[1]:
        arr = np.moveaxis(arr, 0, -1)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[:, :, 0]
    return arr


def crop2fullmask(
    crop_mask: np.ndarray,
    bbox,
    im_size: tuple[int, int],
    zero_pad: bool = False,
    relax: int = 0,
    mask_relax: bool = True,
    interpolation: int = imaging.CUBIC,
) -> np.ndarray:
    """Paste a crop-space prediction back into a full-image mask.

    ``bbox`` is the (relax-padded) box the crop was taken from; with
    ``mask_relax`` the relax border is zeroed after the paste, so only the
    un-padded object box contributes."""
    if zero_pad:
        bounds = (0, 0, im_size[1] - 1, im_size[0] - 1)
        bbox_valid = (
            max(bbox[0], bounds[0]),
            max(bbox[1], bounds[1]),
            min(bbox[2], bounds[2]),
            min(bbox[3], bounds[3]),
        )
    else:
        bbox_valid = bbox
    offsets = (-bbox[0], -bbox[1])

    inds = tuple(map(int, (
        bbox_valid[0] + offsets[0],
        bbox_valid[1] + offsets[1],
        bbox_valid[2] + offsets[0],
        bbox_valid[3] + offsets[1],
    )))

    crop_h = bbox[3] - bbox[1] + 1
    crop_w = bbox[2] - bbox[0] + 1
    crop_mask = imaging.resize(
        crop_mask.astype(np.float32), (crop_h, crop_w), interpolation)

    result = np.zeros(im_size, dtype=crop_mask.dtype)
    result[bbox_valid[1]:bbox_valid[3] + 1, bbox_valid[0]:bbox_valid[2] + 1] = (
        crop_mask[inds[1]:inds[3] + 1, inds[0]:inds[2] + 1]
    )

    if mask_relax and relax > 0:
        inner = (
            max(bbox[0] + relax, 0),
            max(bbox[1] + relax, 0),
            min(bbox[2] - relax, im_size[1] - 1),
            min(bbox[3] - relax, im_size[0] - 1),
        )
        keep = np.zeros(im_size, dtype=bool)
        if inner[2] >= inner[0] and inner[3] >= inner[1]:
            keep[inner[1]:inner[3] + 1, inner[0]:inner[2] + 1] = True
        result = np.where(keep, result, 0)
    return result


def make_gaussian(size, center, sigma: float = 10.0) -> np.ndarray:
    """2-D gaussian bump of ``size`` = (H, W) centred at ``center`` = (x, y)."""
    x = np.arange(0, size[1], 1, float)
    y = np.arange(0, size[0], 1, float)[:, np.newaxis]
    x0, y0 = center[0], center[1]
    return np.exp(-4 * np.log(2) * ((x - x0) ** 2 + (y - y0) ** 2) / sigma**2)


def make_gt(target: np.ndarray, labels, sigma: float = 10.0,
            one_mask_per_point: bool = False) -> np.ndarray:
    """Gaussian heatmap of a point list at ``target``'s (H, W): the
    max-combination of one bump per point, or one channel per point."""
    h, w = target.shape[:2]
    labels = np.asarray(labels)
    if labels.ndim == 1:
        labels = labels[np.newaxis]
    if one_mask_per_point:
        gt = np.zeros((h, w, labels.shape[0]), dtype=np.float32)
        for ii in range(labels.shape[0]):
            gt[:, :, ii] = make_gaussian((h, w), center=labels[ii], sigma=sigma)
    else:
        if native_ops.enabled():
            return native_ops.gaussian_hm(labels[:, :2], (h, w), sigma)
        gt = np.zeros((h, w), dtype=np.float32)
        for ii in range(labels.shape[0]):
            gt = np.maximum(gt, make_gaussian((h, w), center=labels[ii], sigma=sigma))
    return gt.astype(np.float32)
