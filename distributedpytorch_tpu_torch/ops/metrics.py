"""Segmentation metrics, the counterpart of ``distributedpytorch_tpu/ops/metrics.py``.

Instance task: host-side Jaccard (IoU) with a threshold sweep — per-sample
IoU of the binarised prediction against the ground truth, void pixels
excluded, an empty union scoring 1.  Semantic task: the (C, C) confusion
counts (:func:`confusion_matrix`, one ``bincount`` on the tensors'
device) and the per-class IoU, mean IoU and pixel accuracy made from them
(:func:`miou_from_confusion`)."""

from __future__ import annotations

import numpy as np
import torch

#: the reference's eval threshold sweep
DEFAULT_THRESHOLDS = (0.3, 0.5, 0.8)


def np_jaccard(pred: np.ndarray, gt: np.ndarray,
               void: np.ndarray | None = None) -> float:
    """IoU of two binary masks, excluding void pixels."""
    pred = pred.astype(bool)
    gt = gt.astype(bool)
    valid = np.ones_like(gt) if void is None else ~void.astype(bool)
    inter = int(np.sum(pred & gt & valid))
    union = int(np.sum((pred | gt) & valid))
    return 1.0 if union == 0 else inter / union


def np_jaccard_thresholds(prob: np.ndarray, thresholds, gt: np.ndarray,
                          void: np.ndarray | None = None) -> np.ndarray:
    """IoU of ``prob > t`` for each threshold, in one pass: ``prob`` is
    binned against the sorted thresholds (compared in ``prob``'s dtype, as
    ``prob > t`` would) and each threshold's intersection and union are
    suffix sums of two bin counts.  Returns the IoUs in the caller's
    threshold order."""
    prob = np.asarray(prob)
    t = np.asarray(thresholds, dtype=prob.dtype if
                   np.issubdtype(prob.dtype, np.floating) else np.float64)
    order = np.argsort(t, kind="stable")
    ts = t[order]
    k = ts.size
    gt = gt.astype(bool).ravel()
    valid = np.ones_like(gt) if void is None \
        else ~np.asarray(void).astype(bool).ravel()
    bins = np.searchsorted(ts, prob.ravel(), side="left")  # #(ts < x)
    gt_counts = np.bincount(bins[gt & valid], minlength=k + 1)
    other_counts = np.bincount(bins[~gt & valid], minlength=k + 1)
    inter = np.cumsum(gt_counts[::-1])[::-1]
    pred_only = np.cumsum(other_counts[::-1])[::-1]
    n_gt = int(gt_counts.sum())
    out = np.empty(k)
    for j in range(k):
        union = n_gt + int(pred_only[j + 1])
        out[j] = 1.0 if union == 0 else int(inter[j + 1]) / union
    inv = np.empty(k, np.intp)
    inv[order] = np.arange(k)
    return out[inv]


def confusion_matrix(pred: torch.Tensor, label: torch.Tensor, nclass: int,
                     ignore_index: int = 255) -> torch.Tensor:
    """(C, C) int64 confusion counts, rows the true class and columns the
    predicted one, of two integer tensors of one shape; pixels labelled
    ``ignore_index`` are dropped.  One ``bincount`` over ``true * C +
    pred`` on the tensors' device."""
    pred = pred.reshape(-1).long()
    label = label.reshape(-1).long()
    valid = label != ignore_index
    idx = torch.where(valid, label * nclass + pred,
                      torch.full_like(label, nclass * nclass))
    counts = torch.bincount(idx, minlength=nclass * nclass + 1)
    return counts[:nclass * nclass].reshape(nclass, nclass)


def miou_from_confusion(conf) -> dict:
    """Per-class IoU, mean IoU and pixel accuracy of a (C, C) confusion.
    A class absent from both prediction and ground truth (union 0) is
    left out of the mean (``None`` in ``per_class_iou``), the VOC
    convention."""
    conf = np.asarray(conf, dtype=np.float64)
    inter = np.diag(conf)
    union = conf.sum(0) + conf.sum(1) - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, inter / union, np.nan)
    miou = float(np.nanmean(iou)) if np.any(union > 0) else 0.0
    total = conf.sum()
    return {
        "miou": miou,
        "per_class_iou": [None if np.isnan(v) else float(v) for v in iou],
        "pixel_acc": float(inter.sum() / total) if total > 0 else 0.0,
    }
