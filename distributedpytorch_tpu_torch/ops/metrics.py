"""Host-side Jaccard (IoU) with a threshold sweep, the counterpart of
``distributedpytorch_tpu/ops/metrics.py``'s numpy forms: per-sample IoU of
the binarised prediction against the ground truth, void pixels excluded,
an empty union scoring 1."""

from __future__ import annotations

import numpy as np

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
