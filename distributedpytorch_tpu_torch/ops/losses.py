"""Segmentation losses, the counterpart of ``distributedpytorch_tpu/ops/losses.py``:
for the instance task the class-balanced sigmoid BCE from logits and its
weighted sum over DANet's three outputs; for the semantic task the
softmax cross-entropy with an ignore index (:func:`softmax_xent_ignore`).

Logits are NCHW, (B, 1, H, W); the caller gives the target and void masks
the same shape (a (B, H, W) target against (B, 1, H, W) logits would
broadcast to (B, B, H, W), so shapes are checked, not broadcast).  The
class balance counts positives over the whole batch, not per image, as the
JAX function does.

Under data parallelism the JAX batch is the global one, so the balance
and the normaliser are global too: :func:`balance_counts` gives a rank's
(positives, valid pixels), which the train step sums over the ranks, and
the loss of a rank's rows divided by the *global* valid count is its
share of the global loss (the shares sum to it).  Without ``counts`` the
batch is its own whole, bit for bit the single-process loss.  The
softmax loss takes its global valid count the same way
(:func:`valid_count`).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def _valid(labels: torch.Tensor, void: torch.Tensor | None) -> torch.Tensor:
    return torch.ones_like(labels) if void is None else 1.0 - void.to(labels.dtype)


def balance_counts(labels: torch.Tensor,
                   void: torch.Tensor | None = None) -> torch.Tensor:
    """``[positives, valid pixels]`` of a batch (void pixels excluded), as
    a float32 tensor on ``labels``' device: what the class balance and
    the normaliser count.  It carries no gradient."""
    with torch.no_grad():
        labels = labels.float()
        valid = _valid(labels, void)
        return torch.stack([(labels * valid).sum(), valid.sum()])


def sigmoid_balanced_bce(logits: torch.Tensor, labels: torch.Tensor,
                         void: torch.Tensor | None = None,
                         balanced: bool = True,
                         counts: torch.Tensor | None = None) -> torch.Tensor:
    """Class-balanced binary cross-entropy from logits, void pixels masked
    out; a float32 scalar (float64 for float64 logits).  With ``balanced``
    positives weigh the negatives' share of the valid pixels and negatives
    the positives'.  ``counts`` (:func:`balance_counts`, summed over the
    batch these rows belong to) sets the balance and the normaliser;
    without it they are this batch's own."""
    if labels.shape != logits.shape or (void is not None
                                        and void.shape != logits.shape):
        raise ValueError(
            f"logits {tuple(logits.shape)}, labels {tuple(labels.shape)} and "
            f"void {None if void is None else tuple(void.shape)} must have "
            "one shape")
    dtype = torch.promote_types(logits.dtype, torch.float32)
    logits = logits.to(dtype)
    labels = labels.to(dtype)
    valid = _valid(labels, void)
    # max(x, 0) - x z + log1p(exp(-|x|))
    per_pix = F.relu(logits) - logits * labels \
        + torch.log1p(torch.exp(-logits.abs()))
    if counts is None:
        n_pos, n_valid = (labels * valid).sum(), valid.sum()
    else:
        n_pos, n_valid = counts.to(dtype).unbind()
    if balanced:
        w_pos = 1.0 - n_pos / n_valid.clamp(min=1.0)
        weights = torch.where(labels > 0.5, w_pos, 1.0 - w_pos) * valid
    else:
        weights = valid
    return (per_pix * weights).sum() / n_valid.clamp(min=1.0)


def multi_output_loss(outputs: Sequence[torch.Tensor], labels: torch.Tensor,
                      void: torch.Tensor | None = None,
                      weights: Sequence[float] | None = None,
                      balanced: bool = True,
                      counts: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted sum of :func:`sigmoid_balanced_bce` over the model's outputs
    (DANet's fused, position and channel heads), all against one target
    and one ``counts``; ``weights`` defaults to all ones."""
    if weights is None:
        weights = (1.0,) * len(outputs)
    total = 0.0
    for out, w in zip(outputs, weights):
        total = total + w * sigmoid_balanced_bce(out, labels, void, balanced,
                                                 counts)
    return total


def valid_count(labels: torch.Tensor, ignore_index: int = 255) -> torch.Tensor:
    """The number of labels that are not ``ignore_index``, as a float32
    one-element tensor on ``labels``' device: the softmax loss's
    normaliser, which the data-parallel step sums over the ranks."""
    with torch.no_grad():
        return (labels != ignore_index).sum().to(torch.float32).reshape(1)


def softmax_xent_ignore(logits: torch.Tensor, labels: torch.Tensor,
                        ignore_index: int = 255,
                        n_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Multi-class softmax cross-entropy over the class axis (dim 1 of
    NCHW ``logits``), the pixels labelled ``ignore_index`` contributing
    nothing; the sum over the valid pixels divided by ``max(valid, 1)``,
    so an all-void batch gives 0 (where ``F.cross_entropy``'s mean gives
    NaN).  ``labels`` are integer class ids of the logits' shape without
    the class axis.  The label's logit is gathered with the ignored
    labels pointed at class 0 and the product masked, so a non-finite
    logit in a class that is not the label's never reaches the loss.
    ``n_valid`` (:func:`valid_count`, summed over the batch these rows
    belong to) replaces this batch's own count.  float32 (float64 for
    float64 logits)."""
    if labels.shape != logits.shape[:1] + logits.shape[2:]:
        raise ValueError(f"labels {tuple(labels.shape)} do not match logits "
                         f"{tuple(logits.shape)} without the class axis")
    dtype = torch.promote_types(logits.dtype, torch.float32)
    logits = logits.to(dtype)
    labels = labels.long()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    gold = logits.gather(1, safe.unsqueeze(1)).squeeze(1)
    per_pix = (torch.logsumexp(logits, dim=1) - gold) * valid.to(dtype)
    n = valid.sum().to(dtype) if n_valid is None else n_valid.to(dtype).sum()
    return per_pix.sum() / n.clamp(min=1.0)


def multi_softmax_loss(outputs: Sequence[torch.Tensor], labels: torch.Tensor,
                       weights: Sequence[float] | None = None,
                       ignore_index: int = 255,
                       n_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted sum of :func:`softmax_xent_ignore` over the model's
    outputs, all against one label map and one ``n_valid``; ``weights``
    defaults to 1 for the primary output and 0.4 for each auxiliary one
    (the DeepLab recipe)."""
    if weights is None:
        weights = (1.0,) + (0.4,) * (len(outputs) - 1)
    total = 0.0
    for out, w in zip(outputs, weights):
        total = total + w * softmax_xent_ignore(out, labels, ignore_index,
                                                n_valid)
    return total
