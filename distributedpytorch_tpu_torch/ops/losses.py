"""Segmentation losses, the counterpart of ``distributedpytorch_tpu/ops/losses.py``
for the instance task: the class-balanced sigmoid BCE from logits and its
weighted sum over DANet's three outputs.

Logits are NCHW, (B, 1, H, W); the caller gives the target and void masks
the same shape (a (B, H, W) target against (B, 1, H, W) logits would
broadcast to (B, B, H, W), so shapes are checked, not broadcast).  The
class balance counts positives over the whole batch, not per image, as the
JAX function does.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def sigmoid_balanced_bce(logits: torch.Tensor, labels: torch.Tensor,
                         void: torch.Tensor | None = None,
                         balanced: bool = True) -> torch.Tensor:
    """Class-balanced binary cross-entropy from logits, void pixels masked
    out; a float32 scalar (float64 for float64 logits).  With ``balanced``
    positives weigh the negatives' share of the valid pixels and negatives
    the positives'."""
    if labels.shape != logits.shape or (void is not None
                                        and void.shape != logits.shape):
        raise ValueError(
            f"logits {tuple(logits.shape)}, labels {tuple(labels.shape)} and "
            f"void {None if void is None else tuple(void.shape)} must have "
            "one shape")
    dtype = torch.promote_types(logits.dtype, torch.float32)
    logits = logits.to(dtype)
    labels = labels.to(dtype)
    valid = torch.ones_like(labels) if void is None else 1.0 - void.to(dtype)
    # max(x, 0) - x z + log1p(exp(-|x|))
    per_pix = F.relu(logits) - logits * labels \
        + torch.log1p(torch.exp(-logits.abs()))
    if balanced:
        n_valid = valid.sum()
        w_pos = 1.0 - (labels * valid).sum() / n_valid.clamp(min=1.0)
        weights = torch.where(labels > 0.5, w_pos, 1.0 - w_pos) * valid
    else:
        weights = valid
    return (per_pix * weights).sum() / valid.sum().clamp(min=1.0)


def multi_output_loss(outputs: Sequence[torch.Tensor], labels: torch.Tensor,
                      void: torch.Tensor | None = None,
                      weights: Sequence[float] | None = None,
                      balanced: bool = True) -> torch.Tensor:
    """Weighted sum of :func:`sigmoid_balanced_bce` over the model's outputs
    (DANet's fused, position and channel heads), all against one target;
    ``weights`` defaults to all ones."""
    if weights is None:
        weights = (1.0,) * len(outputs)
    total = 0.0
    for out, w in zip(outputs, weights):
        total = total + w * sigmoid_balanced_bce(out, labels, void, balanced)
    return total
