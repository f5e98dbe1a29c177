"""Validation: threshold-swept Jaccard with full-resolution paste-back, the
counterpart of ``distributedpytorch_tpu/train/evaluate.py``'s ``evaluate``.

Per sample: the sigmoid of the fused logits is pasted back into the full
image (``crop2fullmask`` with the crop's recorded bbox and the relax
border shaved), binarised at each threshold and scored against the
full-resolution ground truth with void pixels excluded.  An empty ground
truth scores 1 where the crop prediction is empty at that threshold, else
0.  The metric is the best threshold's mean IoU.

Under data parallelism each rank scores its shard of the validation set
(the loader's wrap-padded shard), then ``(jac_sum, n_samples, loss_sum,
n_batches)`` is summed over the ranks with one ``all_reduce``, as the JAX
function sums them over processes, so every rank holds the same metrics
and the best-checkpoint gate cannot diverge.
"""

from __future__ import annotations

import time
from typing import Callable, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..ops.metrics import np_jaccard_thresholds
from ..parallel.step import INPUT_KEY
from ..utils.helpers import crop2fullmask, get_bbox, tens2image


def _as_list(v, n: int) -> list:
    if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == n:
        return [v[i] for i in range(n)]
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v] * n


def evaluate(eval_step: Callable, state, loader,
             thresholds: Sequence[float] = (0.3, 0.5, 0.8), relax: int = 50,
             zero_pad: bool = True, max_batches: int | None = None,
             debug_asserts: bool = False,
             bf16_readback: bool = False) -> dict:
    """The validation protocol over ``loader``; returns ``loss``,
    ``jaccard_per_threshold``, ``jaccard`` (the best threshold's),
    ``best_threshold``, ``n_samples`` and ``seconds``.  ``bf16_readback``
    rounds the logits to bfloat16 on the device before the copy to the host
    (``eval_bf16_probs``)."""
    thresholds = tuple(thresholds)
    jac_sum = np.zeros(len(thresholds))
    n_samples = 0
    losses: list[torch.Tensor] = []
    t0 = time.perf_counter()
    for bi, batch in enumerate(loader):
        if max_batches is not None and bi >= max_batches:
            break
        if debug_asserts:
            batch_debug_asserts(batch)
        outputs, loss = eval_step(state, batch)
        losses.append(loss)
        raw = outputs[0][:, 0]
        if bf16_readback:
            raw = raw.to(torch.bfloat16)
        logits = raw.float().cpu().numpy()
        probs = 1.0 / (1.0 + np.exp(-logits))
        n = batch[INPUT_KEY].shape[0]
        gts = _as_list(batch["gt"], n)
        voids = _as_list(batch.get("void_pixels", [None] * n), n)
        bboxes = _as_list(batch["bbox"], n) if "bbox" in batch else [None] * n
        for j in range(n):
            gt = tens2image(np.asarray(gts[j]))
            void = None if voids[j] is None else tens2image(np.asarray(voids[j]))
            n_samples += 1
            if gt.max() <= 0.5:
                for ti, th in enumerate(thresholds):
                    jac_sum[ti] += float(not (probs[j] > th).any())
                continue
            bbox = tuple(int(v) for v in np.asarray(bboxes[j])) \
                if bboxes[j] is not None \
                else get_bbox(gt > 0.5, pad=relax, zero_pad=zero_pad)
            full = crop2fullmask(probs[j], bbox, gt.shape[:2],
                                 zero_pad=zero_pad, relax=relax)
            jac_sum += np_jaccard_thresholds(full, thresholds, gt > 0.5, void)
    loss_sum = float(torch.stack(losses).sum()) if losses else 0.0
    n_batches = len(losses)
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        packed = torch.tensor([*jac_sum, n_samples, loss_sum, n_batches],
                              dtype=torch.float64, device=state.device)
        dist.all_reduce(packed)
        summed = packed.tolist()
        jac_sum = np.asarray(summed[:len(thresholds)])
        n_samples, loss_sum = int(summed[-3]), summed[-2]
        n_batches = int(summed[-1])
    jac_avg = (jac_sum / max(n_samples, 1)).tolist()
    best = int(np.argmax(jac_avg))
    return {"loss": loss_sum / max(n_batches, 1),
            "jaccard_per_threshold": dict(zip(map(str, thresholds), jac_avg)),
            "jaccard": jac_avg[best],
            "best_threshold": thresholds[best],
            "n_samples": n_samples,
            "seconds": time.perf_counter() - t0}


def batch_debug_asserts(batch: Mapping[str, np.ndarray]) -> None:
    """The reference's per-batch data checks (``debug_asserts``): input
    channels in [0, 255] and RGB not degenerate, ``crop_gt`` binary."""
    x = np.asarray(batch[INPUT_KEY])
    if not (x.min() >= 0.0 and x.max() <= 255.0):
        raise AssertionError("input outside [0,255]")
    if len(np.unique(x[..., :3])) <= 2:
        raise AssertionError("degenerate RGB channels")
    uniq = np.unique(np.asarray(batch["crop_gt"]))
    if not np.all(np.isin(uniq, (0.0, 1.0))):
        raise AssertionError(f"gt not binary: {uniq[:5]}")
