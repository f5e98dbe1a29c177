"""Validation, the counterpart of ``distributedpytorch_tpu/train/evaluate.py``:
``evaluate`` (the instance task) and ``evaluate_semantic``.

Instance task: threshold-swept Jaccard with full-resolution paste-back.

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

Semantic task (:func:`evaluate_semantic`): confusion-matrix mIoU, by one
of four protocols — at the crop (argmax and counts on the device), at
each image's native size (``eval_full_res``; the probabilities resized
and argmaxed on the device, ``ops/warp.py``, or on the host), and under
test-time augmentation over scales and flips (on the host).  The (C, C)
counts, loss and sample count are summed over the ranks.
"""

from __future__ import annotations

import time
from typing import Callable, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import imaging
from ..ops.metrics import confusion_matrix, miou_from_confusion, np_jaccard_thresholds
from ..ops.warp import fullres_argmax
from ..parallel.step import INPUT_KEY
from ..utils.helpers import crop2fullmask, fixed_resize, get_bbox, tens2image


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
    if _distributed():
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


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def _np_confusion(pred: np.ndarray, label: np.ndarray, nclass: int,
                  ignore_index: int) -> np.ndarray:
    """Host (C, C) confusion of a ragged full-resolution map, rows the
    true class, columns the predicted one."""
    valid = label != ignore_index
    idx = label[valid].astype(np.int64) * nclass + pred[valid].astype(np.int64)
    return np.bincount(idx, minlength=nclass * nclass).reshape(nclass, nclass)


def _native_gt(g) -> np.ndarray:
    g = np.asarray(g)
    return g[..., 0] if g.ndim == 3 else g


def evaluate_semantic(eval_step: Callable, state, loader, nclass: int,
                      ignore_index: int = 255, max_batches: int | None = None,
                      tta_scales: Sequence[float] = (),
                      tta_flip: bool = False, debug_asserts: bool = False,
                      bf16_probs: bool = True,
                      device_fullres: tuple[int, int] | None = None) -> dict:
    """Confusion-matrix mIoU over ``loader``; returns ``miou``,
    ``per_class_iou``, ``pixel_acc``, ``jaccard`` (= ``miou``, the
    best-checkpoint gate's key), ``loss``, ``n_samples`` and ``seconds``.

    Without test-time augmentation the argmax of the primary logits and
    the counts stay on the device until the epoch's end.  A batch with
    ``gt_full`` (``eval_full_res``) is scored at each image's native size:
    the softmax probabilities resized bilinearly (cv2's linear) and
    argmaxed on the device (``fullres_argmax``) when ``device_fullres``
    (the ``(max_h, max_w)`` canvas, ``data.val_max_im_size``) holds every
    image, else read back and resized on the host.  ``tta_scales`` /
    ``tta_flip``: the softmax probabilities averaged over the listed input
    scales (inputs resized on the host, linear; ``crop_gt`` nearest), and
    with ``tta_flip`` over the horizontal flip at each scale; the votes are
    exactly scales x flips (a list without 1.0 does not vote the plain
    pass, which always runs and gives the loss).  ``bf16_probs``
    (``eval_bf16_probs``) rounds the probabilities read back to the host
    to bfloat16 on the device first.  Under data parallelism each rank
    scores its shard and the counts, losses and samples are summed."""
    if len(set(tta_scales)) != len(tta_scales):
        raise ValueError(f"duplicate tta_scales {tuple(tta_scales)} would "
                         "double-weight votes")
    tta = bool(tta_flip or any(s != 1.0 for s in tta_scales))
    scale_list = list(tta_scales) if tta_scales else [1.0]
    wire = torch.bfloat16 if bf16_probs else torch.float32
    conf = np.zeros((nclass, nclass), np.int64)
    confs: list[torch.Tensor] = []   # device counts, read at the end
    losses: list[torch.Tensor] = []
    fullres_maps: list = []          # (device uint8 maps, native gts)
    n_samples = 0
    t0 = time.perf_counter()

    def to_host(probs: torch.Tensor) -> np.ndarray:
        """Device (B, C, H, W) probabilities -> host (B, H, W, C) float32,
        read back in the wire dtype."""
        return probs.to(wire).float().permute(0, 2, 3, 1).cpu().numpy()

    def forward_probs(inp: np.ndarray, gt: np.ndarray):
        outputs, loss = eval_step(state, {INPUT_KEY: inp, "crop_gt": gt})
        return to_host(torch.softmax(outputs[0].float(), dim=1)), loss

    def host_fullres(probs: np.ndarray, gts: list) -> np.ndarray:
        out = np.zeros((nclass, nclass), np.int64)
        for j, gt in enumerate(gts):
            gt = _native_gt(gt)
            p = fixed_resize(probs[j], gt.shape[:2], flagval=imaging.LINEAR)
            out += _np_confusion(np.argmax(p, axis=-1), gt, nclass,
                                 ignore_index)
        return out

    def resize_all(arrs: np.ndarray, hw: tuple[int, int], flag: int):
        return np.stack([fixed_resize(a, hw, flagval=flag) for a in arrs])

    for bi, batch in enumerate(loader):
        if max_batches is not None and bi >= max_batches:
            break
        if debug_asserts:
            semantic_batch_debug_asserts(batch, nclass, ignore_index)
        n = batch[INPUT_KEY].shape[0]
        n_samples += n
        if not tta:
            outputs, loss = eval_step(
                state, {k: batch[k] for k in (INPUT_KEY, "crop_gt")})
            losses.append(loss)
            if "gt_full" in batch:
                gts = [_native_gt(g) for g in _as_list(batch["gt_full"], n)]
                hw = np.array([g.shape[:2] for g in gts], np.int64)
                probs = torch.softmax(outputs[0].float(), dim=1)
                if device_fullres is not None \
                        and hw[:, 0].max() <= device_fullres[0] \
                        and hw[:, 1].max() <= device_fullres[1]:
                    fullres_maps.append((fullres_argmax(
                        probs, torch.from_numpy(hw),
                        tuple(device_fullres)), gts))
                else:
                    conf += host_fullres(to_host(probs), gts)
            else:
                labels = torch.as_tensor(
                    np.asarray(batch["crop_gt"])[..., 0],
                    device=outputs[0].device)
                confs.append(confusion_matrix(outputs[0].argmax(dim=1),
                                              labels, nclass, ignore_index))
            continue

        inp = np.asarray(batch[INPUT_KEY])
        gt = np.asarray(batch["crop_gt"])
        h, w = inp.shape[1:3]
        # the plain pass always runs and gives the loss; it votes only if
        # 1.0 is one of the scales
        base_probs, loss = forward_probs(inp, gt)
        losses.append(loss)
        probs = np.zeros_like(base_probs)
        votes = 0
        for s in scale_list:
            if s == 1.0:
                inp_s, gt_s, p = inp, gt, base_probs
            else:
                hs, ws = max(1, round(h * s)), max(1, round(w * s))
                inp_s = resize_all(inp, (hs, ws), imaging.LINEAR)
                gt_s = resize_all(gt, (hs, ws), imaging.NEAREST)
                p = resize_all(forward_probs(inp_s, gt_s)[0], (h, w),
                               imaging.LINEAR)
            probs += p
            votes += 1
            if tta_flip:
                p_f = forward_probs(inp_s[:, :, ::-1], gt_s[:, :, ::-1])[0]
                p_f = p_f[:, :, ::-1]
                if s != 1.0:
                    p_f = resize_all(p_f, (h, w), imaging.LINEAR)
                probs += p_f
                votes += 1
        avg = probs / votes
        if "gt_full" in batch:
            conf += host_fullres(avg, _as_list(batch["gt_full"], n))
        else:
            conf += _np_confusion(np.argmax(avg, axis=-1), gt[..., 0],
                                  nclass, ignore_index)

    if confs:
        conf += torch.stack(confs).sum(0).cpu().numpy()
    for maps, gts in fullres_maps:
        maps = maps.cpu().numpy()
        for j, g in enumerate(gts):
            conf += _np_confusion(maps[j, :g.shape[0], :g.shape[1]], g,
                                  nclass, ignore_index)
    loss_sum = float(torch.stack(losses).sum()) if losses else 0.0
    n_batches = len(losses)
    if _distributed():
        device = losses[0].device if losses else torch.device("cpu")
        summed = torch.from_numpy(conf).to(device)
        dist.all_reduce(summed)
        conf = summed.cpu().numpy()
        packed = torch.tensor([loss_sum, n_batches, n_samples],
                              dtype=torch.float64, device=device)
        dist.all_reduce(packed)
        loss_sum, n_batches, n_samples = packed.tolist()
        n_batches, n_samples = int(n_batches), int(n_samples)
    out = miou_from_confusion(conf)
    out.update({"loss": loss_sum / max(n_batches, 1),
                "jaccard": out["miou"],
                "n_samples": n_samples,
                "seconds": time.perf_counter() - t0})
    return out


def semantic_batch_debug_asserts(batch: Mapping[str, np.ndarray], nclass: int,
                                 ignore_index: int = 255) -> None:
    """The semantic task's per-batch data checks (``debug_asserts``): input
    channels in [0, 255] and RGB not degenerate, ``crop_gt`` within the
    class ids and the void value."""
    x = np.asarray(batch[INPUT_KEY])
    if not (x.min() >= 0.0 and x.max() <= 255.0):
        raise AssertionError("input outside [0,255]")
    if len(np.unique(x[..., :3])) <= 2:
        raise AssertionError("degenerate RGB channels")
    uniq = np.unique(np.asarray(batch["crop_gt"]))
    valid = np.concatenate([np.arange(nclass), [ignore_index]])
    if not np.all(np.isin(uniq, valid)):
        raise AssertionError(f"gt ids outside 0..{nclass - 1} u "
                             f"{{{ignore_index}}}: {uniq[:8]}")


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
