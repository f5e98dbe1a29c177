#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA device and exits non-zero without one (or without the package beside
it), printing no result.  The phases, each raising on failure:

1. build   — compile the attention kernels from ``csrc/`` with nvcc.
2. kernels — hold each kernel against its plain PyTorch form on the card at
             the serving shapes (B = 1 and 8, N = 4096 tokens, Ck = 64,
             Cv = C = 512), at a ragged N (65² = 4225) and at DANet-R18's
             narrow head (Ck = 16, Cv = C = 128), in float32 (max |diff| <=
             1e-4 x max |plain|: summation order, and the kernels' 3xTF32
             products) and in bfloat16
             inputs (<= 2e-2 x max |plain|, output dtype kept), plus two
             odd widths (C = 100 and 67); each kernel launched twice on one
             input must give the same bits; every kernel against float64
             at an input scale where a single-pass TF32 product fails the
             same bound, and with NaN inputs; then
             time kernel, plain form and a library yardstick with CUDA
             events, taking turns, both for a single launch and per call
             in runs of 20 back to back, and the host's microseconds per
             call at B = 1,
             each against its bound: for float32 work the least time of a
             float32-accurate route, 3xTF32 on the tensor cores (a third of
             the TF32 rate) or the bytes at the memory rate; all three on
             bfloat16 inputs (as bf16 training and serving give them)
             against the bf16 rate or the bytes, their plain forms and a
             bf16 library call (SDPA; ``bmm`` + ``softmax``; ``bmm``).
3. predictor — DANet-R101 at 512² with every weight drawn from seed 0
             (gammas and last-BN scales included), ``predict_batch`` on a
             synthetic 480x640 image with 4 click sets, compared with the
             same predictor forced onto the plain forms (<= 1e-3 abs; the
             three logits <= 1e-3 x max(1, max |logit|)); request latency
             and its breakdown (host prepare, forward with kernels and
             with plain forms, paste-back, profiler top kernels).
4. service — ``InferenceService(max_batch=4)`` under 8 concurrent submits;
             every mask matches ``Predictor.predict`` (<= 1e-4 abs).
5. http    — the HTTP front on localhost answers 3 predicts and /healthz.
6. train   — (a) the kernels' autograd functions alone at DANet-R101's
             attention shapes: every input's gradient within 1e-3 x max |g|
             of autograd through the plain forms; then one step's gradients
             of DANet-R101 at 512², B = 2, every weight drawn from seed 0,
             dropout off, through the kernels, through the plain forms and
             through the plain forms in float64: every parameter tensor
             within 1e-3 x its max |g| of the plain path, or, where float32
             itself is further off, within the plain path's own distance
             from float64 (a deep random net amplifies the kernels'
             float32-level differences; the PAM key bias, zero in exact
             arithmetic, is scaled by the key weight's), the query/key/value
             gradients nonzero, and each kernel's forward counter up by
             exactly 1; (b) the default
             train step (B = 16, SGD 5e-8 / 0.9 / 5e-4, f32) with the
             kernels and with the plain forms, timed in turns with CUDA
             events, images/s, peak memory, a profiler table of one step
             and the device's idle share, and the host pipeline's ms per
             batch of 16; (c) ``python -m distributedpytorch_tpu_torch
             --fake-data`` as a subprocess (DANet-R101 at 512², 4 optimizer
             steps, 2 validations): finite losses, Jaccard in [0, 1], a
             committed checkpoint whose weights ``Predictor.from_run``
             serves bit for bit, and the kernels' launches in the fit equal
             to one per train step and per validation sample.
             bf16 (``train.precision=bfloat16``): (d) one DANet-R101 step's
             gradients at B = 2 through the kernels, through the plain
             forms in bf16 and in float32: every gradient float32, every
             tensor within 2e-2 x its float32 max |g| of the bf16 plain
             path or within that path's own distance from float32, q/k/v
             gradients nonzero, each counter up by 1; (e) the bf16 B = 16
             step in turns with the float32 kernel step and the bf16
             plain-form step (median of 5, images/s, peak memory, profiler
             split, idle share), and one bf16 step with ``model.remat``;
             (f) the bf16 CLI fit at train batch 2 sent SIGTERM after its
             first step line (exit 0, ``preempted``, a committed step with
             ``interrupted_epoch``), then ``resume=auto``: the straight
             run's final step, no batch twice, weights within the stated
             tolerance of a straight run's (``resume_check``: the spread
             measured over three straight runs, one started beside the
             resumed run), launches one per train step
             and validation sample over both runs, and
             ``Predictor.from_run`` serving it in bf16 on float32 weights,
             bitwise the checkpoint's model; (g) a ``Trainer`` warm-started
             from its weights holds them bit for bit, at step 0 with an
             empty optimizer.
7. host    — the host-data layer (phases 6h-6j): (h) each op of the host
             library (``csrc/host_image_ops.cpp``, built with the host C++
             compiler) against its numpy form at the main path's shapes,
             ms of both and max |diff| within ``HOST_OP_TOL``, and ms per
             sample of the default stack on the library, on the numpy
             forms and with the fused crop + resize; (i) ms per
             batch of 16 at 512² from a 375x500 fake VOC set for the
             threaded loader on the numpy forms and on the library, the
             worker-process loader (``data.loader=grain``) at 2, 4 and 8
             processes (capped by the CPU affinity), with
             ``data.fused_crop_resize``, and on an on-disk JPEG/PNG tree with
             ``data.decode_cache`` 0 and 64 (only where PIL imports), the
             worker loader's samples bitwise the threaded loader's, the
             peak ``/dev/shm`` use, no worker left after each; (j) the bf16
             B = 16 step fed by the worker loader (data wait per step, step
             ms, images/s, the stream's idle share between steps; finite
             losses, one launch per kernel per step), then the worker-fed
             bf16 CLI fit (``data.loader=grain data.num_workers=2
             data.fused_crop_resize=true``) SIGTERMed after its first step
             line and resumed: the straight run's final step, no batch
             twice, no process of either fit's process group left.

8. dist    — data parallelism (``parallel/``): (a) world size 1 over NCCL
             through the launcher's torchrun path (its environment set
             here), DDP, cross-replica BatchNorm and ZeRO-1 engaged; (b)
             two ranks over gloo on the one card (NCCL refuses two ranks on
             one device), ``dp``, ``dp_zero1`` and
             ``train.reduce_buckets=4``: DANet-R101 at 512², bf16, global
             batch 16, every weight drawn from seed 0, dropout off, two
             steps at lr 1e-3 each held to the single-process step from the
             same weights (each step's loss, each tensor's update, within
             6d's bf16 bound: 2e-2 of the reference's own size or the bf16
             reference's distance from float32, plus 4 ulps of the
             weight), each rank launching each kernel once per step, then
             ms per step with the share an all_reduce of the gradients
             alone takes; (c) a 2-rank CLI fit (ResNet-18 at 64², gloo)
             whose rank 1 alone gets SIGTERM: both ranks stop at one step
             and save once (``num_shards`` 2), ``resume=auto`` reaches the
             straight runs' final step within 6f's rule, and no process of
             any fit's group is left.  The wrong-device case of the kernels'
             device guard needs a host with two cards and is not run.
9. semantic — the semantic task and the DeepLab family (no attention
             kernel lies on this path; their counters must not move):
             (a) DeepLabV3, DeepLabV3+ and FCN on ResNet-101 at 513², 21
             classes, aux head, every weight drawn from seed 0, eval mode,
             B = 1: the card's float32 logits (TF32 off) within 1e-3 x
             max(1, max |logit|) of the CPU's; (b) one DeepLabV3-R101 step
             at B = 2 from the trainer's initial weights, dropout off,
             labels with a void border: the loss within 1e-5 of the CPU's
             on the card's logits, every gradient within 1e-3 x its max |g|
             of the card's float64 step or within 4x the CPU's float32
             step's own distance from it (float32 itself is off by more on
             some tensors: cancelling sums over 2 x 257² positions, and the
             image-pool BatchNorm over two values), and an all-void batch
             giving loss 0 and zero gradients; (c) BASELINE config 4, the
             B = 8 DeepLabV3-R101 train step, bf16 and float32 in turns
             (median of 5, CUDA events), images/s, peak memory, a profiler
             split (convolutions, BatchNorm, loss, resize, the rest) and the
             idle share; (d) the semantic CLI fit (``task=semantic``
             DeepLabV3-R101 513² bf16, train batch 4, full-res validation
             under 3-scale + flip TTA, 2 steps): finite losses, mIoU and
             pixel accuracy in [0, 1] with 21 per-class entries, a committed
             checkpoint, then ``SemanticPredictor.from_run``'s resize map
             bitwise the argmax of the trainer's eval forward, ``slide``,
             and ``--predict`` writing a PNG; (e) ``fullres_argmax`` on the
             card against the host full-res protocol on the same
             probabilities, >= 99.9% of pixels agreeing.

The first line describes the host (CPU affinity, ``/dev/shm``, RAM,
whether PIL imports and cv2 and grain are installed).  The launch counters
are zeroed just before phase 3 and read after phase 5 (the serving path),
zeroed by the trainer when its fit starts and read from its
``fit_summary.json`` (the training paths, f32, bf16 and worker-fed, the
latter two summed over the preempted and resumed runs), and zeroed just
before the bf16 run is served (the bf16 serving path), and zeroed by each
rank of phase 8 (a) and (b) before each of its steps (the data-parallel
path, rank 0's counts summed): every kernel must have run on each.  Every
bounded check of phases 6f-6j and 8 records its
smallest limit / value, printed as the ``margins`` line before the
records.  The second-to-last line is the ``kernels`` JSON record; the last
line is the device record.  ``--phases train`` (or any comma list of
``kernels,serve,train,host,dist,semantic``) runs part of the script for development
and then prints neither record.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

#: dense peak rates (float32 FLOP/s on CUDA cores, bf16 FLOP/s and TF32
#: FLOP/s on tensor cores, memory bytes/s) from NVIDIA's data sheets, by
#: card variant
PEAKS = {
    "H100 SXM": (67e12, 989e12, 495e12, 3.35e12),
    "H100 PCIe": (51e12, 756e12, 378e12, 2.0e12),
    "H100 NVL": (60e12, 835e12, 417.5e12, 3.9e12),
}
REPO = Path(__file__).resolve().parent
TPU_KERNELS = {
    "position_attention": "distributedpytorch_tpu/ops/pallas_attention.py:50",
    "cam_energy": "distributedpytorch_tpu/ops/pallas_attention.py:167",
    "cam_apply": "distributedpytorch_tpu/ops/pallas_attention.py:195",
}
SOURCE = "distributedpytorch_tpu_torch/csrc/attention.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


#: every bounded check's smallest limit / value over this run (inf where
#: the value was 0); printed as the ``margins`` line before the records
MARGINS: dict[str, float] = {}


def note_margin(name: str, value: float, limit: float) -> float:
    """Record ``limit / value`` as ``name``'s margin (the smallest seen)."""
    ratio = math.inf if value == 0 else limit / value
    MARGINS[name] = min(MARGINS.get(name, math.inf), ratio)
    return ratio


def check(name: str, value: float, limit: float) -> None:
    """Raise unless ``value <= limit``; print both and the margin."""
    ratio = note_margin(name, value, limit)
    log(f"check {name}: {value:.3e} <= {limit:.3e} (limit/value {ratio:.3g})")
    if not value <= limit:
        raise AssertionError(f"{name}: {value:.3e} > {limit:.3e}")


def card_peaks(name: str) -> tuple[str, tuple[float, float, float, float]]:
    for key in ("PCIe", "NVL"):
        if key in name:
            return f"H100 {key}", PEAKS[f"H100 {key}"]
    return "H100 SXM", PEAKS["H100 SXM"]


#: calls per CUDA-event pair of the back-to-back timing
RUN = 20
#: step times of earlier phases that later ones print beside their own
STEP_MS: dict[str, float] = {}


def median_ms(fns, inner: int = 1, reps: int = 21, warmup: int = 3) -> list[float]:
    """Milliseconds per call of each of ``fns``: the median over ``reps``
    rounds, each round timing every function in turn with one CUDA-event
    pair around ``inner`` calls back to back, so that a slow spell of the
    card or of the host falls on all of them alike.  With ``inner = 1`` (a
    single launch) the device waits for whatever part of the host's launch
    cost comes before its first kernel; runs of ``RUN`` calls hide that
    cost wherever the device is the slower of the two."""
    import torch

    for fn in fns:
        for _ in range(warmup):
            fn()
    times = [[] for _ in fns]
    for _ in range(reps):
        for fn, acc in zip(fns, times):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            end.synchronize()
            acc.append(start.elapsed_time(end) / inner)
    return [statistics.median(t) for t in times]


def both_ms(*fns) -> tuple[list[float], list[float]]:
    """Single-launch ms and ms per call in runs of ``RUN`` of each of
    ``fns``, timed together."""
    return median_ms(fns), median_ms(fns, inner=RUN)


def host_us(fn, calls: int = 50, reps: int = 5) -> float:
    """Host microseconds per ``fn()`` while the device's queue has room:
    the Python wrapper's own cost, its launches included (median of
    ``reps`` loops of ``calls`` calls, the device drained before each)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def bound(flops: float, nbytes: float, rate: float, bw: float) -> tuple[float, str]:
    """The least time (ms) for ``flops`` at ``rate`` and ``nbytes`` at ``bw``,
    and which of the two sets it."""
    by_ops, by_bytes = flops / rate, nbytes / bw
    return max(by_ops, by_bytes) * 1e3, "operations" if by_ops >= by_bytes else "bytes"


def phase_kernels(torch, ca, att, peaks) -> dict:
    """Phase 2: correctness on the card, then timings at B = 1 and B = 8."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    # Scales keep the softmaxes soft enough that float32 summation-order
    # noise in the scores is not amplified past the stated bound;
    # check_precision holds the kernels to float64 at larger ones.
    def pam_inputs(b, n, ck, cv, dtype):
        return (randn(b, n, ck, scale=0.5, dtype=dtype),
                randn(b, n, ck, scale=0.5, dtype=dtype),
                randn(b, n, cv, dtype=dtype))

    def cam_inputs(b, n, c, dtype):
        return (randn(b, n, c, scale=0.05, dtype=dtype),)

    def apply_inputs(b, n, c, dtype):
        x = randn(b, n, c, scale=0.05, dtype=dtype)
        return att.channel_energy(x), x

    kernels = {
        "position_attention": (ca.flash_position_attention,
                               att.position_attention, pam_inputs),
        "cam_energy": (ca.cam_energy, att.channel_energy, cam_inputs),
        "cam_apply": (ca.cam_apply, att.channel_apply, apply_inputs),
    }
    # (B, N, Ck, C): serving shapes at B = 1 and 8, ragged N, narrow head,
    # and two odd widths (C = 100: 16-byte rows in float32 but not in
    # bfloat16; C = 67: no 16-byte rows at all)
    shapes = [(1, 4096, 64, 512), (8, 4096, 64, 512), (2, 4225, 64, 512),
              (2, 65, 16, 128), (2, 4225, 16, 100), (1, 257, 8, 67)]
    errors = {name: 0.0 for name in kernels}
    for name, (kernel, plain, make) in kernels.items():
        for b, n, ck, c in shapes:
            for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
                args = make(b, n, ck, c, dtype) if name == "position_attention" \
                    else make(b, n, c, dtype)
                out = kernel(*args)
                torch.cuda.synchronize()
                ref = plain(*args)
                torch.cuda.synchronize()
                if out.dtype != ref.dtype or out.shape != ref.shape:
                    raise AssertionError(
                        f"{name} {dtype}: got {out.dtype} {tuple(out.shape)}, "
                        f"plain gives {ref.dtype} {tuple(ref.shape)}")
                err = (out.float() - ref.float()).abs().max().item()
                limit = tol * ref.float().abs().max().item()
                if not err <= limit:
                    raise AssertionError(
                        f"{name} B={b} N={n} C={c} {dtype}: max |diff| {err:.3e}"
                        f" > {limit:.3e}")
                if dtype == torch.float32 and n == 4096 and c == 512:
                    errors[name] = max(errors[name], err)
                # no atomics: a second launch gives the same bits
                if not torch.equal(out, kernel(*args)):
                    raise AssertionError(f"{name} B={b} N={n} C={c} {dtype}: "
                                         f"two launches differ")
                log(f"check {name} B={b} N={n} C={c} {str(dtype)[6:]}: "
                    f"max|diff| {err:.3e} <= {limit:.3e}; a second launch is "
                    f"bitwise equal")

    check_precision(torch, ca, att, randn)
    check_nan(torch, ca, att, randn)

    f32, bf16, tf32, bw = peaks
    # float32 work at float32 accuracy: 3xTF32 on the tensor cores, three
    # TF32 products per product, beats the CUDA cores' float32 rate
    f32_exact = max(tf32 / 3, f32)
    n, ck, c = 4096, 64, 512
    records = {}
    for b in (1, 8):
        q, k, v = pam_inputs(b, n, ck, c, torch.float32)
        x, = cam_inputs(b, n, c, torch.float32)
        attn = att.channel_energy(x)
        # E is symmetric: the function needs its c(c + 1) / 2 distinct entries
        gram_flops = 2.0 * b * n * c * (c + 1) / 2
        work = {
            # (kernel, plain, library, flops, bytes)
            "position_attention": (
                lambda: ca.flash_position_attention(q, k, v),
                lambda: att.position_attention(q, k, v),
                lambda: F.scaled_dot_product_attention(
                    q[:, None], k[:, None], v[:, None], scale=1.0),
                2.0 * b * n * n * (ck + c), 4.0 * b * n * (2 * ck + 2 * c)),
            "cam_energy": (
                lambda: ca.cam_energy(x),
                lambda: att.channel_energy(x),
                lambda: torch.softmax(_rowmax_minus(torch.bmm(x.transpose(1, 2), x)), -1),
                gram_flops, 4.0 * b * (n * c + c * c)),
            "cam_apply": (
                lambda: ca.cam_apply(attn, x),
                lambda: att.channel_apply(attn, x),
                lambda: torch.bmm(x, attn.transpose(1, 2)),
                2.0 * b * n * c * c, 4.0 * b * (2 * n * c + c * c)),
        }
        for name, (kern, plain, lib, flops, nbytes) in work.items():
            (ms, plain_ms, lib_ms), (ms_run, plain_run, lib_run) = both_ms(
                kern, plain, lib)
            bound_ms, bound_by = bound(flops, nbytes, f32_exact, bw)
            cuda_core_ms, _ = bound(flops, nbytes, f32, bw)
            log(f"time {name} B={b}: kernel {ms:.4f} ms single launch, {ms_run:.4f} "
                f"ms in runs of {RUN}; plain {plain_ms:.4f} / {plain_run:.4f} ms; "
                f"library {lib_ms:.4f} / {lib_run:.4f} ms; bound {bound_ms:.4f} ms "
                f"({bound_by}, 3xTF32), {bound_ms / ms:.1%} of it single, "
                f"{bound_ms / ms_run:.1%} in runs; CUDA-core f32 bound "
                f"{cuda_core_ms:.4f} ms")
            if min(ms, ms_run) < bound_ms:
                raise AssertionError(f"{name} B={b}: {min(ms, ms_run):.4f} ms is below "
                                     f"its bound {bound_ms:.4f} ms: the work is miscounted")
            if name == "cam_energy":
                computed = gram_tile_entries(c, ca._GRAM_TILE)
                tiles_ms, _ = bound(2.0 * b * n * computed, nbytes, f32_exact, bw)
                log(f"time cam_energy B={b}: the Gram computes {computed} entries "
                    f"(its whole tiles on and above the diagonal) of the "
                    f"{c * (c + 1) // 2} it needs; bound at the computed count "
                    f"{tiles_ms:.4f} ms")
            if b == 1:
                records[name] = {
                    "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "ms_run20": ms_run, "plain_ms_run20": plain_run,
                    "library_ms_run20": lib_run,
                    "host_us": host_us(kern), "library_host_us": host_us(lib)}
                log(f"time {name} B=1: host {records[name]['host_us']:.1f} us per "
                    f"call of the wrapper, {records[name]['library_host_us']:.1f} us "
                    f"of the library call")
        # the energy kernel's two launches, each alone
        partial, energy = ca._gram_buffers(x)
        splits = partial.shape[1]
        (gram_ms, softmax_ms), (gram_run, softmax_run) = both_ms(
            lambda: ca._launch_gram(x, partial),
            lambda: ca._launch_softmax(partial, energy))
        gram_bound, gram_by = bound(gram_flops, 4.0 * b * (n * c + splits * c * c),
                                    f32_exact, bw)
        softmax_bound, softmax_by = bound(0.0, 4.0 * b * (splits + 1) * c * c,
                                          f32_exact, bw)
        log(f"time cam_energy B={b} launches: Gram ({splits} slices of N) "
            f"{gram_ms:.4f} ms single, {gram_run:.4f} ms in runs, bound "
            f"{gram_bound:.4f} ms ({gram_by}); softmax {softmax_ms:.4f} ms single, "
            f"{softmax_run:.4f} ms in runs, bound {softmax_bound:.4f} ms "
            f"({softmax_by})")
        (ours, composite), (ours_run, composite_run) = both_ms(
            lambda: ca.flash_channel_attention(x),
            lambda: torch.bmm(
                torch.softmax(_rowmax_minus(torch.bmm(x.transpose(1, 2), x)), -1),
                x.transpose(1, 2)))
        log(f"time channel_attention B={b}: kernels {ours:.4f} ms single, "
            f"{ours_run:.4f} ms in runs; library composite bmm+softmax+bmm "
            f"{composite:.4f} ms single, {composite_run:.4f} ms in runs")
    # bf16 inputs, as the bf16 training and serving forwards give them, each
    # kernel against its plain form and a library call on the same inputs,
    # in turns; bounds at the bf16 tensor-core rate (or the bytes: bf16
    # tokens, float32 maps)
    for b in (1, 8):
        q, k, v = pam_inputs(b, n, ck, c, torch.bfloat16)
        x, = cam_inputs(b, n, c, torch.bfloat16)
        attn = att.channel_energy(x)
        work = {
            "position_attention": (
                lambda: ca.flash_position_attention(q, k, v),
                lambda: att.position_attention(q, k, v),
                lambda: F.scaled_dot_product_attention(
                    q[:, None], k[:, None], v[:, None], scale=1.0),
                2.0 * b * n * n * (ck + c), 2.0 * b * n * (2 * ck + 2 * c)),
            # the library calls round E (energy) or the map (apply) to
            # bf16: a cheaper, less accurate function than the kernels'
            "cam_energy": (
                lambda: ca.cam_energy(x),
                lambda: att.channel_energy(x),
                lambda: torch.softmax(_rowmax_minus(
                    torch.bmm(x.transpose(1, 2), x).float()), -1),
                2.0 * b * n * c * (c + 1) / 2, 2.0 * b * n * c + 4.0 * b * c * c),
            "cam_apply": (
                lambda: ca.cam_apply(attn, x),
                lambda: att.channel_apply(attn, x),
                lambda: torch.bmm(x, attn.transpose(1, 2).to(torch.bfloat16)),
                2.0 * b * n * c * c, 4.0 * b * n * c + 4.0 * b * c * c),
        }
        for name, (kern, plain, lib, flops, nbytes) in work.items():
            (ms, plain_ms, lib_ms), (ms_run, plain_run, lib_run) = both_ms(
                kern, plain, lib)
            bf16_ms, bf16_by = bound(flops, nbytes, bf16, bw)
            log(f"time {name} B={b} bf16: kernel {ms:.4f} ms single, {ms_run:.4f} "
                f"ms in runs of {RUN}; plain {plain_ms:.4f} / {plain_run:.4f} ms; "
                f"library {lib_ms:.4f} / {lib_run:.4f} ms; bf16 bound {bf16_ms:.4f} "
                f"ms ({bf16_by}), {bf16_ms / ms:.1%} of it single, "
                f"{bf16_ms / ms_run:.1%} in runs")
            if min(ms, ms_run) < bf16_ms:
                raise AssertionError(f"{name} B={b} bf16: {min(ms, ms_run):.4f} ms is "
                                     f"below its bound {bf16_ms:.4f} ms")
            if b == 1:
                records[name]["bf16"] = {
                    "ms": ms, "ms_run20": ms_run, "plain_ms": plain_ms,
                    "plain_ms_run20": plain_run, "library_ms": lib_ms,
                    "library_ms_run20": lib_run, "bound_ms": bf16_ms,
                    "bound_by": bf16_by}
    for name in records:
        records[name]["max_abs_err"] = errors[name]
    return records


#: the scale of the inputs at which check_precision holds each kernel to
#: float64 and requires a single-pass TF32 product to fail: X for the
#: channel kernels, q and k for the position kernel (v at unit scale)
PRECISION_SCALE = {"cam_energy": 0.25, "cam_apply": 0.25,
                   "position_attention": 1.0}


def check_precision(torch, ca, att, randn) -> None:
    """Float32 accuracy of the kernels at B = 1, N = 4096, Ck = 64,
    C = Cv = 512, against their plain forms taken in float64, with the bound
    of the other checks, 1e-4 x max |exact|.  The float32 plain form
    (cuBLAS) and the same form with single-pass TF32 products
    (``allow_tf32``) are held to it beside the kernel.  At
    ``PRECISION_SCALE`` the kernel must pass and the single-pass TF32 form
    must miss, or the check could not tell a single-pass TF32 kernel from a
    float32-exact one; the other scales are printed only: at unit scale the
    float32 channel energy itself sits at the bound (``rowmax - E`` rounds
    to the ulp of the diagonal, ~|x|^2 N)."""
    failures = []

    def hold(name, scale, kernel, plain, ref):
        limit = 1e-4 * ref.abs().max().item()
        err = {}
        for what, fn, tf32 in (("kernel", kernel, False),
                               ("float32 plain", plain, False),
                               ("single-pass TF32 plain", plain, True)):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            try:
                got = fn()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            err[what] = (got.double() - ref).abs().max().item()
        log(f"check {name} precision, inputs at scale {scale} vs float64: limit "
            f"{limit:.3e}; " + ", ".join(
                f"{what} {e:.3e} ({e / limit:.3g}x the limit)"
                for what, e in err.items()))
        if scale != PRECISION_SCALE[name]:
            return
        if not err["kernel"] <= limit:
            failures.append(f"{name} at scale {scale}: {err['kernel']:.3e} > "
                            f"{limit:.3e} against float64")
        if not err["single-pass TF32 plain"] > limit:
            failures.append(f"{name}: single-pass TF32 passes the check at "
                            f"scale {scale}, so it cannot see TF32 rounding")

    for scale in (1.0, 0.25, 0.05):
        x = randn(1, 4096, 512, scale=scale)
        xd = x.double()
        exact = torch.softmax(_rowmax_minus(xd.transpose(1, 2) @ xd), -1)
        attn = exact.float()
        hold("cam_energy", scale, lambda: ca.cam_energy(x),
             lambda: att.channel_energy(x), exact)
        hold("cam_apply", scale, lambda: ca.cam_apply(attn, x),
             lambda: att.channel_apply(attn, x), xd @ attn.double().transpose(1, 2))
    for scale in (1.0, 0.5):
        q, k = randn(1, 4096, 64, scale=scale), randn(1, 4096, 64, scale=scale)
        v = randn(1, 4096, 512)
        exact = torch.softmax(q.double() @ k.double().transpose(1, 2), -1) @ v.double()
        hold("position_attention", scale, lambda: ca.flash_position_attention(q, k, v),
             lambda: att.position_attention(q, k, v), exact)
    if failures:
        raise AssertionError("; ".join(failures))


def check_nan(torch, ca, att, randn) -> None:
    """NaN in gives NaN out exactly where the plain form has it: X carries
    two float32 NaN payloads (every mantissa bit set, as the device's own
    NaN; only the lowest bit set) in batch entries 0 and 1, and the map one
    in entry 2; for the position kernel q, k and v carry one each in
    entries 0, 1 and 2 (a query row, a key, a value channel); float32 and
    bfloat16 inputs."""
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        x = randn(3, 300, 128, scale=0.05)
        attn = att.channel_energy(x)
        x.view(torch.int32)[0, 5, 7] = 0x7fffffff
        x.view(torch.int32)[1, 10, 20] = 0x7f800001
        attn.view(torch.int32)[2, 3, 9] = 0x7fffffff
        x = x.to(dtype)
        q, k, v = randn(3, 300, 64, scale=0.5), randn(3, 300, 64, scale=0.5), \
            randn(3, 300, 512)
        q.view(torch.int32)[0, 5, 7] = 0x7fffffff
        k.view(torch.int32)[1, 10, 20] = 0x7f800001
        v.view(torch.int32)[2, 3, 9] = 0x7fffffff
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        for name, kernel, plain, args in (
                ("cam_energy", ca.cam_energy, att.channel_energy, (x,)),
                ("cam_apply", ca.cam_apply, att.channel_apply, (attn, x)),
                ("position_attention", ca.flash_position_attention,
                 att.position_attention, (q, k, v))):
            out, ref = kernel(*args).float(), plain(*args).float()
            nan = ref.isnan()
            if not nan.any() or not torch.equal(out.isnan(), nan):
                raise AssertionError(f"{name} {dtype}: NaN at {int(out.isnan().sum())} "
                                     f"entries, the plain form at {int(nan.sum())}")
            err = (out - ref)[~nan].abs().max().item()
            limit = tol * ref[~nan].abs().max().item()
            if not err <= limit:
                raise AssertionError(f"{name} {dtype} with NaN inputs: finite max "
                                     f"|diff| {err:.3e} > {limit:.3e}")
            log(f"check {name} NaN inputs {str(dtype)[6:]}: NaN at the plain form's "
                f"{int(nan.sum())} entries and no others; finite max|diff| "
                f"{err:.3e} <= {limit:.3e}")


def gram_tile_entries(c: int, tile: int) -> int:
    """Entries of E that the Gram kernel computes: its whole tiles on and
    above the diagonal (the rest are their mirror images)."""
    sides = [min(tile, c - i) for i in range(0, c, tile)]
    return sum(a * b for i, a in enumerate(sides) for b in sides[i:])


def _rowmax_minus(energy):
    return energy.amax(dim=-1, keepdim=True) - energy


def synthetic_image(seed: int = 0):
    """A 480x640 RGB image with smooth structure plus noise, and 4 click
    sets (extreme points of boxes inside it)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:480, 0:640].astype(np.float32)
    image = np.stack([127 + 100 * np.sin(xx / 37.0 + c) * np.cos(yy / 53.0 - c)
                      for c in range(3)], -1)
    image += rng.normal(0, 10, image.shape)
    image = np.clip(image, 0, 255).astype(np.uint8)
    clicks = []
    for x0, y0, x1, y1 in ((60, 40, 300, 260), (320, 200, 600, 460),
                           (200, 100, 420, 380), (10, 300, 180, 470)):
        cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
        clicks.append(np.array([[x0, cy], [cx, y0], [x1, cy], [cx, y1]],
                               np.float64))
    return image, clicks


def phase_predictor(torch, Predictor, ca) -> tuple:
    import numpy as np

    pred = Predictor.fresh(512, "resnet101", seed=0, device="cuda")
    gammas = {n: p.item() for n, p in pred.model.named_parameters()
              if n.endswith("gamma")}
    if not all(abs(g) > 0 for g in gammas.values()):
        raise AssertionError(f"a residual gate is zero: {gammas}")
    log(f"predictor: DANet-R101 512^2 fresh seed 0, gammas {gammas}")
    image, clicks = synthetic_image()
    t0 = time.perf_counter()
    masks = pred.predict_batch(image, clicks)
    log(f"predictor: first predict_batch (build + cuDNN search) "
        f"{time.perf_counter() - t0:.3f} s")
    counts = dict(ca.launches)
    if not all(counts[k] > 0 for k in counts):
        raise AssertionError(f"a kernel was not launched by predict_batch: {counts}")
    for m in masks:
        if m.shape != image.shape[:2] or not np.isfinite(m).all():
            raise AssertionError(f"bad mask {m.shape}")
    # the three heads' logits on the same prepared batch: the PAM and CAM
    # heads see their branch right after one conv-BN-ReLU
    x = torch.from_numpy(np.stack([pred.prepare(image, c)[0] for c in clicks]))
    x = x.to("cuda").permute(0, 3, 1, 2).contiguous()
    with torch.inference_mode():
        fast = pred.model(x)
        pred.model.set_attention_impl("xla")
        slow = pred.model(x)
        plain = pred.predict_batch(image, clicks)
        pred.model.set_attention_impl("auto")
    for head, a, b in zip(("fused", "pam", "cam"), fast, slow):
        err = (a - b).abs().max().item()
        bound = 1e-3 * max(1.0, b.abs().max().item())
        log(f"predictor: {head} logits kernels vs plain max |diff| {err:.3e} "
            f"<= {bound:.3e}; logit range [{b.min().item():.3f}, "
            f"{b.max().item():.3f}]")
        if not err <= bound:
            raise AssertionError(f"{head} logits: {err:.3e} > {bound:.3e}")
    diff = max(float(np.abs(a - b).max()) for a, b in zip(masks, plain))
    spread = [float(m.max() - m.min()) for m in masks]
    log(f"predictor: kernels vs plain forms max |diff| {diff:.3e} (<= 1e-3); "
        f"mask ranges {spread}")
    if not diff <= 1e-3:
        raise AssertionError(f"predictor kernels vs plain: {diff:.3e} > 1e-3")
    lat = []
    for _ in range(10):
        t0 = time.perf_counter()
        pred.predict(image, clicks[0])
        lat.append((time.perf_counter() - t0) * 1e3)
    lat_b = []
    for _ in range(5):
        t0 = time.perf_counter()
        pred.predict_batch(image, clicks)
        lat_b.append((time.perf_counter() - t0) * 1e3)
    log(f"predictor: request latency predict (1 click set) median "
        f"{statistics.median(lat):.2f} ms; predict_batch (4) median "
        f"{statistics.median(lat_b):.2f} ms")
    breakdown(torch, pred, image, clicks)
    return pred, image, clicks


def _host_ms(fn, reps: int = 5) -> float:
    """Median host-clock milliseconds of ``fn()`` (which synchronises)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def breakdown(torch, pred, image, clicks) -> None:
    """Where a request's time goes: host preprocessing, the forward (with
    the kernels and with the plain forms), paste-back, and the device time
    of the top CUDA kernels of one B = 1 forward."""
    import numpy as np

    from distributedpytorch_tpu_torch import native_ops

    prep_ms = _host_ms(lambda: pred.prepare(image, clicks[0]))
    native_ops.reset_calls()
    concat, bbox = pred.prepare(image, clicks[0])
    prep_calls = dict(native_ops.calls)
    prob = pred.forward_prepared(concat)[0]
    paste_ms = _host_ms(lambda: pred.paste_back(prob, bbox, image.shape[:2]))
    with numpy_forms():
        prep_np_ms = _host_ms(lambda: pred.prepare(image, clicks[0]))
        paste_np_ms = _host_ms(lambda: pred.paste_back(prob, bbox, image.shape[:2]))
    log(f"breakdown: prepare {prep_ms:.2f} ms on the host library ({prep_np_ms:.2f} "
        f"ms on the numpy forms; library calls of one prepare {prep_calls}), "
        f"paste_back {paste_ms:.2f} ms ({paste_np_ms:.2f} ms on the numpy forms)")
    stack = {b: np.stack([concat] * b) for b in (1, 4)}
    fwd = {}
    for impl in ("auto", "xla"):
        pred.model.set_attention_impl(impl)
        for b in (1, 4):
            fwd[impl, b] = _host_ms(lambda: pred.forward_prepared(stack[b]))
    pred.model.set_attention_impl("auto")
    log(f"breakdown: prepare {prep_ms:.2f} ms, paste_back {paste_ms:.2f} ms "
        f"per click set; forward_prepared B=1 {fwd['auto', 1]:.2f} ms "
        f"(plain attention {fwd['xla', 1]:.2f} ms), B=4 {fwd['auto', 4]:.2f} ms "
        f"(plain attention {fwd['xla', 4]:.2f} ms)")
    x = torch.from_numpy(concat[None]).to("cuda").permute(0, 3, 1, 2).contiguous()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode(), torch.profiler.profile(activities=acts) as prof:
        pred.model(x)
        torch.cuda.synchronize()
    # device kernels and copies only: aten:: operator rows repeat the
    # device time of the kernels they launch
    events = [e for e in prof.key_averages()
              if e.self_device_time_total > 0 and not e.key.startswith("aten::")]
    total = sum(e.self_device_time_total for e in events)
    attn = sum(e.self_device_time_total for e in events
               if "pam_forward" in e.key or "cam_" in e.key)
    log(f"breakdown: profiler device time of one B=1 forward {total / 1e3:.3f} ms "
        f"over {len(events)} kernel names, of which the attention kernels "
        f"{attn / 1e3:.3f} ms")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"breakdown:   {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:<4d} {e.key[:90]}")


def phase_service(pred, image, clicks, InferenceService) -> None:
    import numpy as np

    requests = [clicks[i % len(clicks)] + 3.0 * (i // len(clicks))
                for i in range(8)]
    expected = [pred.predict(image, pts) for pts in requests]
    svc = InferenceService(pred, max_batch=4, max_wait_s=0.02)
    svc.warmup()
    with svc:
        with ThreadPoolExecutor(8) as pool:
            futures = list(pool.map(lambda p: svc.submit(image, p), requests))
        got = [f.result(timeout=300) for f in futures]
        stats = svc.metrics.snapshot()
    diff = max(float(np.abs(a - b).max()) for a, b in zip(got, expected))
    log(f"service: 8 concurrent submits resolved, max |diff| vs predict "
        f"{diff:.3e} (<= 1e-4); stats {json.dumps(stats)}")
    if not diff <= 1e-4:
        raise AssertionError(f"service vs predict: {diff:.3e} > 1e-4")


def phase_http(pred, image, clicks, InferenceService, make_server,
               ServeClient) -> None:
    import numpy as np

    svc = InferenceService(pred, max_batch=4).start()
    server = make_server(svc, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_port}"
        client = ServeClient(url, timeout_s=300)
        for pts in clicks[:3]:
            t0 = time.perf_counter()
            mask = client.predict(image, pts)
            ms = (time.perf_counter() - t0) * 1e3
            if mask.shape != image.shape[:2] or not np.isfinite(mask).all():
                raise AssertionError(f"bad HTTP mask {mask.shape}")
            log(f"http: POST /v1/predict -> mask {mask.shape}, {ms:.2f} ms")
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
            if r.status != 200 or not health["ok"]:
                raise AssertionError(f"/healthz: {r.status} {health}")
        log(f"http: GET /healthz -> 200 ok, state {health['state']}")
    finally:
        server.shutdown()
        server.server_close()
        svc.stop()
        thread.join(timeout=30)


#: parameters whose gradient is zero in exact arithmetic, each held to the
#: bound of another: the PAM key conv's bias shifts every score of a query
#: row by the same amount, which the softmax cancels, so what is left of
#: its gradient is rounding noise
GRAD_SCALE_OF = {"head.pam.key.bias": "head.pam.key.weight"}
#: the profiler's names for the device time of the convolutions
CONV_FORWARD = ("aten::cudnn_convolution",)
CONV_BACKWARD = ("aten::convolution_backward",)
BATCH_NORM = ("aten::cudnn_batch_norm", "aten::native_batch_norm",
              "aten::cudnn_batch_norm_backward",
              "aten::native_batch_norm_backward")
ATTENTION_KERNELS = ("pam_forward_kernel", "cam_gram_kernel",
                     "cam_softmax_kernel", "cam_apply_kernel")


class Cycled:
    """``dataset``'s samples repeated to ``n``."""

    def __init__(self, dataset, n: int):
        self.dataset, self.n = dataset, n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, index: int, rng=None) -> dict:
        return self.dataset.__getitem__(index % len(self.dataset), rng=rng)


def train_dataset():
    """The train split of the in-memory fake VOC fixture that ``--fake-data``
    trains on (seed 0, every object), through the default train stack at
    512²."""
    from distributedpytorch_tpu_torch.data import fake, pipeline, voc

    tree = fake.make_fake_voc(n_images=8, size=(96, 128), n_val=3, seed=0)
    return voc.VOCInstanceSegmentation(
        tree, split="train", area_thres=0,
        transform=pipeline.build_train_transform(crop_size=(512, 512)))


def phase_train_grads(torch, ca, Predictor, batch) -> None:
    """6a: one step's gradients through the kernels and the plain forms."""
    from distributedpytorch_tpu_torch.ops.losses import multi_output_loss
    from distributedpytorch_tpu_torch.parallel.step import device_batch

    check_function_grads(torch, ca)
    model = Predictor.fresh(512, "resnet101", seed=0, device="cuda").model.train()
    model.head.dropout_rate = 0.0
    data = device_batch(batch, torch.device("cuda"))
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    grads, rises, loss = {}, {}, {}
    # the convolutions' algorithms fixed, so that only attention differs
    torch.backends.cudnn.deterministic = True
    try:
        for path, impl, dtype in (("kernels", "flash", torch.float32),
                                  ("plain", "xla", torch.float32),
                                  ("float64", "xla", torch.float64)):
            model.to(dtype).load_state_dict(saved)
            model.zero_grad(set_to_none=True)
            model.set_attention_impl(impl)
            before = dict(ca.launches)
            out = multi_output_loss(model(data["concat"].to(dtype)),
                                    data["crop_gt"].to(dtype))
            out.backward()
            torch.cuda.synchronize()
            loss[path] = out.item()
            rises[path] = {k: ca.launches[k] - before[k] for k in before}
            grads[path] = {n: p.grad.detach().double()
                           for n, p in model.named_parameters()}
    finally:
        torch.backends.cudnn.deterministic = False
    log(f"train grads: DANet-R101 512^2 B={data['concat'].shape[0]}, loss with kernels "
        f"{loss['kernels']:.9f}, plain forms {loss['plain']:.9f}, plain forms in "
        f"float64 {loss['float64']:.9f}; forward launches with kernels "
        f"{rises['kernels']}, plain {rises['plain']}")
    if any(n != 1 for n in rises["kernels"].values()) or any(rises["plain"].values()):
        raise AssertionError(f"launches per forward+backward: kernels "
                             f"{rises['kernels']} (want 1 each), plain {rises['plain']}")
    kernels, plain, exact = grads["kernels"], grads["plain"], grads["float64"]
    rows, failures = [], []
    for name in plain:
        scale = plain[GRAD_SCALE_OF.get(name, name)].abs().max().item()
        diff = (kernels[name] - plain[name]).abs().max().item()
        f32_err = (plain[name] - exact[name]).abs().max().item()
        rows.append((diff / scale, diff / max(f32_err, 1e-300),
                     f32_err / exact[GRAD_SCALE_OF.get(name, name)].abs().max().item(),
                     name))
        if not diff <= max(1e-3 * scale, f32_err):
            failures.append(f"{name}: {diff:.3e} > 1e-3 x {scale:.3e} and > the "
                            f"float32 error {f32_err:.3e}")
    by_ratio = sorted(rows)
    by_f32 = sorted(rows, key=lambda r: r[1])
    over = [r for r in rows if r[0] > 1e-3]
    log(f"train grads: {len(rows)} parameter tensors; kernels vs plain max|diff| / "
        f"max|g|: largest {by_ratio[-1][0]:.3e} ({by_ratio[-1][3]}), median "
        f"{by_ratio[len(rows) // 2][0]:.3e}, {len(over)} above 1e-3; the float32 "
        f"plain path vs float64, max|diff| / max|g|: median "
        f"{statistics.median(r[2] for r in rows):.3e}, largest {max(r[2] for r in rows):.3e}; "
        f"kernels vs plain over the float32 error, largest {by_f32[-1][1]:.3e} "
        f"({by_f32[-1][3]})")
    pam = {n: kernels[f"head.pam.{n}"].abs().max().item()
           for n in ("query.weight", "key.weight", "value.weight", "query.bias",
                     "key.bias", "value.bias")}
    log("train grads: PAM max|g| with kernels " + ", ".join(
        f"{n} {v:.3e}" for n, v in pam.items()) + " (the key bias is held to the "
        "key weight's scale: its gradient is zero in exact arithmetic)")
    if failures:
        raise AssertionError("gradients, kernels vs plain forms: " + "; ".join(failures))
    if not all(pam[n] > 0 for n in ("query.weight", "key.weight", "value.weight")):
        raise AssertionError(f"a PAM projection gets no gradient through the kernels: {pam}")


def check_function_grads(torch, ca) -> None:
    """The kernels' autograd functions alone, at DANet-R101's attention shapes
    (B = 2, N = 4096, Ck = 64, C = Cv = 512): the gradients of q, k, v and x
    for a random upstream gradient against autograd through the plain forms
    (full softmax), each within 1e-3 x max |g|."""
    from distributedpytorch_tpu_torch.ops import attention as att

    gen = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    cases = (("position_attention", ca.flash_position_attention, att.position_attention,
              (randn(2, 4096, 64, scale=0.5), randn(2, 4096, 64, scale=0.5),
               randn(2, 4096, 512))),
             ("channel_attention", ca.flash_channel_attention, att.channel_attention,
              (randn(2, 4096, 512, scale=0.05),)))
    for name, kernel, plain, inputs in cases:
        upstream = randn(2, 4096, 512)
        got, want = ([x.detach().requires_grad_() for x in inputs] for _ in range(2))
        got = torch.autograd.grad(kernel(*got), got, upstream)
        want = torch.autograd.grad(plain(*want), want, upstream)
        ratios = [((g - w).abs().max() / w.abs().max()).item()
                  for g, w in zip(got, want)]
        log(f"train grads: {name} alone, gradient of each input through the kernel "
            f"vs the plain form, max|diff| / max|g| "
            + ", ".join(f"{r:.3e}" for r in ratios) + " (limit 1e-3)")
        if not all(r <= 1e-3 for r in ratios):
            raise AssertionError(f"{name}: input gradients {ratios} above 1e-3")


def _device_events(prof):
    """The profiler's device kernels and copies (no annotation ranges)."""
    from torch.autograd import DeviceType

    events = prof.events()
    cpu_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    return [e for e in events if e.device_type == DeviceType.CUDA
            and e.name not in cpu_names
            and not getattr(e, "is_user_annotation", False)]


def _op_device_ms(prof, names) -> float:
    """Device ms of the kernels launched inside the host ops ``names``."""
    from torch.autograd import DeviceType

    return sum(e.device_time_total for e in prof.events()
               if e.device_type == DeviceType.CPU and e.name in names) / 1e3


def _profile_split(torch, ca, prof, step_ms: float, what: str,
                   label: str) -> dict:
    """Log one profiled step's device time by part, its top kernels and
    the idle share against ``step_ms``; returns the parts."""
    kernels = _device_events(prof)
    busy = sum(e.device_time_total for e in kernels) / 1e3
    attention = sum(e.device_time_total for e in kernels
                    if any(k in e.name for k in ATTENTION_KERNELS)) / 1e3
    parts = {
        "convolutions, forward": _op_device_ms(prof, CONV_FORWARD),
        "convolutions, backward": _op_device_ms(prof, CONV_BACKWARD),
        "batch norm, forward and backward": _op_device_ms(prof, BATCH_NORM),
        "attention kernels, forward": attention,
        "plain-form recompute, backward": _op_device_ms(prof, (ca.RECOMPUTE_RANGE,)),
        "optimizer step": sum(e.device_time_total for e in prof.events()
                              if e.name.startswith("Optimizer.step")
                              and e.device_type != torch.autograd.DeviceType.CUDA) / 1e3,
        "host-to-device copies": sum(e.device_time_total for e in kernels
                                     if e.name.startswith("Memcpy HtoD")) / 1e3,
    }
    idle = 1.0 - busy / step_ms
    log(f"{label} profile: {what}, device busy {busy:.2f} ms over {len(kernels)} "
        f"kernels and copies; idle share {idle:.4f} of the {step_ms:.2f} ms median "
        f"step")
    for what, t in parts.items():
        log(f"{label} profile:   {t:9.2f} ms  {what}")
    log(f"{label} profile:   {busy - sum(parts.values()):9.2f} ms  everything else")
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.device_time_total / 1e3)
    for name, ts in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:10]:
        log(f"{label} profile:   top {sum(ts):9.2f} ms x{len(ts):<4d} {name[:90]}")
    return parts


def phase_train_step(torch, ca, dataset, batch_size: int = 16, rounds: int = 5) -> None:
    """6b: the default train step with the kernels and with the plain forms."""
    from distributedpytorch_tpu_torch.data import pipeline
    from distributedpytorch_tpu_torch.models import build_model
    from distributedpytorch_tpu_torch.parallel.step import (
        create_train_state,
        make_train_step,
    )
    from distributedpytorch_tpu_torch.train.config import OptimConfig
    from distributedpytorch_tpu_torch.train.optim import make_optimizer

    loader = pipeline.DataLoader(Cycled(dataset, 3 * batch_size), batch_size,
                                 shuffle=True, drop_last=True, seed=0)
    t0 = time.perf_counter()
    batches = list(loader)
    loader_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    t0 = time.perf_counter()
    for i in range(batch_size):
        dataset.__getitem__(i % len(dataset), rng=pipeline.sample_rng(0, 1, i))
    sample_ms = (time.perf_counter() - t0) * 1e3 / batch_size
    log(f"train data: default train stack at 512^2, {loader_ms:.1f} ms per batch of "
        f"{batch_size} through the DataLoader ({loader.num_workers} threads), "
        f"{sample_ms:.1f} ms per sample in one thread")

    cfg = OptimConfig()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model("danet")
    optimizer, schedule = make_optimizer(cfg, model, total_steps=100)
    state = create_train_state(model, optimizer, schedule, 0, torch.device("cuda"))
    step = make_train_step()
    batch = batches[0]
    paths = {"kernels": "auto", "plain": "xla"}
    peak_gb = {}
    for label, impl in paths.items():
        model.set_attention_impl(impl)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        first = step(state, batch).item()
        peak_gb[label] = torch.cuda.max_memory_allocated() / 2**30
        log(f"train step: first step with {label} {time.perf_counter() - t0:.3f} s, "
            f"loss {first:.6f}, peak memory {peak_gb[label]:.2f} GiB")
        step(state, batch)
    times = {label: [] for label in paths}
    losses = []
    before = dict(ca.launches)
    for _ in range(rounds):
        for label, impl in paths.items():
            model.set_attention_impl(impl)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            losses.append(step(state, batch))
            end.record()
            end.synchronize()
            times[label].append(start.elapsed_time(end))
    rise = {k: ca.launches[k] - before[k] for k in before}
    if any(n != rounds for n in rise.values()):
        raise AssertionError(f"{rounds} kernel-path steps launched {rise}: want one "
                             f"forward launch per kernel per step")
    if not torch.isfinite(torch.stack(losses)).all():
        raise AssertionError(f"non-finite train losses: {torch.stack(losses).tolist()}")
    ms = {label: statistics.median(t) for label, t in times.items()}
    for label in paths:
        log(f"train step: B={batch_size} 512^2 with {label} {ms[label]:.2f} ms median "
            f"of {rounds} (all {', '.join(f'{t:.2f}' for t in times[label])}), "
            f"{batch_size / ms[label] * 1e3:.2f} images/s, peak memory "
            f"{peak_gb[label]:.2f} GiB")

    model.set_attention_impl("auto")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    _profile_split(torch, ca, prof, ms["kernels"],
                   f"one B={batch_size} step with kernels", "train")


def _read_jsonl(path: Path) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def phase_train_fit(torch, ca, Predictor) -> dict:
    """6c: the entry point end to end, then its run served."""
    import shutil
    import tempfile

    import numpy as np

    from distributedpytorch_tpu_torch.models import build_model
    from distributedpytorch_tpu_torch.train.checkpoint import (
        CheckpointManager,
        param_digest,
    )
    from distributedpytorch_tpu_torch.train.config import from_json

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_fit_"))
    try:
        cmd = [sys.executable, "-m", "distributedpytorch_tpu_torch", "--fake-data",
               "data.train_batch=4", "data.area_thres=0", "epochs=2",
               f"work_dir={work}", "checkpoint.digest=true"]
        log(f"train fit: {' '.join(cmd[1:])}")
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=600)
        fit_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"the fit exited {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        (run,) = work.glob("run_*")
        with open(run / "fit_summary.json") as f:
            summary = json.load(f)
        records = _read_jsonl(run / "metrics.jsonl")
        epochs = [r for r in records if "train/step_losses" in r]
        step_losses = [x for r in epochs for x in r["train/step_losses"]]
        vals = [r for r in records if "val/jaccard" in r]
        final = summary["final_step"]
        if final < 4 or len(step_losses) != final or \
                not all(x is not None and math.isfinite(x) for x in step_losses):
            raise AssertionError(f"fit: {final} steps, losses {step_losses}")
        if len(vals) != 2 or not all(0.0 <= r["val/jaccard"] <= 1.0 for r in vals):
            raise AssertionError(f"fit validations: {vals}")
        with open(run / "checkpoints" / "COMMITTED.json") as f:
            ledger = json.load(f)
        if final not in ledger["latest"]:
            raise AssertionError(f"COMMITTED.json {ledger} does not name step {final}")
        launches = summary["kernel_launches"]
        want = final + sum(int(r["val/n_samples"]) for r in vals)
        if any(n != want for n in launches.values()):
            raise AssertionError(f"launches in the fit {launches}: want {want} each "
                                 f"({final} train steps + the validation samples)")
        log(f"train fit: {fit_s:.1f} s wall (process start, model build, data, "
            f"{final} steps, 2 validations, checkpoints); losses "
            f"{[round(x, 6) for x in step_losses]}; val jaccard "
            f"{[round(r['val/jaccard'], 6) for r in vals]} over "
            f"{[int(r['val/n_samples']) for r in vals]} samples; COMMITTED.json {ledger}; "
            f"kernel launches {launches}")
        for r in epochs:
            n = len(r["train/step_losses"])
            data_ms = r["train/data_wait_seconds"] / n * 1e3
            log(f"train fit: epoch {int(r['train/epoch'])}: {n} steps of B=4, "
                f"{r['train/epoch_seconds'] / n * 1e3:.1f} ms per step of the loop, "
                f"of which {data_ms:.1f} ms waiting on the host data; "
                f"{r['train/imgs_per_sec']:.2f} images/s")

        pred = Predictor.from_run(str(run), step=final, device="cuda")
        _, meta = CheckpointManager(str(run / "checkpoints")).load(final)
        if param_digest(pred.model.state_dict()) != meta["param_digest"]:
            raise AssertionError("the served weights are not the trained model's")
        cfg = from_json(str(run / "config.json"))
        model = build_model(cfg.model.name, backbone=cfg.model.backbone)
        payload, _ = CheckpointManager(str(run / "checkpoints")).load(final)
        model.load_state_dict(payload["model"], strict=True)
        model.to("cuda").eval()
        image, clicks = synthetic_image()
        concat, _ = pred.prepare(image, clicks[0])
        x = torch.from_numpy(concat[None]).to("cuda").permute(0, 3, 1, 2).contiguous()
        with torch.inference_mode():
            served = pred.model(x)
            direct = model(x)
        if not all(torch.equal(a, b) for a, b in zip(served, direct)):
            raise AssertionError("served logits differ from the checkpoint's model")
        mask = pred.predict(image, clicks[0])
        if mask.shape != image.shape[:2] or not np.isfinite(mask).all():
            raise AssertionError(f"bad mask from the trained run {mask.shape}")
        log(f"train fit: Predictor.from_run(step {final}) serves the weights the "
            f"trainer hashed at save (sha256 {meta['param_digest'][:16]}...), its "
            f"three logits bitwise equal to the checkpoint's model; a click gives a "
            f"finite {mask.shape} mask")
        return launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_train_grads_bf16(torch, ca, Predictor, batch) -> None:
    """6d: one bf16 step's gradients through the kernels, through the plain
    forms in bf16 and through the plain forms in float32."""
    from distributedpytorch_tpu_torch.ops.losses import multi_output_loss
    from distributedpytorch_tpu_torch.parallel.step import _forward, device_batch
    from distributedpytorch_tpu_torch.train.precision import precision_policy

    policy = precision_policy("bfloat16")
    model = Predictor.fresh(512, "resnet101", seed=0, device="cuda").model.train()
    model.head.dropout_rate = 0.0
    data = device_batch(batch, torch.device("cuda"))
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    grads, rises, loss, dtypes = {}, {}, {}, {}
    torch.backends.cudnn.deterministic = True
    try:
        for path, impl, pol in (("kernels", "flash", policy),
                                ("plain", "xla", policy),
                                ("float32", "xla", None)):
            model.load_state_dict(saved)
            model.set_compute_dtype(torch.bfloat16 if pol else None)
            model.zero_grad(set_to_none=True)
            model.set_attention_impl(impl)
            before = dict(ca.launches)
            out = multi_output_loss(_forward(model, data["concat"], pol),
                                    data["crop_gt"])
            out.backward()
            torch.cuda.synchronize()
            loss[path] = out.item()
            rises[path] = {k: ca.launches[k] - before[k] for k in before}
            dtypes[path] = {p.grad.dtype for p in model.parameters()}
            grads[path] = {n: p.grad.detach().double()
                           for n, p in model.named_parameters()}
    finally:
        torch.backends.cudnn.deterministic = False
    log(f"train grads bf16: DANet-R101 512^2 B={data['concat'].shape[0]}, loss with "
        f"kernels {loss['kernels']:.9f}, plain forms in bf16 {loss['plain']:.9f}, "
        f"plain forms in float32 {loss['float32']:.9f}; forward launches with "
        f"kernels {rises['kernels']}; gradient dtypes {sorted(map(str, dtypes['kernels']))}")
    if any(n != 1 for n in rises["kernels"].values()) or any(rises["plain"].values()):
        raise AssertionError(f"launches per bf16 forward+backward: kernels "
                             f"{rises['kernels']} (want 1 each), plain {rises['plain']}")
    if dtypes["kernels"] != {torch.float32}:
        raise AssertionError(f"bf16 step gradients in {dtypes['kernels']}, not float32")
    kernels, plain, f32 = grads["kernels"], grads["plain"], grads["float32"]
    rows, failures = [], []
    for name in plain:
        scale = f32[GRAD_SCALE_OF.get(name, name)].abs().max().item()
        diff = (kernels[name] - plain[name]).abs().max().item()
        own = (plain[name] - f32[name]).abs().max().item()
        rows.append((diff / scale, diff / max(own, 1e-300), own / scale, name))
        if not diff <= max(BF16_GRAD_TOL * scale, own):
            failures.append(f"{name}: {diff:.3e} > {BF16_GRAD_TOL} x {scale:.3e} and "
                            f"> the bf16 plain path's distance from float32 {own:.3e}")
    by_ratio = sorted(rows)
    log(f"train grads bf16: {len(rows)} parameter tensors; kernels vs plain bf16 "
        f"max|diff| / max|g|: largest {by_ratio[-1][0]:.3e} ({by_ratio[-1][3]}), "
        f"median {by_ratio[len(rows) // 2][0]:.3e}; the bf16 plain path vs float32, "
        f"max|diff| / max|g|: median {statistics.median(r[2] for r in rows):.3e}, "
        f"largest {max(r[2] for r in rows):.3e}; kernels-vs-plain over plain-vs-float32:"
        f" median {statistics.median(r[1] for r in rows):.3e}, largest "
        f"{max(r[1] for r in rows):.3e} ({max(rows, key=lambda r: r[1])[3]})")
    pam = {n: kernels[f"head.pam.{n}"].abs().max().item()
           for n in ("query.weight", "key.weight", "value.weight")}
    log("train grads bf16: PAM max|g| with kernels " +
        ", ".join(f"{n} {v:.3e}" for n, v in pam.items()))
    if failures:
        raise AssertionError("bf16 gradients, kernels vs plain forms: " +
                             "; ".join(failures))
    if not all(v > 0 for v in pam.values()):
        raise AssertionError(f"a PAM projection gets no bf16 gradient: {pam}")


def phase_train_step_bf16(torch, ca, dataset, batch_size: int = 16,
                          rounds: int = 5) -> None:
    """6e: the bf16 train step (B = 16) in turns with the float32 kernel step
    and the bf16 plain-form step; then one bf16 step with remat."""
    from distributedpytorch_tpu_torch.data import pipeline
    from distributedpytorch_tpu_torch.models import build_model
    from distributedpytorch_tpu_torch.parallel.step import (
        create_train_state,
        make_train_step,
    )
    from distributedpytorch_tpu_torch.train.config import OptimConfig
    from distributedpytorch_tpu_torch.train.optim import make_optimizer
    from distributedpytorch_tpu_torch.train.precision import precision_policy

    loader = pipeline.DataLoader(Cycled(dataset, batch_size), batch_size,
                                 shuffle=True, drop_last=True, seed=0)
    batch = next(iter(loader))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model("danet", dtype="bfloat16")
    optimizer, schedule = make_optimizer(OptimConfig(), model, total_steps=100)
    state = create_train_state(model, optimizer, schedule, 0, torch.device("cuda"))
    steps = {"bf16": make_train_step(precision=precision_policy("bfloat16")),
             "f32": make_train_step()}
    # (label, step, compute dtype, attention impl)
    paths = {"bf16 kernels": ("bf16", torch.bfloat16, "auto"),
             "f32 kernels": ("f32", None, "auto"),
             "bf16 plain": ("bf16", torch.bfloat16, "xla")}

    def use(label):
        kind, dtype, impl = paths[label]
        model.set_compute_dtype(dtype)
        model.set_attention_impl(impl)
        return steps[kind]

    peak_gb = {}
    for label in paths:
        step = use(label)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        first = step(state, batch).item()
        peak_gb[label] = torch.cuda.max_memory_allocated() / 2**30
        log(f"train step bf16: first step with {label} {time.perf_counter() - t0:.3f} s, "
            f"loss {first:.6f}, peak memory {peak_gb[label]:.2f} GiB")
        step(state, batch)
    times = {label: [] for label in paths}
    losses = []
    before = dict(ca.launches)
    for _ in range(rounds):
        for label in paths:
            step = use(label)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            losses.append(step(state, batch))
            end.record()
            end.synchronize()
            times[label].append(start.elapsed_time(end))
    rise = {k: ca.launches[k] - before[k] for k in before}
    if any(n != 2 * rounds for n in rise.values()):
        raise AssertionError(f"{2 * rounds} kernel-path steps launched {rise}: want "
                             f"one forward launch per kernel per step")
    if not torch.isfinite(torch.stack(losses)).all():
        raise AssertionError(f"non-finite train losses: {torch.stack(losses).tolist()}")
    if any(p.dtype != torch.float32 for p in model.parameters()) or any(
            m.dtype != torch.float32 for s in optimizer.state.values()
            for m in s.values() if torch.is_tensor(m)):
        raise AssertionError("bf16 training left float32 parameters or momentum")
    ms = {label: statistics.median(t) for label, t in times.items()}
    STEP_MS["6e bf16 kernels"] = ms["bf16 kernels"]
    for label in paths:
        log(f"train step bf16: B={batch_size} 512^2 with {label} {ms[label]:.2f} ms "
            f"median of {rounds} (all {', '.join(f'{t:.2f}' for t in times[label])}), "
            f"{batch_size / ms[label] * 1e3:.2f} images/s, peak memory "
            f"{peak_gb[label]:.2f} GiB")
    step = use("bf16 kernels")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    parts = _profile_split(torch, ca, prof, ms["bf16 kernels"],
                           f"one B={batch_size} bf16 step with kernels", "train bf16")
    # aten::_to_copy also carries the batch's copy to the device
    casts = _op_device_ms(prof, ("aten::_to_copy",)) - parts["host-to-device copies"]
    log(f"train bf16 profile:   dtype casts (aten::_to_copy but the batch's copy) "
        f"{casts:.2f} ms, within the parts above")

    model.backbone.remat = True
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(state, batch)
        remat_peak = torch.cuda.max_memory_allocated() / 2**30
        remat_ms = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step(state, batch)
            end.record()
            end.synchronize()
            remat_ms.append(start.elapsed_time(end))
    finally:
        model.backbone.remat = False
    log(f"train step bf16: B={batch_size} with model.remat=true "
        f"{statistics.median(remat_ms):.2f} ms median of 3 "
        f"({', '.join(f'{t:.2f}' for t in remat_ms)}), peak memory "
        f"{remat_peak:.2f} GiB (without remat {peak_gb['bf16 kernels']:.2f} GiB)")


#: the bf16 gradient check's own bound, as a share of the float32 max |g|
BF16_GRAD_TOL = 2e-2
#: resumed vs straight final weights on the card, where the backward is
#: not bitwise repeatable (cuDNN's default weight-gradient algorithms and
#: the bilinear upsample's backward add in no fixed order, and bf16
#: magnifies it): max |diff| per tensor within this share of the straight
#: run's own movement from its initial weights, or within this factor of
#: the card's run-to-run spread (the largest max |diff| between any two of
#: three straight runs, one of them run beside the resumed run, so that
#: the spread is measured under the resumed run's conditions too), plus
#: this many float32 ulps of the tensor's largest value (not for the PAM
#: key bias, whose gradient is zero in exact arithmetic); and the whole
#: model's L2 distance within this share of the straight run's L2
#: movement.  A batch skipped or trained twice moves the weights by about a
#: tenth of a 10-step run's movement, and a state not restored by more.
RESUME_MOVE_TOL, RESUME_SPREAD_FACTOR, RESUME_ULPS, RESUME_L2_TOL = 0.5, 4, 4, 1e-3


#: the bf16 CLI fit of 6f: train batch 2, so that the fixture's 11 train
#: objects make 5 steps per epoch and a stop after the first step line
#: lands inside an epoch (at train batch 4 an epoch is 2 steps, and any
#: such stop would land on an epoch's last step, whose batch the resume
#: replays)
FIT_ARGS = ["--fake-data", "train.precision=bfloat16", "data.train_batch=2",
            "data.area_thres=0", "epochs=2", "checkpoint.digest=true",
            "log_every_steps=1", "checkpoint.preempt_check_every=1"]


def _fit_cmd(work: Path, *extra: str) -> list[str]:
    return [sys.executable, "-m", "distributedpytorch_tpu_torch", *FIT_ARGS,
            f"work_dir={work}", *extra]


def _run_record(run: Path) -> dict:
    with open(run / "fit_summary.json") as f:
        summary = json.load(f)
    records = _read_jsonl(run / "metrics.jsonl")
    return {"summary": summary,
            "epochs": [r for r in records if "train/step_losses" in r],
            "vals": [r for r in records if "val/jaccard" in r]}


def resume_check(torch, init: dict, straights: list[dict], resumed: dict,
                 tag: str = "6f", scale_of: dict | None = None
                 ) -> tuple[list[str], list, dict]:
    """Hold a resumed run's final ``state_dict`` to straight runs' (the
    first is the reference; every pair of them measures the run-to-run
    spread) with the ``RESUME_*`` rule above; records the margins under
    ``tag``.  Returns (failures, per-tensor rows, L2 distances)."""
    scale_of = GRAD_SCALE_OF if scale_of is None else scale_of
    ref = straights[0]
    rows, failures = [], []
    sq = {"resumed": 0.0, "moved": 0.0}
    pairs = [(i, j) for i in range(len(straights)) for j in range(i + 1, len(straights))]
    pair_sq = [0.0] * len(pairs)
    for key, want_t in ref.items():
        got_t = resumed[key]
        if not want_t.is_floating_point():
            if not torch.equal(got_t, want_t):
                failures.append(f"{key}: {got_t} != {want_t}")
            continue
        w, g = want_t.double(), got_t.double()
        others = [s[key].double() for s in straights]
        spread = 0.0
        for n, (i, j) in enumerate(pairs):
            d = others[i] - others[j]
            spread = max(spread, d.abs().max().item())
            pair_sq[n] += float((d ** 2).sum())
        sq["resumed"] += float(((g - w) ** 2).sum())
        sq["moved"] += float(((w - init[key].double()) ** 2).sum())
        diff = (g - w).abs().max().item()
        moved = (w - init[key].double()).abs().max().item()
        ulps = RESUME_ULPS * torch.finfo(torch.float32).eps * w.abs().max().item()
        if key in scale_of:
            continue
        rows.append((diff / max(moved, 1e-300), diff, key))
        limit = max(RESUME_MOVE_TOL * moved, RESUME_SPREAD_FACTOR * spread) + ulps
        note_margin(f"{tag} resumed vs straight, per tensor", diff, limit)
        if not diff <= limit:
            failures.append(f"{key}: {diff:.3e} > {limit:.3e} ({RESUME_MOVE_TOL} x "
                            f"its movement {moved:.3e}, {RESUME_SPREAD_FACTOR} x the "
                            f"straight runs' spread {spread:.3e}, + {ulps:.3e})")
    l2 = {k: v ** 0.5 for k, v in sq.items()}
    l2["spread"] = max(pair_sq) ** 0.5
    note_margin(f"{tag} resumed vs straight, L2", l2["resumed"],
                RESUME_L2_TOL * l2["moved"])
    if not l2["resumed"] <= RESUME_L2_TOL * l2["moved"]:
        failures.append(f"L2 distance {l2['resumed']:.3e} > {RESUME_L2_TOL} x the "
                        f"straight run's movement {l2['moved']:.3e}")
    return failures, rows, l2


def phase_train_resume(torch, ca, Predictor,
                       device: str = "cuda") -> tuple[dict, dict]:
    """6f and 6g: the bf16 CLI fit preempted by SIGTERM and resumed with
    ``resume=auto`` against a straight run, the resumed run served, then a
    warm start from its weights.  Returns the kernels' launches of the
    two fits and of the bf16 serving forward."""
    import shutil
    import signal
    import tempfile

    import numpy as np

    from distributedpytorch_tpu_torch.models import build_model
    from distributedpytorch_tpu_torch.train.checkpoint import CheckpointManager
    from distributedpytorch_tpu_torch.train.config import apply_overrides, from_json
    from distributedpytorch_tpu_torch.train.trainer import Trainer

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_resume_"))
    procs = []
    straight_log = open(root / "straight.log", "w+")

    def straight_run(name: str) -> subprocess.Popen:
        proc = subprocess.Popen(_fit_cmd(root / name), cwd=REPO, text=True,
                                stdout=straight_log, stderr=subprocess.STDOUT)
        procs.append(proc)
        return proc

    try:
        work = root / "preempted"
        log(f"train resume: {' '.join(_fit_cmd(work)[1:])}")
        # three straight runs: the reference and the card's run-to-run
        # spread, two alongside the preempted run, one alongside the
        # resumed run
        straights = [straight_run("straight"), straight_run("again")]
        t0 = time.perf_counter()
        first = subprocess.Popen(_fit_cmd(work), cwd=REPO, text=True,
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        procs.append(first)
        out = []
        for line in first.stdout:
            out.append(line)
            if line.startswith("[step 1] train/loss="):
                first.send_signal(signal.SIGTERM)
                log(f"train resume: SIGTERM after its first step line, "
                    f"{time.perf_counter() - t0:.1f} s after start")
                break
        out.extend(first.stdout)
        if first.wait(timeout=600) != 0:
            raise AssertionError(f"the preempted fit exited {first.returncode}:\n"
                                 f"{''.join(out)[-3000:]}")
        (run_a,) = work.glob("run_*")
        a = _run_record(run_a)
        mgr_a = CheckpointManager(str(run_a / "checkpoints"))
        _, meta_a = mgr_a.load()
        if not a["summary"]["preempted"] or "interrupted_epoch" not in meta_a:
            raise AssertionError(f"preempted fit: summary {a['summary']}, meta {meta_a}")
        log(f"train resume: preempted at step {a['summary']['final_step']}, committed "
            f"{mgr_a.committed_steps()} with interrupted_epoch "
            f"{meta_a['interrupted_epoch']}, epoch_steps_done {meta_a['epoch_steps_done']}")
        straights.append(straight_run("third"))
        proc = subprocess.run(_fit_cmd(work, "resume=auto"), cwd=REPO,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"the resumed fit exited {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        if any(p.wait(timeout=600) != 0 for p in straights):
            straight_log.seek(0)
            raise AssertionError(f"a straight fit exited "
                                 f"{[p.returncode for p in straights]}:\n"
                                 f"{straight_log.read()[-3000:]}")
        fit_s = time.perf_counter() - t0
        (run_b,) = set(work.glob("run_*")) - {run_a}
        runs_s = [next((root / n).glob("run_*")) for n in ("straight", "again", "third")]
        run_s = runs_s[0]
        b, s = _run_record(run_b), _run_record(run_s)
        steps_per_epoch = len(s["epochs"][0]["train/step_losses"])
        done = meta_a["epoch_steps_done"]
        resumed_epoch = b["epochs"][0]
        trained = a["summary"]["final_step"] + \
            b["summary"]["final_step"] - b["summary"]["start_step"]
        if b["summary"]["final_step"] != s["summary"]["final_step"] or \
                trained != s["summary"]["final_step"] or \
                b["summary"]["start_step"] != a["summary"]["final_step"] or \
                resumed_epoch.get("train/resumed_at_batch") != done or \
                len(resumed_epoch["train/step_losses"]) != steps_per_epoch - done:
            raise AssertionError(f"resume: straight {s['summary']}, preempted "
                                 f"{a['summary']}, resumed {b['summary']}, first "
                                 f"resumed epoch {resumed_epoch}")
        launches = {k: a["summary"]["kernel_launches"][k] +
                    b["summary"]["kernel_launches"][k] for k in TPU_KERNELS}
        want = s["summary"]["final_step"] + sum(
            int(r["val/n_samples"]) for r in a["vals"] + b["vals"])
        if any(n != want for n in launches.values()):
            raise AssertionError(f"launches over both fits {launches}: want {want} "
                                 "each (train steps + validation samples)")
        log(f"train resume: resumed at epoch {b['summary']['start_epoch']} batch "
            f"{done} of {steps_per_epoch}, final step {b['summary']['final_step']} as "
            f"the straight run's; {trained} steps trained over both runs; launches "
            f"over both {launches}; {fit_s:.1f} s wall for the five fits")

        final = s["summary"]["final_step"]
        straight_ws = [CheckpointManager(str(r / "checkpoints")).load(final)[0]["model"]
                       for r in runs_s]
        resumed_w, meta_b = CheckpointManager(str(run_b / "checkpoints")).load(final)
        cfg = from_json(str(run_b / "config.json"))
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            init = build_model(cfg.model.name, backbone=cfg.model.backbone).state_dict()
        failures, rows, l2 = resume_check(torch, init, straight_ws,
                                          resumed_w["model"])
        equal = sum(1 for _, d, _ in rows if d == 0.0)
        log(f"train resume: final weights, resumed vs straight: {equal} of "
            f"{len(rows)} float tensors bitwise equal; largest max|diff| "
            f"{max(r[1] for r in rows):.3e}; largest max|diff| over the tensor's own "
            f"movement: " + ", ".join(f"{r:.3e} ({k})" for r, _, k in sorted(rows)[-5:])
            + f"; L2 distance {l2['resumed']:.3e} against the straight run's L2 "
            f"movement {l2['moved']:.3e}; the largest L2 distance between two "
            f"straight runs {l2['spread']:.3e}")
        log("train resume: margins (limit / value, smallest over the tensors): " +
            ", ".join(f"{k[len('6f resumed vs straight, '):]} {v:.3g}"
                      for k, v in MARGINS.items() if k.startswith("6f")))
        if failures:
            raise AssertionError("resumed vs straight weights: " + "; ".join(failures[:8]))

        ca.reset_launches()
        pred = Predictor.from_run(str(run_b), step=final, device=device)
        if pred.dtype != torch.bfloat16 or any(
                p.dtype != torch.float32 for p in pred.model.parameters()):
            raise AssertionError(f"Predictor.from_run of the bf16 run: dtype {pred.dtype}")
        model = build_model(cfg.model.name, backbone=cfg.model.backbone,
                            dtype="bfloat16")
        model.load_state_dict(resumed_w["model"], strict=True)
        model.to(device).eval()
        image, clicks = synthetic_image()
        concat, _ = pred.prepare(image, clicks[0])
        x = torch.from_numpy(concat[None]).to(device).permute(0, 3, 1, 2).contiguous()
        with torch.inference_mode():
            served = pred.model(x)
        mask = pred.predict(image, clicks[0])
        serve_launches = dict(ca.launches)
        with torch.inference_mode():
            direct = model(x)
        if not all(o.dtype == torch.bfloat16 for o in served) or \
                not all(torch.equal(p, q) for p, q in zip(served, direct)):
            raise AssertionError("served bf16 logits differ from the checkpoint's model")
        if mask.shape != image.shape[:2] or not np.isfinite(mask).all():
            raise AssertionError(f"bad mask from the resumed run {mask.shape}")
        log(f"train resume: Predictor.from_run(step {final}) serves in bf16 on float32 "
            f"weights, its three bf16 logits bitwise equal to the checkpoint's model; "
            f"kernel launches of its forwards {serve_launches}")
        del pred, model

        # 6g: warm start from the resumed run's weights
        pth = root / "resumed_weights.pth"
        torch.save(resumed_w["model"], pth)
        wcfg = apply_overrides(cfg, [f"checkpoint.warm_start={pth}", "resume=null",
                                     f"work_dir={root / 'warm'}"])
        trainer = Trainer(wcfg, device=device)
        got = trainer.model.state_dict()
        mismatched = [k for k, v in resumed_w["model"].items()
                      if not k.endswith("num_batches_tracked")
                      and not torch.equal(got[k].cpu(), v.cpu())]
        if mismatched or trainer.state.step != 0 or trainer.state.optimizer.state:
            raise AssertionError(f"warm start: mismatched {mismatched[:5]}, step "
                                 f"{trainer.state.step}, optimizer state "
                                 f"{len(trainer.state.optimizer.state)}")
        trainer.close()
        log(f"train warm start: checkpoint.warm_start={pth.name}: "
            f"{len(resumed_w['model'])} tensors bitwise equal (BatchNorm's "
            f"num_batches_tracked aside), step 0, empty optimizer state")
        del trainer
        return launches, serve_launches
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        straight_log.close()
        shutil.rmtree(root, ignore_errors=True)


def environment_line() -> str:
    """CPU affinity, /dev/shm size and free space, host RAM, and whether
    PIL imports and cv2 and grain are installed (found, not imported)."""
    import importlib.util
    import os
    import platform

    cpus = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") \
        else os.cpu_count()
    try:
        st = os.statvfs("/dev/shm")
        shm = (f"/dev/shm {st.f_blocks * st.f_frsize / 2**20:.0f} MiB, "
               f"{st.f_bavail * st.f_frsize / 2**20:.0f} MiB free")
    except OSError:
        shm = "/dev/shm absent"
    ram = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") / 2**30
    avail = "?"
    with contextlib.suppress(OSError, ValueError, IndexError):
        with open("/proc/meminfo") as f:
            avail = next(f"{int(line.split()[1]) / 2**20:.1f}" for line in f
                         if line.startswith("MemAvailable"))
    try:
        import PIL
        pil = f"PIL {PIL.__version__} imports"
    except ImportError:
        pil = "PIL does not import"
    found = ", ".join(f"{m} {'installed' if importlib.util.find_spec(m) else 'absent'}"
                      for m in ("cv2", "grain"))
    return (f"env: CPU affinity {cpus} (os.cpu_count {os.cpu_count()}), {shm}, "
            f"host RAM {ram:.1f} GiB ({avail} GiB available), {pil}, {found}; "
            f"python {platform.python_version()}")


@contextlib.contextmanager
def numpy_forms():
    """Within the block the host ops take their numpy forms
    (``DPTPU_NATIVE=0``), in this process and in workers started in it."""
    import os

    old = os.environ.get("DPTPU_NATIVE")
    os.environ["DPTPU_NATIVE"] = "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["DPTPU_NATIVE"]
        else:
            os.environ["DPTPU_NATIVE"] = old


def _best_ms(fn, reps: int) -> float:
    """Median host-clock ms of ``reps`` calls of ``fn`` after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def host_image(size: tuple[int, int], seed: int = 0):
    """A float32 RGB image in [0, 255] with smooth structure plus noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size[0], 0:size[1]].astype(np.float32)
    img = np.stack([127 + 100 * np.sin(xx / 17.0 + c) * np.cos(yy / 23.0 - c)
                    for c in range(3)], -1)
    return np.clip(img + rng.normal(0, 10, img.shape), 0, 255).astype(np.float32)


#: native vs numpy bounds of phase 6h (max |diff| on the [0, 255] scale for
#: images, [0, 1] for the heatmaps; 0 where the op picks pixels)
HOST_OP_TOL = {"resize": 1e-3, "resize_nearest": 0.0, "warp_cubic_uint8": 1.0,
               "warp_nearest": 0.0, "crop_resize": 1e-3, "gaussian_hm": 1e-5,
               "nellipse": 1e-5, "hflip": 0.0}


def phase_host_ops(src: tuple[int, int] = (375, 500),
                   crop: tuple[int, int] = (512, 512), reps: int = 5,
                   tree=None, samples: int = 8) -> dict:
    """6h: each host-library op against its numpy form at the main path's
    shapes (a VOC-sized image, its crop resized to ``crop``): ms of both
    and max |diff| within :data:`HOST_OP_TOL`; then ms per sample of the
    default train stack over ``tree`` (a fake VOC train split at ``src``)
    in one thread, on the library, on the numpy forms, and fused."""
    import numpy as np

    from distributedpytorch_tpu_torch import imaging, native_ops
    from distributedpytorch_tpu_torch.data import guidance
    from distributedpytorch_tpu_torch.utils import helpers

    t0 = time.perf_counter()
    native_ops.load()
    log(f"host ops: library {native_ops.LIBRARY} built or found in "
        f"{time.perf_counter() - t0:.2f} s")
    h, w = src
    img = host_image(src)
    img8 = img.astype(np.uint8)
    mask = np.zeros(src, np.float32)
    mask[h // 5:4 * h // 5, w // 4:3 * w // 4] = 1.0
    window = (-w // 12, h // 12, 3 * w // 5, 9 * h // 10)
    big = host_image((max(crop[0] + 188, h), max(crop[1] + 138, w)), seed=1)
    crop_img = helpers.crop_from_bbox(img, window, zero_pad=True)
    m = imaging.rotation_matrix((w / 2, h / 2), 13.7, 1.1)
    pts = np.array([[crop[1] * 0.1, crop[0] * 0.5], [crop[1] * 0.5, crop[0] * 0.12],
                    [crop[1] * 0.9, crop[0] * 0.45], [crop[1] * 0.55, crop[0] * 0.9]])
    grid = (np.arange(crop[1]), np.arange(crop[0]))
    cases = [  # (name, tolerance key, what, function)
        ("resize", "resize", f"cubic {window[3] - window[1] + 1}x"
         f"{window[2] - window[0] + 1}x3 -> {crop[0]}x{crop[1]}",
         lambda: imaging.resize(crop_img, crop, imaging.CUBIC)),
        ("resize", "resize", f"cubic {big.shape[0]}x{big.shape[1]}x3 -> "
         f"{crop[0]}x{crop[1]}", lambda: imaging.resize(big, crop, imaging.CUBIC)),
        ("resize", "resize_nearest", f"nearest {h}x{w} mask -> {crop[0]}x{crop[1]}",
         lambda: imaging.resize(mask, crop, imaging.NEAREST)),
        ("warp_affine", "warp_cubic_uint8", f"cubic {h}x{w}x3 uint8, 13.7 deg x 1.1",
         lambda: imaging.warp_affine(img8, m, src, imaging.CUBIC, 0)),
        ("warp_affine", "warp_nearest", f"nearest {h}x{w} mask, border 255",
         lambda: imaging.warp_affine(mask, m, src, imaging.NEAREST, 255)),
        ("crop_resize", "crop_resize", f"cubic window {window} of {h}x{w}x3 -> "
         f"{crop[0]}x{crop[1]}", lambda: imaging.crop_resize(img, window, crop,
                                                             imaging.CUBIC)),
        ("gaussian_hm", "gaussian_hm", f"make_gt, 4 points, {crop[0]}x{crop[1]}",
         lambda: helpers.make_gt(np.zeros(crop, np.float32), pts)),
        ("nellipse", "nellipse", f"compute_nellipse, 4 points, {crop[0]}x{crop[1]}",
         lambda: guidance.compute_nellipse(*grid, pts)),
        ("hflip", "hflip", f"{h}x{w}x3 float32", lambda: imaging.flip_h(img)),
    ]
    out = {}
    for op, tol_key, what, fn in cases:
        native_ops.reset_calls()
        got = fn()
        if native_ops.calls[op] < 1:
            raise AssertionError(f"{op} did not run on the host library: "
                                 f"{native_ops.calls}")
        with numpy_forms():
            want = fn()
            ms_np = _best_ms(fn, max(1, reps // 2))
        ms = _best_ms(fn, reps)
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{op} ({what}): {got.shape} {got.dtype} vs the "
                                 f"numpy form's {want.shape} {want.dtype}")
        diff = float(np.abs(got.astype(np.float64) - want).max())
        log(f"host op: {op} ({what}): {ms:.3f} ms on the library, {ms_np:.3f} ms "
            f"in the numpy form")
        check(f"6h {tol_key}, library vs numpy form, max |diff|", diff,
              HOST_OP_TOL[tol_key])
        out[f"{op} ({what})"] = {"ms": ms, "numpy_ms": ms_np, "max_abs_diff": diff}

    from distributedpytorch_tpu_torch.data import pipeline

    tree = tree if tree is not None else host_tree(4, src)
    per_sample = {}
    for label, fused, forms in (("on the library", False, contextlib.nullcontext),
                                ("on the numpy forms", False, numpy_forms),
                                ("fused crop + resize, on the library", True,
                                 contextlib.nullcontext)):
        ds = host_dataset(tree, crop, fused=fused)
        n = min(samples, len(ds))
        with forms():
            t0 = time.perf_counter()
            for i in range(n):
                ds.__getitem__(i, rng=pipeline.sample_rng(0, 0, i))
            per_sample[label] = (time.perf_counter() - t0) * 1e3 / n
    log(f"host data: ms per sample of the default train stack at {crop[0]}x{crop[1]} "
        f"from {src[0]}x{src[1]} in one thread: " + ", ".join(
            f"{v:.1f} {k}" for k, v in per_sample.items()))
    out["ms per sample"] = per_sample
    return out


def host_tree(n_images: int, size: tuple[int, int], seed: int = 0):
    """An in-memory fake VOC train split of ``n_images`` at ``size``."""
    from distributedpytorch_tpu_torch.data import fake

    return fake.make_fake_voc(n_images=n_images + 1, size=size, n_val=1, seed=seed)


def host_dataset(tree, crop: tuple[int, int], fused: bool = False,
                 decode_cache: int = 0):
    """The train split of ``tree`` through the default train stack."""
    from distributedpytorch_tpu_torch.data import pipeline, voc

    return voc.VOCInstanceSegmentation(
        tree, split="train", area_thres=0, decode_cache=decode_cache,
        transform=pipeline.build_train_transform(crop_size=crop,
                                                 fused_crop_resize=fused))


def write_tree(tree, root: Path) -> None:
    """``tree`` as a VOC2012 directory: JPEG images, PNG masks (PIL)."""
    from PIL import Image

    voc = root / "VOCdevkit" / "VOC2012"
    dirs = {k: voc / d for k, d in (("image", "JPEGImages"),
                                    ("instances", "SegmentationObject"),
                                    ("classes", "SegmentationClass"),
                                    ("sets", "ImageSets/Segmentation"))}
    for d in dirs.values():
        d.mkdir(parents=True, exist_ok=True)
    ids = tree.split_ids("train")
    (dirs["sets"] / "train.txt").write_text("\n".join(ids))
    for im_id in ids:
        Image.fromarray(tree.image(im_id)).save(dirs["image"] / f"{im_id}.jpg",
                                                quality=90)
        Image.fromarray(tree.instances(im_id)).save(dirs["instances"] / f"{im_id}.png")
        Image.fromarray(tree.classes(im_id)).save(dirs["classes"] / f"{im_id}.png")


class ShmPeak:
    """Samples the used bytes of ``/dev/shm`` every 20 ms in a thread; the
    peak above the level at the start is :attr:`peak` (None without
    ``/dev/shm``)."""

    def __init__(self):
        import os

        self._os = os
        self.peak = None
        self._stop = threading.Event()
        self._base = self._used()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _used(self):
        try:
            st = self._os.statvfs("/dev/shm")
        except OSError:
            return None
        return (st.f_blocks - st.f_bfree) * st.f_frsize

    def _run(self):
        while not self._stop.wait(0.02):
            used = self._used()
            if used is not None and self._base is not None:
                self.peak = max(self.peak or 0, used - self._base)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def no_children(where: str) -> None:
    import multiprocessing

    left = multiprocessing.active_children()
    if left:
        raise AssertionError(f"worker processes left after {where}: {left}")


def loader_ms(loader, n: int) -> tuple[float, float, list]:
    """(ms to the first batch, ms per batch after it, the batches) over the
    first ``n`` batches of ``loader``'s epoch 0."""
    loader.set_epoch(0)
    batches = []
    it = iter(loader)
    t0 = time.perf_counter()
    try:
        for batch in it:
            batches.append(batch)
            if len(batches) == 1:
                t1 = time.perf_counter()
            if len(batches) == n:
                break
    finally:
        it.close()
    t2 = time.perf_counter()
    return (t1 - t0) * 1e3, (t2 - t1) * 1e3 / max(1, len(batches) - 1), batches


def phase_loaders(tree=None, n_images: int = 64,
                  size: tuple[int, int] = (375, 500),
                  crop: tuple[int, int] = (512, 512), batch: int = 16,
                  n_samples: int = 256, workers: tuple[int, ...] = (2, 4, 8),
                  decode_cache: int = 64, numpy_batches: int = 3) -> dict:
    """6i: ms per batch of ``batch`` for the threaded loader on the numpy
    forms and on the host library, the worker loader at each of
    ``workers`` (capped by the CPU affinity), with the fused crop + resize,
    and over an on-disk JPEG/PNG tree with and without the decode cache
    (only where PIL imports); the worker loader's samples against the
    threaded loader's, bit for bit; no worker left after any of them."""
    import importlib.util
    import shutil
    import tempfile

    import numpy as np

    from distributedpytorch_tpu_torch.data import grain_pipeline, pipeline

    t0 = time.perf_counter()
    tree = tree if tree is not None else host_tree(n_images, size)
    dataset = Cycled(host_dataset(tree, crop), n_samples)
    log(f"host data: in-memory fake VOC, {n_images} train images at {size[0]}x"
        f"{size[1]}, {len(dataset.dataset)} objects cycled to {n_samples} samples, "
        f"made in {time.perf_counter() - t0:.1f} s")
    n_batches = n_samples // batch
    results, shm = {}, {}

    def run(label, loader, n=n_batches):
        first, per, got = loader_ms(loader, n)
        results[label] = per
        log(f"host data: {per:.1f} ms per batch of {batch}, {label} "
            f"({len(got)} batches; the first after {first:.1f} ms)")
        no_children(label)
        return got

    with numpy_forms():
        run("threads (2) + numpy forms",
            pipeline.DataLoader(dataset, batch, shuffle=True, drop_last=True,
                                seed=0, num_workers=2), numpy_batches)
    run("threads (2) + host library",
        pipeline.DataLoader(dataset, batch, shuffle=True, drop_last=True, seed=0,
                            num_workers=2), 2 * numpy_batches)
    cap = grain_pipeline.cpu_count()
    counts = sorted({min(n, cap) for n in workers})
    for n in counts:
        loader = grain_pipeline.GrainDataLoader(dataset, batch, shuffle=True,
                                                drop_last=True, seed=0,
                                                num_workers=n)
        with ShmPeak() as peak:
            got = run(f"data.loader=grain, {n} processes + host library", loader)
        shm[n] = peak.peak
    # the worker loader's samples against the threaded loader's sample
    # function, for the same (seed, epoch, index)
    plan = loader.batch_plan()
    checked = 0
    for (_, idxs), b in list(zip(plan, got))[:2]:
        for k, i in enumerate(idxs):
            want = dataset.__getitem__(int(i), rng=pipeline.sample_rng(0, 0, i))
            for key, val in want.items():
                if key != "meta" and not np.array_equal(b[key][k], val):
                    raise AssertionError(f"worker loader sample {i} differs from the "
                                         f"threaded loader's in {key}")
            checked += 1
    log(f"check 6i worker vs threaded samples: {checked} samples of {counts[-1]} "
        f"worker processes bitwise equal to the threaded loader's (exact)")
    fused = Cycled(host_dataset(tree, crop, fused=True), n_samples)
    run(f"data.loader=grain, {counts[-1]} processes, data.fused_crop_resize",
        grain_pipeline.GrainDataLoader(fused, batch, shuffle=True, drop_last=True,
                                       seed=0, num_workers=counts[-1]))
    if importlib.util.find_spec("PIL") is None:
        log("host data: PIL does not import here: the on-disk JPEG/PNG timing "
            "with and without data.decode_cache is skipped")
    else:
        root = Path(tempfile.mkdtemp(prefix="chip_smoke_voc_"))
        try:
            write_tree(tree, root)
            for cache in (0, decode_cache):
                disk = Cycled(host_dataset(str(root), crop, decode_cache=cache),
                              n_samples)
                run(f"data.loader=grain, {counts[-1]} processes, on-disk "
                    f"{size[0]}x{size[1]} JPEG/PNG tree, data.decode_cache={cache}",
                    grain_pipeline.GrainDataLoader(disk, batch, shuffle=True,
                                                   drop_last=True, seed=0,
                                                   num_workers=counts[-1]))
        finally:
            shutil.rmtree(root, ignore_errors=True)
    log("host data: peak /dev/shm use above its level at the start, by worker "
        "count: " + ", ".join(f"{n}: {'not measured' if v is None else f'{v / 2**20:.1f} MiB'}"
                              for n, v in shm.items()))
    log("host data: " + json.dumps({k: round(v, 2) for k, v in results.items()}))
    return results


#: the worker-fed bf16 CLI fit of 6j, SIGTERMed after its first step line
#: and resumed: the fake fixture's 11 train objects on 2 workers make
#: batches of 2 from slices of 6 and 5, 5 steps an epoch
WORKER_FIT_ARGS = ["--fake-data", "train.precision=bfloat16", "data.train_batch=2",
                   "data.loader=grain", "data.num_workers=2",
                   "data.fused_crop_resize=true", "epochs=2", "data.area_thres=0",
                   "log_every_steps=1", "checkpoint.preempt_check_every=1"]


def group_members(pgid: int) -> list[str]:
    """Live (not zombie) processes of process group ``pgid``, from /proc."""
    import os

    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        if int(fields[2]) == pgid and fields[0] != "Z":
            out.append(f"{pid} {stat[stat.index('('):stat.rindex(')') + 1]} {fields[0]}")
    return out


def run_in_group(cmd: list[str], timeout: float = 600, on_line=None) -> tuple[int, str]:
    """Run ``cmd`` in a new process group (its own session), stream its
    output to ``on_line(proc, line)``, and fail if any process of the group
    is still alive 10 s after it exits."""
    proc = subprocess.Popen(cmd, cwd=REPO, text=True, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, start_new_session=True)
    out = []
    try:
        for line in proc.stdout:
            out.append(line)
            if on_line is not None:
                on_line(proc, line)
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    deadline = time.perf_counter() + 10
    while (left := group_members(proc.pid)) and time.perf_counter() < deadline:
        time.sleep(0.2)
    if left:
        raise AssertionError(f"processes of {' '.join(cmd[1:4])} ... alive after it "
                             f"exited: {left}")
    return proc.returncode, "".join(out)


def phase_train_workers(torch, ca, dataset, batch_size: int = 16,
                        steps: int = 12, warm: int = 2) -> dict:
    """6j: the bf16 train step at B = 16 fed by the worker loader at the
    affinity-capped count; then the worker-fed bf16 CLI fit SIGTERMed and
    resumed.  Returns the kernels' launches of the two fits."""
    import shutil
    import signal
    import tempfile

    from distributedpytorch_tpu_torch.data import grain_pipeline
    from distributedpytorch_tpu_torch.models import build_model
    from distributedpytorch_tpu_torch.parallel.step import (
        create_train_state,
        make_train_step,
    )
    from distributedpytorch_tpu_torch.train.config import OptimConfig
    from distributedpytorch_tpu_torch.train.optim import make_optimizer
    from distributedpytorch_tpu_torch.train.precision import precision_policy

    workers = grain_pipeline.cpu_count()
    loader = grain_pipeline.GrainDataLoader(dataset, batch_size, shuffle=True,
                                            drop_last=True, seed=0,
                                            num_workers=workers)
    if len(loader) < steps:
        raise AssertionError(f"{len(loader)} batches for {steps} steps")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model("danet", dtype="bfloat16")
    optimizer, schedule = make_optimizer(OptimConfig(), model, total_steps=100)
    state = create_train_state(model, optimizer, schedule, 0, torch.device("cuda"))
    step = make_train_step(precision=precision_policy("bfloat16"))
    loader.set_epoch(0)
    waits, events, losses = [], [], []
    before = None
    it = iter(loader)
    try:
        for k in range(steps):
            if k == warm:
                torch.cuda.synchronize()
                before = dict(ca.launches)
                t_loop = time.perf_counter()
            t0 = time.perf_counter()
            batch = next(it)
            waits.append((time.perf_counter() - t0) * 1e3)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            losses.append(step(state, batch))
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t_loop) * 1e3
    finally:
        it.close()
    no_children("the worker-fed bf16 steps")
    timed = steps - warm
    rise = {k: ca.launches[k] - before[k] for k in before}
    if any(n != timed for n in rise.values()):
        raise AssertionError(f"{timed} worker-fed bf16 steps launched {rise}: want one "
                             f"forward launch per kernel per step")
    if not torch.isfinite(torch.stack(losses)).all():
        raise AssertionError(f"non-finite losses: {torch.stack(losses).tolist()}")
    dev = [s.elapsed_time(e) for s, e in events[warm:]]
    gaps = [events[i][1].elapsed_time(events[i + 1][0])
            for i in range(warm, steps - 1)]
    span = events[warm][0].elapsed_time(events[-1][1])
    log(f"train workers: bf16 B={batch_size} 512^2 fed by {workers} worker processes "
        f"(data.loader=grain), {timed} steps after {warm}: {wall / timed:.1f} ms per "
        f"step of the loop, {statistics.median(waits[warm:]):.1f} ms median data wait "
        f"(all {', '.join(f'{w:.1f}' for w in waits[warm:])}), "
        f"{statistics.median(dev):.1f} ms median device step (events around it); "
        f"{batch_size * timed / wall * 1e3:.2f} images/s; the stream idle between "
        f"steps {sum(gaps) / span:.4f} of the steps' span; launches {rise}")
    del model, optimizer, state
    gc.collect()
    torch.cuda.empty_cache()

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_workers_"))
    try:
        cmd = [sys.executable, "-m", "distributedpytorch_tpu_torch", *WORKER_FIT_ARGS,
               f"work_dir={root}"]
        log(f"train workers fit: {' '.join(cmd[1:])}")

        def stop_after_first_step(proc, line):
            if line.startswith("[step 1] train/loss=") and proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
                log("train workers fit: SIGTERM after its first step line")

        t0 = time.perf_counter()
        rc, out = run_in_group(cmd, on_line=stop_after_first_step)
        if rc != 0:
            raise AssertionError(f"the preempted worker-fed fit exited {rc}:\n{out[-3000:]}")
        (run_a,) = root.glob("run_*")
        a = _run_record(run_a)
        if not a["summary"]["preempted"]:
            raise AssertionError(f"the worker-fed fit was not preempted: {a['summary']}")
        rc, out = run_in_group(cmd + ["resume=auto"])
        if rc != 0:
            raise AssertionError(f"the resumed worker-fed fit exited {rc}:\n{out[-3000:]}")
        fit_s = time.perf_counter() - t0
        (run_b,) = set(root.glob("run_*")) - {run_a}
        b = _run_record(run_b)
        # a straight run's steps: the same loader over the same fixture
        from distributedpytorch_tpu_torch.data import fake, voc
        tree = fake.make_fake_voc(n_images=8, size=(96, 128), n_val=3, seed=0)
        per_epoch = len(grain_pipeline.GrainDataLoader(
            voc.VOCInstanceSegmentation(tree, split="train", area_thres=0), 2,
            drop_last=True, num_workers=2))
        straight = 2 * per_epoch
        done = int(b["epochs"][0].get("train/resumed_at_batch", 0))
        trained = a["summary"]["final_step"] + \
            b["summary"]["final_step"] - b["summary"]["start_step"]
        if b["summary"]["final_step"] != straight or trained != straight or \
                b["summary"]["start_step"] != a["summary"]["final_step"] or \
                len(b["epochs"][0]["train/step_losses"]) != per_epoch - done or \
                not all(x is not None and math.isfinite(x)
                        for r in a["epochs"] + b["epochs"]
                        for x in r["train/step_losses"]):
            raise AssertionError(f"worker-fed resume: preempted {a['summary']}, "
                                 f"resumed {b['summary']}, epochs {b['epochs']}")
        launches = {k: a["summary"]["kernel_launches"][k] +
                    b["summary"]["kernel_launches"][k] for k in TPU_KERNELS}
        want = straight + sum(int(r["val/n_samples"]) for r in a["vals"] + b["vals"])
        if any(n != want for n in launches.values()):
            raise AssertionError(f"launches over both worker-fed fits {launches}: "
                                 f"want {want} each")
        for r in b["epochs"]:
            n = len(r["train/step_losses"])
            log(f"train workers fit: resumed epoch {int(r['train/epoch'])}: {n} steps "
                f"of B=2 on 2 worker processes, "
                f"{r['train/data_wait_seconds'] / n * 1e3:.1f} ms waiting on data and "
                f"{r['train/epoch_seconds'] / n * 1e3:.1f} ms per step of the loop")
        log(f"train workers fit: preempted at step {a['summary']['final_step']}, "
            f"resumed at batch {done} of {per_epoch}, final step "
            f"{b['summary']['final_step']} = a straight run's {straight}; {trained} "
            f"steps over both runs; no process of either fit's group left; "
            f"launches {launches}; {fit_s:.1f} s wall for both")
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_train(torch, ca, Predictor) -> dict:
    """Phase 6 (a-g); returns the launch counts of each training and bf16
    serving path."""
    from distributedpytorch_tpu_torch.data import pipeline

    t0 = time.perf_counter()
    dataset = train_dataset()
    batch = pipeline.collate([dataset.__getitem__(i, rng=pipeline.sample_rng(0, 0, i))
                              for i in range(2)])
    phase_train_grads(torch, ca, Predictor, batch)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"train: (a) done at {time.perf_counter() - t0:.1f} s")
    phase_train_step(torch, ca, dataset)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"train: (b) done at {time.perf_counter() - t0:.1f} s")
    launches = phase_train_fit(torch, ca, Predictor)
    log(f"train: (c) done at {time.perf_counter() - t0:.1f} s")
    phase_train_grads_bf16(torch, ca, Predictor, batch)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"train: (d) done at {time.perf_counter() - t0:.1f} s")
    phase_train_step_bf16(torch, ca, dataset)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"train: (e) done at {time.perf_counter() - t0:.1f} s")
    bf16_fit, bf16_serve = phase_train_resume(torch, ca, Predictor)
    log(f"train: (f, g) done; phase wall time {time.perf_counter() - t0:.1f} s")
    return {"train": launches, "train_bf16": bf16_fit, "serve_bf16": bf16_serve}


def phase_host(torch, ca) -> dict:
    """Phase 6 (h-j): the host library, the loaders, and the bf16 step and
    CLI fit fed by worker processes; returns the launch counts of the
    worker-fed fits."""
    t0 = time.perf_counter()
    tree = host_tree(64, (375, 500))
    phase_host_ops(tree=tree)
    log(f"host: (h) done at {time.perf_counter() - t0:.1f} s")
    phase_loaders(tree)
    log(f"host: (i) done at {time.perf_counter() - t0:.1f} s")
    launches = phase_train_workers(
        torch, ca, Cycled(host_dataset(tree, (512, 512)), 256))
    log(f"host: (j) done; phase wall time {time.perf_counter() - t0:.1f} s")
    return {"train_workers": launches}


#: the dist phase's optimizer (lr large enough that two steps move the
#: weights past their float32 ulps, small enough that the second step's
#: gradients stay near the first's, as 6d's gradients are compared), its
#: global batch and the steps compared and then timed
DIST_LR, DIST_BATCH, DIST_STEPS, DIST_TIMED = 1e-4, 16, 2, 3
#: the 2-rank CLI fit of (c): ResNet-18 at 64^2 on the fake fixture, global
#: batch 4 (2 per rank: 3 steps per epoch over a rank's 6 of the 11
#: objects), float32 on gloo
DIST_FIT_ARGS = ["--dist-backend", "gloo", "--fake-data", "model.backbone=resnet18",
                 "data.crop_size=[64,64]", "data.relax=10", "data.area_thres=0",
                 "data.train_batch=4", "epochs=2", "optim.lr=1e-3",
                 "log_every_steps=1", "checkpoint.preempt_check_every=1"]


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _rank_env(rank: int, world: int, port: int) -> dict:
    """torchrun's environment for ``rank`` of a one-host group."""
    return {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
            "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "localhost",
            "MASTER_PORT": str(port)}


def dist_rank(spec: dict) -> None:
    """A rank of (a) or (b): joins the group its torchrun environment
    describes through the launcher's path (``initialize_distributed``),
    then, for each strategy, builds the trainer's data-parallel state
    (DANet-R101 in bf16 on float32 weights, cross-replica BatchNorm, DDP,
    ZeRO-1 under dp_zero1) from the saved weights and runs its rows of the
    global batches: the compared steps, then the timed ones.  Rank 0
    writes the results."""
    import os

    os.environ.update(spec["env"])
    sys.path.insert(0, str(REPO))
    import torch
    import torch.distributed as dist

    from distributedpytorch_tpu_torch.models import build_model
    from distributedpytorch_tpu_torch.ops import cuda_attention as ca
    from distributedpytorch_tpu_torch.parallel import mesh
    from distributedpytorch_tpu_torch.parallel.step import (
        create_train_state,
        make_train_step,
        wrap_data_parallel,
    )
    from distributedpytorch_tpu_torch.parallel.zero import shard_optimizer
    from distributedpytorch_tpu_torch.train.config import OptimConfig
    from distributedpytorch_tpu_torch.train.optim import make_optimizer
    from distributedpytorch_tpu_torch.train.precision import apply_policy

    device = mesh.initialize_distributed(backend=spec["backend"])
    rank, world = mesh.process_index(), mesh.data_axis_size()
    policy = apply_policy("bfloat16")
    init = torch.load(spec["init"])
    batches = torch.load(spec["batches"], weights_only=False)
    per = DIST_BATCH // world
    mine = [{k: v[rank * per:(rank + 1) * per] for k, v in b.items()} for b in batches]
    out = {"world": world, "backend": dist.get_backend(), "device": str(device)}
    for strategy in spec["strategies"]:
        model = build_model("danet", dtype="bfloat16", dropout_rate=0.0,
                            bn_cross_replica=True)
        model.load_state_dict(init)
        opt, sched = make_optimizer(OptimConfig(lr=DIST_LR), model, 100)
        state = create_train_state(model, opt, sched, 0, device)
        if strategy == "dp_zero1":
            state.optimizer = shard_optimizer(opt)
        buckets = 4 if strategy == "reduce_buckets=4" else 0
        wrap_data_parallel(state, buckets)
        step = make_train_step(precision=policy, global_balance=not buckets)
        losses, launches, times = [], [], []
        for i in range(DIST_STEPS + DIST_TIMED):
            ca.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step(state, mine[i % len(mine)]).item()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            launches.append(dict(ca.launches))
            losses.append(loss)
            if i == DIST_STEPS - 1 and rank == 0:
                torch.save({k: v.cpu() for k, v in model.state_dict().items()},
                           Path(spec["out"]) / f"{strategy}.pt")
        out[strategy] = {"losses": losses[:DIST_STEPS], "launches": launches,
                         "ms": times[DIST_STEPS:], "first_ms": times[0]}
        if strategy == spec["strategies"][0]:
            n = sum(p.numel() for p in model.parameters())
            flat = torch.zeros(n, device=device)
            ar = []
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dist.all_reduce(flat)
                torch.cuda.synchronize()
                ar.append((time.perf_counter() - t0) * 1e3)
            out["allreduce_ms"], out["grad_mib"] = ar[1:], n * 4 / 2**20
            del flat
        del state, model, opt, step
        torch.cuda.empty_cache()
    gathered = [None] * world
    dist.all_gather_object(gathered, out)
    if rank == 0:
        with open(Path(spec["out"]) / "results.json", "w") as f:
            json.dump(gathered, f)
    mesh.destroy_distributed()


def _run_ranks(specs: list[dict], timeout: float = 600) -> None:
    """Spawn one process per spec running :func:`dist_rank`; fail if any
    exits non-zero or outlives ``timeout``."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=dist_rank, args=(spec,)) for spec in specs]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + timeout
    try:
        for p in procs:
            p.join(max(1.0, deadline - time.perf_counter()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * len(procs):
        raise AssertionError(f"dist ranks exited {codes}")


def _dist_reference(torch, init: dict, batches: list, precision: str | None,
                    attention_impl: str = "auto"):
    """The single-process step (no group: the plain layers) from ``init``
    on the global batches: losses and the weights after DIST_STEPS."""
    from distributedpytorch_tpu_torch.models import build_model
    from distributedpytorch_tpu_torch.parallel.step import (
        create_train_state,
        make_train_step,
    )
    from distributedpytorch_tpu_torch.train.config import OptimConfig
    from distributedpytorch_tpu_torch.train.optim import make_optimizer
    from distributedpytorch_tpu_torch.train.precision import apply_policy

    policy = apply_policy(precision or "float32")
    model = build_model("danet", dtype=precision or "float32", dropout_rate=0.0,
                        attention_impl=attention_impl)
    model.load_state_dict(init)
    opt, sched = make_optimizer(OptimConfig(lr=DIST_LR), model, 100)
    state = create_train_state(model, opt, sched, 0, torch.device("cuda"))
    step = make_train_step(precision=policy)
    losses = [step(state, batches[i]).item() for i in range(DIST_STEPS)]
    weights = {k: v.cpu() for k, v in model.state_dict().items()}
    del state, model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return losses, weights


def dist_compare(torch, what: str, got: dict, init: dict, refs: dict) -> list[str]:
    """A data-parallel bf16 run's losses and weights after DIST_STEPS
    against the single-process steps ``refs`` (``bf16`` with the kernels,
    ``plain`` bf16 on the plain forms, ``f32``: (losses, weights) each),
    with the bounds of 6d: within BF16_GRAD_TOL of the bf16 step's own
    size (each step's loss; each tensor's update, its max |update|), or
    within a bf16 step's own distance from the float32 step, plus
    RESUME_ULPS float32 ulps of max(1, the weight) (the tests' max(1,
    |leaf|): flax's zero-initialised last BatchNorm scales leave the layers
    before them an update that is zero in exact arithmetic at step 1 and
    second-order at step 2).  The data-parallel run is a bf16 computation
    of its own (its BatchNorm sums in float32 where cuDNN's does not), so
    it is measured against whichever reference is nearest."""
    failures = []
    bf16, f32 = refs["bf16"], refs["f32"]
    for i, g in enumerate(got["losses"]):
        b, f = bf16[0][i], f32[0][i]
        limit = max(BF16_GRAD_TOL * abs(b),
                    *(abs(r[0][i] - f) for r in refs.values()))
        diff = min(abs(g - r[0][i]) for r in refs.values())
        note_margin(f"dist {what}, loss", diff, limit)
        if not diff <= limit:
            failures.append(f"step {i + 1} loss {g:.6f} vs {b:.6f} (limit {limit:.3e})")
    rows = []
    for key, w0 in init.items():
        b, g = bf16[1][key], got["weights"][key]
        if not w0.is_floating_point():
            if not torch.equal(g, b):
                failures.append(f"{key}: {g} != {b}")
            continue
        deltas = {name: r[1][key].double() - w0.double() for name, r in refs.items()}
        dg = g.double() - w0.double()
        scale_key = GRAD_SCALE_OF.get(key, key)
        scale = (bf16[1][scale_key].double() - init[scale_key].double()).abs().max().item()
        own = max((d - deltas["f32"]).abs().max().item() for d in deltas.values())
        diff = min((dg - d).abs().max().item() for d in deltas.values())
        ulps = RESUME_ULPS * torch.finfo(torch.float32).eps * max(
            1.0, b.abs().max().item())
        limit = max(BF16_GRAD_TOL * scale, own) + ulps
        note_margin(f"dist {what}, weights", diff, limit)
        rows.append((diff / limit, key))
        if not diff <= limit:
            failures.append(f"{key}: update differs by {diff:.3e} > {limit:.3e}")
    rows.sort()
    log(f"dist {what}: losses {['%.6f' % x for x in got['losses']]} against the "
        f"single-process bf16 {['%.6f' % x for x in bf16[0]]} (plain forms "
        f"{['%.6f' % x for x in refs['plain'][0]]}, float32 "
        f"{['%.6f' % x for x in f32[0]]}); weights after {DIST_STEPS} steps, "
        f"update difference over its limit: median {rows[len(rows) // 2][0]:.3g}, "
        f"largest " + ", ".join(f"{r:.3g} ({k})" for r, k in rows[-3:]))
    return failures


def phase_dist(torch, dataset) -> dict:
    """(a) world size 1 over NCCL, (b) two ranks over gloo on the one card,
    (c) a 2-rank CLI fit SIGTERMed on rank 1 and resumed.  Returns the
    kernels' launches of the data-parallel steps (rank 0, (a) and (b))."""
    import shutil
    import tempfile

    from distributedpytorch_tpu_torch.data import pipeline
    from distributedpytorch_tpu_torch.models import build_model

    t0 = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_dist_"))
    try:
        loader = pipeline.DataLoader(Cycled(dataset, DIST_STEPS * DIST_BATCH),
                                     DIST_BATCH, shuffle=True, drop_last=True, seed=1)
        batches = list(loader)
        torch.save(batches, root / "batches.pt")
        # the trainer's initial weights (seed 0, flax's initialisers): every
        # weight drawn from a seed as 6a/6d draw them makes a net so
        # ill-conditioned that its bf16 loss is 2% off float32's, and two
        # bf16 computations' updates differ by as much as either is off
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            init = build_model("danet", dropout_rate=0.0).state_dict()
        torch.save(init, root / "init.pt")
        refs = {"bf16": _dist_reference(torch, init, batches, "bfloat16"),
                "plain": _dist_reference(torch, init, batches, "bfloat16", "xla"),
                "f32": _dist_reference(torch, init, batches, None)}
        log(f"dist: single-process references (B={DIST_BATCH}, lr {DIST_LR}) at "
            f"{time.perf_counter() - t0:.1f} s")
        launches = {k: 0 for k in TPU_KERNELS}
        failures = []
        for label, world, backend, strategies in (
                ("a", 1, "nccl", ["dp_zero1"]),
                ("b", 2, "gloo", ["dp", "dp_zero1", "reduce_buckets=4"])):
            out = root / label
            out.mkdir()
            port = _free_port()
            specs = [{"env": _rank_env(r, world, port), "backend": backend,
                      "strategies": strategies, "init": str(root / "init.pt"),
                      "batches": str(root / "batches.pt"), "out": str(out)}
                     for r in range(world)]
            t1 = time.perf_counter()
            _run_ranks(specs)
            with open(out / "results.json") as f:
                ranks = json.load(f)
            for r, res in enumerate(ranks):
                if res["world"] != world or res["backend"] != backend:
                    raise AssertionError(f"({label}) rank {r}: {res['world']} ranks "
                                         f"over {res['backend']}")
            for strategy in strategies:
                what = f"({label}) W={world} {backend} {strategy}"
                per_rank = [res[strategy] for res in ranks]
                for r, res in enumerate(per_rank):
                    if any(n != {k: 1 for k in TPU_KERNELS} for n in res["launches"]):
                        raise AssertionError(f"{what}: rank {r} launches per step "
                                             f"{res['launches']} (want 1 per kernel)")
                for k in TPU_KERNELS:
                    launches[k] += sum(n[k] for n in per_rank[0]["launches"])
                got = {"losses": per_rank[0]["losses"],
                       "weights": torch.load(out / f"{strategy}.pt")}
                failures += dist_compare(torch, what, got, init, refs)
                ms = statistics.median(per_rank[0]["ms"])
                line = (f"dist {what}: {ms:.2f} ms per step of {DIST_BATCH} "
                        f"({DIST_BATCH // world} per rank; median of {DIST_TIMED}: "
                        f"{', '.join('%.2f' % t for t in per_rank[0]['ms'])}; first "
                        f"step {per_rank[0]['first_ms']:.1f} ms), "
                        f"{DIST_BATCH / ms * 1e3:.2f} images/s")
                if label == "a":
                    line += (f"; the single-process bf16 step of 6e "
                             f"{STEP_MS.get('6e bf16 kernels', float('nan')):.2f} ms")
                else:
                    ar = statistics.median(ranks[0]["allreduce_ms"])
                    line += (f"; an all_reduce of the {ranks[0]['grad_mib']:.1f} MiB "
                             f"of gradients alone {ar:.2f} ms ({ar / ms:.3f} of the step)")
                log(line)
            log(f"dist ({label}): {time.perf_counter() - t1:.1f} s")
        if failures:
            raise AssertionError("dist vs single-process: " + "; ".join(failures[:8]))
        phase_dist_fit(torch, root)
        log(f"dist: phase wall time {time.perf_counter() - t0:.1f} s")
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _start_fit(work: Path, port: int, *extra: str, stdout=None) -> list:
    """The two ranks of a CLI fit, each in a new process group of its own,
    torchrun's environment set; rank 0's output to ``stdout`` if given."""
    import os

    procs = []
    for r in range(2):
        cmd = [sys.executable, "-m", "distributedpytorch_tpu_torch", *DIST_FIT_ARGS,
               f"work_dir={work}", *extra]
        to = stdout if r == 0 and stdout is not None else subprocess.DEVNULL
        procs.append(subprocess.Popen(
            cmd, cwd=REPO, text=True, env={**os.environ, **_rank_env(r, 2, port)},
            stdout=to, stderr=subprocess.STDOUT if to is not subprocess.DEVNULL
            else subprocess.DEVNULL, start_new_session=True))
    return procs


def _finish_fit(procs: list, what: str, timeout: float = 600) -> None:
    """Wait for both ranks: exit 0 each, and no process of either rank's
    group alive 10 s later."""
    codes = [p.wait(timeout=timeout) for p in procs]
    if codes != [0, 0]:
        raise AssertionError(f"{what}: ranks exited {codes}")
    deadline = time.perf_counter() + 10
    while (left := [m for p in procs for m in group_members(p.pid)]) and \
            time.perf_counter() < deadline:
        time.sleep(0.2)
    if left:
        raise AssertionError(f"{what}: processes of its groups alive after it "
                             f"exited: {left}")


def phase_dist_fit(torch, root: Path) -> None:
    """(c): a 2-rank CLI fit (gloo, one card) whose rank 1 alone gets
    SIGTERM after rank 0's first step line: both ranks stop at one step and
    save once; ``resume=auto`` continues it to the straight 2-rank run's
    final step, its weights held to three straight runs with 6f's rule;
    no process of any fit's group is left."""
    import signal

    from distributedpytorch_tpu_torch.models import build_model
    from distributedpytorch_tpu_torch.train.checkpoint import CheckpointManager

    t0 = time.perf_counter()
    groups = []
    try:
        straights = [_start_fit(root / f"straight{i}", _free_port()) for i in (0, 1)]
        groups += straights
        work = root / "preempted"
        first = _start_fit(work, _free_port(), stdout=subprocess.PIPE)
        groups.append(first)
        out = []
        for line in first[0].stdout:
            out.append(line)
            if line.startswith("[step 1] train/loss="):
                first[1].send_signal(signal.SIGTERM)
                log(f"dist (c): SIGTERM to rank 1 alone after rank 0's first step "
                    f"line, {time.perf_counter() - t0:.1f} s after start")
                break
        out.extend(first[0].stdout)
        try:
            _finish_fit(first, "the preempted 2-rank fit")
        except AssertionError as e:
            raise AssertionError(f"{e}\n{''.join(out)[-3000:]}") from None
        (run_a,) = work.glob("run_*")
        a = _run_record(run_a)
        _, meta_a = CheckpointManager(str(run_a / "checkpoints")).load()
        stop = a["summary"]["final_step"]
        if not a["summary"]["preempted"] or \
                a["summary"]["final_step_by_rank"] != [stop, stop] or \
                meta_a.get("num_shards") != 2 or meta_a["step"] != stop:
            raise AssertionError(f"preempted 2-rank fit: summary {a['summary']}, "
                                 f"meta {meta_a}")
        log(f"dist (c): both ranks stopped at step {stop} "
            f"(final_step_by_rank {a['summary']['final_step_by_rank']}), one save "
            f"with num_shards {meta_a['num_shards']}, epoch_steps_done "
            f"{meta_a['epoch_steps_done']}")
        third = _start_fit(root / "straight2", _free_port())
        groups.append(third)
        resumed = _start_fit(work, _free_port(), "resume=auto")
        groups.append(resumed)
        for procs, what in ((resumed, "the resumed 2-rank fit"),
                            (straights[0], "straight 0"), (straights[1], "straight 1"),
                            (third, "straight 2")):
            _finish_fit(procs, what)
        (run_b,) = set(work.glob("run_*")) - {run_a}
        b = _run_record(run_b)
        runs_s = [next((root / f"straight{i}").glob("run_*")) for i in range(3)]
        s = _run_record(runs_s[0])
        final = s["summary"]["final_step"]
        trained = stop + b["summary"]["final_step"] - b["summary"]["start_step"]
        if b["summary"]["final_step"] != final or trained != final or \
                b["summary"]["final_step_by_rank"] != [final, final] or \
                b["epochs"][0].get("train/resumed_at_batch") != meta_a["epoch_steps_done"]:
            raise AssertionError(f"2-rank resume: straight {s['summary']}, resumed "
                                 f"{b['summary']}, first epoch {b['epochs'][0]}")
        straight_ws = [CheckpointManager(str(r / "checkpoints")).load(final)[0]["model"]
                       for r in runs_s]
        resumed_w = CheckpointManager(str(run_b / "checkpoints")).load(final)[0]["model"]
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            init = build_model("danet", backbone="resnet18").state_dict()
        failures, rows, l2 = resume_check(torch, init, straight_ws, resumed_w,
                                          tag="dist (c)")
        log(f"dist (c): resumed at batch {meta_a['epoch_steps_done']} to step "
            f"{final} as the straight runs; final weights {sum(d == 0 for _, d, _ in rows)}"
            f" of {len(rows)} float tensors bitwise equal, largest max|diff| "
            f"{max(r[1] for r in rows):.3e}, L2 distance {l2['resumed']:.3e} against an "
            f"L2 movement of {l2['moved']:.3e} (straight runs' largest L2 spread "
            f"{l2['spread']:.3e}); margins " + ", ".join(
                f"{k[len('dist (c) resumed vs straight, '):]} {v:.3g}"
                for k, v in MARGINS.items() if k.startswith("dist (c)"))
            + f"; no process of the 5 fits' groups left; {time.perf_counter() - t0:.1f} s")
        if failures:
            raise AssertionError("2-rank resumed vs straight: " + "; ".join(failures[:8]))
    finally:
        for procs in groups:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


#: the profiler's names for the semantic step's loss and resizes
SEM_LOSS = ("aten::logsumexp", "aten::gather",
            "autograd::engine::evaluate_function: LogsumexpBackward0",
            "autograd::engine::evaluate_function: GatherBackward0")
SEM_RESIZE = ("aten::upsample_bilinear2d", "aten::upsample_bilinear2d_backward")
#: the semantic path: BASELINE config 4's shape
SEM_SIZE, SEM_CLASSES = 513, 21


def randomize_segmenter(torch, model, seed: int = 0):
    """Every parameter and BatchNorm statistic of a DeepLab/FCN model drawn
    from ``seed`` (the last-BN scales included, which flax zero-inits), at
    scales that keep a 101-layer net finite; the classifiers' weights 100x
    wider, for logits of order 10."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, module in model.named_modules():
            if isinstance(module, torch.nn.Conv2d):
                fan_in = module.weight[0].numel()
                gain = 100.0 if name.endswith(("classifier", "Conv_1")) \
                    and module.weight.shape[2] == 1 else 2.0
                module.weight.normal_(0.0, (gain / fan_in) ** 0.5, generator=gen)
                if module.bias is not None:
                    module.bias.normal_(0.0, 0.1, generator=gen)
            elif isinstance(module, torch.nn.BatchNorm2d):
                module.weight.uniform_(0.2, 0.6, generator=gen)
                module.bias.normal_(0.0, 0.1, generator=gen)
                module.running_mean.normal_(0.0, 0.1, generator=gen)
                module.running_var.uniform_(0.5, 2.0, generator=gen)
    return model


def _semantic_image(seed: int, size: int = SEM_SIZE):
    import numpy as np

    return np.random.default_rng(seed).uniform(
        0, 255, (1, size, size, 3)).astype(np.float32)


def semantic_forward(torch) -> None:
    """9a: the three families' eval forward on the card against the CPU."""
    from distributedpytorch_tpu_torch.models import build_model

    x = torch.from_numpy(_semantic_image(1)).permute(0, 3, 1, 2).contiguous()
    for name in ("deeplabv3", "deeplabv3plus", "fcn"):
        model = randomize_segmenter(torch, build_model(
            name, nclass=SEM_CLASSES, backbone="resnet101", aux_head=True,
            in_channels=3)).eval()
        t0 = time.perf_counter()
        with torch.inference_mode():
            want = model(x)
        cpu_s = time.perf_counter() - t0
        model.to("cuda")
        with torch.inference_mode():
            got = model(x.to("cuda"))
        torch.cuda.synchronize()
        if [tuple(g.shape) for g in got] != [(1, SEM_CLASSES, SEM_SIZE, SEM_SIZE)] * 2:
            raise AssertionError(f"{name}: output shapes {[g.shape for g in got]}")
        for label, g, w in zip(("primary", "aux"), got, want):
            g = g.float().cpu()
            if not torch.isfinite(g).all():
                raise AssertionError(f"{name} {label}: non-finite logits")
            scale = max(1.0, w.abs().max().item())
            check(f"semantic (a) {name} {label}, card vs CPU float32, max|diff|",
                  (g - w).abs().max().item(), 1e-3 * scale)
        log(f"semantic (a): {name}-R101 {SEM_SIZE}^2 OS {model.output_stride}, "
            f"{SEM_CLASSES} classes, aux on, B=1, max|logit| "
            f"{want[0].abs().max().item():.3f}; CPU forward {cpu_s:.1f} s")
        del model, got
        torch.cuda.empty_cache()


def _semantic_grads(torch, model, saved, batch, dtype, device="cuda"):
    """One forward and backward of ``model`` (weights ``saved``) in
    ``dtype`` on ``device`` on ``batch``: (loss, the outputs, the batch on
    the device, every parameter's gradient in float64 on the card)."""
    from distributedpytorch_tpu_torch.parallel.step import _compute_loss, device_batch

    model.to(device=device, dtype=dtype).load_state_dict(saved)
    model.zero_grad(set_to_none=True)
    data = {k: v.to(dtype) for k, v in
            device_batch(batch, torch.device(device)).items()}
    outputs = model(data["concat"])
    loss = _compute_loss(outputs, data, (1.0, 0.4), loss_type="multi_softmax")
    loss.backward()
    grads = {n: p.grad.detach().to("cuda", torch.float64)
             for n, p in model.named_parameters()}
    return loss.item(), [o.detach() for o in outputs], data, grads


def semantic_step_checks(torch) -> None:
    """9b: a DeepLabV3-R101 step's loss and gradients on the card."""
    import numpy as np

    from distributedpytorch_tpu_torch.models import build_model
    from distributedpytorch_tpu_torch.ops.losses import softmax_xent_ignore

    rng = np.random.default_rng(2)
    labels = rng.integers(0, SEM_CLASSES, (2, SEM_SIZE, SEM_SIZE, 1)).astype(np.float32)
    labels[:, :24] = labels[:, -24:] = 255.0  # a void border
    labels[:, :, :24] = labels[:, :, -24:] = 255.0
    batch = {"concat": np.concatenate([_semantic_image(3), _semantic_image(4)]),
             "crop_gt": labels}
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)  # the trainer's initial weights
        model = build_model("deeplabv3", nclass=SEM_CLASSES, backbone="resnet101",
                            aux_head=True, in_channels=3, dropout_rate=0.0)
    model.train()
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    torch.backends.cudnn.deterministic = True
    try:
        loss32, outputs, data, g32 = _semantic_grads(torch, model, saved, batch,
                                                     torch.float32)
        labels_cpu = data["crop_gt"][:, 0].cpu()
        cpu_loss = sum(w * softmax_xent_ignore(o.cpu(), labels_cpu)
                       for w, o in zip((1.0, 0.4), outputs)).item()
        check("semantic (b) loss, card vs CPU on the card's logits, relative",
              abs(loss32 - cpu_loss) / abs(cpu_loss), 1e-5)
        del outputs, data
        loss64, _, _, g64 = _semantic_grads(torch, model, saved, batch, torch.float64)
        t0 = time.perf_counter()
        loss_cpu, _, _, gcpu = _semantic_grads(torch, model, saved, batch,
                                               torch.float32, device="cpu")
        cpu_s = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = False
    # float32 arithmetic itself is off float64 by more than 1e-3 of some
    # tensors' max|g| here (cancelling sums over 2 x 257^2 positions, and
    # the image-pool BatchNorm over two values, whose input gradient is
    # rounding over the batch's spread); the CPU's float32 step, another
    # implementation, measures that distance
    ratios, failures, by_cpu = [], [], []
    for name, want in g64.items():
        scale = want.abs().max().item()
        diff = (g32[name] - want).abs().max().item()
        cpu_off = (gcpu[name] - want).abs().max().item()
        limit = max(1e-3 * scale, 4.0 * cpu_off)
        note_margin("semantic (b) gradients, card float32 vs float64 per tensor",
                    diff, limit)
        ratios.append((diff / scale if scale else 0.0, name))
        if not diff <= limit:
            failures.append(f"{name}: {diff:.3e} > 1e-3 x {scale:.3e} and > 4 x "
                            f"the CPU float32 step's distance {cpu_off:.3e}")
        elif diff > 1e-3 * scale:
            by_cpu.append((diff / cpu_off, diff / scale, name))
    ratios.sort()
    by_cpu.sort()
    log(f"semantic (b): DeepLabV3-R101 {SEM_SIZE}^2 B=2, the trainer's initial "
        f"weights, dropout off, void border 24 px; loss card float32 {loss32:.9f}, "
        f"float64 {loss64:.9f}, CPU float32 {loss_cpu:.9f} ({cpu_s:.1f} s); "
        f"{len(ratios)} parameter tensors, card float32 vs float64 max|diff| / "
        f"max|g|: median {ratios[len(ratios) // 2][0]:.3e}, largest "
        f"{ratios[-1][0]:.3e} ({ratios[-1][1]}); {len(by_cpu)} above 1e-3 and "
        f"within 4x the CPU float32 step's distance from float64, the largest at "
        f"{max((r[0] for r in by_cpu), default=0.0):.3f}x it")
    for of_cpu, ratio, name in by_cpu[-4:]:
        log(f"semantic (b):   {name}: {ratio:.3e} of max|g|, {of_cpu:.3f}x the "
            f"CPU float32 distance")
    if failures:
        raise AssertionError("semantic (b) gradients, float32 vs float64: "
                             + "; ".join(failures[:8]))
    del g32, g64, gcpu

    void = dict(batch, crop_gt=np.full_like(labels, 255.0))
    loss, _, _, grads = _semantic_grads(torch, model, saved, void, torch.float32)
    gmax = max(g.abs().max().item() for g in grads.values())
    log(f"semantic (b): all-void batch, loss {loss!r}, largest |g| {gmax!r}")
    if loss != 0.0 or gmax != 0.0:
        raise AssertionError(f"all-void batch: loss {loss}, max |g| {gmax}")
    del model, grads
    torch.cuda.empty_cache()


def semantic_step_timed(torch, batch_size: int = 8, rounds: int = 5) -> None:
    """9c: BASELINE config 4's train step, bf16 and float32, timed in turns."""
    import numpy as np

    from distributedpytorch_tpu_torch.models import build_model
    from distributedpytorch_tpu_torch.parallel.step import (
        create_train_state,
        make_train_step,
    )
    from distributedpytorch_tpu_torch.train.config import OptimConfig
    from distributedpytorch_tpu_torch.train.optim import make_optimizer
    from distributedpytorch_tpu_torch.train.precision import precision_policy

    rng = np.random.default_rng(5)
    labels = rng.integers(0, SEM_CLASSES, (batch_size, SEM_SIZE, SEM_SIZE, 1))
    labels[rng.random(labels.shape) < 0.05] = 255
    batch = {"concat": rng.uniform(0, 255, (batch_size, SEM_SIZE, SEM_SIZE, 3)
                                   ).astype(np.float32),
             "crop_gt": labels.astype(np.float32)}
    paths = {}
    for label, precision in (("bf16", "bfloat16"), ("f32", None)):
        policy = precision_policy(precision) if precision else None
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = build_model("deeplabv3", nclass=SEM_CLASSES,
                                backbone="resnet101", aux_head=True,
                                in_channels=3, dtype=precision or "float32")
        optimizer, schedule = make_optimizer(OptimConfig(lr=1e-4), model, 100)
        state = create_train_state(model, optimizer, schedule, 0,
                                   torch.device("cuda"))
        paths[label] = (state, make_train_step(
            loss_weights=(1.0, 0.4), precision=policy, loss_type="multi_softmax"))
    peak_gb = {}
    for label, (state, step) in paths.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        first = step(state, batch).item()
        step(state, batch)
        torch.cuda.synchronize()
        peak_gb[label] = torch.cuda.max_memory_allocated() / 2**30
        log(f"semantic (c): first two {label} steps {time.perf_counter() - t0:.3f} s, "
            f"loss {first:.6f}, peak memory {peak_gb[label]:.2f} GiB")
    times = {label: [] for label in paths}
    losses = []
    for _ in range(rounds):
        for label, (state, step) in paths.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            losses.append(step(state, batch))
            end.record()
            end.synchronize()
            times[label].append(start.elapsed_time(end))
    if not torch.isfinite(torch.stack(losses)).all():
        raise AssertionError(f"non-finite semantic train losses: "
                             f"{torch.stack(losses).tolist()}")
    ms = {label: statistics.median(t) for label, t in times.items()}
    for label in paths:
        STEP_MS[f"semantic {label}"] = ms[label]
        log(f"semantic (c): config 4, DeepLabV3-R101 {SEM_SIZE}^2 OS 16 B={batch_size} "
            f"{SEM_CLASSES} classes aux on, {label}: {ms[label]:.2f} ms median of "
            f"{rounds} (all {', '.join(f'{t:.2f}' for t in times[label])}), "
            f"{batch_size / ms[label] * 1e3:.2f} images/s, peak memory "
            f"{peak_gb[label]:.2f} GiB")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for label, (state, step) in paths.items():
        with torch.profiler.profile(activities=acts) as prof:
            step(state, batch)
            torch.cuda.synchronize()
        kernels = _device_events(prof)
        busy = sum(e.device_time_total for e in kernels) / 1e3
        parts = {"convolutions, forward and backward":
                 _op_device_ms(prof, CONV_FORWARD + CONV_BACKWARD),
                 "batch norm, forward and backward": _op_device_ms(prof, BATCH_NORM),
                 "loss (logsumexp, gather), forward and backward":
                 _op_device_ms(prof, SEM_LOSS),
                 "bilinear resize, forward and backward": _op_device_ms(prof, SEM_RESIZE)}
        log(f"semantic (c) profile: {label} B={batch_size}, device busy {busy:.2f} ms "
            f"over {len(kernels)} kernels and copies; idle share "
            f"{1.0 - busy / ms[label]:.4f} of the {ms[label]:.2f} ms median step")
        for what, t in parts.items():
            log(f"semantic (c) profile:   {t:9.2f} ms  {what}")
        log(f"semantic (c) profile:   {busy - sum(parts.values()):9.2f} ms  the rest")
    del paths
    torch.cuda.empty_cache()


SEM_FIT_ARGS = ["--fake-data", "task=semantic", "model.name=deeplabv3",
                "model.nclass=21", "model.in_channels=3", "model.aux_head=true",
                "model.loss_weights=[1.0,0.4]", "data.crop_size=[513,513]",
                "train.precision=bfloat16", "data.train_batch=4", "data.val_batch=2",
                "eval_full_res=true", "eval_tta_scales=[0.75,1.0,1.25]",
                "eval_tta_flip=true", "epochs=2"]


def semantic_fit(torch) -> None:
    """9d: the semantic CLI fit, then its run served."""
    import shutil
    import tempfile

    import numpy as np

    from distributedpytorch_tpu_torch import imaging
    from distributedpytorch_tpu_torch.parallel.step import TrainState, make_eval_step
    from distributedpytorch_tpu_torch.predict import (
        SemanticPredictor,
        load_run_config,
        load_run_model,
    )
    from distributedpytorch_tpu_torch.train.precision import precision_policy

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_semantic_"))
    try:
        cmd = [sys.executable, "-m", "distributedpytorch_tpu_torch", *SEM_FIT_ARGS,
               f"work_dir={work}"]
        log(f"semantic (d): {' '.join(cmd[1:])}")
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"the semantic fit exited {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        fit_s = time.perf_counter() - t0
        (run,) = work.glob("run_*")
        with open(run / "fit_summary.json") as f:
            summary = json.load(f)
        records = _read_jsonl(run / "metrics.jsonl")
        step_losses = [x for r in records for x in r.get("train/step_losses", [])]
        vals = [r for r in records if "val/miou" in r]
        final = summary["final_step"]
        if final < 2 or len(step_losses) != final or \
                not all(x is not None and math.isfinite(x) for x in step_losses):
            raise AssertionError(f"semantic fit: {final} steps, losses {step_losses}")
        for r in vals:
            if not (0.0 <= r["val/miou"] <= 1.0 and 0.0 <= r["val/pixel_acc"] <= 1.0
                    and len(r["val/per_class_iou"]) == SEM_CLASSES
                    and r["val/jaccard"] == r["val/miou"]):
                raise AssertionError(f"semantic validation record {r}")
        if len(vals) != 2:
            raise AssertionError(f"semantic fit validations: {vals}")
        with open(run / "checkpoints" / "COMMITTED.json") as f:
            ledger = json.load(f)
        if final not in ledger["latest"]:
            raise AssertionError(f"COMMITTED.json {ledger} does not name step {final}")
        log(f"semantic (d): {fit_s:.1f} s wall, {final} steps, losses "
            f"{[round(x, 6) for x in step_losses]}; val mIoU "
            f"{[round(r['val/miou'], 6) for r in vals]}, pixel accuracy "
            f"{[round(r['val/pixel_acc'], 6) for r in vals]} over "
            f"{[int(r['val/n_samples']) for r in vals]} images (full-res, TTA 3 "
            f"scales x flip); COMMITTED.json {ledger}; kernel launches "
            f"{summary['kernel_launches']}")

        pred = SemanticPredictor.from_run(str(run), device="cuda")
        cfg = load_run_config(str(run))
        model, _ = load_run_model(str(run), cfg)
        state = TrainState(model.to("cuda"), None, None, None)
        eval_step = make_eval_step(loss_weights=cfg.model.loss_weights,
                                   precision=precision_policy(cfg.train.precision),
                                   loss_type="multi_softmax")
        image = np.random.default_rng(6).uniform(0, 255, (375, 500, 3))
        resized = imaging.resize(np.clip(image.astype(np.float32), 0, 255),
                                 (SEM_SIZE, SEM_SIZE), imaging.CUBIC)
        outputs, _ = eval_step(state, {
            "concat": resized[None],
            "crop_gt": np.zeros((1, SEM_SIZE, SEM_SIZE, 1), np.float32)})
        want = imaging.resize(outputs[0].argmax(dim=1)[0].cpu().numpy().astype(
            np.float32), image.shape[:2], imaging.NEAREST).astype(np.uint8)
        got = pred.predict(image, mode="resize")
        if got.dtype != np.uint8 or not np.array_equal(got, want):
            raise AssertionError(f"SemanticPredictor resize: {got.dtype}, "
                                 f"{int((got != want).sum())} pixels differ from "
                                 "the trainer's eval forward")
        t0 = time.perf_counter()
        slid = pred.predict(image, mode="slide")
        slide_s = time.perf_counter() - t0
        if slid.shape != image.shape[:2] or slid.max() >= SEM_CLASSES:
            raise AssertionError(f"slide: {slid.shape}, max class {slid.max()}")
        from PIL import Image

        Image.fromarray(image.astype(np.uint8)).save(work / "image.png")
        out = work / "classes.png"
        proc = subprocess.run(
            [sys.executable, "-m", "distributedpytorch_tpu_torch", "--predict",
             str(work / "image.png"), "--run-dir", str(run), "--out", str(out)],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0 or not out.exists():
            raise AssertionError(f"--predict exited {proc.returncode}:\n"
                                 f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
        with Image.open(out) as im:
            png = np.asarray(im)
        if png.shape != image.shape[:2]:
            raise AssertionError(f"--predict wrote a {png.shape} PNG")
        log(f"semantic (d): SemanticPredictor.from_run resize == the trainer's "
            f"bf16 eval forward's argmax, bit for bit ({got.size} pixels, classes "
            f"{sorted(set(np.unique(got).tolist()))}); slide {slide_s:.2f} s for "
            f"375x500; --predict wrote a {png.shape} PNG: "
            f"{proc.stdout.strip().splitlines()[-1][:160]}")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def semantic_fullres(torch) -> None:
    """9e: ``fullres_argmax`` on the card against the host protocol."""
    import numpy as np

    from distributedpytorch_tpu_torch import imaging
    from distributedpytorch_tpu_torch.ops.warp import fullres_argmax
    from distributedpytorch_tpu_torch.utils.helpers import fixed_resize

    gen = torch.Generator(device="cuda").manual_seed(7)
    logits = torch.randn(2, SEM_CLASSES, SEM_SIZE, SEM_SIZE, generator=gen,
                         device="cuda") * 4
    probs = torch.softmax(logits, dim=1)
    sizes = np.array([[375, 500], [500, 333]], np.int64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    maps = fullres_argmax(probs, torch.from_numpy(sizes), (500, 500)).cpu().numpy()
    dev_ms = (time.perf_counter() - t0) * 1e3
    host = probs.permute(0, 2, 3, 1).cpu().numpy()
    agree, total = 0, 0
    t0 = time.perf_counter()
    for j, (h, w) in enumerate(sizes):
        want = np.argmax(fixed_resize(host[j], (int(h), int(w)),
                                      flagval=imaging.LINEAR), axis=-1)
        agree += int((maps[j, :h, :w] == want).sum())
        total += int(h * w)
    host_ms = (time.perf_counter() - t0) * 1e3
    share = agree / total
    note_margin("semantic (e) full-res agreement, disagreeing share",
                1.0 - share, 1e-3)
    log(f"check semantic (e) fullres_argmax vs the host protocol: {share:.6f} of "
        f"{total} pixels agree >= 0.999 (the card {dev_ms:.1f} ms with readback, "
        f"the host {host_ms:.1f} ms)")
    if share < 0.999:
        raise AssertionError(f"full-res agreement {share:.6f} < 0.999")


def phase_semantic(torch, ca) -> None:
    """Phase 9: the semantic task and the DeepLab family (9a-9e); no
    attention kernel lies on this path, so their counters must not move."""
    ca.reset_launches()
    t0 = time.perf_counter()
    semantic_forward(torch)
    semantic_step_checks(torch)
    semantic_step_timed(torch)
    semantic_fit(torch)
    semantic_fullres(torch)
    if any(ca.launches.values()):
        raise AssertionError(f"attention kernels launched on the semantic path: "
                             f"{dict(ca.launches)}")
    log(f"semantic: no attention kernel launched; phase {time.perf_counter() - t0:.1f} s")


#: the phases of a whole run, in order
PHASES = ("kernels", "serve", "train", "host", "dist", "semantic")


def main(argv: list[str] | None = None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma list of " + ", ".join(PHASES) + " (default: all)")
    phases = set(parser.parse_args(argv).phases.split(","))
    if not phases <= set(PHASES):
        parser.error(f"unknown phases {sorted(phases)}")
    log(environment_line())
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from distributedpytorch_tpu_torch.ops import _build
    from distributedpytorch_tpu_torch.ops import attention as att
    from distributedpytorch_tpu_torch.ops import cuda_attention as ca
    from distributedpytorch_tpu_torch.predict import Predictor
    from distributedpytorch_tpu_torch.serve.__main__ import make_server
    from distributedpytorch_tpu_torch.serve.client import ServeClient
    from distributedpytorch_tpu_torch.serve.service import InferenceService

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32: torch.backends.cuda.matmul.allow_tf32=False, "
        "torch.backends.cudnn.allow_tf32=False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    name = torch.cuda.get_device_name(0)
    variant, peaks = card_peaks(name)
    log(f"device: {name}, peaks of {variant}: {peaks[0] / 1e12:g} TFLOP/s "
        f"f32, {peaks[1] / 1e12:g} TFLOP/s bf16, {peaks[2] / 1e12:g} TFLOP/s "
        f"TF32, {peaks[3] / 1e12:g} TB/s; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    t0 = time.perf_counter()
    ca.build()
    log(f"build: attention.cu in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds})")

    if "kernels" in phases:
        records = phase_kernels(torch, ca, att, peaks)

    paths = {}
    if "serve" in phases:
        ca.reset_launches()
        pred, image, clicks = phase_predictor(torch, Predictor, ca)
        phase_service(pred, image, clicks, InferenceService)
        phase_http(pred, image, clicks, InferenceService, make_server, ServeClient)
        paths["serve"] = dict(ca.launches)
        del pred
    if "train" in phases:
        paths.update(phase_train(torch, ca, Predictor))
    if "host" in phases:
        paths.update(phase_host(torch, ca))
    if "dist" in phases:
        paths["dist"] = phase_dist(torch, train_dataset())
    if "semantic" in phases:
        phase_semantic(torch, ca)
    for path, launches in paths.items():
        if not all(launches[k] > 0 for k in TPU_KERNELS):
            raise AssertionError(f"a kernel never ran on the {path} path: {launches}")
    if phases != set(PHASES):
        log(f"partial run of phases {sorted(phases)}: no result")
        return 0

    log("margins: " + json.dumps({k: (None if math.isinf(v) else round(v, 4))
                                  for k, v in MARGINS.items()}))
    log(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE, "replaces": TPU_KERNELS[k],
         "launches": sum(p[k] for p in paths.values()),
         "launches_by_path": {path: p[k] for path, p in paths.items()}, **r}
        for k, r in records.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
