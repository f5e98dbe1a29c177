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
             tolerance of a straight run's, launches one per train step
             and validation sample over both runs, and
             ``Predictor.from_run`` serving it in bf16 on float32 weights,
             bitwise the checkpoint's model; (g) a ``Trainer`` warm-started
             from its weights holds them bit for bit, at step 0 with an
             empty optimizer.

The launch counters are zeroed just before phase 3 and read after phase 5
(the serving path), zeroed by the trainer when its fit starts and read
from its ``fit_summary.json`` (the training paths, f32 and bf16, the latter
summed over the preempted and resumed runs), and zeroed just before the
bf16 run is served (the bf16 serving path): every kernel must have run on
each.  The second-to-last line is the ``kernels`` JSON record; the
last line is the device record.  ``--phases train`` (or any comma list of
``kernels,serve,train``) runs part of the script for development and then
prints neither record.
"""

from __future__ import annotations

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


def card_peaks(name: str) -> tuple[str, tuple[float, float, float, float]]:
    for key in ("PCIe", "NVL"):
        if key in name:
            return f"H100 {key}", PEAKS[f"H100 {key}"]
    return "H100 SXM", PEAKS["H100 SXM"]


#: calls per CUDA-event pair of the back-to-back timing
RUN = 20


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

    prep_ms = _host_ms(lambda: pred.prepare(image, clicks[0]))
    concat, bbox = pred.prepare(image, clicks[0])
    prob = pred.forward_prepared(concat)[0]
    paste_ms = _host_ms(lambda: pred.paste_back(prob, bbox, image.shape[:2]))
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
#: run's own movement from its initial weights, or within this factor of a
#: second straight run's max |diff| from the first (the card's own spread),
#: plus this many float32 ulps of the tensor's largest value (not for the
#: PAM key bias, whose gradient is zero in exact arithmetic); and the whole
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
    try:
        straight_dir, work = root / "straight", root / "preempted"
        log(f"train resume: {' '.join(_fit_cmd(work)[1:])}")
        # two straight runs alongside the preempted one: the reference and
        # the card's own run-to-run spread
        straight = subprocess.Popen(_fit_cmd(straight_dir), cwd=REPO, text=True,
                                    stdout=straight_log, stderr=subprocess.STDOUT)
        again = subprocess.Popen(_fit_cmd(root / "again"), cwd=REPO, text=True,
                                 stdout=straight_log, stderr=subprocess.STDOUT)
        procs += [straight, again]
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
        proc = subprocess.run(_fit_cmd(work, "resume=auto"), cwd=REPO,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"the resumed fit exited {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        if straight.wait(timeout=600) != 0 or again.wait(timeout=600) != 0:
            straight_log.seek(0)
            raise AssertionError(f"the straight fit exited {straight.returncode}:\n"
                                 f"{straight_log.read()[-3000:]}")
        fit_s = time.perf_counter() - t0
        (run_b,) = set(work.glob("run_*")) - {run_a}
        (run_s,) = straight_dir.glob("run_*")
        (run_s2,) = (root / "again").glob("run_*")
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
            f"over both {launches}; {fit_s:.1f} s wall for the three fits")

        final = s["summary"]["final_step"]
        straight_w, _ = CheckpointManager(str(run_s / "checkpoints")).load(final)
        again_w, _ = CheckpointManager(str(run_s2 / "checkpoints")).load(final)
        resumed_w, meta_b = CheckpointManager(str(run_b / "checkpoints")).load(final)
        cfg = from_json(str(run_b / "config.json"))
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            init = build_model(cfg.model.name, backbone=cfg.model.backbone).state_dict()
        rows, failures = [], []
        sq = {"resumed": 0.0, "again": 0.0, "moved": 0.0}
        for key, want_t in straight_w["model"].items():
            got_t = resumed_w["model"][key]
            if not want_t.is_floating_point():
                if not torch.equal(got_t, want_t):
                    failures.append(f"{key}: {got_t} != {want_t}")
                continue
            w, g = want_t.double(), got_t.double()
            spread = again_w["model"][key].double() - w
            sq["resumed"] += float(((g - w) ** 2).sum())
            sq["again"] += float((spread ** 2).sum())
            sq["moved"] += float(((w - init[key].double()) ** 2).sum())
            diff = (g - w).abs().max().item()
            moved = (w - init[key].double()).abs().max().item()
            ulps = RESUME_ULPS * torch.finfo(torch.float32).eps * w.abs().max().item()
            if key in GRAD_SCALE_OF:
                continue
            rows.append((diff / max(moved, 1e-300), diff, key))
            limit = max(RESUME_MOVE_TOL * moved,
                        RESUME_SPREAD_FACTOR * spread.abs().max().item()) + ulps
            if not diff <= limit:
                failures.append(f"{key}: {diff:.3e} > {limit:.3e} ({RESUME_MOVE_TOL} x "
                                f"its movement {moved:.3e}, {RESUME_SPREAD_FACTOR} x the "
                                f"straight runs' spread, + {ulps:.3e})")
        l2 = {k: v ** 0.5 for k, v in sq.items()}
        equal = sum(1 for _, d, _ in rows if d == 0.0)
        log(f"train resume: final weights, resumed vs straight: {equal} of "
            f"{len(rows)} float tensors bitwise equal; largest max|diff| "
            f"{max(r[1] for r in rows):.3e}; largest max|diff| over the tensor's own "
            f"movement: " + ", ".join(f"{r:.3e} ({k})" for r, _, k in sorted(rows)[-5:])
            + f"; L2 distance {l2['resumed']:.3e} against the straight run's L2 "
            f"movement {l2['moved']:.3e}; a second straight run's L2 distance from "
            f"the first {l2['again']:.3e}")
        if not l2["resumed"] <= RESUME_L2_TOL * l2["moved"]:
            failures.append(f"L2 distance {l2['resumed']:.3e} > {RESUME_L2_TOL} x the "
                            f"straight run's movement {l2['moved']:.3e}")
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


def phase_train(torch, ca, Predictor) -> dict:
    """Phase 6 (a-g); returns the launch counts of each training and bf16
    serving path."""
    import gc

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


def main(argv: list[str] | None = None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default="kernels,serve,train",
                        help="comma list of kernels, serve, train (default: all)")
    phases = set(parser.parse_args(argv).phases.split(","))
    if not phases <= {"kernels", "serve", "train"}:
        parser.error(f"unknown phases {sorted(phases)}")
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
    for path, launches in paths.items():
        if not all(launches[k] > 0 for k in TPU_KERNELS):
            raise AssertionError(f"a kernel never ran on the {path} path: {launches}")
    if phases != {"kernels", "serve", "train"}:
        log(f"partial run of phases {sorted(phases)}: no result")
        return 0

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
