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
             1e-4 x max |plain|: summation order only) and in bfloat16
             inputs (<= 2e-2 x max |plain|, output dtype kept); then time
             kernel, plain form and a library yardstick with CUDA events.
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

The launch counters are zeroed just before phase 3 and read after phase 5:
every kernel must have run on that main path.  The second-to-last line is
the ``kernels`` JSON record; the last line is the device record.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

#: dense peak rates (float32 FLOP/s on CUDA cores, bf16 FLOP/s on tensor
#: cores, memory bytes/s) from NVIDIA's data sheets, by card variant
PEAKS = {
    "H100 SXM": (67e12, 989e12, 3.35e12),
    "H100 PCIe": (51e12, 756e12, 2.0e12),
    "H100 NVL": (60e12, 835e12, 3.9e12),
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


def card_peaks(name: str) -> tuple[str, tuple[float, float, float]]:
    for key in ("PCIe", "NVL"):
        if key in name:
            return f"H100 {key}", PEAKS[f"H100 {key}"]
    return "H100 SXM", PEAKS["H100 SXM"]


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn()`` over ``reps`` event-timed launches."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_kernels(torch, ca, att, peaks) -> dict:
    """Phase 2: correctness on the card, then timings at B = 1 and B = 8."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    # Scales keep the softmaxes soft enough that float32 summation-order
    # noise in the scores is not amplified past the stated bound.
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
    # (B, N, Ck, C): serving shapes at B = 1 and 8, ragged N, narrow head
    shapes = [(1, 4096, 64, 512), (8, 4096, 64, 512), (2, 4225, 64, 512),
              (2, 65, 16, 128)]
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
                bound = tol * ref.float().abs().max().item()
                if not err <= bound:
                    raise AssertionError(
                        f"{name} B={b} N={n} C={c} {dtype}: max |diff| {err:.3e}"
                        f" > {bound:.3e}")
                if dtype == torch.float32 and n == 4096 and c == 512:
                    errors[name] = max(errors[name], err)
                log(f"check {name} B={b} N={n} C={c} {str(dtype)[6:]}: "
                    f"max|diff| {err:.3e} <= {bound:.3e}")

    f32, bf16, bw = peaks
    n, ck, c = 4096, 64, 512
    records = {}
    for b in (1, 8):
        q, k, v = pam_inputs(b, n, ck, c, torch.float32)
        x, = cam_inputs(b, n, c, torch.float32)
        attn = att.channel_energy(x)
        work = {
            # (kernel, plain, library, flops, bytes, peak flop/s)
            "position_attention": (
                lambda: ca.flash_position_attention(q, k, v),
                lambda: att.position_attention(q, k, v),
                lambda: F.scaled_dot_product_attention(
                    q[:, None], k[:, None], v[:, None], scale=1.0),
                2.0 * b * n * n * (ck + c), 4.0 * b * n * (2 * ck + 2 * c), f32),
            "cam_energy": (
                lambda: ca.cam_energy(x),
                lambda: att.channel_energy(x),
                lambda: torch.softmax(_rowmax_minus(torch.bmm(x.transpose(1, 2), x)), -1),
                2.0 * b * n * c * c, 4.0 * b * (n * c + c * c), f32),
            "cam_apply": (
                lambda: ca.cam_apply(attn, x),
                lambda: att.channel_apply(attn, x),
                lambda: torch.bmm(x, attn.transpose(1, 2)),
                2.0 * b * n * c * c, 4.0 * b * (2 * n * c + c * c), f32),
        }
        for name, (kern, plain, lib, flops, nbytes, peak) in work.items():
            ms = median_ms(kern)
            plain_ms = median_ms(plain)
            lib_ms = median_ms(lib)
            bound_ms = max(flops / peak, nbytes / bw) * 1e3
            bound_by = "operations" if flops / peak >= nbytes / bw else "bytes"
            log(f"time {name} B={b}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms,"
                f" library {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
            if b == 1:
                records[name] = {"ms": ms, "plain_ms": plain_ms,
                                 "library_ms": lib_ms, "bound_ms": bound_ms,
                                 "bound_by": bound_by}
        x, = cam_inputs(b, n, c, torch.float32)
        composite = median_ms(lambda: torch.bmm(
            torch.softmax(_rowmax_minus(torch.bmm(x.transpose(1, 2), x)), -1),
            x.transpose(1, 2)))
        ours = median_ms(lambda: ca.flash_channel_attention(x))
        log(f"time channel_attention B={b}: kernels {ours:.4f} ms, library "
            f"composite bmm+softmax+bmm {composite:.4f} ms")
    # bf16-input bounds at B = 1: the position kernel's inputs are bf16
    q, k, v = pam_inputs(1, n, ck, c, torch.bfloat16)
    ms = median_ms(lambda: ca.flash_position_attention(q, k, v))
    flops, nbytes = 2.0 * n * n * (ck + c), 2.0 * n * (2 * ck + 2 * c)
    log(f"time position_attention B=1 bf16: kernel {ms:.4f} ms, bound "
        f"{max(flops / bf16, nbytes / bw) * 1e3:.4f} ms")
    for name in records:
        records[name]["max_abs_err"] = errors[name]
    return records


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


def main() -> int:
    import torch

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
        f"f32, {peaks[1] / 1e12:g} TFLOP/s bf16, {peaks[2] / 1e12:g} TB/s; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    ca.build()
    log(f"build: attention.cu in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds})")

    records = phase_kernels(torch, ca, att, peaks)

    ca.reset_launches()
    pred, image, clicks = phase_predictor(torch, Predictor, ca)
    phase_service(pred, image, clicks, InferenceService)
    phase_http(pred, image, clicks, InferenceService, make_server, ServeClient)
    launches = dict(ca.launches)
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"a kernel never ran on the main path: {launches}")

    log(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE,
         "replaces": TPU_KERNELS[k], "launches": launches[k],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for k, r in records.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
