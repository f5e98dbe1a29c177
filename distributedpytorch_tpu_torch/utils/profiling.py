"""Tracing and timing utilities, the counterpart of
``distributedpytorch_tpu/utils/profiling.py``.

* :func:`trace` — ``torch.profiler`` over a code region (host ops and,
  on a card, its kernels and copies), written as a Chrome trace
  (``*.pt.trace.json``) under ``log_dir``, which TensorBoard's profiler
  plugin and ``chrome://tracing`` read;
* :func:`annotate` — a named range inside such a trace;
* :func:`throughput` — steps dispatched back to back, one sync at the end;
* :class:`StepTimer` — per-step latency, each step synchronised;
* :func:`percentile` — nearest-rank percentile;
* :func:`device_memory_stats` — a card's allocator counters under the JAX
  function's key names.
"""

from __future__ import annotations

import contextlib
import math
import statistics
import time

import torch


def _sync(outputs=None) -> None:
    """Wait for the card's queued work (for the devices of ``outputs``'
    tensors, every visible one otherwise); nothing without CUDA."""
    if not torch.cuda.is_available():
        return
    if outputs is None:
        torch.cuda.synchronize()
        return
    for device in {t.device for t in _tensors(outputs) if t.device.type == "cuda"}:
        torch.cuda.synchronize(device)


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed region into a Chrome trace under ``log_dir``
    (``torch.profiler.tensorboard_trace_handler``, which needs no
    ``tensorboard`` package): CPU activity always, CUDA activity where a
    card is visible.  The queued work is synchronised before the trace
    closes, so the region's kernels are in it."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        try:
            yield
        finally:
            _sync()


def annotate(name: str):
    """A named range visible in the profiler's trace."""
    return torch.profiler.record_function(name)


def throughput(step_fn, steps: int, warmup: int = 2,
               items_per_step: int | None = None) -> dict:
    """Steady-state throughput of ``step_fn() -> outputs``: ``warmup``
    calls synchronised and left out, then ``steps`` calls dispatched back
    to back and one synchronisation on the last outputs."""
    out = None
    for _ in range(warmup):
        out = step_fn()
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(steps):
        out = step_fn()
    _sync(out)
    dt = time.perf_counter() - t0
    res = {"steps": steps, "total_s": dt, "mean_s": dt / steps}
    if items_per_step:
        res["items_per_sec"] = items_per_step * steps / dt
    return res


def percentile(values, q: float) -> float:
    """Nearest-rank percentile of ``values`` (q in [0, 100]): always a
    sample that was observed, never an interpolation between two."""
    if not values:
        raise ValueError("percentile of no samples")
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"q must be in [0, 100], got {q}")
    ordered = sorted(values)
    if q == 0.0:
        return ordered[0]
    rank = math.ceil(q / 100.0 * len(ordered))
    return ordered[min(len(ordered), rank) - 1]


class StepTimer:
    """Per-step wall times: ``tick(*outputs)`` synchronises on the
    outputs' devices (``sync="block"``: ``torch.cuda.synchronize``) or
    reads them to the host (``sync="device_get"``), reads the clock, and
    records the time since the last tick once ``warmup`` steps are past.

    >>> timer = StepTimer(warmup=2)
    >>> for batch in loader:
    ...     timer.tick(step(state, batch))
    >>> timer.summary()    # {'mean_s': ..., 'p50_s': ..., 'p99_s': ...}
    """

    def __init__(self, warmup: int = 2, sync: str = "block"):
        if sync not in ("block", "device_get"):
            raise ValueError(f"sync must be 'block' or 'device_get', "
                             f"got {sync!r}")
        self.warmup = warmup
        self.sync = sync
        self._seen = 0
        self._last: float | None = None
        self.times: list[float] = []

    def tick(self, *outputs) -> float | None:
        """Record one step boundary; pass any step outputs to wait on."""
        if outputs:
            if self.sync == "device_get":
                for t in _tensors(outputs):
                    t.cpu()
            else:
                _sync(outputs)
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            self._seen += 1
            if self._seen > self.warmup:
                dt = now - self._last
                self.times.append(dt)
        self._last = now
        return dt

    def summary(self, items_per_step: int | None = None) -> dict:
        if not self.times:
            return {"steps": 0}
        out = {
            "steps": len(self.times),
            "mean_s": statistics.fmean(self.times),
            "p50_s": statistics.median(self.times),
            "p99_s": percentile(self.times, 99.0),
            "min_s": min(self.times),
            "max_s": max(self.times),
        }
        if items_per_step:
            out["items_per_sec"] = items_per_step / out["mean_s"]
        return out


def device_memory_stats(device: torch.device | str | None = None) -> dict:
    """One card's memory, ``{bytes_in_use, peak_bytes_in_use,
    bytes_limit}`` as the JAX function names them: the caching
    allocator's bytes allocated now and at their peak
    (``torch.cuda.memory_stats``), and the card's total memory.  Zeros for
    a CPU device."""
    device = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available()
        else torch.device("cpu"))
    if device.type != "cuda":
        return {"bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0}
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.get_device_properties(device).total_memory),
    }
