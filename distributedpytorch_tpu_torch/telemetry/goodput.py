"""Goodput accounting and MFU estimation, the counterpart of
``distributedpytorch_tpu/telemetry/goodput.py``.

The :class:`GoodputAccountant` attributes the process's wall-clock to a
small closed set of buckets:

* ``step``       — productive train-step dispatch + readback
* ``compile``    — the first dispatch (on the port: the first step, which
  pays the kernels' build at first use, cuDNN's algorithm search and
  CUDA's lazy initialisation) and the FLOP count beside it
* ``checkpoint`` — save/restore/wait
* ``eval``       — validation epochs
* ``input_wait`` — the step loop blocked on the data pipeline
* ``idle``       — everything untracked (derived: total - tracked)

Attribution is exclusive and nestable: entering an inner bucket pauses
the outer one's clock, so the buckets sum to tracked wall-clock by
construction (plus ``idle``, exactly total).  Per-thread stacks keep the
accounting correct on the overlapped validation's thread — with
genuinely concurrent work the per-bucket sums can exceed wall-clock (two
threads, one clock); single-threaded runs sum exactly.  The books are
host ``perf_counter`` bookkeeping: no synchronisation with the card is
added, so device time lands in the bucket whose host code waits for it.

MFU (model FLOPs utilization) = model FLOPs per step / step time /
device peak FLOP/s.  The FLOPs come from :func:`step_flops`
(``torch.utils.flop_counter.FlopCounterMode``), the peak from the table
below keyed by a substring of ``torch.cuda.get_device_name()``, with the
smallest peak in the table and the label ``fallback`` for unknown
hardware (the CPU included) — an estimate is always produced, labelled
with its source.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch

from .registry import MetricsRegistry, get_registry

#: the closed attribution set (order = reporting order)
BUCKETS = ("step", "compile", "checkpoint", "eval", "input_wait")

# Published dense (no sparsity) bf16 tensor-core peaks per card, from
# NVIDIA's H100 data sheet: SXM 989.4 TFLOP/s, PCIe 756 TFLOP/s.  One peak
# per kind, as in the JAX package's table, so a float32 run with TF32 off
# (CUDA cores, 67 TFLOP/s on the SXM part) is read against the bf16 peak
# too: its MFU is a share of what the card could do in bf16.  Matched by
# lower-case substring of ``torch.cuda.get_device_name()``, in order:
# "h100 pcie" before "h100" (the SXM part names itself "NVIDIA H100 80GB
# HBM3").
PEAK_FLOPS_BY_KIND = {
    "h100 pcie": 756e12,
    "h100": 989.4e12,
}

# Peak HBM bandwidth per card (B/s), same data sheet, keyed identically:
# SXM 3.35 TB/s (HBM3), PCIe 2.0 TB/s (HBM2e).
PEAK_HBM_BY_KIND = {
    "h100 pcie": 2.0e12,
    "h100": 3.35e12,
}

#: unknown hardware (the CPU, other cards): the smallest peak in the
#: table — it never inflates a denominator it cannot justify, and the
#: estimate is labelled 'fallback' so nobody mistakes it for a
#: measured-peak ratio
FALLBACK_PEAK_FLOPS = min(PEAK_FLOPS_BY_KIND.values())


def current_device_kind() -> str:
    """``torch.cuda.get_device_name(0)``, or ``"cpu"`` without a card."""
    return torch.cuda.get_device_name(0) if torch.cuda.is_available() \
        else "cpu"


def peak_flops_for(device_kind: str | None = None) -> tuple[float, str]:
    """(peak FLOP/s, source) for a device name; source is the matched
    table key or 'fallback'."""
    if device_kind is None:
        device_kind = current_device_kind()
    kind = device_kind.lower()
    for sub, val in PEAK_FLOPS_BY_KIND.items():
        if sub in kind:
            return val, sub
    return FALLBACK_PEAK_FLOPS, "fallback"


def mfu_estimate(flops_per_step: float, step_time_s: float,
                 device_kind: str | None = None) -> dict:
    """MFU = achieved FLOP/s per device / peak FLOP/s per device.

    ``flops_per_step`` is the PER-DEVICE model FLOPs of one optimizer
    step (for a whole-group cost, divide by the number of ranks first);
    ``step_time_s`` is the mean wall-clock of one step.
    """
    if flops_per_step <= 0 or step_time_s <= 0:
        raise ValueError(
            f"flops_per_step and step_time_s must be > 0, got "
            f"{flops_per_step}, {step_time_s}")
    peak, source = peak_flops_for(device_kind)
    achieved = flops_per_step / step_time_s
    return {
        "mfu": achieved / peak,
        "achieved_flops_per_sec": achieved,
        "peak_flops_per_device": peak,
        "peak_source": source,
        "flops_per_step": flops_per_step,
        "step_time_s": step_time_s,
    }


def step_flops(model: torch.nn.Module, inputs: torch.Tensor) -> float:
    """Model FLOPs of one train step of ``model`` on ``inputs``: the
    forward and the backward of every output, counted once by
    ``torch.utils.flop_counter.FlopCounterMode`` (matrix products and
    convolutions; elementwise work is not counted).

    Counting runs the step, so pass a copy on the meta device: no memory,
    no arithmetic, and the live model's BatchNorm statistics and gradients
    stay untouched.  That copy must take the plain attention forms: the
    CUDA kernels are ``ctypes`` launches inside autograd Functions, which
    the counter cannot see (and which refuse meta tensors); the plain
    forms do the same products.  Recomputation (remat, the kernels'
    backward) is not model work and is left out, as in MFU's definition.
    """
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        outputs = model(inputs)
        if isinstance(outputs, torch.Tensor):
            outputs = (outputs,)
        torch.stack([o.float().sum() for o in outputs]).sum().backward()
    return float(counter.get_total_flops())


class _Account:
    """Class-based context manager for :meth:`GoodputAccountant.account` —
    the generator-based form costs ~2x more per entry, and this sits on
    the step loop's per-iteration path (the <=2%-overhead contract)."""

    __slots__ = ("_a", "bucket")

    def __init__(self, a: "GoodputAccountant", bucket: str):
        if bucket not in a._seconds:
            raise ValueError(f"unknown goodput bucket {bucket!r} "
                             f"(one of {BUCKETS})")
        self._a = a
        self.bucket = bucket

    def __enter__(self) -> "_Account":
        a = self._a
        stack = a._stack()
        now = time.perf_counter()
        if stack:  # pause the outer bucket's clock
            outer, outer_t0 = stack[-1]
            a._credit(outer, now - outer_t0)
            stack[-1] = (outer, None)
        stack.append((self.bucket, now))
        with a._lock:
            a._counts[self.bucket] += 1
        return self

    def __exit__(self, *exc) -> bool:
        a = self._a
        stack = a._stack()
        now = time.perf_counter()
        _, t0 = stack.pop()
        a._credit(self.bucket, now - t0)
        if stack:  # resume the outer bucket's clock
            stack[-1] = (stack[-1][0], now)
        return False


#: shared stateless no-op for disabled accountants
_NOOP = contextlib.nullcontext()


class GoodputAccountant:
    """Wall-clock attribution over :data:`BUCKETS`, exclusive + nested.

    >>> acct = GoodputAccountant()
    >>> with acct.account("eval"):
    ...     with acct.account("checkpoint"):   # pauses the eval clock
    ...         save()
    >>> acct.report()["buckets"]               # sums to total (with idle)

    ``reset(enabled=False)`` turns every ``account()`` into a shared
    no-op context — the disable path the <=2%-overhead contract is
    measured against.
    """

    def __init__(self, registry: MetricsRegistry | None = None,
                 enabled: bool = True):
        self._registry = registry
        self._lock = threading.Lock()
        self._tls = threading.local()
        self.enabled = enabled
        self._t0 = time.perf_counter()
        self._seconds = {b: 0.0 for b in BUCKETS}
        self._counts = {b: 0 for b in BUCKETS}

    # ------------------------------------------------------------ lifecycle
    def reset(self, enabled: bool = True) -> None:
        """Zero the books and restart the wall clock (call at fit start)."""
        with self._lock:
            self.enabled = enabled
            self._t0 = time.perf_counter()
            self._seconds = {b: 0.0 for b in BUCKETS}
            self._counts = {b: 0 for b in BUCKETS}

    # ---------------------------------------------------------- attribution
    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _credit(self, bucket: str, seconds: float) -> None:
        with self._lock:
            self._seconds[bucket] += seconds

    def account(self, bucket: str):
        """Attribute the enclosed wall-clock to ``bucket`` (exclusive of
        any nested ``account`` regions, whose time goes to themselves).
        Returns a context manager; a shared no-op when disabled."""
        if not self.enabled:
            return _NOOP
        return _Account(self, bucket)

    def snapshot(self) -> dict:
        """Current per-bucket seconds, no derived fields, no publishing —
        the cheap read the feed governor's tick differences against its
        previous snapshot (one lock, one dict copy; safe at the log
        cadence)."""
        with self._lock:
            return dict(self._seconds)

    # ------------------------------------------------------------- reporting
    def report(self, publish: bool = True) -> dict:
        """Breakdown since the last reset.  ``idle`` is derived (total -
        tracked, clamped at 0), so in single-threaded use the buckets sum
        to ``total_s`` exactly; concurrent threads can push tracked time
        past wall-clock (two threads, one clock) — ``overlap_s`` exposes
        the excess instead of hiding it.

        ``publish`` mirrors the breakdown into registry gauges
        (``goodput_seconds{bucket=...}``, ``goodput_ratio``) so the serve
        front's ``/metrics`` exports train goodput too."""
        with self._lock:
            total = time.perf_counter() - self._t0
            seconds = dict(self._seconds)
            counts = dict(self._counts)
        tracked = sum(seconds.values())
        seconds["idle"] = max(0.0, total - tracked)
        rep = {
            "total_s": total,
            "buckets": seconds,
            "counts": counts,
            "goodput": (seconds["step"] / total) if total > 0 else 0.0,
            "overlap_s": max(0.0, tracked - total),
        }
        if publish:
            reg = self._registry or get_registry()
            for b, v in seconds.items():
                reg.gauge("goodput_seconds",
                          "wall-clock attributed per goodput bucket",
                          labels={"bucket": b}).set(v)
            reg.gauge("goodput_ratio",
                      "fraction of wall-clock in productive steps"
                      ).set(rep["goodput"])
        return rep


class FeedWindow:
    """Bounded ring of per-tick ``(busy_s, input_wait_s)`` samples — the
    windowed view of the input-stall signal the feed governor
    (data/governor.py) acts on.

    The source is the EXISTING exclusive goodput attribution: callers
    difference :meth:`GoodputAccountant.snapshot` between ticks (the log
    cadence the trainer already pays — no new host syncs) and push the
    deltas here.  ``busy_s`` is productive device-side wall-clock of the
    interval (step + compile); ``input_wait_s`` is host time blocked on
    the data pipeline.  The rolling stall fraction is
    ``sum(wait) / sum(wait + busy)`` over the ring — a per-step fraction
    would whipsaw on echo/multi-step configs where waits land on a
    subset of ticks.
    """

    def __init__(self, size: int = 16):
        if size < 1:
            raise ValueError(f"window size must be >= 1, got {size}")
        self._ring: collections.deque = collections.deque(maxlen=int(size))
        self.dropped = 0

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def size(self) -> int:
        return self._ring.maxlen

    def push(self, busy_s: float, input_wait_s: float) -> None:
        if busy_s < 0 or input_wait_s < 0:
            # clock skew / accountant reset between snapshots: drop, never
            # poison the window — but COUNT the drop (a silently shrinking
            # sample base looked exactly like a healthy feed), so /metrics
            # and the doctor can tell "no stalls" from "no samples"
            self.dropped += 1
            get_registry().counter(
                "telemetry_dropped_deltas_total",
                "goodput deltas dropped for being negative "
                "(accountant reset raced the feed window)").inc()
            return
        self._ring.append((float(busy_s), float(input_wait_s)))

    def reset(self) -> None:
        self._ring.clear()

    def totals(self) -> tuple[float, float]:
        """(busy_s, input_wait_s) summed over the ring."""
        busy = sum(b for b, _ in self._ring)
        wait = sum(w for _, w in self._ring)
        return busy, wait

    def stall_fraction(self) -> float | None:
        """Rolling input-stall fraction over the ring; None until a
        sample with nonzero tracked time lands."""
        busy, wait = self.totals()
        total = busy + wait
        if total <= 0:
            return None
        return wait / total


#: process-wide accountant (reset at each fit; checkpoint/eval wiring
#: reaches it from their own modules without plumbing)
_ACCOUNTANT = GoodputAccountant()


def get_accountant() -> GoodputAccountant:
    return _ACCOUNTANT
