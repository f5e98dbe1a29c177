"""On-demand, bounded ``torch.profiler`` trace capture — no restart
needed; the counterpart of ``distributedpytorch_tpu/telemetry/trace.py``.

:class:`TraceCapture` arms a capture from the outside of a live process
— ``SIGUSR2`` on the trainer, ``POST /debug/trace?steps=N`` on the serve
front — and the owning loop drives it with one cheap :meth:`tick` per
step/batch: the next tick after a request starts a ``torch.profiler``
(CPU and, with a card, CUDA activity), N ticks later it stops, and the
Chrome trace lands under the log dir (``trace_NNN/*.pt.trace.json``,
which TensorBoard's profiler plugin and ``chrome://tracing`` read).

Safety properties, each deliberate:

* **Bounded.**  Steps are clamped to ``max_steps`` and a wall-clock
  ``max_seconds`` backstop closes a trace even if the step flow stalls.
* **Signal-safe arming.**  :meth:`request` only assigns plain attributes
  (no blocking locks): it is safe to call from a signal handler
  interrupting arbitrary code.  All real work happens in :meth:`tick` on
  the owning loop's thread.
* **One at a time.**  ``torch.profiler`` allows one active profiler per
  process: a request while a capture is active or armed is refused
  (returns None), and a start while another profiler runs (the trainer's
  ``profile_epoch``) fails, is counted in
  ``trace_capture_failures_total`` and is dropped.
* **Never fatal.**  Profiler failures are counted and printed, never
  raised into the loop.
"""

from __future__ import annotations

import os
import signal
import threading
import time

import torch

from .registry import MetricsRegistry, get_registry


class TraceCapture:
    """Armed-from-outside bounded profiler trace; driven by ``tick``.

    ``tick(n)`` means "n more steps are about to run": the owning loop
    calls it immediately before each dispatch (the trainer passes 1 per
    step; the serve worker passes 1 per batch and 0 on idle polls so the
    time backstop still runs).
    """

    def __init__(self, log_dir: str, default_steps: int = 20,
                 max_steps: int = 200, max_seconds: float = 120.0,
                 registry: MetricsRegistry | None = None):
        self.log_dir = log_dir
        self.default_steps = default_steps
        self.max_steps = max_steps
        self.max_seconds = max_seconds
        self._registry = registry
        # armed-request slot: written by request() (possibly from a signal
        # handler), consumed by tick() on the owning thread.  The arm is
        # guarded by a non-blocking try-lock: concurrent HTTP threads
        # cannot both claim the slot, and a signal handler that finds it
        # held refuses (acquire(False) never blocks)
        self._arm_lock = threading.Lock()
        self._want = 0
        self._pending_dir = ""
        # active-capture state: owned by the tick()er's thread
        self._active = False
        self._remaining = 0
        self._started = 0.0
        self._dir = ""
        self._captures = 0
        self._prof = None

    # ------------------------------------------------------------- arming
    @property
    def active(self) -> bool:
        return self._active

    def request(self, steps: int | None = None) -> str | None:
        """Arm a capture of ``steps`` (clamped to [1, max_steps]); the
        next step tick starts it.  Returns the directory the trace will
        land in, or None when one is already armed/active (refused, not
        queued).  Safe to call from signal handlers and HTTP threads."""
        if not self._arm_lock.acquire(blocking=False):
            return None
        try:
            if self._active or self._want:
                return None
            n = self.default_steps if steps is None else int(steps)
            target = os.path.join(self.log_dir,
                                  f"trace_{self._captures:03d}")
            # the target before the arm: tick() may fire between the two
            # assignments and must already see where to write
            self._pending_dir = target
            self._want = max(1, min(self.max_steps, n))
            return target
        finally:
            self._arm_lock.release()

    def install_signal(self, signum: int | None = None):
        """Install a SIGUSR2 (default) handler that arms a default
        capture; returns an uninstall callable.  Off the main thread
        (where ``signal.signal`` raises) this degrades to a no-op."""
        if signum is None:
            signum = getattr(signal, "SIGUSR2", None)
            if signum is None:
                return lambda: None
        try:
            prev = signal.signal(signum, lambda s, f: self.request())
        except ValueError:
            return lambda: None
        return lambda: signal.signal(signum, prev)

    # ------------------------------------------------------------- driving
    def tick(self, n: int = 1) -> None:
        """Advance by ``n`` imminent steps (0 = just service the time
        backstop).  Called from exactly one thread — the step loop."""
        if self._active:
            if self._remaining <= 0 or \
                    time.perf_counter() - self._started > self.max_seconds:
                self._stop()
            else:
                self._remaining -= n
        elif self._want and n > 0:
            # start only on a real step tick: an idle tick(0) opening the
            # trace would burn the backstop on idle time
            steps = self._want
            self._want = 0
            self._start(steps)
            self._remaining = steps - n

    def close(self) -> None:
        """Stop any in-flight capture (fit end, service stop, or before
        the trainer's own ``profile_epoch`` profiler starts)."""
        if self._active:
            self._stop()

    # ------------------------------------------------------------ internals
    def _reg(self) -> MetricsRegistry:
        return self._registry or get_registry()

    def _fail(self, what: str, e: Exception) -> None:
        self._reg().counter("trace_capture_failures_total",
                            "on-demand trace captures that failed").inc()
        print(f"telemetry: trace capture failed to {what}: {e}", flush=True)

    def _start(self, steps: int) -> None:
        self._dir = self._pending_dir or os.path.join(
            self.log_dir, f"trace_{self._captures:03d}")
        try:
            if torch._C._autograd._profiler_enabled():
                # a second start would silently end the first one's
                # session instead of raising
                raise RuntimeError("another torch.profiler is active "
                                   "(profile_epoch?)")
            os.makedirs(self._dir, exist_ok=True)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(
                activities=acts,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    self._dir))
            prof.start()
        except Exception as e:  # another profiler active, or its error
            self._fail("start", e)
            return
        self._prof = prof
        self._active = True
        self._started = time.perf_counter()
        print(f"telemetry: capturing {steps}-step trace -> {self._dir}",
              flush=True)

    def _stop(self) -> None:
        prof, self._prof = self._prof, None
        try:
            if torch.cuda.is_available():
                torch.cuda.synchronize()  # the traced steps' kernels land
            prof.stop()
        except Exception as e:
            self._fail("stop", e)
        else:
            self._reg().counter("trace_captures_total",
                                "on-demand trace captures completed").inc()
            print(f"telemetry: trace written -> {self._dir}", flush=True)
        self._active = False
        self._captures += 1


def query_steps(query: str, default: int | None = None) -> int | None:
    """Parse ``steps=N`` out of a raw query string (bad values -> default)."""
    from urllib.parse import parse_qs

    try:
        vals = parse_qs(query).get("steps")
        return int(vals[0]) if vals else default
    except (ValueError, TypeError):
        return default
