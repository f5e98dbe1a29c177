"""Graceful preemption, the counterpart of
``distributedpytorch_tpu/train/preemption.py``.

A termination signal (SIGTERM, SIGINT) sets a flag instead of killing the
process; the trainer reads it between steps, leaves the loop, saves the
whole train state once and returns, and the next run resumes where it
stopped.  Under data parallelism the decision is a consensus, as in the
JAX guard: at each check every rank's flag is gathered and the ranks stop
if any is set (``replicated_decision(..., reduce="any")``), so a signal to
one rank stops every rank at the same step.  With one process the
decision is the local flag.  At each check the signals seen so far are
published, as in the JAX guard: ``preemption_signals_total`` and
``preemption_stop_pending`` in the registry and a ``preemption``
``preempt`` event in the flight recorder (from normal thread context; the
handler itself only counts); the consensus runs inside the span
``preempt/consensus`` when there are several processes.
"""

from __future__ import annotations

import contextlib
import signal
import threading

from ..parallel import mesh
from ..parallel.consensus import replicated_decision
from ..telemetry import events as events_lib
from ..telemetry import get_registry, is_enabled, span


class PreemptionGuard:
    """Installs termination-signal handlers and exposes the stop flag.

    Usage::

        with PreemptionGuard() as guard:
            for step, batch in enumerate(loader):
                ...
                if guard.should_stop(step):
                    break
        if guard.triggered:
            save(...)

    ``trip()`` sets the flag as a signal would (for tests, and for a
    caller's own watchdog).  A second signal while the flag is set
    re-delivers it to the handler that was there before, so a double
    Ctrl-C still raises ``KeyboardInterrupt`` — except inside
    :meth:`shield`, which absorbs it while the final checkpoint is
    written.  Leaving the ``with`` block restores the previous handlers.
    """

    def __init__(self, signals: tuple[int, ...] = (signal.SIGTERM,
                                                   signal.SIGINT),
                 check_every: int = 32):
        self._signals = tuple(signals)
        self._prev: dict[int, object] = {}
        self._flag = threading.Event()
        self._shield_depth = 0
        self.check_every = max(1, int(check_every))
        #: termination signals delivered to this process
        self.signals_received = 0
        self._signals_reported = 0

    def __enter__(self) -> "PreemptionGuard":
        for s in self._signals:
            try:
                self._prev[s] = signal.signal(s, self._handle)
            except ValueError:
                # only the main thread may install handlers; a guard used
                # from another thread still works through trip()
                pass
        return self

    def __exit__(self, *exc) -> bool:
        for s, prev in self._prev.items():
            # getsignal() reports None for a handler installed from C
            signal.signal(s, signal.SIG_DFL if prev is None else prev)
        self._prev.clear()
        return False

    def _handle(self, signum, frame) -> None:
        self.signals_received += 1
        if self._flag.is_set():
            if self._shield_depth > 0:
                return
            prev = self._prev.pop(signum, signal.SIG_DFL)
            if prev is None:
                prev = signal.SIG_DFL
            if callable(prev):
                signal.signal(signum, prev)
                prev(signum, frame)
            else:
                signal.signal(signum, prev)
                signal.raise_signal(signum)
            return
        self._flag.set()

    @contextlib.contextmanager
    def shield(self):
        """While active, further signals never escalate: the final
        checkpoint write in flight completes."""
        self._shield_depth += 1
        try:
            yield
        finally:
            self._shield_depth -= 1

    def trip(self) -> None:
        """Request a graceful stop, as a signal would."""
        self._flag.set()

    @property
    def triggered(self) -> bool:
        """Whether a signal arrived or ``trip()`` was called."""
        return self._flag.is_set()

    def should_stop(self, step: int | None = None) -> bool:
        """The stop decision, read every ``check_every`` steps: a ``step``
        off the cadence returns False; ``None`` (an epoch boundary)
        always reads it.  A read is a collective under a process group:
        every rank reads at the same steps, and all stop if any rank's
        flag is set."""
        if step is not None and step % self.check_every != 0:
            return False
        self._publish_telemetry()
        if mesh.data_axis_size() == 1:
            return self.triggered
        # the consensus is a host sync on the step-loop cadence: named, so
        # its cost is attributable in a trace
        with span("preempt/consensus"):
            return bool(replicated_decision(
                self.triggered, reduce="any",
                label="preemption/should_stop"))

    def _publish_telemetry(self) -> None:
        """Mirror the handler's signal count into the registry and the
        flight recorder (normal thread context — the handler stays
        lock-free)."""
        if not is_enabled():
            return
        seen = self.signals_received
        if seen > self._signals_reported:
            get_registry().counter(
                "preemption_signals_total",
                "termination signals delivered to this process"
            ).inc(seen - self._signals_reported)
            self._signals_reported = seen
            events_lib.emit("preemption", "preempt",
                            payload={"signals_received": seen})
        get_registry().gauge(
            "preemption_stop_pending",
            "1 while a graceful stop is requested but not yet taken"
        ).set(float(self.triggered))
