"""The inference service: bounded queue -> micro-batcher -> bucketed forward.

Counterpart of ``distributedpytorch_tpu/serve/service.py`` without sessions,
hot-swap, AOT or the compile watchdog::

    client threads --submit()--> bounded queue --drain--> micro-batcher
                                                              |
         futures <--paste-back <-- unpad <-- bucketed forward

* A full queue sheds the NEW request at once (:class:`QueueFullError`)
  instead of growing everyone's latency.
* The worker dispatches when ``max_batch`` requests are pending or
  ``max_wait_s`` has passed since the first one; requests already queued
  are always drained.
* Each drained batch is padded to the next power-of-two bucket
  (``batching``), so the forward sees a fixed, small set of batch shapes.
* A request whose deadline passed while queued is dropped at drain time
  (:class:`DeadlineExceededError`).

Host preprocessing (clicks -> guidance -> crop) runs on the caller's thread
in :meth:`InferenceService.submit`; the worker owns the forward and the
paste-back.  The counters live in the telemetry registry
(:class:`.metrics.ServeMetrics`), so ``GET /metrics`` exports them; the
chaos sites ``serve/enqueue`` (the caller's thread, before anything is
queued) and ``serve/drain`` (the worker, before the forward) fire as in
the JAX service; an optional :class:`..telemetry.trace.TraceCapture` is
driven by the worker, one tick per batch.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any

import numpy as np

from ..chaos import sites as chaos_sites
from . import batching
from .metrics import ServeMetrics


class QueueFullError(RuntimeError):
    """Load shed: the bounded request queue is full — retry later."""


class DeadlineExceededError(TimeoutError):
    """The request's deadline passed before its batch was dispatched."""


class ServiceUnhealthyError(RuntimeError):
    """The service refused the request (not running)."""


@dataclasses.dataclass
class _Request:
    """One queued request, already host-preprocessed."""
    concat: np.ndarray                    # prepared (H, W, C) network input
    bbox: tuple[int, int, int, int]       # paste-back crop box
    shape_hw: tuple[int, int]             # full-image size for paste-back
    future: Future                        # resolves to the (H, W) mask
    submitted: float                      # perf_counter at submit
    deadline: float | None                # absolute perf_counter, or None


class InferenceService:
    """Multi-client batched inference over one :class:`predict.Predictor`.

    >>> with InferenceService(predictor, max_batch=8) as svc:
    ...     fut = svc.submit(image, points)          # non-blocking
    ...     mask = fut.result(timeout=5.0)           # (H, W) float32

    ``max_batch`` (a power of two) tops the bucket ladder; ``queue_depth``
    bounds admission; ``max_wait_s`` bounds how long the batcher holds a
    lone request hoping for company; ``default_deadline_s`` applies to
    requests submitted without a deadline (``None``: no deadline).
    ``trace`` is the on-demand profiler capture the worker drives
    (``POST /debug/trace``, SIGUSR2 on the HTTP front).
    """

    def __init__(self, predictor, max_batch: int = 8, queue_depth: int = 64,
                 max_wait_s: float = 0.005,
                 default_deadline_s: float | None = None, trace=None):
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        if max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {max_wait_s}")
        self.predictor = predictor
        self.buckets = batching.bucket_sizes(max_batch)
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.default_deadline_s = default_deadline_s
        self.metrics = ServeMetrics()
        self.trace = trace
        self._queue: queue.Queue[_Request] = queue.Queue(maxsize=queue_depth)
        self._stop = threading.Event()
        #: "new" (accepting, queued until start) -> "running" -> "stopped"
        self._state = "new"
        self._worker: threading.Thread | None = None

    # ------------------------------------------------------------ lifecycle

    def warmup(self) -> dict:
        """Run every bucket's batch shape once before taking traffic (the
        first forward at a shape pays cuDNN's algorithm search and, on the
        card, the kernels' build).  Returns per-bucket milliseconds."""
        h, w = self.predictor.resolution
        ch = self.predictor.in_channels
        out = {}
        for b in self.buckets:
            t0 = time.perf_counter()
            self.predictor.forward_prepared(np.zeros((b, h, w, ch), np.float32))
            out[b] = (time.perf_counter() - t0) * 1e3
        return out

    def start(self) -> "InferenceService":
        """Start the batcher worker.  Requests submitted before start wait in
        the queue and drain as the first batch."""
        if self._state != "new":
            raise RuntimeError(f"cannot start a {self._state} service")
        # chaos: arm an env-named fault plan (DPTPU_CHAOS_PLAN) for this
        # service's lifetime; one getenv when unset
        chaos_sites.maybe_arm_from_env()
        self._state = "running"
        self._worker = threading.Thread(target=self._run, name="serve-batcher",
                                        daemon=True)
        self._worker.start()
        return self

    def stop(self) -> None:
        """Stop the worker and fail any still-queued requests."""
        if self._state == "stopped":
            return
        self._state = "stopped"
        self._stop.set()
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if self._fail_stopped(req.future):
                self.metrics.count("failed")

    @staticmethod
    def _fail_stopped(future: Future) -> bool:
        """Fail a queued future with 'service stopped'; False when it was
        cancelled or already failed by the racing side of a stop."""
        try:
            if not future.set_running_or_notify_cancel():
                return False
        except RuntimeError:  # already resolved by the other side of the race
            return False
        future.set_exception(ServiceUnhealthyError("service stopped"))
        return True

    def __enter__(self) -> "InferenceService":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()

    # ------------------------------------------------------------ front door

    def submit(self, image: np.ndarray, points: Any,
               deadline_s: float | None = None) -> Future:
        """Enqueue one request; returns a Future resolving to the mask.

        Raises :class:`QueueFullError` at once when the queue is full,
        :class:`ServiceUnhealthyError` when the service is stopped, and
        ``ValueError`` for bad inputs, before anything is queued."""
        if self._state == "stopped":
            raise ServiceUnhealthyError("service stopped")
        # chaos seam, on the caller's thread: latency is a slow host
        # preprocess, an error a front-door dependency failing — both
        # before anything is queued
        chaos_sites.fire("serve/enqueue")
        if self._queue.full():
            # shed before the host preprocessing: a rejection must be cheap
            self.metrics.count("shed_queue_full")
            raise QueueFullError(
                f"request queue full ({self._queue.maxsize} deep) — "
                "overloaded; retry with backoff")
        now = time.perf_counter()
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        concat, bbox = self.predictor.prepare(image, points)
        req = _Request(concat=concat, bbox=bbox,
                       shape_hw=tuple(np.asarray(image).shape[:2]),
                       future=Future(), submitted=now,
                       deadline=None if deadline_s is None else now + deadline_s)
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            self.metrics.count("shed_queue_full")
            raise QueueFullError(
                f"request queue full ({self._queue.maxsize} deep) — "
                "overloaded; retry with backoff") from None
        self.metrics.count("requests")
        if self._state == "stopped":
            # raced a concurrent stop() past its queue drain
            self._fail_stopped(req.future)
        return req.future

    def predict(self, image: np.ndarray, points: Any,
                deadline_s: float | None = None,
                timeout: float | None = None) -> np.ndarray:
        """Blocking convenience: :meth:`submit` + ``Future.result``."""
        return self.submit(image, points, deadline_s).result(timeout)

    def health(self) -> dict:
        """Liveness and the counters a probe reads."""
        return {
            "ok": self._state == "running" and (
                self._worker is not None and self._worker.is_alive()),
            "state": self._state,
            "device": str(self.predictor.device),
            "queue_depth": self._queue.qsize(),
            "queue_capacity": self._queue.maxsize,
            "buckets": list(self.buckets),
            "stats": self.metrics.snapshot(),
        }

    # ------------------------------------------------------------ worker

    def _run(self) -> None:
        while not self._stop.is_set():
            batch = self._gather()
            if self.trace is not None:
                # 1 step per batch, 0 on idle polls so the wall-clock
                # backstop still closes a capture when traffic stops
                self.trace.tick(1 if batch else 0)
            if batch:
                self._process(batch)
        if self.trace is not None:
            self.trace.close()

    def _gather(self) -> list[_Request]:
        """Wait up to ``max_wait_s`` after the first request for company,
        up to ``max_batch``; requests already queued always drain."""
        try:
            first = self._queue.get(timeout=0.05)
        except queue.Empty:
            return []
        batch = [first]
        wait_until = time.perf_counter() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = wait_until - time.perf_counter()
            try:
                if remaining > 0:
                    batch.append(self._queue.get(timeout=remaining))
                else:
                    batch.append(self._queue.get_nowait())
            except queue.Empty:
                if remaining <= 0:
                    break
        return batch

    def _process(self, batch: list[_Request]) -> None:
        # chaos seam, on the worker before the deadline check: latency
        # stalls the drain like a slow device; a raised fault fails this
        # batch and the worker serves on
        try:
            chaos_sites.fire("serve/drain", batch_size=len(batch))
        except Exception as e:
            failed = 0
            for req in batch:
                if req.future.set_running_or_notify_cancel():
                    req.future.set_exception(e)
                    failed += 1
            self.metrics.count("failed", failed)
            return
        now = time.perf_counter()
        live: list[_Request] = []
        for req in batch:
            if not req.future.set_running_or_notify_cancel():
                continue  # the client gave up
            if req.deadline is not None and now > req.deadline:
                self.metrics.count("shed_deadline")
                req.future.set_exception(DeadlineExceededError(
                    "deadline passed while queued — the service is "
                    "saturated; shed instead of serving a stale answer"))
                continue
            live.append(req)
        if not live:
            return
        try:
            bucket = batching.bucket_for(len(live), self.buckets)
            padded = batching.pad_to_bucket(
                np.stack([r.concat for r in live]), bucket)
            probs = batching.unpad(self.predictor.forward_prepared(padded),
                                   len(live))
            for i, req in enumerate(live):
                req.future.set_result(self.predictor.paste_back(
                    probs[i], req.bbox, req.shape_hw))
        except Exception as e:  # fail this batch, keep serving
            failed = 0
            for req in live:
                if not req.future.done():
                    req.future.set_exception(e)
                    failed += 1
            self.metrics.count("failed", failed)
            return
        self.metrics.observe_batch(bucket, len(live))
        self.metrics.count("completed", len(live))
        done = time.perf_counter()
        for req in live:
            self.metrics.observe_latency(done - req.submitted)
