"""The inference service: bounded queue -> micro-batcher -> bucketed forward.

Counterpart of ``distributedpytorch_tpu/serve/service.py`` with its
sessions, its hot swap, its AOT warm boot and its retrace tripwire::

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
* With a split predictor (``supports_sessions``, a ``guidance_inject=
  "head"`` DANet) a request may carry a ``session_id``.  The session's
  first click, or one outside its crop or on another image, is a cold
  ``full`` request: encode and decode, and the crop's features are kept
  on the device (:class:`.sessions.SessionStore`).  A later click inside
  the crop is a warm ``decode`` request: only the guidance is drawn anew,
  and the decode runs on the cached features.  A drain dispatches one
  group per kind, so warm clicks of many sessions share one bucketed
  decode, their features concatenated on the device.  One session may
  hold at most ``session_lane_depth`` queued requests
  (:class:`SessionLaneFullError`), so a busy session cannot take every
  queue slot.
* :meth:`InferenceService.swap` admits a new weight set beside the one in
  service as a canary generation (:mod:`.swap`): a session keeps the
  generation that encoded it, new sessions and stateless requests are
  routed to the canary by ``canary_fraction``, and a drain dispatches one
  group per (kind, generation), so no batch mixes two generations'
  weights.  The pool promotes or rolls the canary back from the outcomes
  the worker reports (or :meth:`InferenceService.promote` /
  :meth:`InferenceService.rollback` do); a canary's non-finite full batch
  is served again by the active generation, and the worker's 1 Hz sweep
  retires drained generations, whose weights are then freed.
* :meth:`InferenceService.warmup` readies every bucket's program before
  traffic: with an ``aot_cache`` (``serve/aot.py``) it loads each
  program's AOTInductor package and installs it in the predictor, and
  warms eagerly, with a loud stderr line, whatever the cache cannot give;
  without one it warms every program eagerly, the port's ordinary path.
* The retrace tripwire: a :class:`..utils.compile_watchdog.CompileWatchdog`
  runs on the worker thread for the service's lifetime.  The port's steady
  state compiles nothing (eager forwards, loaded packages), and the budget
  is JAX's, one compile per batch shape dispatched that no warm-up
  readied; a compile beyond it counts ``retrace_failures``, makes the
  service unhealthy (``health()["unhealthy_reason"]``) and, with
  ``strict_retrace`` (the default), refuses further requests with
  :class:`ServiceUnhealthyError`.

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
import os
import queue
import sys
import threading
import time
from concurrent.futures import Future
from typing import Any

import numpy as np
import torch

from ..chaos import sites as chaos_sites
from . import batching
from .metrics import ServeMetrics


class QueueFullError(RuntimeError):
    """Load shed: the bounded request queue is full — retry later."""


class SessionLaneFullError(QueueFullError):
    """Load shed: one session overfilled its per-session lane.

    A :class:`QueueFullError` (the same 429 and retry advice), but its own
    type: a full queue means the service is saturated, a full lane that
    one session outpaces its share and only it should back off."""


class DeadlineExceededError(TimeoutError):
    """The request's deadline passed before its batch was dispatched."""


class ServiceUnhealthyError(RuntimeError):
    """The service refused the request (stopped, or tripped unhealthy)."""


class _NonFiniteOutputError(RuntimeError):
    """A dispatch gave NaN or inf probabilities: the signal the swap pool's
    canary health keys on (a poisoned checkpoint's failure)."""


class _NonFiniteInputError(RuntimeError):
    """Both generations gave non-finite output for the same batch: the
    poison came with the request (NaN pixels in a float image), not with
    any weights.  A plain failure, never a canary signal, so one hostile
    request cannot veto a healthy deploy."""


@dataclasses.dataclass
class _Request:
    """One queued request, already host-preprocessed.

    ``kind="full"``: a stateless request or a session's cold click;
    ``concat`` is the prepared (H, W, C) input, and with ``store_session``
    the encoded features are cached under ``session_id``.
    ``kind="decode"``: a warm click; ``guidance`` is the new (H, W, 1)
    guidance and ``session`` the cached entry it decodes against.
    ``gen_id`` pins the weight generation for the request's whole life
    (:mod:`.swap`)."""
    bbox: tuple[int, int, int, int]       # paste-back crop box
    shape_hw: tuple[int, int]             # full-image size for paste-back
    future: Future                        # resolves to the (H, W) mask
    submitted: float                      # perf_counter at submit
    deadline: float | None                # absolute perf_counter, or None
    kind: str = "full"                    # full | decode
    concat: np.ndarray | None = None      # full: prepared network input
    guidance: np.ndarray | None = None    # decode: (H, W, 1) guidance
    session: object | None = None        # decode: the sessions.Session
    session_id: str | None = None
    store_session: bool = False           # full: cache the features
    gen_id: int = 0                       # weight generation (swap routing)
    digest: int = 0                       # session: image fingerprint


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
    (``POST /debug/trace``, SIGUSR2 on the HTTP front).  With a split
    predictor, ``session_budget_bytes`` and ``session_ttl_s`` bound the
    session store and ``session_lane_depth`` one session's queued
    requests.  :meth:`swap`, :meth:`promote` and :meth:`rollback` change
    the weights in service without stopping it.  ``aot_cache`` (a path or
    a :class:`.aot.AotCache`) is where :meth:`warmup` loads the bucket
    ladder's compiled programs from; ``strict_retrace=False`` keeps
    serving after a tripped retrace check (counted and reported
    unhealthy all the same).
    """

    def __init__(self, predictor, max_batch: int = 8, queue_depth: int = 64,
                 max_wait_s: float = 0.005,
                 default_deadline_s: float | None = None, trace=None,
                 session_budget_bytes: int = 256 << 20,
                 session_ttl_s: float = 600.0,
                 session_lane_depth: int = 4, aot_cache=None,
                 strict_retrace: bool = True):
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        if max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {max_wait_s}")
        if session_lane_depth < 1:
            raise ValueError(f"session_lane_depth must be >= 1, got "
                             f"{session_lane_depth}")
        self.predictor = predictor
        self.buckets = batching.bucket_sizes(max_batch)
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.default_deadline_s = default_deadline_s
        self.metrics = ServeMetrics()
        self.trace = trace
        self.sessions_enabled = bool(
            getattr(predictor, "supports_sessions", False))
        self.session_lane_depth = session_lane_depth
        self._store = None
        if self.sessions_enabled:
            from .sessions import SessionStore

            self._store = SessionStore(budget_bytes=session_budget_bytes,
                                       ttl_s=session_ttl_s)
        #: weight generations (serve/swap.py): generation 0 is this
        #: predictor; swap() adds canary generations
        from .swap import PredictorPool

        self._pool = PredictorPool(predictor)
        #: queued requests per session (the fairness lane)
        self._lane_lock = threading.Lock()
        self._lanes: dict[str, int] = {}
        #: max_batch - 1 zero feature lanes, of the features' shape and
        #: dtype, whose head pads a decode to its bucket
        self._feat_pad = None
        self._queue: queue.Queue[_Request] = queue.Queue(maxsize=queue_depth)
        if isinstance(aot_cache, (str, os.PathLike)):
            from .aot import AotCache

            aot_cache = AotCache(os.fspath(aot_cache))
        self._aot_cache = aot_cache
        #: the last warmup()'s record (None before one ran)
        self.last_warmup: dict | None = None
        self.strict_retrace = strict_retrace
        from ..utils.compile_watchdog import CompileWatchdog

        #: entered on the worker thread for the service's lifetime
        self._watchdog = CompileWatchdog()
        #: (kind, bucket, predictor key) of every program dispatched, and
        #: of every one a warm-up readied
        self._shapes_dispatched: set[tuple] = set()
        self._warm_shapes: set[tuple] = set()
        self._unhealthy: str | None = None
        self._stop = threading.Event()
        #: "new" (accepting, queued until start) -> "running" -> "stopped"
        self._state = "new"
        self._worker: threading.Thread | None = None

    # ------------------------------------------------------------ lifecycle

    def warmup(self) -> dict:
        """Ready every bucket's program before taking traffic, and return
        (and keep as :attr:`last_warmup`) the record JAX's warm-up gives:
        ``warmup_seconds``, ``programs_compiled``, ``programs_loaded``,
        ``aot_cache`` (``off`` without a cache; ``hit`` when every program
        loaded, ``partial`` when some did, ``miss`` when none did) and
        ``programs``, one ``{"program", "outcome", "fallback", "ms"}`` a
        program.  A split predictor has two programs a bucket (encode and
        decode), a stem predictor one (the whole forward).

        With an ``aot_cache`` each program loads its AOTInductor package
        (``serve/aot.py``), runs it once and installs it in the predictor
        (outcome ``load``): no compile.  A program the cache cannot give
        (a miss: absent, or built for other weights, card, torch, ...; an
        error: a checksum mismatch, a package that does not load) is warmed
        eagerly with a loud stderr line naming why, and a fingerprint that
        cannot be taken disables the cache for the boot, as loudly: a
        cache never stops a boot.  An eagerly warmed program's outcome is
        ``eager``, not JAX's ``compile``, since the port's eager forward
        compiles nothing (its first call at a shape pays cuDNN's algorithm
        choice and, on the card, the kernels' build); it counts in
        ``programs_compiled``, as a fresh compile does in JAX's.  The
        eager forward launches the same kernels: it is the port's ordinary
        serving path, not a fallback that hides a kernel.  Each program's
        outcome and milliseconds go to stderr (``serve/warmup: <program>:
        <outcome> <ms> ms``), and its shape is registered with the retrace
        tripwire."""
        self.last_warmup = self._warm(self.predictor)
        return self.last_warmup

    def _warm(self, pred) -> dict:
        """Every program of ``pred``'s ladder, loaded or warmed eagerly, on
        the calling thread; returns the warm-up record."""
        from .aot import (
            AotCacheError,
            AotCacheMiss,
            cache_fingerprint,
            example_inputs,
            ladder_programs,
        )

        # a plan armed for the boot (DPTPU_CHAOS_PLAN) reaches serve/aot_load
        chaos_sites.maybe_arm_from_env()
        t0 = time.perf_counter()
        cache = self._aot_cache
        fingerprint = None
        if cache is not None:
            try:
                fingerprint = cache_fingerprint(pred)
            except Exception as e:  # fingerprinting never kills a boot
                print(f"serve/aot: cache disabled for this boot — "
                      f"fingerprinting failed ({type(e).__name__}: {e})",
                      file=sys.stderr)
                cache = None
        log: list[dict] = []
        for name, _module, meta, key in ladder_programs(pred, self.buckets):
            p0 = time.perf_counter()
            outcome, fallback = "eager", None
            args = example_inputs(meta, pred.device)
            if cache is not None:
                try:
                    program = cache.load(name, fingerprint)
                    with torch.inference_mode():
                        program(*args)
                    pred.install_aot(key, program)
                    outcome = "load"
                except AotCacheMiss as e:
                    fallback = "miss"
                    print(f"serve/aot: miss for {name!r}: {e} — warming "
                          "eagerly", file=sys.stderr)
                except AotCacheError as e:
                    fallback = "error"
                    print(f"serve/aot: REFUSING cache entry {name!r}: {e} "
                          "— warming eagerly", file=sys.stderr)
                except Exception as e:  # noqa: BLE001 — the backstop: a
                    # bad cache is a slower boot, never a dead one
                    fallback = "error"
                    print(f"serve/aot: unexpected failure loading {name!r} "
                          f"({type(e).__name__}: {e}) — warming eagerly",
                          file=sys.stderr)
            if outcome == "eager":
                self._warm_eagerly(pred, key, args)
            self._warm_shapes.add(self._shape_key(key, pred))
            ms = (time.perf_counter() - p0) * 1e3
            log.append({"program": name, "outcome": outcome,
                        "fallback": fallback, "ms": round(ms, 3)})
            print(f"serve/warmup: {name}: {outcome} {ms:.1f} ms"
                  + (f" (cache {fallback})" if fallback else ""),
                  file=sys.stderr)
        loaded = sum(1 for e in log if e["outcome"] == "load")
        compiled = len(log) - loaded
        if self._aot_cache is None:
            aot = "off"
        elif compiled == 0 and loaded:
            aot = "hit"
        elif loaded:
            aot = "partial"
        else:
            aot = "miss"
        return {"warmup_seconds": round(time.perf_counter() - t0, 4),
                "programs_compiled": compiled,
                "programs_loaded": loaded,
                "aot_cache": aot,
                "programs": log}

    @staticmethod
    def _warm_eagerly(pred, key: tuple, args: tuple) -> None:
        """One eager call of the stage ``key`` names, on its zero inputs."""
        kind = key[0]
        if kind == "forward":
            pred.forward_prepared(args[0])
        elif kind == "encode":
            pred.encode(args[0])
        else:
            pred.decode(*args)

    def _shape_key(self, key: tuple, pred) -> tuple:
        """The tripwire's key of a program: its kind, its bucket and its
        predictor (:meth:`_pred_key`)."""
        kind, shape = key
        bucket = shape[0] if kind == "forward" else shape
        return (kind, bucket, self._pred_key(pred))

    @staticmethod
    def _pred_key(pred) -> int:
        """A predictor's tag in the tripwire's keys: each generation has its
        own programs, so an unwarmed swapped-in generation's first
        dispatches are new shapes, not retraces.  ``id()`` is stable while
        the pool holds the predictor; a later predictor that reuses a
        retired one's id inherits one ladder of budget, accepted for the
        simplicity (as in JAX)."""
        return id(pred)

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
               deadline_s: float | None = None,
               session_id: str | None = None) -> Future:
        """Enqueue one request; returns a Future resolving to the mask.

        Raises :class:`QueueFullError` at once when the queue is full,
        :class:`SessionLaneFullError` when ``session_id`` already holds
        ``session_lane_depth`` queued requests,
        :class:`ServiceUnhealthyError` when the service is stopped or (with
        ``strict_retrace``) tripped unhealthy, and
        ``ValueError`` for bad inputs, before anything is queued.
        ``session_id`` (a split predictor only) makes the click part of a
        session: the first encodes and caches the crop's features, later
        clicks inside the crop only decode."""
        if self._state == "stopped":
            raise ServiceUnhealthyError("service stopped")
        if self._unhealthy and self.strict_retrace:
            raise ServiceUnhealthyError(self._unhealthy)
        if session_id is not None and not self.sessions_enabled:
            raise ValueError(
                "session_id needs a split predictor (model built with "
                "guidance_inject='head'); this service's predictor folds "
                "the guidance into the backbone — submit statelessly")
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
        if session_id is not None:
            self._reserve_lane(session_id, check_only=True)
        req = self._build_request(image, points, deadline_s, session_id)
        # the lane slot and the generation's in-flight count are booked
        # before the enqueue: booked after, the sweep could retire a
        # generation whose request is already queued
        self._track_request(req)
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            self._untrack_request(req.session_id, req.gen_id)
            self.metrics.count("shed_queue_full")
            raise QueueFullError(
                f"request queue full ({self._queue.maxsize} deep) — "
                "overloaded; retry with backoff") from None
        self.metrics.count("requests")
        if self._state == "stopped":
            # raced a concurrent stop() past its queue drain
            self._fail_stopped(req.future)
        return req.future

    def _build_request(self, image, points, deadline_s,
                       session_id) -> _Request:
        """Route and host-preprocess one request on the caller's thread."""
        now = time.perf_counter()
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        deadline = None if deadline_s is None else now + deadline_s
        shape_hw = tuple(np.asarray(image).shape[:2])
        if session_id is None:
            gen_id, pred = self._pool.route(None)
            concat, bbox = pred.prepare(image, points)
            return _Request(concat=concat, bbox=bbox, shape_hw=shape_hw,
                            gen_id=gen_id, future=Future(), submitted=now,
                            deadline=deadline)
        from .sessions import image_digest

        # the warm path skips prepare_input, so it validates the clicks
        # as prepare_input does: a bad click is a ValueError on every path
        pts = np.asarray(points, np.float64)
        if pts.shape != (4, 2):
            raise ValueError(f"expected 4 xy extreme points, got {pts.shape}")
        h_img, w_img = shape_hw
        if (pts[:, 0].max() >= w_img or pts[:, 1].max() >= h_img
                or pts.min() < 0):
            raise ValueError(f"points {pts.tolist()} outside image "
                             f"{w_img}x{h_img}")
        digest = image_digest(image)
        sess = self._store.get(session_id)
        pred = (None if sess is None
                else self._pool.predictor_for(sess.generation))
        if pred is not None and sess.covers(pts, shape_hw, digest=digest):
            # warm click: only the guidance is drawn, in the session's
            # crop, and the decode runs on the generation that encoded the
            # features (a session whose generation was retired under it
            # takes the cold path below)
            self._store.hit()
            return _Request(kind="decode",
                            guidance=pred.prepare_guidance(pts, sess.bbox),
                            session=sess, session_id=session_id,
                            bbox=sess.bbox, shape_hw=sess.shape_hw,
                            gen_id=sess.generation, digest=digest,
                            future=Future(), submitted=now,
                            deadline=deadline)
        # cold click: a new or expired session, clicks outside its crop,
        # or another image under the same id
        self._store.miss()
        gen_id, pred = self._pool.route(session_id)
        concat, bbox = pred.prepare(image, pts)
        return _Request(concat=concat, bbox=bbox, shape_hw=shape_hw,
                        session_id=session_id, store_session=True,
                        gen_id=gen_id, digest=digest, future=Future(),
                        submitted=now, deadline=deadline)

    def _reserve_lane(self, session_id: str, check_only: bool = False
                      ) -> None:
        """Take one of ``session_id``'s lane slots, or only check that one
        is free (the cheap shed before the host preprocessing); the
        check-and-take under one lock is the authoritative one."""
        with self._lane_lock:
            n = self._lanes.get(session_id, 0)
            if n >= self.session_lane_depth:
                self.metrics.count("shed_session_lane")
                raise SessionLaneFullError(
                    f"session {session_id!r} already holds "
                    f"{self.session_lane_depth} queued request(s) — one "
                    "session cannot starve the others; retry with backoff")
            if not check_only:
                self._lanes[session_id] = n + 1

    def _track_request(self, req: _Request) -> None:
        """Take the request's lane slot (authoritatively) and book it in
        flight on its generation; the future gives both back when it
        resolves, however it resolves.  The callback holds the session id
        and the generation, not the request: a request it held would form
        a cycle with its future, and keep an evicted session's features on
        the card until the cyclic garbage collector ran."""
        sid, gen = req.session_id, req.gen_id
        if sid is not None:
            self._reserve_lane(sid)
        self._pool.track_inflight(gen, +1)
        req.future.add_done_callback(
            lambda _f: self._untrack_request(sid, gen))

    def _untrack_request(self, sid: str | None, gen: int) -> None:
        if sid is not None:
            with self._lane_lock:
                n = self._lanes.get(sid, 1) - 1
                if n <= 0:
                    self._lanes.pop(sid, None)
                else:
                    self._lanes[sid] = n
        self._pool.track_inflight(gen, -1)

    def predict(self, image: np.ndarray, points: Any,
                deadline_s: float | None = None,
                timeout: float | None = None,
                session_id: str | None = None) -> np.ndarray:
        """Blocking convenience: :meth:`submit` + ``Future.result``."""
        return self.submit(image, points, deadline_s,
                           session_id=session_id).result(timeout)

    # ------------------------------------------------------------- hot swap

    #: "leave the pool's promote_after alone", apart from the meaningful
    #: None (manual promotion only)
    _UNSET = object()

    def swap(self, predictor, label: str = "",
             canary_fraction: float | None = None, warmup: bool = True,
             min_observations: int | None = None,
             max_error_rate: float | None = None,
             promote_after=_UNSET) -> int:
        """Admit ``predictor`` (a new weight set, e.g. from
        :func:`.swap.load_swap_predictor`) as the canary generation and
        return its id.  Live sessions keep decoding on their generation;
        a ``canary_fraction`` of new sessions and stateless requests goes
        to the new weights until :meth:`promote` or :meth:`rollback`, or
        the pool's own decision from the outcomes it observes (a NaN
        checkpoint rolls back on its first poisoned output).  The warm-up
        of the new predictor's buckets runs here, on the calling thread,
        before any request is routed to it, through the AOT cache where
        there is one (a miss unless it was built for these weights), and
        its programs are registered with the retrace tripwire under its
        own key."""
        from .swap import SwapInProgressError

        if self.sessions_enabled and not getattr(
                predictor, "supports_sessions", False):
            raise ValueError(
                "swap: this service serves sessions; the new predictor "
                "must keep the encode/decode split "
                "(guidance_inject='head')")
        if tuple(predictor.resolution) != tuple(self.predictor.resolution):
            raise ValueError(
                f"swap: resolution {predictor.resolution} != the "
                f"service's {self.predictor.resolution} — the bucket "
                "ladder and the paste-back are resolution-keyed")
        if self._pool.canary_generation is not None:
            # before the warm-up and before any threshold changes: a
            # refused swap leaves the undecided canary as it was
            # (begin_swap checks again under its lock)
            raise SwapInProgressError(
                f"generation {self._pool.canary_generation} is still "
                "canarying — promote() or rollback() before swapping "
                "again")
        if warmup:
            self._warm(predictor)
        gen = self._pool.begin_swap(predictor, label=label,
                                    canary_fraction=canary_fraction)
        # thresholds only after a successful admission: they configure
        # this canary's decision, not one already running
        if min_observations is not None:
            self._pool.min_observations = int(min_observations)
        if max_error_rate is not None:
            self._pool.max_error_rate = float(max_error_rate)
        if promote_after is not InferenceService._UNSET:
            self._pool.promote_after = promote_after
        return gen

    def promote(self) -> dict:
        """Promote the canary to active; the old active generation drains
        (serves its remaining sessions) and retires when empty."""
        return self._pool.promote()

    def rollback(self) -> dict:
        """Roll the canary back; its sessions are evicted (their features
        came from the rolled-back weights) and re-encode cold on the
        active generation at their next click."""
        gen = self._pool.canary_generation
        out = self._pool.rollback()
        if gen is not None and self._store is not None:
            self._store.evict_generation(gen)
        return out

    def health(self) -> dict:
        """Liveness and the counters a probe reads; ``unhealthy_reason`` is
        the tripped retrace check's message, or None."""
        return {
            "ok": self._state == "running" and (
                self._worker is not None and self._worker.is_alive())
            and self._unhealthy is None,
            "state": self._state,
            "unhealthy_reason": self._unhealthy,
            "device": str(self.predictor.device),
            "queue_depth": self._queue.qsize(),
            "queue_capacity": self._queue.maxsize,
            "buckets": list(self.buckets),
            "stats": self.metrics.snapshot(),
            "sessions": (self._store.snapshot()
                         if self._store is not None else None),
            "swap": self._pool.snapshot(),
        }

    @property
    def compile_counts(self) -> dict:
        """Compiles the worker's lifetime watchdog has seen, by name."""
        return dict(self._watchdog.counts)

    # ------------------------------------------------------------ worker

    def _run(self) -> None:
        # the watchdog counts the compiles of the thread that entered it:
        # this one, where every dispatch happens
        with self._watchdog:
            self._serve()
        if self.trace is not None:
            self.trace.close()

    def _serve(self) -> None:
        last_sweep = time.perf_counter()
        while not self._stop.is_set():
            batch = self._gather()
            if self.trace is not None:
                # 1 step per batch, 0 on idle polls so the wall-clock
                # backstop still closes a capture when traffic stops
                self.trace.tick(1 if batch else 0)
            now = time.perf_counter()
            if now - last_sweep > 1.0:
                # housekeeping between drains, before the drained batch
                # runs: reap abandoned sessions, retire drained
                # generations (a stateless service that swaps frees its
                # old weights too); a generation a batch's outcome just
                # drained retires at a later sweep, after its clients
                # have their answers and can read its state
                last_sweep = now
                if self._store is not None:
                    self._store.sweep()
                freed = self._pool.gc(self._store.counts_by_generation()
                                      if self._store is not None else {})
                if freed and not self._pool.is_resident(self.predictor):
                    # the first predictor's generation retired: point at
                    # the active one, or this reference would keep the old
                    # weights on the card for the service's lifetime (the
                    # settings are the same: load_swap_predictor inherits
                    # them)
                    self.predictor = self._pool.active_predictor
            if batch:
                self._process(batch)

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
        # one dispatch group per (kind, generation), in drain order: warm
        # clicks of any sessions decode together, cold and stateless ones
        # run whole, and two generations never share a batch (their
        # weights differ)
        groups: dict[tuple[str, int], list[_Request]] = {}
        for req in live:
            groups.setdefault((req.kind, req.gen_id), []).append(req)
        for (kind, gen_id), reqs in groups.items():
            self._dispatch_group(kind, gen_id, reqs)

    def _dispatch_group(self, kind: str, gen_id: int,
                        live: list[_Request]) -> None:
        try:
            bucket = batching.bucket_for(len(live), self.buckets)
            if kind == "decode":
                probs, gen_used = self._decode_batch(gen_id, live, bucket)
            else:
                probs, gen_used = self._full_batch(gen_id, live, bucket)
            self._check_retrace()
            for i, req in enumerate(live):
                req.future.set_result(self.predictor.paste_back(
                    probs[i], req.bbox, req.shape_hw))
        except Exception as e:  # fail this batch, keep serving
            failed = 0
            for req in live:
                if not req.future.done():
                    req.future.set_exception(e)
                    failed += 1
                self._observe_generation(
                    gen_id, ok=False,
                    nonfinite=isinstance(e, _NonFiniteOutputError))
            self.metrics.count("failed", failed)
            return
        self.metrics.observe_batch(bucket, len(live))
        self.metrics.count("completed", len(live))
        done = time.perf_counter()
        for req in live:
            self.metrics.observe_latency(done - req.submitted)
            self._observe_generation(gen_used, ok=True)

    def _full_batch(self, gen_id: int, live: list[_Request],
                    bucket: int) -> tuple[np.ndarray, int]:
        """Cold and stateless requests at one bucket; returns the
        probabilities and the generation that served them.  A canary's
        non-finite output is served again by the active generation, so
        the clients get masks and the canary is observed non-finite."""
        padded = batching.pad_to_bucket(
            np.stack([r.concat for r in live]), bucket)
        probs, feats = self._run_full(self._pool.predictor_for(gen_id),
                                      padded, bucket)
        if not np.isfinite(probs[:len(live)]).all():
            active = self._pool.active_generation
            if gen_id == active:
                raise _NonFiniteOutputError(
                    f"non-finite probabilities from active generation "
                    f"{gen_id}")
            # blame the canary's weights only if the active generation
            # serves the same batch finitely: a request with NaN pixels
            # poisons every generation alike
            probs2, feats2 = self._run_full(
                self._pool.predictor_for(active), padded, bucket)
            if not np.isfinite(probs2[:len(live)]).all():
                raise _NonFiniteInputError(
                    "non-finite probabilities from BOTH generations — "
                    "the request input is poisoned, not the weights")
            self._observe_generation(gen_id, ok=False, nonfinite=True)
            gen_id, probs, feats = active, probs2, feats2
        for i, req in enumerate(live):
            if req.store_session:
                with torch.inference_mode():
                    lane = feats[i:i + 1].clone()
                self._store.put(req.session_id, lane, req.bbox,
                                req.shape_hw, gen_id, digest=req.digest)
        return batching.unpad(probs, len(live)), gen_id

    def _run_full(self, pred, padded: np.ndarray, bucket: int):
        """(probabilities, features or None) of one padded bucket.  A
        split predictor runs its two stages here, the same two its
        ``forward_prepared`` runs, so a cold click's mask is the stateless
        one, bit for bit; a cold click's features stay on the device in
        the store (a copy of its lane, so the bucket's batch is not kept
        alive).  The programs are registered with the tripwire after they
        ran: a dispatch that failed leaves no shape behind."""
        key = self._pred_key(pred)
        if not pred.supports_sessions:
            probs = pred.forward_prepared(padded)
            self._shapes_dispatched.add(("forward", bucket, key))
            return probs, None
        feats = pred.encode(padded[..., :-1])
        probs = pred.decode(feats, padded[..., -1:])
        self._shapes_dispatched.add(("encode", bucket, key))
        self._shapes_dispatched.add(("decode", bucket, key))
        return probs, feats

    def _decode_batch(self, gen_id: int, live: list[_Request],
                      bucket: int) -> tuple[np.ndarray, int]:
        """Warm clicks of many sessions in one bucketed decode: their
        cached features are concatenated on the device, padded with
        cached zero lanes, and never leave it."""
        pred = self._pool.predictor_for(gen_id)
        guidance = batching.pad_to_bucket(
            np.stack([r.guidance for r in live]), bucket)
        feats = [r.session.features for r in live]
        n_pad = bucket - len(feats)
        with torch.inference_mode():
            if n_pad:
                pad = self._feat_pad
                if pad is None or pad.shape[1:] != feats[0].shape[1:] \
                        or pad.dtype != feats[0].dtype:
                    pad = self._feat_pad = torch.zeros(
                        (self.max_batch - 1, *feats[0].shape[1:]),
                        dtype=feats[0].dtype, device=feats[0].device)
                feats = feats + [pad[:n_pad]]
            batch = torch.cat(feats) if len(feats) > 1 else feats[0]
        probs = pred.decode(batch, guidance)
        self._shapes_dispatched.add(("decode", bucket, self._pred_key(pred)))
        if not np.isfinite(probs[:len(live)]).all():
            # a decode has no image to encode again, so no failover; a
            # poisoned canary is caught at its cold click, so this is a
            # generation that went bad after admission: fail the group,
            # and the observation rolls a canary back
            raise _NonFiniteOutputError(
                f"non-finite probabilities decoding generation {gen_id}")
        for req in live:
            self._store.touch_click(req.session)
        return batching.unpad(probs, len(live)), gen_id

    def _observe_generation(self, gen_id: int, ok: bool,
                            nonfinite: bool = False) -> None:
        """Report one outcome to the pool and apply its decision: a
        rollback evicts that generation's sessions (features must never
        outlive their weights)."""
        action = self._pool.observe(gen_id, ok=ok, nonfinite=nonfinite)
        if action == "rolled_back" and self._store is not None:
            self._store.evict_generation(gen_id)

    def _check_retrace(self) -> None:
        """One compile per program, ever: more compiles on the worker than
        programs dispatched that no warm-up readied is a steady-state
        retrace.  Warmed programs are outside the budget, so that the first
        compile at a warmed shape trips it.  The port's forwards compile
        nothing, so the count stays 0 unless something on the serving path
        starts compiling."""
        compiles = self._watchdog.total
        budget = len(self._shapes_dispatched - self._warm_shapes)
        if compiles > budget:
            self.metrics.count("retrace_failures")
            self._unhealthy = (
                f"steady-state retrace: {compiles} compiles on the serving "
                f"thread for {budget} cold program shapes (counts: "
                f"{dict(self._watchdog.counts)})")
