"""Session-affine feature cache: pay the backbone once per image, not per
click.  The counterpart of ``distributedpytorch_tpu/serve/sessions.py``.

The workload is interactive: a user places extreme points, gets a mask and
refines it with further clicks on the same image.  With a split predictor
(``predict.Predictor.supports_sessions``, a ``guidance_inject="head"``
DANet) the backbone's encoding of the session's crop is a function of the
image alone, so it is computed once on the first (cold) click and kept on
the card; every later (warm) click re-synthesises only the guidance and
pays a decode.

This module is the store; queueing and dispatch live in
:class:`.service.InferenceService`.  The store owns:

* **Device-resident entries.**  ``Session.features`` is the encoded
  (1, C_feat, H / os, W / os) feature tensor on the card, never copied to
  the host: a cache that moved features through host memory would pay two
  PCIe copies a warm click.
* **A byte budget.**  ``put`` evicts the least recently used entries until
  the new one fits; the new entry is always admitted, so resident bytes
  are bounded by ``max(budget_bytes, one entry)``.  One 512² OS 8
  ResNet-101 session is 64·64·2048·4 B = 32 MiB in float32 (16 MiB in
  bf16); a 64² ResNet-18 one is 8·8·512·4 B = 128 KiB.
* **TTL expiry.**  A session expires ``ttl_s`` after its last use, reaped
  lazily on access and by the service worker's :meth:`SessionStore.sweep`.
* **Generations.**  Each entry records the weight generation that
  encoded it (:mod:`.swap`): its warm clicks decode on that generation
  for the session's life.  The service evicts a rolled-back generation's
  entries (``evict_generation``) and retires a drained generation once
  ``counts_by_generation`` holds none of its sessions.

The gauges ``serve_session_live_bytes`` and ``serve_sessions_live`` and the
counters ``serve_session_evictions_total{reason=ttl|lru|explicit|
generation}``, ``serve_session_hits_total`` and
``serve_session_misses_total`` live in the process-wide telemetry registry.
"""

from __future__ import annotations

import collections
import threading
import time
import zlib

import numpy as np

from ..telemetry.registry import MetricsRegistry, get_registry

#: eviction reasons: the counter's closed label set
EVICT_REASONS = ("ttl", "lru", "explicit", "generation")


def image_digest(image) -> int:
    """Identity fingerprint of the whole image (crc32 of its bytes and its
    shape), so a reused session id with a different image of the same
    size re-encodes instead of decoding the old image's features."""
    arr = np.ascontiguousarray(np.asarray(image))
    return zlib.crc32(arr.tobytes()) ^ hash(arr.shape) & 0xFFFFFFFF


def nbytes_of(features) -> int:
    """Bytes held by a feature tensor (or a numpy stand-in)."""
    if hasattr(features, "element_size"):
        return int(features.numel() * features.element_size())
    return int(np.prod(features.shape) * np.dtype(features.dtype).itemsize)


class Session:
    """One live session: the cached encoding and its crop frame."""

    __slots__ = ("session_id", "features", "bbox", "shape_hw", "generation",
                 "nbytes", "created", "last_used", "clicks", "digest")

    def __init__(self, session_id: str, features, bbox, shape_hw,
                 generation: int, now: float, digest: int = 0):
        self.session_id = session_id
        self.features = features
        self.bbox = tuple(int(v) for v in bbox)
        self.shape_hw = tuple(int(v) for v in shape_hw)
        self.generation = int(generation)
        self.nbytes = nbytes_of(features)
        self.created = now
        self.last_used = now
        self.clicks = 1
        self.digest = int(digest)

    def covers(self, points, shape_hw, digest: int | None = None) -> bool:
        """Whether a later click can reuse this entry: the clicks fall
        inside the session's crop (the guidance is drawn in its
        coordinates) and the image is the one the features encode (size
        and content fingerprint).  A different image under a reused id
        re-encodes; it never gets a mask from another image's features."""
        if tuple(int(v) for v in shape_hw) != self.shape_hw:
            return False
        if digest is not None and digest != self.digest:
            return False
        pts = np.asarray(points, np.float64)
        x0, y0, x1, y1 = self.bbox
        return bool((pts[:, 0] >= x0).all() and (pts[:, 0] <= x1).all()
                    and (pts[:, 1] >= y0).all() and (pts[:, 1] <= y1).all())


class SessionStore:
    """TTL + LRU session cache under a device-byte budget.

    Thread-safe: the service's submitting threads and its worker share
    it; every mutation happens under one lock, and the stored feature
    tensors are never written."""

    def __init__(self, budget_bytes: int = 256 << 20, ttl_s: float = 600.0,
                 registry: MetricsRegistry | None = None):
        if budget_bytes < 1:
            raise ValueError(f"budget_bytes must be >= 1, got {budget_bytes}")
        if ttl_s <= 0:
            raise ValueError(f"ttl_s must be > 0, got {ttl_s}")
        self.budget_bytes = int(budget_bytes)
        self.ttl_s = float(ttl_s)
        self._lock = threading.Lock()
        #: insertion and use order is the LRU order (move_to_end on touch)
        self._entries: collections.OrderedDict[str, Session] = \
            collections.OrderedDict()
        self._live_bytes = 0
        reg = registry or get_registry()
        self._g_bytes = reg.gauge(
            "serve_session_live_bytes",
            "device bytes held by cached session encodings")
        self._g_live = reg.gauge(
            "serve_sessions_live", "live interactive sessions")
        self._c_evict = {
            reason: reg.counter(
                "serve_session_evictions_total",
                "session-cache evictions", labels={"reason": reason})
            for reason in EVICT_REASONS}
        self._c_hit = reg.counter(
            "serve_session_hits_total",
            "warm clicks served from the feature cache")
        self._c_miss = reg.counter(
            "serve_session_misses_total",
            "clicks that had to (re-)encode (new/expired/out-of-crop)")
        #: registry values at construction: the registry keeps process
        #: totals, this store reports its own deltas
        self._base = {
            "hits": self._c_hit.value, "misses": self._c_miss.value,
            **{f"evict_{r}": c.value for r, c in self._c_evict.items()}}

    def get(self, session_id: str, now: float | None = None
            ) -> Session | None:
        """The live entry (LRU-touched), or None; an expired entry is
        reaped here.  Hits and misses are the caller's to count
        (:meth:`hit`, :meth:`miss`): a click outside the crop misses after
        a successful get."""
        now = time.monotonic() if now is None else now
        with self._lock:
            sess = self._entries.get(session_id)
            if sess is None:
                return None
            if now - sess.last_used > self.ttl_s:
                self._drop(session_id, "ttl")
                return None
            sess.last_used = now
            self._entries.move_to_end(session_id)
            return sess

    def hit(self) -> None:
        self._c_hit.inc()

    def miss(self) -> None:
        self._c_miss.inc()

    def put(self, session_id: str, features, bbox, shape_hw,
            generation: int = 0, now: float | None = None,
            digest: int = 0) -> Session:
        """Install or replace an entry, evicting LRU entries until it fits
        the budget; the new entry is always admitted."""
        now = time.monotonic() if now is None else now
        sess = Session(session_id, features, bbox, shape_hw, generation,
                       now, digest=digest)
        with self._lock:
            if session_id in self._entries:
                self._drop(session_id, "explicit")
            while (self._entries
                   and self._live_bytes + sess.nbytes > self.budget_bytes):
                self._drop(next(iter(self._entries)), "lru")
            self._entries[session_id] = sess
            self._live_bytes += sess.nbytes
            self._publish()
            return sess

    def touch_click(self, sess: Session) -> None:
        with self._lock:
            sess.clicks += 1

    def sweep(self, now: float | None = None) -> int:
        """Reap every expired entry; returns how many went."""
        now = time.monotonic() if now is None else now
        with self._lock:
            expired = [sid for sid, s in self._entries.items()
                       if now - s.last_used > self.ttl_s]
            for sid in expired:
                self._drop(sid, "ttl")
            return len(expired)

    def evict(self, session_id: str, reason: str = "explicit") -> bool:
        with self._lock:
            if session_id not in self._entries:
                return False
            self._drop(session_id, reason)
            return True

    def evict_generation(self, generation: int) -> int:
        """Drop every session encoded by ``generation``."""
        with self._lock:
            doomed = [sid for sid, s in self._entries.items()
                      if s.generation == generation]
            for sid in doomed:
                self._drop(sid, "generation")
            return len(doomed)

    @property
    def live_bytes(self) -> int:
        with self._lock:
            return self._live_bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def counts_by_generation(self) -> dict[int, int]:
        with self._lock:
            return dict(collections.Counter(
                s.generation for s in self._entries.values()))

    def snapshot(self) -> dict:
        """One dict for ``/healthz`` and ``health()["sessions"]``."""
        with self._lock:
            return {
                "live": len(self._entries),
                "live_bytes": self._live_bytes,
                "budget_bytes": self.budget_bytes,
                "ttl_s": self.ttl_s,
                "by_generation": {
                    str(g): n
                    for g, n in sorted(collections.Counter(
                        s.generation
                        for s in self._entries.values()).items())},
                "evictions": {
                    r: int(c.value - self._base[f"evict_{r}"])
                    for r, c in self._c_evict.items()},
                "hits": int(self._c_hit.value - self._base["hits"]),
                "misses": int(self._c_miss.value - self._base["misses"]),
            }

    def _drop(self, session_id: str, reason: str) -> None:
        """Remove one entry; the caller holds the lock."""
        sess = self._entries.pop(session_id)
        self._live_bytes -= sess.nbytes
        self._c_evict[reason].inc()
        self._publish()

    def _publish(self) -> None:
        self._g_bytes.set(float(self._live_bytes))
        self._g_live.set(float(len(self._entries)))
