"""Ops surface of the inference service: counters + latency percentiles,
the counterpart of ``distributedpytorch_tpu/serve/metrics.py``.

Storage lives in the process-wide telemetry registry
(:mod:`..telemetry.registry`) under the JAX package's Prometheus names
(``serve_requests_total``, ``serve_batch_dispatches_total{bucket=...}``,
``serve_latency_seconds``, ...), so ``GET /metrics`` exports the serve
counters and any train-side goodput gauges and spans from one surface,
and the same operations render the same text in both packages.  The
:class:`ServeMetrics` view stays per service: each instance snapshots the
registry values at construction and reports deltas ("monotonic since
service start"), while the registry keeps process-lifetime totals.

Latency is end-to-end request latency (submit -> mask handed back):
queue wait + batching wait + forward + paste-back.  Percentiles are
nearest-rank over a bounded reservoir of the most recent samples.
"""

from __future__ import annotations

import collections
import threading

from ..telemetry.registry import MetricsRegistry, get_registry
from ..utils.profiling import percentile

#: counter slug -> help string (also fixes the exported metric set)
_COUNTERS = {
    "requests": "requests accepted into the queue",
    "completed": "requests answered with a mask",
    "failed": "requests answered with an error",
    "shed_queue_full": "requests rejected at the front door (queue full)",
    "shed_session_lane": "requests rejected because one session "
                         "overfilled its per-session lane",
    "shed_deadline": "requests dropped at drain time (deadline blown)",
    "batches": "compiled-forward dispatches",
    "retrace_failures": "steady-state recompiles the watchdog caught",
}


class ServeMetrics:
    """Per-service view over registry-backed counters, a bounded latency
    reservoir and the per-bucket batch tally behind ``/stats``."""

    def __init__(self, reservoir: int = 2048,
                 registry: MetricsRegistry | None = None):
        self._registry = registry or get_registry()
        self._lock = threading.Lock()
        self._c = {name: self._registry.counter(f"serve_{name}_total", help)
                   for name, help in _COUNTERS.items()}
        #: registry values at service start — the delta IS this service
        self._base = {name: c.value for name, c in self._c.items()}
        #: the counters this service has counted (the ``counts`` of /stats)
        self._counted: set[str] = set()
        #: per-bucket dispatch counts {bucket_size: batches}
        self.batch_buckets: collections.Counter = collections.Counter()
        #: per-bucket real-lane totals (padding = bucket*batches - this)
        self.batch_lanes: collections.Counter = collections.Counter()
        self._hist = self._registry.histogram(
            "serve_latency_seconds",
            "end-to-end request latency (submit -> mask)",
            reservoir=reservoir)
        self._latencies = collections.deque(maxlen=reservoir)
        #: per-bucket registry children, cached: the dispatch path pays no
        #: registry get-or-create per batch
        self._bucket_children: dict[int, tuple] = {}

    def __getattr__(self, name: str) -> int:
        # counter reads (metrics.requests, .shed_deadline, ...) — delta
        # against the service-start baseline
        c = self.__dict__.get("_c", {}).get(name)
        if c is None:
            raise AttributeError(name)
        return int(c.value - self.__dict__["_base"][name])

    def count(self, name: str, n: int = 1) -> None:
        self._c[name].inc(n)
        with self._lock:
            self._counted.add(name)

    def observe_batch(self, bucket: int, lanes: int) -> None:
        children = self._bucket_children.get(bucket)
        if children is None:
            children = self._bucket_children[bucket] = (
                self._registry.counter(
                    "serve_batch_dispatches_total",
                    "dispatches per bucket size",
                    labels={"bucket": bucket}),
                self._registry.counter(
                    "serve_batch_lanes_total",
                    "real lanes per bucket size",
                    labels={"bucket": bucket}))
        self._c["batches"].inc()
        children[0].inc()
        children[1].inc(lanes)
        with self._lock:
            self.batch_buckets[bucket] += 1
            self.batch_lanes[bucket] += lanes

    def observe_latency(self, seconds: float) -> None:
        self._hist.observe(seconds)
        with self._lock:
            self._latencies.append(seconds)

    def snapshot(self) -> dict:
        """The ``/stats`` JSON: ``counts`` (each counter this service has
        counted, since its start), ``latency_p50_ms``, ``latency_p99_ms``,
        ``batches_by_bucket`` and ``lane_fill`` (real lanes / dispatched
        lanes)."""
        with self._lock:
            lat = list(self._latencies)
            counted = sorted(self._counted)
            buckets = dict(self.batch_buckets)
            lanes = sum(self.batch_lanes.values())
        p50 = percentile(lat, 50.0) if lat else None
        p99 = percentile(lat, 99.0) if lat else None
        dispatched = sum(b * n for b, n in buckets.items())
        return {
            "counts": {name: int(self._c[name].value - self._base[name])
                       for name in counted},
            "latency_p50_ms": None if p50 is None else p50 * 1e3,
            "latency_p99_ms": None if p99 is None else p99 * 1e3,
            "batches_by_bucket": {str(k): v for k, v in sorted(buckets.items())},
            "lane_fill": lanes / dispatched if dispatched else None,
        }
