"""Process-wide metrics registry: counters, gauges, histograms, the
counterpart of ``distributedpytorch_tpu/telemetry/registry.py`` with the
same names.

One thread-safe, process-wide name -> metric table that the Prometheus
renderer (prometheus.py), the goodput accountant (goodput.py), the span
recorder (spans.py) and the serve counters (``serve/metrics.py``) write
into, and that ``GET /metrics`` on the serve front reads out.

Three primitive kinds:

* :class:`Counter`  — monotonic float (requests served, signals seen);
* :class:`Gauge`    — last-write-wins float (queue depth, goodput ratio);
* :class:`Histogram`— bounded reservoir of recent samples with
  nearest-rank percentiles (:func:`utils.profiling.percentile`) plus
  monotonic ``count``/``sum`` so rates stay derivable after the
  reservoir wraps.

Metrics take Prometheus-style labels: ``registry.counter("x_total",
labels={"bucket": "8"})`` returns the child for that label set; children
of one name form a family that renders together.  Everything is
host-side Python with no device work, so instrumentation can sit at
step-loop boundaries without adding a synchronisation.
"""

from __future__ import annotations

import collections
import re
import threading

from ..utils.profiling import percentile

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: empty-labelset key (the unlabeled child of a family)
_NO_LABELS: tuple = ()


def _label_key(labels: dict | None) -> tuple:
    if not labels:
        return _NO_LABELS
    for k in labels:
        if not _LABEL_RE.match(k):
            raise ValueError(f"bad label name {k!r}")
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic counter.  ``inc`` only; decrements are a bug by type."""

    __slots__ = ("labels", "_lock", "_value")

    def __init__(self, labels: tuple = _NO_LABELS):
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0.0  # guarded by self._lock

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins value; ``inc``/``dec`` for up-down accounting."""

    __slots__ = ("labels", "_lock", "_value")

    def __init__(self, labels: tuple = _NO_LABELS):
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0.0  # guarded by self._lock

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Bounded reservoir of the most recent samples + monotonic totals.

    The reservoir keeps the tail CURRENT (a week-old latency spike must
    not sit in p99 forever); ``count``/``sum`` stay monotonic over the
    process lifetime so Prometheus-side rate() works across the wrap.
    Percentiles are nearest-rank — an observed sample, never an
    interpolation (the convention shared with StepTimer and serve).
    """

    __slots__ = ("labels", "_lock", "_samples", "_count", "_sum")

    def __init__(self, labels: tuple = _NO_LABELS, reservoir: int = 2048):
        self.labels = labels
        self._lock = threading.Lock()
        self._samples: collections.deque = collections.deque(maxlen=reservoir)
        self._count = 0    # guarded by self._lock
        self._sum = 0.0    # guarded by self._lock

    def observe(self, v: float) -> None:
        with self._lock:
            self._samples.append(float(v))
            self._count += 1
            self._sum += float(v)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, q: float) -> float | None:
        with self._lock:
            samples = list(self._samples)
        return percentile(samples, q) if samples else None

    def snapshot(self) -> dict:
        with self._lock:
            samples = list(self._samples)
            count, total = self._count, self._sum
        out = {"count": count, "sum": total, "samples": len(samples)}
        if samples:
            out["p50"] = percentile(samples, 50.0)
            out["p99"] = percentile(samples, 99.0)
            out["max"] = max(samples)
        return out

    def collect(self, qs: tuple = (0.5, 0.9, 0.99)) -> dict:
        """One locked copy + ONE sort serving every requested quantile —
        the scrape-path shape (snapshot()+percentile() per quantile would
        re-sort the reservoir once per value)."""
        import math

        with self._lock:
            ordered = sorted(self._samples)
            count, total = self._count, self._sum
        n = len(ordered)
        quantiles = {q: ordered[min(n, max(1, math.ceil(q * n))) - 1]
                     for q in qs} if n else {}
        return {"count": count, "sum": total, "quantiles": quantiles}


class Family:
    """All children of one metric name (one per label set)."""

    __slots__ = ("kind", "name", "help", "_children", "_lock", "_reservoir")

    def __init__(self, kind: str, name: str, help: str = "",
                 reservoir: int = 2048):
        self.kind = kind
        self.name = name
        self.help = help
        self._children: dict[tuple, object] = {}
        self._lock = threading.Lock()
        self._reservoir = reservoir

    def child(self, labels: dict | None = None):
        key = _label_key(labels)
        with self._lock:
            got = self._children.get(key)
            if got is None:
                cls = {"counter": Counter, "gauge": Gauge}.get(self.kind)
                got = Histogram(key, self._reservoir) if cls is None \
                    else cls(key)
                self._children[key] = got
            return got

    def children(self) -> list:
        with self._lock:
            return [self._children[k] for k in sorted(self._children)]


class MetricsRegistry:
    """Thread-safe name -> :class:`Family` table with get-or-create
    accessors.  Use the process-wide default via :func:`get_registry`;
    construct private instances only in tests."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, Family] = {}

    def _family(self, kind: str, name: str, help: str,
                reservoir: int = 2048) -> Family:
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = Family(kind, name, help, reservoir)
                self._families[name] = fam
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}, "
                    f"requested {kind}")
            if help and not fam.help:
                fam.help = help
            return fam

    def counter(self, name: str, help: str = "",
                labels: dict | None = None) -> Counter:
        return self._family("counter", name, help).child(labels)

    def gauge(self, name: str, help: str = "",
              labels: dict | None = None) -> Gauge:
        return self._family("gauge", name, help).child(labels)

    def histogram(self, name: str, help: str = "",
                  labels: dict | None = None,
                  reservoir: int = 2048) -> Histogram:
        return self._family("histogram", name, help, reservoir).child(labels)

    def collect(self) -> list[Family]:
        """Families sorted by name — the renderer's stable iteration."""
        with self._lock:
            return [self._families[n] for n in sorted(self._families)]


#: the process-wide registry every subsystem shares
REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY


#: process-wide instrumentation switch (config.telemetry): False turns
#: spans, goodput accounting and the preemption publishing into no-ops —
#: the zero-instrumentation baseline the telemetry's cost is read against.
#: Registry WRITES through direct handles (serve counters) stay live:
#: they are the service's own ops surface, not optional instrumentation.
_ENABLED = True


def set_enabled(enabled: bool) -> None:
    global _ENABLED
    _ENABLED = bool(enabled)


def is_enabled() -> bool:
    return _ENABLED
