"""Host-side spans that nest — and appear in profiler traces by the same
name; the counterpart of ``distributedpytorch_tpu/telemetry/spans.py``.

A :func:`span` is a context manager that (1) times the enclosed host
region, (2) records the duration into the registry histogram
``span_seconds{span="<path>"}`` where ``<path>`` is the slash-joined
nesting (``fit/epoch/checkpoint``), and (3) enters a
``torch.profiler.record_function`` range with the same path, so the
identical names show up in a ``torch.profiler`` trace (``profile_epoch``,
the on-demand trace) next to the kernels they bracket.  One name, three
views: registry percentiles, Prometheus summary, profiler timeline.

``record_function`` costs a few microseconds even with no profiler
running, so spans sit at evaluation, checkpoint and preemption
boundaries only, never per op.  Nesting is thread-local: concurrent
threads (the overlapped validation, the serve worker) each carry their
own span stack, so paths never interleave across threads.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

from .registry import MetricsRegistry, get_registry, is_enabled

_tls = threading.local()


def current_span() -> str:
    """Slash-joined path of the active span stack ('' outside any span)."""
    return "/".join(getattr(_tls, "stack", ()))


@contextlib.contextmanager
def span(name: str, registry: MetricsRegistry | None = None):
    """Time a named, nestable host region; mirror it into profiler traces.

    >>> with span("epoch"):
    ...     with span("checkpoint"):   # records span="epoch/checkpoint"
    ...         ckpt.save(...)

    A profiler failure degrades (the host region still runs and records);
    with telemetry disabled (:func:`registry.set_enabled`) the whole span
    is a no-op.
    """
    if not is_enabled():
        yield name
        return
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(name)
    path = "/".join(stack)
    annotation = None
    try:
        annotation = torch.profiler.record_function(path)
        annotation.__enter__()
    except Exception:
        annotation = None  # never corrupt the stack or kill the region
    t0 = time.perf_counter()
    try:
        yield path
    finally:
        dt = time.perf_counter() - t0
        if annotation is not None:
            try:
                annotation.__exit__(None, None, None)
            except Exception:
                pass
        stack.pop()
        (registry or get_registry()).histogram(
            "span_seconds", "host-side span durations by nested path",
            labels={"span": path}).observe(dt)
