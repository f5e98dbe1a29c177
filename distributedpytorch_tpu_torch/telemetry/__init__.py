"""Unified telemetry, the counterpart of ``distributedpytorch_tpu/telemetry``
with the same names (``lowering``, ``timeline`` and ``doctor`` are not
ported: the FLOP count has its own :func:`goodput.step_flops`):

* :mod:`registry`   — thread-safe counters/gauges/histograms
  (:func:`get_registry` is the process singleton);
* :mod:`spans`      — nested host spans mirrored into profiler traces via
  ``torch.profiler.record_function``;
* :mod:`goodput`    — wall-clock attribution ({step, compile, checkpoint,
  eval, input_wait, idle}) and MFU against the card's peak table;
* :mod:`prometheus` — text exposition for ``GET /metrics``;
* :mod:`trace`      — on-demand bounded ``torch.profiler`` capture
  (SIGUSR2 / ``POST /debug/trace``) without restarting the process;
* :mod:`events`     — the flight recorder
  (``run_dir/events/<host>.<pid>.jsonl``).
"""

from . import events, goodput, prometheus, registry, spans, trace
from .events import EventLog, events_block
from .goodput import (
    BUCKETS,
    FeedWindow,
    GoodputAccountant,
    get_accountant,
    mfu_estimate,
    peak_flops_for,
    step_flops,
)
from .prometheus import render_text
from .registry import MetricsRegistry, get_registry, is_enabled, set_enabled
from .spans import current_span, span
from .trace import TraceCapture

__all__ = [
    "BUCKETS", "EventLog", "FeedWindow", "GoodputAccountant",
    "MetricsRegistry", "TraceCapture", "current_span", "events",
    "events_block", "get_accountant", "get_registry", "goodput",
    "is_enabled", "mfu_estimate", "peak_flops_for", "prometheus",
    "registry", "render_text", "set_enabled", "span", "spans",
    "step_flops", "trace",
]
