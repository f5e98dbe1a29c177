"""Prometheus text-exposition rendering of a :class:`MetricsRegistry`,
the counterpart of ``distributedpytorch_tpu/telemetry/prometheus.py``:
the same registry operations render byte-identical text in both
packages.

Text format 0.0.4, with no client library.  Counters and gauges render
directly; histograms render as Prometheus *summaries*
(``name{quantile="0.5"}``, ``name_sum``, ``name_count``): the reservoir
keeps observed samples, so nearest-rank quantiles are exact over the
window.  Served by ``GET /metrics`` on the serve front
(``serve/__main__.py``).
"""

from __future__ import annotations

import math

from .registry import Family, MetricsRegistry, get_registry

#: served with this Content-Type (version is part of the contract)
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_QUANTILES = (0.5, 0.9, 0.99)


def _fmt(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape(v: str) -> str:
    """Label-value escaping (0.0.4 spec): backslash, double-quote, and
    line feed — exactly these three, in this order (backslash first or
    the later escapes get double-escaped)."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    """HELP-text escaping: only backslash and line feed — the spec does
    NOT escape double-quote outside label values, and scrapers take a
    literal ``\\"`` in HELP at face value (two characters, wrong text)."""
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _labels(pairs, extra: tuple = ()) -> str:
    items = [*pairs, *extra]
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_escape(str(v))}"' for k, v in items) + "}"


def _render_family(fam: Family, lines: list[str]) -> None:
    if fam.help:
        lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
    kind = "summary" if fam.kind == "histogram" else fam.kind
    lines.append(f"# TYPE {fam.name} {kind}")
    for child in fam.children():
        if fam.kind == "histogram":
            snap = child.collect(_QUANTILES)  # one lock + one sort
            for q, v in snap["quantiles"].items():
                lines.append(
                    f"{fam.name}"
                    f"{_labels(child.labels, (('quantile', q),))} "
                    f"{_fmt(v)}")
            lines.append(f"{fam.name}_sum{_labels(child.labels)} "
                         f"{_fmt(snap['sum'])}")
            lines.append(f"{fam.name}_count{_labels(child.labels)} "
                         f"{_fmt(snap['count'])}")
        else:
            lines.append(f"{fam.name}{_labels(child.labels)} "
                         f"{_fmt(child.value)}")


def render_text(registry: MetricsRegistry | None = None) -> str:
    """The whole registry as Prometheus text exposition (ends with \\n)."""
    lines: list[str] = []
    for fam in (registry or get_registry()).collect():
        _render_family(fam, lines)
    return "\n".join(lines) + "\n" if lines else "\n"
