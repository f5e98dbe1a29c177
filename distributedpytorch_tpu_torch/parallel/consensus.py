"""Replicated decisions: one all-gather, one deterministic reduce, one
answer on every rank — the counterpart of
``distributedpytorch_tpu/parallel/consensus.py``.

    decided = replicated_decision(local_value, reduce="max")

Every process contributes its local value, every process receives the
per-process list in rank order, and every process applies the same
deterministic reduce to it, so the decision is identical everywhere by
construction.  ``reduce="same"`` demands that the inputs already agree and
raises :class:`ConsensusError` naming every process's value when they do
not.  It is a collective: every rank calls it at the same point with the
same ``reduce``.  Values must be JSON-encodable (the JAX package's wire;
tuples come back as lists).  Without a process group the gather is
``[value]`` and the reduce applies unchanged.

The pure core (:func:`reduce_decision`, :data:`REDUCERS`,
:class:`ConsensusError`) is a copy of the JAX module's, which the tests
hold it to; the gather is ``torch.distributed.all_gather_object``.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Sequence

import torch.distributed as dist


class ConsensusError(RuntimeError):
    """Per-process inputs diverged and the reduce cannot reconcile them
    (``reduce="same"``)."""

    def __init__(self, label: str, values: Sequence[Any]):
        self.label = label
        self.values = list(values)
        shown = ", ".join(f"p{i}={v!r}" for i, v in enumerate(values))
        super().__init__(
            f"replicated_decision({label!r}): per-process values diverged "
            f"and reduce='same' cannot reconcile them: {shown[:800]}")


def _same(label: str, values: list) -> Any:
    keys = [json.dumps(v, sort_keys=True) for v in values]
    if any(k != keys[0] for k in keys[1:]):
        raise ConsensusError(label, values)
    return values[0]


#: named reduces, each deterministic over the rank-ordered gather
REDUCERS: dict[str, Callable[[list], Any]] = {
    "max": max,
    "min": min,
    "sum": sum,
    "mean": lambda vs: sum(vs) / len(vs),
    "any": lambda vs: bool(any(vs)),
    "all": lambda vs: bool(all(vs)),
}


def reduce_decision(values: Sequence[Any], reduce: str | Callable = "same",
                    label: str = "decision") -> Any:
    """One decision from the gathered per-process values: ``reduce`` is a
    name from :data:`REDUCERS`, ``"same"``, or a deterministic callable
    ``list -> decision``."""
    values = list(values)
    if not values:
        raise ValueError(f"replicated_decision({label!r}): empty gather")
    if callable(reduce):
        return reduce(values)
    if reduce == "same":
        return _same(label, values)
    try:
        fn = REDUCERS[reduce]
    except KeyError:
        raise ValueError(
            f"unknown reduce {reduce!r} — one of "
            f"{['same', *REDUCERS]} or a deterministic callable") from None
    return fn(values)


def gather_values(value: Any) -> list:
    """Every process's ``value`` in rank order, on every process, through
    its JSON form; ``[value]`` without a process group."""
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return [value]
    out: list = [None] * dist.get_world_size()
    dist.all_gather_object(out, json.dumps(value, sort_keys=True))
    return [json.loads(v) for v in out]


def replicated_decision(value: Any, reduce: str | Callable = "same", *,
                        label: str = "decision",
                        _gather: Callable[[Any], list] | None = None) -> Any:
    """One decision, identical on every process: all-gather ``value``,
    apply the deterministic ``reduce``, return the result.  ``_gather``
    is the test seam: a fake per-process gather."""
    return reduce_decision((_gather or gather_values)(value), reduce, label)
