"""The sharding-strategy planner, the counterpart of
``distributedpytorch_tpu/parallel/plan.py`` for the data-only rungs.

``parallel.strategy`` names a strategy and the planner resolves it into a
validated :class:`Plan`, whose JSON :meth:`Plan.block` is recorded in
``fit_summary.json`` and in every checkpoint's meta::

    dp            (n, 1)   replicated state, DDP's gradient all-reduce
    dp_zero1      (n, 1)   + optimizer state sharded over the ranks
                           (``ZeroRedundancyOptimizer``, ``parallel/zero.py``)

``dp_tp``, ``dp_tp_zero1`` and ``auto`` (whose ladder walks the
tensor-parallel rungs) are not ported and raise ``NotImplementedError``
naming the strategy.  ``n_devices`` is the world size: the port runs one
process per card.  Unset, the strategy follows the legacy ``mesh.*``
knobs, ``mesh.shard_opt_state`` giving ``dp_zero1``.  The messages,
:func:`normalized_block`, :func:`plans_differ`,
:func:`plan_record_block` and :func:`reduce_buckets_conflict` are copies
of the JAX module's, held to it by the tests.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from .mesh import data_axis_size

#: resolvable strategies, in ladder order
STRATEGIES = ("dp", "dp_zero1", "dp_tp", "dp_tp_zero1")
#: the strategies this port runs
PORTED_STRATEGIES = ("dp", "dp_zero1")

_SHARD_PARAMS = {"dp_tp", "dp_tp_zero1"}
_SHARD_OPT = {"dp_zero1", "dp_tp_zero1"}

#: strategies the bucketed all-reduce (train.reduce_buckets) composes with
BUCKET_COMPATIBLE = ("dp", "dp_zero1")

#: reduce_buckets rejection: the nearest strategy that keeps the buckets
NEAREST_BUCKET_STRATEGY = {"dp_tp": "dp", "dp_tp_zero1": "dp_zero1"}


class PlanError(ValueError):
    """An unresolvable or inconsistent parallel plan."""


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (parallel.strategy dp | dp_zero1)")


def topology_fingerprint(n_devices: int | None = None,
                         platform: str | None = None) -> str:
    """``"<platform>:<n_devices>/p<processes>"`` (e.g. ``cuda:2/p2``): the
    live topology a plan was resolved against.  One process per card, so
    the devices are the ranks unless ``n_devices`` says otherwise."""
    procs = data_axis_size()
    if platform is None:
        platform = "cuda" if torch.cuda.is_available() else "cpu"
    return f"{platform}:{int(procs if n_devices is None else n_devices)}/p{procs}"


def fingerprint_devices(fp) -> int | None:
    """The device count a :func:`topology_fingerprint` names (None for
    malformed or absent fingerprints)."""
    try:
        return int(str(fp).split(":", 1)[1].split("/", 1)[0])
    except (IndexError, ValueError):
        return None


@dataclasses.dataclass(frozen=True)
class Plan:
    """One resolved, validated parallel layout (see the JAX ``Plan``)."""

    strategy: str
    data: int | None = None
    model: int = 1
    slices: int = 1
    process_is_granule: bool | None = None
    topology: str | None = None

    @property
    def shard_params(self) -> bool:
        return self.strategy in _SHARD_PARAMS

    @property
    def shard_opt_state(self) -> bool:
        return self.strategy in _SHARD_OPT

    def block(self) -> dict:
        """The JSON record block (schema-stable keys)."""
        return {
            "strategy": self.strategy,
            "data": self.data,
            "model": self.model,
            "slices": self.slices,
            "shard_params": self.shard_params,
            "shard_opt_state": self.shard_opt_state,
            "topology": self.topology,
        }

    def describe(self) -> str:
        d = self.data if self.data is not None else "*"
        s = f"{self.strategy} (data={d} x model={self.model}"
        if self.slices != 1:
            s += f" x slices={self.slices}"
        return s + ")"


def resolve_plan(strategy: str, n_devices: int | None = None,
                 data: int | None = None, model: int = 0, slices: int = 1,
                 process_is_granule: bool | None = None) -> Plan:
    """One concrete strategy -> a validated :class:`Plan` (``dp`` and
    ``dp_zero1``; the tensor-parallel rungs raise ``NotImplementedError``).
    ``n_devices`` defaults to the world size."""
    if strategy not in STRATEGIES:
        raise PlanError(
            f"unknown parallel.strategy {strategy!r} — pick one of "
            f"{list(STRATEGIES)} (or 'auto' to let the memory model "
            "walk that ladder)")
    if strategy not in PORTED_STRATEGIES:
        raise _not_ported(f"parallel.strategy={strategy!r}")
    if model == 0:
        model = 1
    if model != 1:
        raise PlanError(
            f"strategy {strategy!r} has a 1-wide model axis but "
            f"parallel.model={model} — use "
            f"{'dp_tp_zero1' if strategy == 'dp_zero1' else 'dp_tp'} to "
            "make the model axis live")
    if n_devices is None:
        n_devices = data_axis_size()
    if slices != 1:
        raise _not_ported(f"mesh.slices={slices}")
    if data is None:
        data = n_devices
    if data != n_devices:
        raise PlanError(
            f"plan {data}x{model} (x{slices} slices) covers "
            f"{data * model * slices} devices but {n_devices} are "
            "requested — drop parallel.data to derive it")
    return Plan(strategy=strategy, data=data, model=model, slices=slices,
                process_is_granule=process_is_granule)


def plan_from_config(cfg, n_devices: int | None = None) -> Plan:
    """The trainer's entry: ``cfg.parallel`` -> :class:`Plan`, stamped
    with the topology.  With ``parallel.strategy`` unset the legacy
    ``mesh.*`` knobs name the layout; a set strategy owns it, and legacy
    sharding knobs beside it raise."""
    p, m = cfg.parallel, cfg.mesh
    if n_devices is None:
        n_devices = data_axis_size()

    def stamp(plan: Plan) -> Plan:
        return dataclasses.replace(plan,
                                   topology=topology_fingerprint(n_devices))

    if not p.strategy:
        strategy = {(False, False): "dp", (True, False): "dp_tp",
                    (False, True): "dp_zero1", (True, True): "dp_tp_zero1"
                    }[(m.shard_params, m.shard_opt_state)]
        if m.shard_params:
            raise _not_ported("mesh.shard_params=True")
        if m.model != 1 or m.slices != 1:
            raise _not_ported(f"mesh.model={m.model}, mesh.slices={m.slices}")
        return stamp(Plan(strategy=strategy, data=m.data, model=m.model,
                          slices=m.slices,
                          process_is_granule=m.process_is_granule))
    if m.shard_params or m.shard_opt_state or m.model != 1 \
            or m.data is not None:
        raise PlanError(
            f"parallel.strategy={p.strategy!r} owns the mesh layout, "
            "but legacy mesh knobs are also set "
            f"(mesh.data={m.data}, mesh.model={m.model}, "
            f"shard_params={m.shard_params}, "
            f"shard_opt_state={m.shard_opt_state}) — clear them, or "
            "unset parallel.strategy to keep driving the low-level "
            "knobs")
    if p.strategy == "auto":
        raise _not_ported("parallel.strategy='auto'")
    return stamp(resolve_plan(
        p.strategy, n_devices=n_devices, data=p.data,
        model=p.model, slices=m.slices,
        process_is_granule=m.process_is_granule))


def normalized_block(block: Mapping, n_devices: int) -> dict:
    """A :meth:`Plan.block` dict with an implicit ``data=None`` resolved
    against ``n_devices``: the comparison form."""
    out = dict(block)
    if out.get("data") is None:
        model = int(out.get("model") or 1)
        slices = int(out.get("slices") or 1)
        if n_devices % (model * slices) == 0:
            out["data"] = n_devices // (model * slices)
    return out


def plans_differ(saved: Mapping | None, live: Mapping | None,
                 n_devices: int) -> bool:
    """Does a restore from a checkpoint saved under ``saved`` into a run
    planned as ``live`` cross plans?  Layouts compare normalized, each
    side's implicit ``data`` resolved against the topology it names; the
    fingerprints join the comparison only when both sides carry one."""
    if not saved or not live:
        return False
    a = normalized_block(saved,
                         fingerprint_devices(saved.get("topology"))
                         or n_devices)
    b = normalized_block(live, n_devices)
    if a.get("topology") is None or b.get("topology") is None:
        a.pop("topology", None)
        b.pop("topology", None)
    return a != b


def reduce_buckets_conflict(strategy: str) -> PlanError:
    """The rejection of ``train.reduce_buckets`` under a model-axis-sharded
    plan, naming the nearest strategy that keeps the buckets."""
    nearest = NEAREST_BUCKET_STRATEGY.get(strategy, "dp")
    return PlanError(
        f"train.reduce_buckets is incompatible with strategy "
        f"{strategy!r}: the bucketed reduce runs fwd/bwd per-device in "
        "a shard_map whose replicated in_specs cannot express "
        "model-axis-sharded params (TP keeps the GSPMD-implicit "
        f"reduce).  Nearest supported: parallel.strategy={nearest!r} "
        f"(buckets compose with {list(BUCKET_COMPATIBLE)} — ZeRO-1 "
        "lives in the optimizer update outside the shard_map region), "
        "or drop train.reduce_buckets to keep the TP layout")


def plan_record_block(plan: Plan | None,
                      n_devices: int | None = None) -> dict | None:
    """The bench-record ``plan`` block: ``None`` for the plain
    data-parallel default over every device, the full :meth:`Plan.block`
    otherwise."""
    if plan is None:
        return None
    if plan.strategy == "dp" and plan.model == 1 and plan.slices == 1 \
            and plan.data is None:
        return None
    if n_devices is None:
        n_devices = data_axis_size()
    if plan.strategy == "dp" and plan.model == 1 and plan.slices == 1 \
            and plan.data == n_devices:
        return None
    return plan.block()
