"""Named injection sites + the process-wide arming flag, the
counterpart of ``distributedpytorch_tpu/chaos/sites.py``.

The seams woven into the port's real code paths (not shadow copies):

* ``trainer/batch_fetch`` — the trainer's batch-fetch boundary, inside
  the same ``input_wait`` goodput account the telemetry books;
* ``trainer/train_step``  — after each train-step dispatch (payload = the
  loss tensor; sigterm here is "preempted between steps");
* ``checkpoint/save``     — after a checkpoint save has landed (``path``
  ctx = the step directory, the truncation fault's target);
* ``checkpoint/restore``  — before a checkpoint restore;
* ``serve/enqueue``       — the serve front door (submit), on the
  caller's thread;
* ``serve/drain``         — the batcher worker, before the forward;
* ``serve/swap_params``   — a hot swap's new weights
  (``serve.swap.load_swap_predictor``; payload = the state dict, a
  ``nan`` fault is a poisoned checkpoint);
* ``device/put``          — the device prefetcher, before it places a
  host batch (``parallel.mesh``; payload = the batch);
* ``serve/aot_load``      — an AOT cache entry's raw bytes before their
  checksum (``serve.aot.AotCache.load``; payload = a uint8 view, a
  ``bitflip`` fault is bit rot the checksum must catch).

:data:`SITES` keeps the JAX package's whole list, so a plan written for
it parses here; the sites whose code the port does not have yet
(``data/packed_read``, ``serve/session_append``, ``serve/route``,
``serve/health_poll``) never fire.

Disabled is the default and it is ~free: ``fire`` loads one module
attribute, sees ``None`` and returns.  ``arm()`` installs a
:class:`faults.FaultPlan` process-wide; ``armed_plan()`` scopes one to a
``with`` block; ``maybe_arm_from_env()`` arms from ``DPTPU_CHAOS_PLAN``
(the JAX package's variable: a JSON file path or inline JSON) so any
entry point can be chaos-tested without code changes.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os

from .faults import FaultPlan

#: the single armed plan (None = chaos disabled, the ~zero-overhead path)
_PLAN: FaultPlan | None = None

#: env var naming a plan: a path to a scenario/plan JSON, or inline JSON
PLAN_ENV = "DPTPU_CHAOS_PLAN"

SITES = (
    "trainer/batch_fetch",
    "trainer/train_step",
    "checkpoint/save",
    "checkpoint/restore",
    "serve/enqueue",
    "serve/drain",
    "serve/swap_params",
    "serve/aot_load",
    "device/put",
    "data/packed_read",
    "serve/session_append",
    "serve/route",
    "serve/health_poll",
)


def arm(plan: FaultPlan) -> FaultPlan:
    """Install ``plan`` process-wide; returns it."""
    global _PLAN
    _PLAN = plan
    return plan


def disarm() -> None:
    global _PLAN
    _PLAN = None


def armed() -> FaultPlan | None:
    """The armed plan, or None."""
    return _PLAN


def active_scenario() -> str | None:
    """The armed plan's name, or None."""
    plan = _PLAN
    return plan.name if plan is not None else None


@contextlib.contextmanager
def armed_plan(plan: FaultPlan):
    """Scope a plan to a ``with`` block (tests; the runner)."""
    prev = _PLAN
    arm(plan)
    try:
        yield plan
    finally:
        if prev is None:
            disarm()
        else:
            arm(prev)


def maybe_arm_from_env() -> FaultPlan | None:
    """Arm from ``DPTPU_CHAOS_PLAN`` if set (and nothing is armed yet):
    the value is a JSON file path or inline JSON holding either a bare
    plan ``{"seed", "faults"}`` or a scenario wrapper with a ``"plan"``
    key.  Returns the armed plan (new or pre-existing), None when unset.
    Called at the trainer's ``fit()`` and the service's start — the env
    check is the only cost on the disabled path."""
    if _PLAN is not None:
        return _PLAN
    raw = os.environ.get(PLAN_ENV)
    if not raw:
        return None
    if raw.lstrip().startswith("{"):
        obj = json.loads(raw)
    else:
        with open(raw) as f:
            obj = json.load(f)
    if "plan" in obj and "faults" not in obj:  # scenario wrapper
        plan = dict(obj["plan"])
        plan.setdefault("name", obj.get("name", "env"))
        obj = plan
    return arm(FaultPlan.from_dict(obj))


def fire(site: str, payload=None, **ctx):
    """The hot-path hook every seam calls: with no plan armed this is one
    attribute check and a return; with a plan armed it delegates to
    :meth:`faults.FaultPlan.fire` (which may sleep, raise, signal,
    truncate ``ctx['path']``, or return a poisoned ``payload``)."""
    plan = _PLAN
    if plan is None:
        return payload
    return plan.fire(site, payload, **ctx)


class inject:
    """``fire`` as a context manager or decorator, for seams that wrap a
    block rather than transform a payload::

        with chaos_sites.inject("checkpoint/restore"):
            restored = mgr.restore(step, ...)

        @chaos_sites.inject("serve/enqueue")
        def submit(...): ...

    Fires on entry (context) / per call (decorator)."""

    def __init__(self, site: str, **ctx):
        self.site = site
        self.ctx = ctx

    def __enter__(self) -> "inject":
        fire(self.site, **self.ctx)
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            fire(self.site, **self.ctx)
            return fn(*args, **kwargs)

        return wrapper
