"""chaos — deterministic fault injection + unified failure policies, the
counterpart of ``distributedpytorch_tpu/chaos`` (its scenario runner is
not ported):

* :mod:`sites`    — named injection sites woven into the real seams,
  armed process-wide (one attribute check when disabled);
* :mod:`faults`   — seeded, deterministic fault plans (latency, raised
  errors, NaN payload poisoning, SIGTERM delivery, checkpoint
  truncation), every firing booked as ``chaos_injected_total{site,kind}``;
* :mod:`policies` — the one Retry/backoff-with-jitter, Timeout and
  CircuitBreaker.

Import-light: importing this package touches neither torch nor the
telemetry stack.
"""

from . import faults, policies, sites
from .faults import FaultPlan, FaultSpec, InjectedFaultError
from .policies import (
    CircuitBreaker,
    CircuitOpenError,
    PolicyTimeoutError,
    Retry,
    RetryBudgetExceededError,
    Timeout,
)
from .sites import (
    active_scenario,
    arm,
    armed,
    armed_plan,
    disarm,
    fire,
    inject,
    maybe_arm_from_env,
)

__all__ = [
    "CircuitBreaker", "CircuitOpenError", "FaultPlan", "FaultSpec",
    "InjectedFaultError", "PolicyTimeoutError", "Retry",
    "RetryBudgetExceededError", "Timeout", "active_scenario", "arm",
    "armed", "armed_plan", "disarm", "faults", "fire", "inject",
    "maybe_arm_from_env", "policies", "sites",
]
