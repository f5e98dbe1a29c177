"""Input-feed governor: the feedback loop from measured stall to
actuation, the counterpart of ``distributedpytorch_tpu/data/governor.py``.

The :class:`FeedGovernor` watches the windowed stall fraction (a
:class:`~..telemetry.goodput.FeedWindow` fed from the goodput snapshots
the trainer takes at the log cadence — no new host syncs) and works the
feed's knobs through an escalation ladder with hysteresis:

0. **Pack recommendation** (first escalation, once per run): when the
   stalled source is not packed, log the exact ``dptpu-pack`` invocation
   (operator-actuated).
1. **Hot prefetch resize** (any tick): double host + device prefetch
   depth, bounded.
2. **Device-path flip** (epoch boundaries): move augmentation + guidance
   synthesis on device when the config allows it, else log a
   *recommendation* naming the exact config keys.
3. **Arm data echoing** (epoch boundaries): step each loaded batch
   ``ceil(1 / (1 - stall))`` times (Choi et al., arXiv:1907.05550),
   clamped to ``data.max_echo``; later boundaries may raise it.
4. **Disarm with hysteresis**: once the windowed stall holds below
   ``disarm_factor x target`` for ``disarm_patience`` ticks, echo returns
   to its configured base at the next boundary.
5. **Persistent shortfall**: stalled at the top of the ladder, the
   governor reports loudly (stderr + ledger + counter).

Modes (``data.governor``): ``off`` | ``observe`` (the default — every
decision is logged to ``run_dir/governor.jsonl`` and the registry, but
nothing is actuated; the ladder advances *virtually* so the log shows the
full would-be sequence) | ``auto`` (decisions applied; the port's config
refuses it until its actuators exist).  Under ``consensus`` every
decision input routes through
:func:`~..parallel.consensus.replicated_decision`: the stall fraction
reduces by max across processes, the escalation request by any, so every
process's ladder stays identical.  ``observe`` stays main-process-local —
it actuates nothing, so there is nothing to agree on.
"""

from __future__ import annotations

import json
import math
import sys
import time

GOVERNOR_MODES = ("off", "observe", "auto")

#: rung-1 bounds: prefetch depth doubles up to these caps (batches)
MAX_HOST_PREFETCH = 8
MAX_DEVICE_PREFETCH = 8

#: ladder actions, as they appear in governor.jsonl / the actions counter.
#: ``pack_recommendation`` is rung 0 (data/packed.py): when the stalled
#: source is NOT already packed, the first escalation names the exact
#: ``dptpu-pack`` invocation that deletes the stall at its source —
#: cheaper than every actuation above it.  A packed source skips
#: straight to rung 1 (prefetch).
ACTIONS = ("pack_recommendation", "raise_prefetch", "flip_device_path",
           "recommend", "arm_echo", "raise_echo", "disarm_echo",
           "shortfall")


def governor_consensus(value, reduce: str, label: str):
    """The governor's one door to :func:`replicated_decision`
    (parallel/consensus.py) — a module seam so tests can simulate
    divergent per-host inputs without processes."""
    from ..parallel.consensus import replicated_decision

    return replicated_decision(value, reduce=reduce, label=label)


def echo_factor(stall: float, max_echo: int, current: int = 1,
                target: float | None = None) -> int:
    """The echo factor for a measured stall fraction.

    Unarmed (``current == 1``): the Choi et al. arming factor
    ``ceil(1 / (1 - stall))`` — each loaded batch stepped that many
    times amortizes the per-batch wait over as many optimizer steps as
    the stall ratio says were lost.  Already armed: the target-aware
    escalation ``ceil(current * stall * (1 - target) / (target * (1 -
    stall)))`` — the factor that brings the *armed* measurement (whose
    waits are already amortized over ``current`` echoes) down to
    ``target``.  Clamped to ``[current, max_echo]``; a stall at or past
    1.0 pins the top.
    """
    max_echo = max(1, int(max_echo))
    if stall >= 1.0:
        return max_echo
    if stall <= 0.0:
        return max(1, int(current))
    if current <= 1:
        want = math.ceil(1.0 / (1.0 - stall))
    else:
        t = min(max(target if target is not None else 0.1, 1e-3), 0.999)
        want = math.ceil(current * stall * (1.0 - t) / (t * (1.0 - stall)))
    return max(max(1, int(current)), min(max_echo, int(want)))


class FeedActuators:
    """The knobs the governor works, duck-typed so tests can stub them.

    The trainer implements this over its live feed state (host/device
    prefetch depth, the effective echo factor, the device-path flip);
    ``observe`` mode never calls the setters.  Every getter must be
    cheap — they run at the tick cadence.
    """

    def get_prefetch(self) -> tuple[int, int]:
        raise NotImplementedError

    def set_prefetch(self, host: int, device: int) -> None:
        raise NotImplementedError

    def flip_available(self) -> tuple[bool, str]:
        """(eligible, reason/recommendation).  ``reason`` names the
        config keys the operator would flip when ineligible."""
        raise NotImplementedError

    def flip_device_path(self) -> None:
        raise NotImplementedError

    def get_echo(self) -> int:
        raise NotImplementedError

    def base_echo(self) -> int:
        raise NotImplementedError

    def can_set_echo(self) -> tuple[bool, str]:
        raise NotImplementedError

    def set_echo(self, factor: int) -> None:
        raise NotImplementedError

    def pack_status(self) -> tuple[bool, str | None]:
        """Rung 0 (data/packed.py): ``(already_packed,
        recommendation)``.  When the source is not packed, the
        recommendation names the exact ``dptpu-pack`` invocation(s).
        Default says "packed" so duck-typed actuators that predate the
        rung keep their ladder unchanged."""
        return True, None


class FeedGovernor:
    """Escalation-ladder controller over the windowed input-stall signal.

    ``tick(busy_s, wait_s, ...)`` at the log cadence pushes one window
    sample and may hot-apply rung 1; ``epoch_boundary(...)`` applies the
    recompile-unsafe rungs (flip, echo) and the disarm.  Every decision
    — applied or observed — lands as one JSONL line and one
    ``train_governor_actions_total{action}`` increment; the rolling
    stall fraction is published to the ``train_feed_stall_fraction``
    gauge and the armed echo factor to ``train_feed_echo_armed``.
    """

    def __init__(self, mode: str, target: float,
                 actuators: FeedActuators, *,
                 max_echo: int = 4,
                 window=None,
                 jsonl_path: str | None = None,
                 min_samples: int = 2,
                 patience: int = 2,
                 disarm_factor: float = 0.5,
                 disarm_patience: int = 4,
                 telemetry: bool = True,
                 consensus: bool = False,
                 clock=time.time):
        from ..telemetry.goodput import FeedWindow

        if mode not in GOVERNOR_MODES:
            raise ValueError(f"data.governor must be one of "
                             f"{GOVERNOR_MODES}, got {mode!r}")
        if not 0.0 < target < 1.0:
            raise ValueError(
                f"data.governor_target must be in (0, 1), got {target}")
        if max_echo < 1:
            raise ValueError(f"data.max_echo must be >= 1, got {max_echo}")
        self.mode = mode
        self.target = float(target)
        self.actuators = actuators
        self.max_echo = int(max_echo)
        self.window = window if window is not None else FeedWindow()
        self.jsonl_path = jsonl_path
        self.min_samples = int(min_samples)
        self.patience = int(patience)
        self.disarm_factor = float(disarm_factor)
        self.disarm_patience = int(disarm_patience)
        self._telemetry = telemetry
        #: multi-host auto mode: decision inputs route through
        #: replicated_decision so the ladder state is identical on every
        #: host (see the module docstring).  Each tick/boundary then IS
        #: a collective — the caller owes a replicated call cadence.
        self.consensus = bool(consensus)
        self._clock = clock
        # hysteresis counters: consecutive ticks above target / below the
        # disarm threshold; the band between them holds both at zero
        self._above = 0
        self._below = 0
        #: rung-1 state in observe mode advances virtually (the log shows
        #: the full would-be ladder without touching the live knobs)
        self._virtual_prefetch: tuple[int, int] | None = None
        self._virtual_echo: int | None = None
        self._flip_attempted = False
        self._pack_noted = False
        self._echo_armed = False
        self._wants_escalation = False
        self._shortfall = False
        self.decisions: list[dict] = []
        self.actions_count: dict[str, int] = {}

    # ------------------------------------------------------------ helpers
    @property
    def applies(self) -> bool:
        return self.mode == "auto"

    def stall_fraction(self) -> float | None:
        return self.window.stall_fraction()

    def _decided_stall(self, stall: float | None) -> float | None:
        """The stall fraction the ladder acts on: the local window's
        under single-host, the MAX across hosts under consensus (the
        most-starved host is the one gating every collective — its
        stall is the job's stall).  "No reading yet" encodes as -1 so a
        host below min_samples still joins the allgather (every host
        must make the same number of consensus calls) without vetoing
        hosts that have one."""
        if not self.consensus:
            return stall
        decided = float(governor_consensus(
            -1.0 if stall is None else float(stall), "max",
            "governor/stall"))
        return None if decided < 0.0 else decided

    def _get_prefetch(self) -> tuple[int, int]:
        if not self.applies and self._virtual_prefetch is not None:
            return self._virtual_prefetch
        return self.actuators.get_prefetch()

    def _get_echo(self) -> int:
        if not self.applies and self._virtual_echo is not None:
            return self._virtual_echo
        return self.actuators.get_echo()

    def _decide(self, action: str, *, step: int, epoch: int,
                stall: float | None, applied: bool, detail) -> dict:
        rec = {"ts": round(float(self._clock()), 3), "step": int(step),
               "epoch": int(epoch), "action": action,
               "applied": bool(applied),
               "stall": (round(stall, 4) if stall is not None else None),
               "target": self.target, "detail": detail}
        self.decisions.append(rec)
        self.actions_count[action] = self.actions_count.get(action, 0) + 1
        if self.jsonl_path:
            try:
                with open(self.jsonl_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            except OSError as e:  # a full disk must not kill training
                print(f"governor: could not append to {self.jsonl_path}: "
                      f"{e}", file=sys.stderr)
        if self._telemetry:
            from ..telemetry import get_registry
            from ..telemetry.registry import is_enabled

            if is_enabled():
                get_registry().counter(
                    "train_governor_actions_total",
                    "Feed-governor ladder decisions (data/governor.py)",
                    labels={"action": action}).inc()
        # flight recorder (telemetry/events.py): the decision, mirrored —
        # governor.jsonl stays the authoritative ledger
        from ..telemetry import events as events_lib

        events_lib.emit("governor", action, step=int(step),
                        epoch=int(epoch),
                        payload={"stall": rec["stall"],
                                 "target": self.target,
                                 "applied": bool(applied),
                                 "detail": detail})
        return rec

    def _publish_gauges(self, stall: float | None) -> None:
        if not self._telemetry:
            return
        from ..telemetry import get_registry
        from ..telemetry.registry import is_enabled

        if not is_enabled():
            return
        reg = get_registry()
        if stall is not None:
            reg.gauge("train_feed_stall_fraction",
                      "Rolling input-stall fraction over the feed window"
                      ).set(stall)
        reg.gauge("train_feed_echo_armed",
                  "Governor-armed echo factor (0 = not armed)"
                  ).set(self._get_echo() if self._echo_armed else 0)

    # --------------------------------------------------------------- tick
    def tick(self, busy_s: float, wait_s: float, *, step: int,
             epoch: int) -> None:
        """One log-cadence observation: push the goodput delta, update
        the hysteresis counters, and (rung 1) hot-resize prefetch.

        Under ``consensus`` a zero delta still ticks (the trainer calls
        at the replicated cadence regardless) — the sample is dropped
        but the host joins the stall allgather, so consensus calls stay
        congruent across hosts."""
        if busy_s + wait_s > 0:
            self.window.push(busy_s, wait_s)
        local = self.window.stall_fraction()
        ready = local is not None and len(self.window) >= self.min_samples
        stall = self._decided_stall(local if ready else None)
        self._publish_gauges(stall if stall is not None else local)
        if stall is None:
            return
        if stall > self.target:
            self._above += 1
            self._below = 0
        elif stall < self.target * self.disarm_factor:
            self._below += 1
            self._above = 0
        else:  # hysteresis band: hold
            self._above = 0
            self._below = 0
        if self._above >= self.patience:
            self._above = 0
            self._rung0_pack(step=step, epoch=epoch, stall=stall)
            host, dev = self._get_prefetch()
            if host < MAX_HOST_PREFETCH or dev < MAX_DEVICE_PREFETCH:
                # never below current: an operator-configured depth
                # above the governor's cap stays put (the raise rung
                # must not SHRINK the pipeline mid-stall)
                new = (max(host, min(MAX_HOST_PREFETCH, max(1, host) * 2)),
                       max(dev, min(MAX_DEVICE_PREFETCH, max(1, dev) * 2)))
                if self.applies:
                    self.actuators.set_prefetch(*new)
                else:
                    self._virtual_prefetch = new
                self._decide(
                    "raise_prefetch", step=step, epoch=epoch, stall=stall,
                    applied=self.applies,
                    detail={"host": [host, new[0]], "device": [dev, new[1]]})
            else:
                # rung 1 exhausted: the recompile-unsafe rungs wait for
                # the epoch boundary
                self._wants_escalation = True

    def _rung0_pack(self, *, step: int, epoch: int,
                    stall: float | None) -> None:
        """Rung 0, emitted once per run at the FIRST escalation: when
        the stalled source is not already packed, log the exact
        ``dptpu-pack`` invocation that removes the stall at its source
        (pre-decoded mmap records — data/packed.py).  Never actuated
        (packing is the operator's move, like the flip recommendation);
        packed sources skip straight to rung 1.  Config-derived on
        every host, so no consensus is needed for a log-only line."""
        if self._pack_noted:
            return
        self._pack_noted = True
        status = getattr(self.actuators, "pack_status", None)
        if status is None:
            return
        packed, recommendation = status()
        if packed or not recommendation:
            return
        self._decide("pack_recommendation", step=step, epoch=epoch,
                     stall=stall, applied=False, detail=recommendation)

    # ---------------------------------------------------------- boundary
    def epoch_boundary(self, *, epoch: int, step: int) -> list[dict]:
        """The recompile-safe seam: flip / arm / raise / disarm echo.
        Returns the decisions made at this boundary."""
        made: list[dict] = []
        stall = self._decided_stall(self.window.stall_fraction())

        def decide(action, applied, detail):
            made.append(self._decide(action, step=step, epoch=epoch,
                                     stall=stall, applied=applied,
                                     detail=detail))

        # a mid-epoch escalation request whose stall has since cleared
        # (fault ended late in the epoch, window drained) is dropped —
        # it must not shadow the disarm check below.  Consensus: ANY
        # host's escalation request escalates everywhere — the echo
        # factor the rung sets must land identically on every host, or
        # optimizer step counts desynchronize at the next epoch.
        wants_esc = self._wants_escalation
        if self.consensus:
            wants_esc = bool(governor_consensus(
                bool(wants_esc), "any", "governor/escalate"))
        wants = wants_esc and stall is not None and stall > self.target
        self._wants_escalation = False
        if wants:
            escalated = False
            if not self._flip_attempted:
                self._flip_attempted = True
                ok, reason = self.actuators.flip_available()
                if ok and self.applies:
                    self.actuators.flip_device_path()
                    decide("flip_device_path", True, reason)
                    escalated = True  # give the flip an epoch to measure
                elif ok:
                    decide("flip_device_path", False, reason)
                    escalated = True
                else:
                    # config does not allow the flip: recommend, loudly,
                    # and fall through to the echo rung at THIS boundary
                    decide("recommend", False, reason)
            if not escalated:
                can, why = self.actuators.can_set_echo()
                cur = self._get_echo()
                if not can:
                    decide("shortfall", False,
                           f"stall {stall:.2f} > target {self.target} at "
                           f"the top of the ladder and echo is "
                           f"unavailable ({why})")
                    self._shout(stall, why)
                else:
                    want = echo_factor(stall, self.max_echo, current=cur,
                                       target=self.target)
                    if want > cur:
                        if self.applies:
                            self.actuators.set_echo(want)
                        else:
                            self._virtual_echo = want
                        decide("arm_echo" if not self._echo_armed
                               else "raise_echo", self.applies,
                               {"factor": [cur, want],
                                "max_echo": self.max_echo})
                        self._echo_armed = True
                    else:
                        detail = (f"stall {stall:.2f} > target "
                                  f"{self.target} with echo already at "
                                  f"{cur}/{self.max_echo} — the ladder "
                                  "is out of rungs (raise data.max_echo, "
                                  "add loader workers, or move to a "
                                  "prepared cache)")
                        decide("shortfall", False, detail)
                        self._shout(stall, detail)
        if not wants and self._echo_armed \
                and self._below >= self.disarm_patience:
            base = self.actuators.base_echo()
            cur = self._get_echo()
            if self.applies:
                self.actuators.set_echo(base)
            else:
                self._virtual_echo = base
            decide("disarm_echo", self.applies,
                   {"factor": [cur, base]})
            self._echo_armed = False
            self._shortfall = False
            self._below = 0
        self._publish_gauges(stall)
        return made

    def _shout(self, stall: float, detail: str) -> None:
        """A shortfall the ladder cannot fix is reported loudly, never
        hidden — once per escalation episode, not per boundary."""
        if self._shortfall:
            return
        self._shortfall = True
        print(f"governor: PERSISTENT INPUT SHORTFALL — windowed stall "
              f"{stall:.2f} above target {self.target} with every rung "
              f"exhausted ({detail})", file=sys.stderr, flush=True)

    # ---------------------------------------------------------- reporting
    def summary_block(self) -> dict:
        """The fit-history / fit_summary ``feed`` block."""
        return {
            "mode": self.mode,
            "target": self.target,
            "input_wait_fraction": self.window.stall_fraction(),
            "echo_effective": self.actuators.get_echo(),
            "echo_armed": self._echo_armed,
            "shortfall": self._shortfall,
            "actions": dict(self.actions_count),
        }


def feed_block(goodput_report: dict | None, governor: str | None = None,
               echo_effective: int | None = None,
               source: str = "fs") -> dict:
    """A run record's ``feed`` block (the JAX bench record's) — keys
    always present, null-valued when off/unknowable.

    ``input_wait_fraction`` is derived from a goodput report's buckets
    (wait / (wait + step + compile)); ``governor`` names the governing
    mode conditioning the record (null = ungoverned); ``echo_effective``
    is the echo factor in effect (null when echoing is off/NA);
    ``source`` names the data plane feeding the record (``fs`` |
    ``packed``).
    """
    frac = None
    buckets = (goodput_report or {}).get("buckets") or {}
    busy = (buckets.get("step", 0.0) or 0.0) \
        + (buckets.get("compile", 0.0) or 0.0)
    wait = buckets.get("input_wait", 0.0) or 0.0
    if busy + wait > 0:
        frac = round(wait / (busy + wait), 4)
    return {
        "input_wait_fraction": frac,
        "governor": governor,
        "echo_effective": echo_effective,
        "source": source,
    }
