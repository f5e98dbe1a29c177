"""Seeded, deterministic fault plans: WHAT fires, WHERE, and WHEN; the
counterpart of ``distributedpytorch_tpu/chaos/faults.py``, with the same
plan format, so one plan file drives both packages.

A :class:`FaultPlan` maps injection sites (``sites.py`` names them; the
port wires the trainer's batch fetch and step, the checkpoint save and
the serve front door and drain) to fault specs.  Every decision is
deterministic: selection is by per-site visit index (``at`` / ``every``
/ ``after`` / ``times``) and any probabilistic selection (``p``) draws
from a ``random.Random`` seeded from ``(plan seed, site, kind)`` — the
same plan replays the same firings.

Fault kinds:

* ``latency``   — sleep ``delay_s`` at the site (slow host, slow device);
* ``error``     — raise :class:`InjectedFaultError` (dependency blew up);
* ``nan``       — poison the site's payload: float arrays (numpy, or
  torch tensors NaN-filled on their own device) filled with NaN, scalars
  replaced; integer tensors pass through;
* ``sigterm``   — deliver SIGTERM to this process (preemption, the real
  signal through the real handler);
* ``sigkill``   — SIGKILL this process: a hard crash with no graceful
  stop, no final checkpoint, no exit handler;
* ``truncate``  — cut the tail off a file under the site's ``path``
  context (torn checkpoint write / post-commit corruption);
* ``bitflip``   — XOR one byte of an array payload (``offset`` into the
  buffer, default 0): bit rot / a torn read.

Every actual firing increments ``chaos_injected_total{site,kind}`` in
the process-wide telemetry registry, is emitted to the flight recorder
as a ``chaos`` event, and is appended to ``plan.firings`` for in-test
assertions.
"""

from __future__ import annotations

import json
import os
import random
import signal
import sys
import threading
import time

KINDS = ("latency", "error", "nan", "sigterm", "sigkill", "truncate",
         "bitflip")


class InjectedFaultError(RuntimeError):
    """The exception an ``error``-kind fault raises at its site."""


def _poison_leaf(x):
    """NaN-fill one payload leaf; non-float leaves pass through.  A
    float ``torch.Tensor`` is filled on its own device (no copy to the
    host); integer tensors pass through."""
    import numpy as np
    import torch

    if isinstance(x, (float,)):
        return float("nan")
    if isinstance(x, torch.Tensor):
        return torch.full_like(x, float("nan")) \
            if x.is_floating_point() else x
    if not isinstance(x, np.ndarray) \
            or not np.issubdtype(x.dtype, np.floating):
        return x
    return np.full_like(x, np.nan)


def poison_payload(payload):
    """NaN-poison every float leaf of ``payload`` (dict/list/tuple trees,
    arrays, scalars); structure and non-float leaves are preserved."""
    if isinstance(payload, dict):
        return {k: poison_payload(v) for k, v in payload.items()}
    if isinstance(payload, tuple) and hasattr(payload, "_fields"):
        # NamedTuple: the constructor wants positional fields, not one
        # iterable like the plain-tuple branch below passes
        return type(payload)(*(poison_payload(v) for v in payload))
    if isinstance(payload, (list, tuple)):
        return type(payload)(poison_payload(v) for v in payload)
    return _poison_leaf(payload)


def flip_payload_byte(payload, offset: int = 0):
    """XOR one byte of an array payload (the deterministic bit-rot /
    torn-read model); non-array or empty payloads pass through.  Always
    flips a PRIVATE copy — the caller's buffer (e.g. an mmap view) is
    never mutated."""
    import numpy as np

    if not isinstance(payload, np.ndarray) or payload.size == 0:
        return payload
    out = np.array(payload)  # private contiguous copy
    flat = out.reshape(-1).view(np.uint8)
    flat[int(offset) % flat.size] ^= 0xFF
    return out


def truncate_file(path: str, fraction: float = 0.5) -> str:
    """Tear the LARGEST file under ``path`` (a file or a directory tree)
    down to ``fraction`` of its bytes — the deterministic stand-in for a
    torn write / post-commit corruption.  Returns the torn file's path.

    Largest-first with lexicographic tie-break keeps the choice stable
    run-to-run; the largest file is the array payload, which is exactly
    what a crashed writer tears in practice.
    """
    if os.path.isfile(path):
        victim = path
    else:
        candidates: list[tuple[int, str]] = []
        for dirpath, _dirnames, filenames in os.walk(path):
            for fname in filenames:
                p = os.path.join(dirpath, fname)
                try:
                    size = os.path.getsize(p)
                except OSError:
                    continue
                if size > 0:
                    candidates.append((size, p))
        if not candidates:
            raise InjectedFaultError(
                f"truncate fault found no non-empty file under {path!r}")
        candidates.sort(key=lambda sp: (-sp[0], sp[1]))
        victim = candidates[0][1]
    size = os.path.getsize(victim)
    with open(victim, "r+b") as f:
        f.truncate(max(0, int(size * fraction)))
    return victim


class FaultSpec:
    """One fault at one site, with a deterministic firing schedule.

    ``at``: explicit 1-based visit indices; ``every``: every Nth visit;
    ``after``: visits to skip first; ``times``: max firings; ``p``:
    seeded per-visit probability.  Unset selectors default to "every
    visit" — combine them to carve out the schedule you mean.
    """

    def __init__(self, site: str, kind: str, *, at=None, every=None,
                 after: int = 0, times=None, p=None, delay_s: float = 0.05,
                 message: str = "", fraction: float = 0.5,
                 offset: int = 0):
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r} "
                             f"({' | '.join(KINDS)})")
        if p is not None and not 0.0 <= p <= 1.0:
            raise ValueError(f"p must be in [0, 1], got {p}")
        if every is not None and int(every) < 1:
            # parse-time, not fire-time: every=0 would otherwise surface
            # as a ZeroDivisionError inside the instrumented hot path —
            # a framework crash indistinguishable from a real bug
            raise ValueError(f"every must be >= 1, got {every}")
        if after < 0 or (times is not None and int(times) < 0):
            raise ValueError(
                f"after/times must be >= 0, got after={after} times={times}")
        self.site = site
        self.kind = kind
        self.at = None if at is None else tuple(int(i) for i in at)
        self.every = None if every is None else int(every)
        self.after = int(after)
        self.times = None if times is None else int(times)
        self.p = p
        self.delay_s = float(delay_s)
        self.message = message
        self.fraction = float(fraction)
        self.offset = int(offset)
        self._fired = 0
        self._rng = None  # seeded by the owning plan

    def to_dict(self) -> dict:
        out = {"site": self.site, "kind": self.kind}
        if self.at is not None:
            out["at"] = list(self.at)
        if self.every is not None:
            out["every"] = self.every
        if self.after:
            out["after"] = self.after
        if self.times is not None:
            out["times"] = self.times
        if self.p is not None:
            out["p"] = self.p
        if self.kind == "latency":
            out["delay_s"] = self.delay_s
        if self.message:
            out["message"] = self.message
        if self.kind == "truncate":
            out["fraction"] = self.fraction
        if self.kind == "bitflip" and self.offset:
            out["offset"] = self.offset
        return out

    def should_fire(self, visit: int) -> bool:
        """Deterministic selection for the ``visit``-th site visit
        (1-based).  NOTE: called once per visit in order — the seeded
        ``p`` draw advances per visit, which is what keeps a
        probabilistic schedule replayable."""
        if self.times is not None and self._fired >= self.times:
            return False
        if visit <= self.after:
            return False
        if self.at is not None and visit not in self.at:
            return False
        if self.every is not None and (visit - self.after) % self.every:
            return False
        if self.p is not None and self._rng.random() >= self.p:
            return False
        return True


class FaultPlan:
    """A named, seeded set of :class:`FaultSpec` keyed by site.

    ``fire(site, payload, **ctx)`` is called by ``sites.fire`` on every
    visit to an armed site: it advances that site's visit counter, fires
    any due specs (latency sleeps, error raises, sigterm kills, truncate
    tears ``ctx['path']``, nan returns a poisoned payload), books each
    firing as ``chaos_injected_total{site,kind}``, and returns the
    (possibly poisoned) payload.
    """

    def __init__(self, faults, *, seed: int = 0, name: str = "adhoc"):
        self.name = name
        self.seed = int(seed)
        self.faults: list[FaultSpec] = list(faults)
        self._by_site: dict[str, list[FaultSpec]] = {}
        for f in self.faults:
            # per-spec RNG seeded from (plan seed, site, kind, index):
            # independent streams, reproducible regardless of which other
            # sites fire in between
            f._fired = 0
            f._rng = random.Random(
                f"{self.seed}/{f.site}/{f.kind}/{len(self._by_site.get(f.site, []))}")
            self._by_site.setdefault(f.site, []).append(f)
        self._visits: dict[str, int] = {}
        #: (site, kind, visit) tuples of every firing, in order
        self.firings: list[tuple[str, str, int]] = []
        #: serializes visit counting + schedule decisions: serve/enqueue
        #: fires from N client threads and device/put from the prefetch
        #: worker, and the determinism contract (same plan -> same
        #: firings) dies the moment two threads race a visit index
        self._lock = threading.Lock()

    # ------------------------------------------------------------ serde
    @classmethod
    def from_dict(cls, obj: dict) -> "FaultPlan":
        faults = [FaultSpec(**spec) for spec in obj.get("faults", ())]
        return cls(faults, seed=obj.get("seed", 0),
                   name=obj.get("name", "adhoc"))

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        return cls.from_dict(json.loads(text))

    def to_dict(self) -> dict:
        return {"name": self.name, "seed": self.seed,
                "faults": [f.to_dict() for f in self.faults]}

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    # ------------------------------------------------------------ firing
    def sites(self) -> list[str]:
        return sorted(self._by_site)

    def injected_total(self) -> dict:
        """``{(site, kind): count}`` of the firings so far."""
        out: dict[tuple[str, str], int] = {}
        for site, kind, _visit in self.firings:
            out[site, kind] = out.get((site, kind), 0) + 1
        return out

    def fire(self, site: str, payload=None, **ctx):
        specs = self._by_site.get(site)
        if not specs:
            return payload
        # decide under the lock (visit index, schedule, RNG draws, the
        # `times` budget); ACT outside it — an injected sleep must stall
        # only its own thread, exactly like the real slowness it models.
        # The firing RECORD (plan.firings + the registry counter) is
        # written per spec at the moment it acts, so an error-kind fault
        # aborting the visit leaves no phantom record for the specs it
        # pre-empted (their consumed `times` budget is the one trace of
        # the aborted visit).
        with self._lock:
            visit = self._visits.get(site, 0) + 1
            self._visits[site] = visit
            due = []
            for spec in specs:
                if spec.should_fire(visit):
                    spec._fired += 1
                    due.append(spec)
        for spec in due:
            with self._lock:
                self.firings.append((site, spec.kind, visit))
            self._book(site, spec.kind)
            if spec.kind == "latency":
                time.sleep(spec.delay_s)
            elif spec.kind == "error":
                raise InjectedFaultError(
                    spec.message or f"injected fault at {site} "
                    f"(visit {visit}, plan {self.name!r})")
            elif spec.kind == "sigterm":
                os.kill(os.getpid(), signal.SIGTERM)
            elif spec.kind == "sigkill":
                # flush whatever the process has written — the POINT is
                # that nothing else (handlers, atexit) runs
                try:
                    sys.stdout.flush()
                    sys.stderr.flush()
                except Exception:
                    pass
                os.kill(os.getpid(), signal.SIGKILL)
            elif spec.kind == "truncate":
                path = ctx.get("path")
                if not path:
                    raise InjectedFaultError(
                        f"truncate fault at {site} needs a path= context "
                        "(site not wired for truncation?)")
                truncate_file(path, spec.fraction)
            elif spec.kind == "nan":
                payload = poison_payload(payload)
            elif spec.kind == "bitflip":
                payload = flip_payload_byte(payload, spec.offset)
        return payload

    @staticmethod
    def _book(site: str, kind: str) -> None:
        # armed-path only; deferred so the chaos package imports without
        # pulling the telemetry stack
        from ..telemetry import events as events_lib
        from ..telemetry import get_registry

        get_registry().counter(
            "chaos_injected_total",
            "Deterministic fault-injection firings (chaos/)",
            labels={"site": site, "kind": kind}).inc()
        # flight recorder: the fault firing is every chaos episode's
        # ground-truth opening anchor
        events_lib.emit("chaos", kind, payload={"site": site})
