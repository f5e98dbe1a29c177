"""Flight recorder: the process-wide, crash-safe run-event log, the
counterpart of ``distributedpytorch_tpu/telemetry/events.py`` (stdlib,
copied with its schema unchanged, so one reader takes both packages'
files).

One versioned line schema, appended to
``run_dir/events/<host>.<pid>.jsonl`` by every subsystem through small
adapters at their existing choke points (trainer, checkpoint,
preemption, governor, chaos); the subsystems' own ledgers
(``governor.jsonl``, ``COMMITTED.json``) stay each one's authoritative
record.

Schema (version 1), one JSON object per line::

    {"v": 1, "ts_wall": <time.time()>, "ts_mono": <perf_counter()>,
     "host": str, "pid": int, "generation": int|null,
     "source": str, "kind": str, "step": int|null, "epoch": int|null,
     "payload": {...}}

``ts_mono`` orders events within a process (immune to NTP steps);
``ts_wall`` aligns processes and hosts.  ``generation`` is the
``run_<N>`` index of a trainer's run dir — the stitching key across
restarts.

The stream is line-buffered so a crashed process keeps its tail;
non-finite floats serialize as ``null`` (strict JSON — a diverging run
is exactly when the log must stay machine-readable); a recorder failure
never kills the run it records — I/O and serialization errors are
swallowed and counted (``dropped``).

Emission is host-side only and off the per-step path: emitters fire at
boundary cadence (fit start and end, checkpoint saves and commits,
preemption, governor decisions, fault firings), never per step, and the
disabled path is one list check.  Stdlib only: importable without torch.
"""

from __future__ import annotations

import json
import math
import os
import re
import socket
import threading
import time

#: schema version stamped on every line; bump on any key change
SCHEMA_VERSION = 1

#: the one line schema, in emission order (payload last)
EVENT_KEYS = ("v", "ts_wall", "ts_mono", "host", "pid", "generation",
              "source", "kind", "step", "epoch", "payload")

#: the emitting subsystems (the ``source`` field's closed set — the
#: JAX package's timeline keys on these; the set is shared)
SOURCES = ("trainer", "governor", "sentinel", "checkpoint", "preemption",
           "supervisor", "serve", "flywheel", "chaos", "fleet")

_RUN_RE = re.compile(r"run_(\d+)$")


def run_generation(run_dir: str) -> int | None:
    """The ``run_<N>`` index of a run dir (the trainer's process
    generation under supervision); None for non-run_<N> paths."""
    m = _RUN_RE.search(os.path.normpath(run_dir))
    return int(m.group(1)) if m else None


def _jsonable(v):
    """Non-finite -> null, recursively (the JsonlWriter rule)."""
    if isinstance(v, bool) or v is None:
        return v
    if isinstance(v, (int, str)):
        return v
    if isinstance(v, float):
        return v if math.isfinite(v) else None
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, set, frozenset)):
        return [_jsonable(x) for x in v]
    # numpy scalars (and anything float()-able) without importing numpy:
    # this module stays stdlib-importable
    try:
        f = float(v)
        return f if math.isfinite(f) else None
    except (TypeError, ValueError):
        return repr(v)


class EventLog:
    """Append-only event stream for one process at one run dir.

    One file per (host, pid): concurrent processes (the ranks of a
    data-parallel fit) never interleave writes, and a reader gets
    per-process monotonic order for free.
    """

    def __init__(self, run_dir: str, generation: int | None = None):
        self.run_dir = run_dir
        self.generation = (run_generation(run_dir)
                           if generation is None else int(generation))
        self.host = socket.gethostname()
        self.pid = os.getpid()
        self.emitted = 0
        self.dropped = 0
        self._lock = threading.Lock()
        self.path: str | None = None
        self._f = None
        try:
            events_dir = os.path.join(run_dir, "events")
            os.makedirs(events_dir, exist_ok=True)
            self.path = os.path.join(events_dir,
                                     f"{self.host}.{self.pid}.jsonl")
            # line-buffered: a crashed run keeps its tail (the last
            # lines before the crash are the diagnosis)
            self._f = open(self.path, "a", buffering=1)
        except OSError:
            # a read-only run dir must not kill the process it records;
            # every emit() becomes a counted drop
            self.path = None

    def emit(self, source: str, kind: str, *, step: int | None = None,
             epoch: int | None = None, generation: int | None = None,
             payload: dict | None = None) -> None:
        """Append one event.  Never raises; failures count as drops."""
        rec = {
            "v": SCHEMA_VERSION,
            "ts_wall": time.time(),
            "ts_mono": time.perf_counter(),
            "host": self.host,
            "pid": self.pid,
            "generation": (self.generation if generation is None
                           else int(generation)),
            "source": source,
            "kind": kind,
            "step": None if step is None else int(step),
            "epoch": None if epoch is None else int(epoch),
            "payload": _jsonable(payload or {}),
        }
        try:
            line = json.dumps(rec, allow_nan=False)
        except (TypeError, ValueError):
            self.dropped += 1
            return
        with self._lock:
            if self._f is None:
                self.dropped += 1
                return
            try:
                self._f.write(line + "\n")
                self.emitted += 1
            except (OSError, ValueError):
                self.dropped += 1

    def block(self) -> dict:
        """The ``events`` block of a run record: keys always present."""
        return {"emitted": int(self.emitted), "dropped": int(self.dropped),
                "path": self.path}

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                try:
                    self._f.close()
                except OSError:
                    pass
                self._f = None


# --------------------------------------------------------- process state
#
# A stack, not a bare singleton: an outer process may configure its own
# log, then each in-process fit configures its run_<N> — the fit's
# events land under the fit's run dir, and release() restores the outer
# log when the trainer closes.

_STACK: list[EventLog] = []
_STACK_LOCK = threading.Lock()


def configure(run_dir: str, generation: int | None = None) -> EventLog:
    """Open (and make current) an event log under ``run_dir``."""
    log = EventLog(run_dir, generation=generation)
    with _STACK_LOCK:
        _STACK.append(log)
    return log


def release(log: EventLog | None) -> None:
    """Close ``log`` and restore the previously configured one."""
    if log is None:
        return
    log.close()
    with _STACK_LOCK:
        if log in _STACK:
            _STACK.remove(log)


def current() -> EventLog | None:
    return _STACK[-1] if _STACK else None


def emit(source: str, kind: str, *, step: int | None = None,
         epoch: int | None = None, generation: int | None = None,
         payload: dict | None = None) -> None:
    """Module-level adapter every subsystem calls: a no-op (one list
    check) when no log is configured — the disabled path's whole cost."""
    if not _STACK:
        return
    log = _STACK[-1]
    log.emit(source, kind, step=step, epoch=epoch,
             generation=generation, payload=payload)


def events_block() -> dict:
    """The ``events`` block of a run record from the current log — keys
    ALWAYS present, all None when no log is configured (telemetry off:
    the recovery/plan null convention)."""
    log = current()
    if log is None:
        return {"emitted": None, "dropped": None, "path": None}
    return log.block()


def read_events_file(path: str) -> list[dict]:
    """Parse one event file, tolerating a torn last line (the crash-safe
    read half: a SIGKILLed process's final partial write is dropped, not
    fatal)."""
    out: list[dict] = []
    try:
        with open(path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn tail / partial write
                if isinstance(rec, dict) and rec.get("v") == SCHEMA_VERSION:
                    out.append(rec)
    except OSError:
        pass
    return out
