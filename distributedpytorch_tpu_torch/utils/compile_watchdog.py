"""Compile watchdog: count PyTorch's compilations, fail on steady-state
recompiles.

Counterpart of ``distributedpytorch_tpu/utils/compile_watchdog.py``, with
its interface: a context manager whose ``counts`` (a ``Counter`` keyed by
the compiled function's name) and ``total`` hold the compilations made on
the thread that entered the block, and whose ``max_compiles`` budget
raises :class:`RecompileError` at exit.

>>> with CompileWatchdog(match="step_fn", max_compiles=1) as wd:
...     for batch in batches:
...         loss = step_fn(batch)          # a torch.compile'd function
>>> wd.counts            # {"step_fn": 1}

What counts, from PyTorch's own hooks and logs (no call site of the port
counts anything):

* each Dynamo frame compile, recompiles on shape drift included: the
  bytecode hook (``torch._dynamo.convert_frame.register_bytecode_hook``)
  runs once per frame Dynamo transforms, keyed by the frame's
  ``co_name``.  A watchdog never imports Dynamo (with Inductor, seconds
  of the start of a process that compiles nothing, such as the eager
  server's): opened before anything imported it, it registers the hook
  the moment Dynamo's frame converter is imported (a finder on
  ``sys.meta_path``, removed with the hooks);
* each Inductor graph compile, of ``torch.compile`` or of AOTInductor
  (``serve/aot.py``'s build): the step log record ``torchinductor
  compiling FORWARDS|BACKWARDS graph N`` of the
  ``torch._inductor.compile_fx`` logger, keyed ``inductor``.  A graph
  served from Inductor's FX graph cache is not compiled and does not
  count.

Loading an AOTInductor package compiles nothing and counts 0.  Counting
is per thread, as JAX's thread-local ``jax.log_compiles()`` is: a compile
on another thread of the process counts nothing.  Nested watchdogs count
independently; the hooks are installed while any watchdog is open and
removed with the last.  While one is open the Inductor logger passes its
INFO records to the counter (it is lowered to INFO if it sat higher) and
drops those below its own former level, so nothing new is printed.  JAX's
``mute_jax_logs`` has no counterpart: nothing here adds log output to
mute.
"""

from __future__ import annotations

import importlib.abc
import importlib.machinery
import logging
import re
import sys
import threading
from collections import Counter

#: the Inductor step record of one graph compile
_INDUCTOR_RE = re.compile(r"torchinductor compiling (FORWARDS|BACKWARDS) graph")
_INDUCTOR_LOGGER = "torch._inductor.compile_fx"
#: the module whose bytecode hook counts Dynamo's frame compiles
_DYNAMO_MODULE = "torch._dynamo.convert_frame"


class RecompileError(AssertionError):
    """A watched function compiled more often than the declared budget."""


class _OnDynamoImport(importlib.abc.MetaPathFinder):
    """Finds Dynamo's frame converter as the path finder does, and tells
    the hooks once the module has run."""

    def __init__(self, hooks: "_Hooks"):
        self.hooks = hooks

    def find_spec(self, name, path, target=None):
        if name != _DYNAMO_MODULE:
            return None
        spec = importlib.machinery.PathFinder.find_spec(name, path, target)
        if spec is None or spec.loader is None:
            return None
        exec_module = spec.loader.exec_module

        def exec_and_hook(module):
            exec_module(module)
            self.hooks.dynamo_imported(module)

        spec.loader.exec_module = exec_and_hook
        return spec


class _Hooks:
    """The process-wide hooks, installed while any watchdog is open; each
    event goes to the open watchdogs of the thread it happened on."""

    def __init__(self):
        self.lock = threading.Lock()
        self.active: list[CompileWatchdog] = []
        self._handle = None
        self._logger_level = None
        self._finder = _OnDynamoImport(self)

    def _record(self, name: str) -> None:
        tid = threading.get_ident()
        with self.lock:
            watchers = [w for w in self.active if w._thread == tid]
        for w in watchers:
            w._record(name)

    def _bytecode_hook(self, code, new_code):
        self._record(code.co_name)
        return None

    def filter(self, record: logging.LogRecord) -> bool:
        """The Inductor logger's filter: count its compile records, pass
        what its former level would have passed."""
        if record.levelno == logging.INFO:
            try:
                msg = record.getMessage()
            except Exception:   # a foreign record whose args don't format
                msg = ""
            if _INDUCTOR_RE.search(msg):
                self._record("inductor")
        return record.levelno >= self._logger_level

    def add(self, watchdog: "CompileWatchdog") -> None:
        with self.lock:
            self.active.append(watchdog)
            if len(self.active) > 1:
                return
            convert_frame = sys.modules.get(_DYNAMO_MODULE)
            if convert_frame is not None:
                self._handle = convert_frame.register_bytecode_hook(
                    self._bytecode_hook)
            else:
                sys.meta_path.insert(0, self._finder)
            logger = logging.getLogger(_INDUCTOR_LOGGER)
            self._saved_level = logger.level
            self._logger_level = logger.getEffectiveLevel()
            logger.addFilter(self)
            if self._logger_level > logging.INFO:
                logger.setLevel(logging.INFO)

    def dynamo_imported(self, convert_frame) -> None:
        """Dynamo's frame converter has just been imported: register the
        bytecode hook if a watchdog is still open."""
        with self.lock:
            if self._finder in sys.meta_path:
                sys.meta_path.remove(self._finder)
            if self.active and self._handle is None:
                self._handle = convert_frame.register_bytecode_hook(
                    self._bytecode_hook)

    def remove(self, watchdog: "CompileWatchdog") -> None:
        with self.lock:
            self.active.remove(watchdog)
            if self.active:
                return
            if self._handle is not None:
                self._handle.remove()
                self._handle = None
            if self._finder in sys.meta_path:
                sys.meta_path.remove(self._finder)
            logger = logging.getLogger(_INDUCTOR_LOGGER)
            logger.removeFilter(self)
            logger.setLevel(self._saved_level)


_HOOKS = _Hooks()


class CompileWatchdog:
    """Count PyTorch compilations per compiled function's name within a
    region, on the thread that entered it.

    ``match``: substring filter on the name; only matching compilations
    count (and only they can trip the budget).  ``max_compiles``: the
    per-name budget enforced at block exit; a primary exception leaving
    the block takes precedence, the watchdog never masks it.
    """

    def __init__(self, match: str | None = None,
                 max_compiles: int | None = None):
        self.match = match
        self.max_compiles = max_compiles
        self.counts: Counter[str] = Counter()
        self._thread: int | None = None
        self._lock = threading.Lock()

    def _record(self, name: str) -> None:
        if self.match is None or self.match in name:
            with self._lock:
                self.counts[name] += 1

    @property
    def total(self) -> int:
        return sum(self.counts.values())

    def __enter__(self) -> "CompileWatchdog":
        self._thread = threading.get_ident()
        _HOOKS.add(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        _HOOKS.remove(self)
        self._thread = None
        if exc_type is not None:
            return  # never mask the primary failure
        if self.max_compiles is not None:
            over = {name: n for name, n in self.counts.items()
                    if n > self.max_compiles}
            if over:
                detail = ", ".join(f"{k} x{v}" for k, v in over.items())
                raise RecompileError(
                    f"steady-state recompile: {detail} (budget "
                    f"{self.max_compiles} per function) — look for shape "
                    "drift in the batch or Python control flow on tensor "
                    "values")
