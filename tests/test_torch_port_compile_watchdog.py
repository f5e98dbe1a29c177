"""The port's CompileWatchdog (``utils/compile_watchdog.py``): compile
counting, the recompile budget and hygiene, the cases of the JAX package's
``tests/test_compile_watchdog.py`` on ``torch.compile(backend="eager")``
(Dynamo's frame compiles, no code generation), plus the per-thread scope.
Inductor's graph compiles and a package load are counted in
``test_torch_port_aot.py``, around the one AOTInductor build.
"""

import logging
import os
import subprocess
import sys
import threading
import types

import pytest
import torch
from torch._dynamo import convert_frame

from distributedpytorch_tpu_torch.utils.compile_watchdog import (
    CompileWatchdog,
    RecompileError,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fresh_compiled(tag: str):
    """A ``torch.compile``'d function whose code object is new and named
    ``tag``: Dynamo keeps its cache on the code object, so each test's
    counts are its own whatever ran before.  ``dynamic=False`` recompiles
    at every new shape."""
    def fn(x):
        return x * 2 + 1

    code = fn.__code__.replace(co_name=tag)
    return torch.compile(types.FunctionType(code, fn.__globals__, tag),
                         backend="eager", dynamic=False)


class TestCounting:
    def test_steady_state_compiles_once(self):
        step = fresh_compiled("wd_steady_fn")
        with CompileWatchdog(match="wd_steady_fn") as wd:
            for _ in range(3):
                step(torch.ones(4))
        assert wd.counts["wd_steady_fn"] == 1
        assert wd.total == 1

    def test_shape_drift_counts_every_recompile(self):
        step = fresh_compiled("wd_drift_fn")
        with CompileWatchdog(match="wd_drift_fn") as wd:
            step(torch.ones(2))
            step(torch.ones(3))
            step(torch.ones(2))  # a cache hit, not a compile
        assert wd.counts["wd_drift_fn"] == 2

    def test_match_filters_unrelated_compiles(self):
        step = fresh_compiled("wd_match_fn")
        other = fresh_compiled("wd_other_fn")
        with CompileWatchdog(match="wd_match_fn") as wd:
            step(torch.ones(4))
            other(torch.ones(4))
        assert wd.total == 1
        assert "wd_other_fn" not in wd.counts

    def test_counting_stops_outside_the_block(self):
        step = fresh_compiled("wd_scope_fn")
        with CompileWatchdog(match="wd_scope_fn") as wd:
            step(torch.ones(4))
        step(torch.ones(5))  # a recompile after the exit: not counted
        assert wd.counts["wd_scope_fn"] == 1

    def test_another_threads_compile_is_not_counted(self):
        mine = fresh_compiled("wd_mine_fn")
        theirs = fresh_compiled("wd_theirs_fn")
        with CompileWatchdog() as wd:
            t = threading.Thread(target=theirs, args=(torch.ones(4),))
            t.start()
            t.join()
            mine(torch.ones(4))
        assert dict(wd.counts) == {"wd_mine_fn": 1}

    def test_a_watchdog_on_the_other_thread_counts_it(self):
        step = fresh_compiled("wd_worker_fn")
        seen = {}

        def worker():
            with CompileWatchdog() as wd:
                step(torch.ones(4))
            seen.update(wd.counts)

        with CompileWatchdog() as outer:
            t = threading.Thread(target=worker)
            t.start()
            t.join()
        assert seen == {"wd_worker_fn": 1} and outer.total == 0


class TestBudget:
    def test_budget_ok_no_raise(self):
        step = fresh_compiled("wd_budget_ok_fn")
        with CompileWatchdog(match="wd_budget_ok_fn", max_compiles=1):
            for _ in range(3):
                step(torch.ones(4))

    def test_recompile_trips_budget(self):
        step = fresh_compiled("wd_budget_trip_fn")
        with pytest.raises(RecompileError, match="wd_budget_trip_fn x2"):
            with CompileWatchdog(match="wd_budget_trip_fn", max_compiles=1):
                step(torch.ones(2))
                step(torch.ones(3))

    def test_primary_exception_not_masked(self):
        step = fresh_compiled("wd_mask_fn")
        with pytest.raises(ValueError, match="primary"):
            with CompileWatchdog(match="wd_mask_fn", max_compiles=0):
                step(torch.ones(2))  # would trip the budget ...
                raise ValueError("primary")  # ... but this wins


class TestHygiene:
    def test_hooks_removed_and_logger_restored(self):
        logger = logging.getLogger("torch._inductor.compile_fx")
        before = (dict(convert_frame._bytecode_hooks), list(logger.filters),
                  logger.level)
        with CompileWatchdog():
            assert len(convert_frame._bytecode_hooks) == len(before[0]) + 1
            assert logger.isEnabledFor(logging.INFO)
        assert (dict(convert_frame._bytecode_hooks), list(logger.filters),
                logger.level) == before

    def test_opened_before_dynamo_is_imported(self):
        """A watchdog never imports Dynamo.  Opened before anything did, it
        hooks Dynamo's frame converter when that is imported and counts
        the compile that needed it; its import finder goes with the
        hooks, whether Dynamo came or not."""
        code = """
import sys
import torch
from distributedpytorch_tpu_torch.utils.compile_watchdog import (
    _HOOKS, CompileWatchdog)
with CompileWatchdog():
    assert _HOOKS._finder in sys.meta_path
assert _HOOKS._finder not in sys.meta_path
with CompileWatchdog() as wd:
    assert "torch._dynamo" not in sys.modules
    step = torch.compile(lambda x: x * 2 + 1, backend="eager",
                         dynamic=False)
    step(torch.ones(2)); step(torch.ones(2)); step(torch.ones(3))
    assert _HOOKS._finder not in sys.meta_path
assert _HOOKS._handle is None and _HOOKS._finder not in sys.meta_path
print(dict(wd.counts))
"""
        r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, timeout=300, cwd=REPO,
                           env=dict(os.environ, PYTHONPATH=REPO))
        assert r.returncode == 0, r.stderr[-2000:]
        assert r.stdout.strip().splitlines()[-1] == "{'<lambda>': 2}"

    def test_no_compile_log_spam_on_stderr(self, capfd):
        step = fresh_compiled("wd_quiet_fn")
        with CompileWatchdog(match="wd_quiet_fn") as wd:
            step(torch.ones(4))
        assert wd.total == 1
        err = capfd.readouterr().err
        assert "wd_quiet_fn" not in err and "torchinductor" not in err

    def test_nested_fresh_counts(self):
        step = fresh_compiled("wd_nested_fn")
        with CompileWatchdog(match="wd_nested_fn") as outer:
            step(torch.ones(2))
            with CompileWatchdog(match="wd_nested_fn") as inner:
                step(torch.ones(3))
        assert outer.counts["wd_nested_fn"] == 2
        assert inner.counts["wd_nested_fn"] == 1
