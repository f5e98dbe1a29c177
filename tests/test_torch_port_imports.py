"""The port stands alone: importing any of its modules loads neither JAX,
flax nor the JAX package (nor ``grain`` or ``cv2``, which the card's
machine does not have, nor scipy, which only an SBD read or write
needs), no source imports any of them, and
``chip_smoke.py`` refuses to run (printing no result) without a CUDA device
or away from the repository."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "distributedpytorch_tpu_torch"
MODULES = sorted(
    "distributedpytorch_tpu_torch." + ".".join(
        p.relative_to(PORT).with_suffix("").parts).replace(".__init__", "")
    for p in PORT.rglob("*.py"))
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _env():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_importing_every_module_leaves_jax_out():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'distributedpytorch_tpu', 'grain', 'cv2'))\n"
        "assert not bad, bad\n"
        "assert 'scipy' not in sys.modules, 'scipy waits for an SBD read'\n"
        "print('standalone-ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=REPO, env=_env())
    assert out.returncode == 0, out.stderr
    assert "standalone-ok" in out.stdout


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                # a relative import must stay inside the port package:
                # PORT/a/b.py may climb at most 2 levels, PORT/b.py 1
                levels = len(path.relative_to(PORT).parts) \
                    if PORT in path.parents else 0
                assert node.level <= levels, \
                    f"{path}: relative import leaves the package"
                continue
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "distributedpytorch_tpu",
                                "grain", "cv2"), \
                f"{path} imports {name}"


def test_data_parallel_modules_are_checked():
    """The data-parallel slice's modules stand alone like the rest: the
    two checks above cover them (they walk the package)."""
    for name in ("parallel.mesh", "parallel.consensus", "parallel.plan",
                 "parallel.zero", "parallel.launch", "ops.sync_bn"):
        assert f"distributedpytorch_tpu_torch.{name}" in MODULES
        assert PORT / (name.replace(".", "/") + ".py") in SOURCES


def test_telemetry_and_chaos_modules_are_checked():
    """The telemetry and chaos core, the serve metrics and the governor
    stand alone too: the JAX package's copies import JAX lazily, the
    port's import none of it."""
    for name in ("telemetry", "telemetry.registry", "telemetry.prometheus",
                 "telemetry.spans", "telemetry.events", "telemetry.goodput",
                 "telemetry.trace", "chaos", "chaos.faults", "chaos.sites",
                 "chaos.policies", "serve.metrics", "data.governor"):
        assert f"distributedpytorch_tpu_torch.{name}" in MODULES
        path = PORT / (name.replace(".", "/") + ".py")
        if not path.exists():
            path = PORT / name / "__init__.py"
        assert path in SOURCES


def test_chip_smoke_refuses_without_cuda(tmp_path):
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=240,
                         cwd=tmp_path, env={**_env(), "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {**_env(), "PYTHONPATH": ""}
    out = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                         text=True, timeout=240, cwd=tmp_path, env=env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
