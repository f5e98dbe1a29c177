"""Pins the JAX package's n-ellipse path in the port's parity tests.

The JAX package's ``compute_nellipse`` takes its native rasterizer only
when its host library (``native/libdptpu_host.so``, git-ignored) is
loaded and ``DPTPU_NATIVE`` is not ``0``, and its numpy form otherwise;
the port always takes its own library.  So a parity test must say which
JAX path it compares with.  :func:`jax_native_path` gives the native one:
it loads the JAX library, building it first from ``native/image_ops.cpp``
into a temporary directory (pointed to by ``DPTPU_NATIVE_LIB``) where no
build is there, and skips only where no C++ compiler exists.  The JAX
module's loaded library is put back as it was afterwards, so later tests
in the process see the JAX package as they would have.
"""

import os
import shutil
import subprocess

import pytest

from distributedpytorch_tpu import native_ops as jax_native_ops

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "native", "image_ops.cpp")


@pytest.fixture(scope="session")
def jax_native_lib(tmp_path_factory):
    """The path of a JAX host library to load: the repo's build where
    there is one, else a build of ``native/image_ops.cpp`` made here."""
    built = os.path.join(jax_native_ops._NATIVE_DIR, jax_native_ops._LIB_NAME)
    if os.path.exists(built):
        return built
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the JAX package's host library")
    out = str(tmp_path_factory.mktemp("jax_native") / jax_native_ops._LIB_NAME)
    subprocess.run([cxx, "-O3", "-fPIC", "-std=c++17", "-shared", "-o", out,
                    SOURCE], check=True, capture_output=True)
    return out


@pytest.fixture
def jax_native_path(jax_native_lib, monkeypatch):
    """Within the test, the JAX package's n-ellipse takes its native
    rasterizer."""
    saved = jax_native_ops._lib
    monkeypatch.delenv("DPTPU_NATIVE", raising=False)
    monkeypatch.setenv("DPTPU_NATIVE_LIB", jax_native_lib)
    if saved is None:
        jax_native_ops.load()
    assert jax_native_ops.enabled()
    yield
    jax_native_ops._lib = saved
