"""The port's host image library (``csrc/host_image_ops.cpp`` behind
``native_ops.py``), on the CPU.

* The copy's C API — every exported function with its parameter list — is
  the JAX package's ``native/image_ops.cpp``'s, and ``native_ops`` binds
  each one.  The library is built from the port's own source into
  ``build/kernels/`` (never ``native/``), a failed build or a missing
  compiler raises, and ``DPTPU_NATIVE=0`` is the only way to the numpy
  forms: ``imaging``, ``helpers.make_gt`` and ``guidance.compute_nellipse``
  call the library otherwise.
* Each op against the port's numpy form on the same inputs: nearest
  resizes, warps (nearest and cubic, float32 and uint8) and the flip bit
  for bit; linear and cubic resizes and the fused crop + resize within
  1e-3 on the [0, 255] scale (summation order), and so uint8 cubic
  resizes within one grey level (a sum near a half rounds either way); the gaussian heatmap
  within 1e-6 and the n-ellipse within 1e-5 on [0, 1] (the library
  computes them in float and double, the numpy forms in float64 and
  float32).
* Each op against the JAX package's library (built here from
  ``native/image_ops.cpp`` into a temporary directory) on the same inputs:
  the flip, the gaussian heatmap and the n-ellipse bit for bit; linear and
  cubic resizes and the fused crop + resize within 2e-3 (the port takes the
  tap coordinates in double, as cv2 does, the JAX library in float);
  nearest resizes bit for bit where the output size is a power of two (the
  JAX library's float tap coordinates pick other pixels at other sizes).
  The warp follows OpenCV 5's float coordinates where the JAX library
  follows OpenCV 4's 1/32-pixel fixed point: uint8 images within one grey
  level on >= 98% of pixels, masks equal on >= 99.5%.
* The fused crop + resize train stack against the JAX package's
  ``build_train_transform(fused_crop_resize=True)`` on the JAX package's
  fixture (the JAX warp through cv2, its crop through its library):
  ``crop_gt`` bit for bit, ``crop_image`` within 2 grey levels (the warps'
  rare one-level differences through the cubic resize), the guidance and
  ``concat`` within 2 as well; and against the port's own stack on the
  numpy forms within 1e-3.
* ``prepare_input`` (serving) on the library against the numpy forms:
  within 1e-3 on the [0, 255] scale, the same bbox.
"""

import ctypes
import re
import subprocess
from pathlib import Path

import numpy as np
import pytest

from distributedpytorch_tpu import native_ops as jax_native
from distributedpytorch_tpu.data import fake as jax_fake
from distributedpytorch_tpu.data import pipeline as jax_pipeline
from distributedpytorch_tpu.data import voc as jax_voc
from distributedpytorch_tpu_torch import imaging, native_ops
from distributedpytorch_tpu_torch.data import guidance, pipeline, voc
from distributedpytorch_tpu_torch.ops import _build
from distributedpytorch_tpu_torch.predict import prepare_input
from distributedpytorch_tpu_torch.utils import helpers

REPO = Path(__file__).resolve().parents[1]
PORT_SRC = REPO / "distributedpytorch_tpu_torch" / "csrc" / "host_image_ops.cpp"
JAX_SRC = REPO / "native" / "image_ops.cpp"


def c_api(path: Path) -> dict[str, str]:
    """Every function defined in the ``extern "C"`` block (the exported
    ones and their helpers) -> its parameter list, whitespace-normalized."""
    text = path.read_text()
    body = text[text.index('extern "C" {'):]
    return {name: " ".join(params.split())
            for name, params in re.findall(r"^void (\w+)\(([^)]*)\)", body,
                                           flags=re.M)}


#: the functions ``native_ops`` binds
EXPORTED = ("resize_f32", "warp_affine_f32", "crop_resize_f32", "hflip_f32",
            "gaussian_hm_f32", "nellipse_f32")


def test_c_api_is_the_jax_librarys():
    port, ref = c_api(PORT_SRC), c_api(JAX_SRC)
    assert port == ref and set(EXPORTED) <= set(port)
    lib = native_ops.load()
    for name in EXPORTED:
        assert getattr(lib, name).argtypes is not None, name


def test_built_from_the_ports_source_into_build_kernels():
    native_ops.load()
    path = _build._library_path(native_ops.LIBRARY)
    assert path.parent == REPO / "build" / "kernels" and path.exists()
    assert _build._source(native_ops.LIBRARY) == (PORT_SRC, False)
    assert str(path) in {native_ops.load()._name}


def test_failed_build_and_missing_compiler_raise(tmp_path, monkeypatch):
    (tmp_path / "host_image_ops.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(native_ops, "_lib", None)
    with pytest.raises(RuntimeError, match="failed for host_image_ops.cpp"):
        native_ops.load()
    monkeypatch.setenv("CXX", "")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native_ops.load()


def test_routing_follows_dptpu_native(monkeypatch):
    img = image((30, 40))
    calls = []
    for env in (None, "0"):
        if env is not None:
            monkeypatch.setenv("DPTPU_NATIVE", env)
        native_ops.reset_calls()
        imaging.resize(img, (20, 20))
        imaging.warp_affine(img, imaging.rotation_matrix((20, 15), 10, 1), (30, 40))
        imaging.flip_h(img)
        imaging.crop_resize(img, (-3, -2, 30, 20), (16, 16))
        helpers.make_gt(np.zeros((30, 40)), np.array([[3, 4], [20, 10]]))
        guidance.compute_nellipse(np.arange(40), np.arange(30), [[3, 4], [20, 10]])
        calls.append(dict(native_ops.calls))
    assert calls[0] == dict.fromkeys(calls[0], 1)
    assert calls[1] == dict.fromkeys(calls[1], 0)


def image(size, seed=0, channels=3) -> np.ndarray:
    """Smooth structure plus noise, float32 in [0, 255]."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size[0], 0:size[1]].astype(np.float32)
    img = np.stack([127 + 100 * np.sin(xx / 7 + c) * np.cos(yy / 11 - c)
                    for c in range(channels)], -1)
    return np.clip(img + r.normal(0, 8, img.shape), 0, 255).astype(np.float32)


def mask(size) -> np.ndarray:
    m = np.zeros(size, np.float32)
    m[size[0] // 4:3 * size[0] // 4, size[1] // 5:3 * size[1] // 4] = 1
    return m


POINTS = np.array([[3, 40], [50, 2], [97, 30], [60, 70]])
MATRIX = imaging.rotation_matrix((50, 37.5), 13.7, 1.1)


@pytest.fixture
def numpy_forms(monkeypatch):
    """Call ``fn`` with the numpy forms selected."""
    def call(fn):
        monkeypatch.setenv("DPTPU_NATIVE", "0")
        try:
            return fn()
        finally:
            monkeypatch.delenv("DPTPU_NATIVE")
    return call


#: (op, function of an (H, W, 3) float32 image, max |diff| to the numpy form)
OPS = [
    ("resize nearest up", lambda a: imaging.resize(a, (150, 230), imaging.NEAREST), 0),
    ("resize nearest down", lambda a: imaging.resize(a, (37, 51), imaging.NEAREST), 0),
    ("resize nearest mask", lambda a: imaging.resize(mask(a.shape[:2]), (64, 64),
                                                     imaging.NEAREST), 0),
    ("resize linear", lambda a: imaging.resize(a, (150, 230), imaging.LINEAR), 1e-3),
    ("resize cubic up", lambda a: imaging.resize(a, (150, 230), imaging.CUBIC), 1e-3),
    ("resize cubic down", lambda a: imaging.resize(a, (37, 51), imaging.CUBIC), 1e-3),
    ("resize cubic uint8", lambda a: imaging.resize(a.astype(np.uint8), (64, 64),
                                                    imaging.CUBIC), 1),
    ("warp cubic", lambda a: imaging.warp_affine(a, MATRIX, a.shape[:2]), 0),
    ("warp cubic uint8", lambda a: imaging.warp_affine(a.astype(np.uint8), MATRIX,
                                                       a.shape[:2]), 0),
    ("warp nearest mask", lambda a: imaging.warp_affine(
        mask(a.shape[:2]), MATRIX, a.shape[:2], imaging.NEAREST, 255), 0),
    ("crop_resize overhang", lambda a: imaging.crop_resize(a, (-10, 5, 60, 90),
                                                           (64, 64)), 1e-3),
    ("crop_resize inside", lambda a: imaging.crop_resize(a, (3, 4, 40, 30),
                                                         (64, 64)), 1e-3),
    ("crop_resize nearest", lambda a: imaging.crop_resize(
        mask(a.shape[:2]), (-4, 10, 90, 80), (64, 64), imaging.NEAREST), 0),
    ("flip", lambda a: imaging.flip_h(a), 0),
    ("flip uint8 mask", lambda a: imaging.flip_h(mask(a.shape[:2]).astype(np.uint8)), 0),
    ("gaussian_hm", lambda a: helpers.make_gt(np.zeros(a.shape[:2]), POINTS), 1e-6),
    ("gaussian_hm float points", lambda a: helpers.make_gt(
        np.zeros(a.shape[:2]), POINTS * 0.731 + 0.25), 1e-6),
    ("nellipse", lambda a: guidance.compute_nellipse(
        np.arange(a.shape[1]), np.arange(a.shape[0]), POINTS), 1e-5),
]


@pytest.mark.parametrize("op,fn,tol", OPS, ids=[o[0] for o in OPS])
def test_library_against_numpy_forms(op, fn, tol, numpy_forms):
    img = image((75, 100))
    got, want = fn(img), numpy_forms(lambda: fn(img))
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = float(np.abs(got.astype(np.float64) - want).max())
    assert diff <= tol, f"{op}: {diff:.3e} > {tol:.1e}"


@pytest.fixture(scope="module")
def jax_library(tmp_path_factory):
    """The JAX package's library, built from ``native/image_ops.cpp`` with
    its Makefile's flags into a temporary directory."""
    out = tmp_path_factory.mktemp("jax_native") / "libdptpu_host.so"
    subprocess.run([_build.find_cxx(), "-O3", "-fPIC", "-std=c++17", "-shared",
                    "-o", str(out), str(JAX_SRC)], check=True)
    return jax_native._bind(ctypes.CDLL(str(out)))


@pytest.fixture
def jax_lib(jax_library, monkeypatch):
    monkeypatch.setattr(jax_native, "_lib", jax_library)
    monkeypatch.delenv("DPTPU_NATIVE", raising=False)
    return jax_native


#: (op, port call, JAX call, max |diff|), on an (H, W, 3) float32 image
JAX_OPS = [
    ("resize nearest pow2", lambda n, a: n.resize(a, (64, 128), 0), 0),
    ("resize linear", lambda n, a: n.resize(a, (150, 230), 1), 2e-3),
    ("resize cubic up", lambda n, a: n.resize(a, (150, 230), 2), 2e-3),
    ("resize cubic down", lambda n, a: n.resize(a, (37, 51), 2), 2e-3),
    ("crop_resize", lambda n, a: n.crop_resize(a, (-10, 5, 60, 90), (64, 64), 2), 2e-3),
    ("crop_resize nearest", lambda n, a: n.crop_resize(
        mask(a.shape[:2]), (-4, 10, 90, 80), (64, 64), 0), 0),
    ("hflip", lambda n, a: n.hflip(a), 0),
    ("gaussian_hm", lambda n, a: n.gaussian_hm(POINTS, a.shape[:2], 10.0), 0),
    ("nellipse", lambda n, a: n.nellipse(POINTS, a.shape[:2], 0.05), 0),
]


@pytest.mark.parametrize("op,fn,tol", JAX_OPS, ids=[o[0] for o in JAX_OPS])
def test_library_against_jax_library(op, fn, tol, jax_lib):
    img = image((75, 100))
    got, want = fn(native_ops, img), fn(jax_lib, img)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    diff = float(np.abs(got.astype(np.float64) - want).max())
    assert diff <= tol, f"{op}: {diff:.3e} > {tol:.1e}"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_warp_against_jax_library(seed, jax_lib):
    """OpenCV 5's float coordinates against the JAX library's OpenCV 4
    fixed point."""
    r = np.random.default_rng(seed)
    img8, msk = image((75, 100), seed).astype(np.uint8), mask((75, 100))
    m = imaging.rotation_matrix((50, 37.5), r.uniform(-20, 20), r.uniform(0.75, 1.25))
    got = imaging.warp_affine(img8, m, (75, 100), imaging.CUBIC, 0)
    want = np.clip(np.rint(jax_lib.warp_affine(img8, m, (75, 100), 2, 0.0)),
                   0, 255).astype(np.uint8)
    assert (np.abs(got.astype(int) - want) <= 1).mean() >= 0.98
    for border in (0, 255):
        got = native_ops.warp_affine(msk, m, (75, 100), 0, border)
        want = jax_lib.warp_affine(msk, m, (75, 100), 0, float(border))
        assert (got == want).mean() >= 0.995


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc"))
    jax_fake.make_fake_voc(root, n_images=6, size=(96, 128), n_val=2, seed=3)
    return root


FUSED = dict(crop_size=(64, 64), relax=10, zero_pad=True,
             fused_crop_resize=True)


def test_fused_stack_matches_jax(fixture_root, jax_lib):
    ref = jax_voc.VOCInstanceSegmentation(
        fixture_root, split="train", preprocess=True,
        transform=jax_pipeline.build_train_transform(**FUSED))
    got = voc.VOCInstanceSegmentation(
        fixture_root, split="train", transform=pipeline.build_train_transform(**FUSED))
    assert len(got) == len(ref) > 0
    for i in range(len(ref)):
        g = got.__getitem__(i, rng=pipeline.sample_rng(0, 1, i))
        w = ref.__getitem__(i, rng=jax_pipeline.sample_rng(0, 1, i))
        assert set(g) == set(w)
        for key in w:
            if key == "meta":
                assert g[key] == w[key]
                continue
            a, b = np.asarray(g[key]), np.asarray(w[key])
            assert a.shape == b.shape and a.dtype == b.dtype, key
            if key in ("crop_gt", "bbox"):
                np.testing.assert_array_equal(a, b, err_msg=key)
            else:
                assert float(np.abs(a.astype(np.float64) - b).max()) <= 2.0, key
        assert 0.0 <= g["crop_image"].min() and g["crop_image"].max() <= 255.0


def test_fused_stack_on_numpy_forms(fixture_root, numpy_forms):
    ds = voc.VOCInstanceSegmentation(
        fixture_root, split="train", transform=pipeline.build_train_transform(**FUSED))
    for i in range(len(ds)):
        got = ds.__getitem__(i, rng=pipeline.sample_rng(0, 1, i))
        want = numpy_forms(lambda: ds.__getitem__(i, rng=pipeline.sample_rng(0, 1, i)))
        for key in ("crop_image", "crop_gt", "concat"):
            assert float(np.abs(got[key].astype(np.float64) - want[key]).max()) \
                <= 1e-3, key
        np.testing.assert_array_equal(got["crop_gt"], want["crop_gt"])


def test_prepare_input_on_the_library(numpy_forms):
    img = image((120, 160))
    pts = np.array([[10.0, 60.0], [80.0, 7.0], [150.0, 50.0], [70.0, 110.0]])
    native_ops.reset_calls()
    got, bbox = prepare_input(img, pts, resolution=(64, 64))
    assert native_ops.calls["resize"] == 1 and native_ops.calls["nellipse"] == 1
    want, want_bbox = numpy_forms(lambda: prepare_input(img, pts, resolution=(64, 64)))
    assert bbox == want_bbox
    assert float(np.abs(got.astype(np.float64) - want).max()) <= 1e-3
