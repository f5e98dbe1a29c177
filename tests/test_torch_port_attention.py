"""The port's attention ops against the JAX package's, on the CPU.

Inputs come from numpy with fixed seeds and go through both packages.  The
plain PyTorch forms are held to the JAX jnp forms and to the Pallas kernels
run in interpret mode (as tests/test_ring_flash.py runs them); N is not a
block multiple, so the key-mask and zero-row paths are exercised.  On the
CPU the kernel wrappers must take the plain forms and count no launch; the
CUDA kernels themselves are checked on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.ops import attention as jatt
from distributedpytorch_tpu.ops import pallas_attention as jpallas
from distributedpytorch_tpu_torch.ops import _build
from distributedpytorch_tpu_torch.ops import attention as tatt
from distributedpytorch_tpu_torch.ops import cuda_attention as ca

#: float32, different summation order: 1e-5 x max |reference|
RTOL = 1e-5


def assert_close(got, ref, rtol=RTOL):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    bound = rtol * max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(got - ref).max()) <= bound


def qkv(b=2, n=300, ck=16, cv=32, seed=0):
    r = np.random.RandomState(seed)
    return tuple(r.randn(b, n, c).astype(np.float32) for c in (ck, ck, cv))


def tokens(b=2, n=100, c=32, seed=7):
    return np.random.RandomState(seed).randn(b, n, c).astype(np.float32)


def t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


class TestPlainFormsVsJax:
    @pytest.mark.parametrize("n", [300, 256])
    def test_position_attention(self, n):
        q, k, v = qkv(n=n)
        ref = jatt.position_attention(*map(jnp.asarray, (q, k, v)))
        assert_close(tatt.position_attention(*t(q, k, v)), ref)

    @pytest.mark.parametrize("block", [64, 128])
    def test_blocked_position_attention(self, block):
        q, k, v = qkv(seed=1)
        ref = jatt.blocked_position_attention(*map(jnp.asarray, (q, k, v)),
                                              block_size=block)
        assert_close(tatt.blocked_position_attention(*t(q, k, v), block), ref)

    def test_blocked_matches_full_with_scale(self):
        q, k, v = t(*qkv(seed=2))
        assert_close(tatt.blocked_position_attention(q, k, v, 128, scale=0.125),
                     tatt.position_attention(q, k, v, scale=0.125))

    @pytest.mark.parametrize("n", [100, 128])
    def test_channel_attention(self, n):
        x = tokens(n=n)
        ref = jatt.channel_attention(jnp.asarray(x))
        assert_close(tatt.channel_attention(torch.from_numpy(x)), ref)

    def test_channel_halves_compose(self):
        x = torch.from_numpy(tokens(seed=3))
        attn = tatt.channel_energy(x)
        assert attn.dtype == torch.float32 and attn.shape == (2, 32, 32)
        np.testing.assert_allclose(attn.sum(-1).numpy(), 1.0, atol=1e-5)
        assert torch.equal(tatt.channel_apply(attn, x),
                           tatt.channel_attention(x))

    def test_bf16_keeps_dtype(self):
        q, k, v = (a.to(torch.bfloat16) for a in t(*qkv(seed=4)))
        assert tatt.position_attention(q, k, v).dtype == torch.bfloat16
        x = torch.from_numpy(tokens()).to(torch.bfloat16)
        assert tatt.channel_attention(x).dtype == torch.bfloat16


class TestWrappersVsPallasInterpret:
    """The wrappers' CPU path against the TPU kernels in interpret mode."""

    @pytest.mark.parametrize("scale", [None, 0.125])
    def test_flash_position_attention(self, scale):
        q, k, v = qkv(seed=5)
        ref = jpallas.flash_position_attention(
            *map(jnp.asarray, (q, k, v)), 128, 128, scale, True)
        before = dict(ca.launches)
        got = ca.flash_position_attention(*t(q, k, v), 128, 128, scale=scale)
        assert_close(got, ref)
        assert ca.launches == before

    @pytest.mark.parametrize("n", [100, 128])
    def test_flash_channel_attention(self, n):
        x = tokens(n=n, seed=8)
        ref = jpallas.flash_channel_attention(jnp.asarray(x), 64, True)
        before = dict(ca.launches)
        assert_close(ca.flash_channel_attention(torch.from_numpy(x), 64), ref)
        assert ca.launches == before


class TestWrapperChecks:
    def test_shape_mismatch_raises(self):
        q, k, v = t(*qkv(n=10))
        with pytest.raises(ValueError):
            ca.flash_position_attention(q, k[:, :5], v)
        with pytest.raises(ValueError):
            ca.cam_apply(torch.zeros(2, 8, 8), torch.zeros(2, 10, 4))

    def test_non_cuda_device_raises(self):
        x = torch.zeros(1, 16, 8, device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            ca.cam_energy(x)

    def test_mixed_devices_raise(self):
        q, k, v = t(*qkv(n=10))
        with pytest.raises(ValueError, match="different devices"):
            ca.flash_position_attention(q, k, v.to("meta"))

    @pytest.mark.parametrize("batch,channels,n_tok,splits", [
        (1, 512, 4096, 8),    # serving shape at B = 1: 16 tiles x 8
        (8, 512, 4096, 1),    # 128 blocks already
        (2, 512, 4225, 4),
        (1, 128, 4096, 8),
        (2, 128, 65, 1),      # short N: no slice under 256 tokens
    ])
    def test_gram_splits(self, batch, channels, n_tok, splits):
        assert ca.gram_splits(batch, channels, n_tok) == splits


class TestBuild:
    def test_missing_nvcc_raises(self, monkeypatch):
        monkeypatch.setattr(_build.os, "access", lambda *a: False)
        monkeypatch.setattr(_build.shutil, "which", lambda name: None)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.find_nvcc()

    def test_nvcc_from_cuda_home(self, monkeypatch, tmp_path):
        nvcc = tmp_path / "bin" / "nvcc"
        nvcc.parent.mkdir()
        nvcc.write_text("#!/bin/sh\n")
        nvcc.chmod(0o755)
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        assert _build.find_nvcc() == str(nvcc)

    def test_library_name_follows_source(self, monkeypatch, tmp_path):
        monkeypatch.setattr(_build, "CSRC", tmp_path)
        (tmp_path / "k.cu").write_text("// one\n")
        first = _build._library_path("k")
        assert _build._library_path("k") == first
        (tmp_path / "k.cu").write_text("// two\n")
        assert _build._library_path("k") != first
        (tmp_path / "k.cuh").write_text("// header\n")
        assert first.parent == _build.BUILD_DIR
        assert first.name.startswith("libk_") and first.suffix == ".so"

    def test_sources_present(self):
        src = (_build.CSRC / "attention.cu").read_text()
        for entry in ("dptpu_pam_forward", "dptpu_cam_energy",
                      "dptpu_cam_apply"):
            assert f"int {entry}(" in src
        assert set(ca._SIGNATURES) == {"dptpu_pam_forward",
                                       "dptpu_cam_energy", "dptpu_cam_apply"}
