"""The port's attention ops against the JAX package's, on the CPU.

Inputs come from numpy with fixed seeds and go through both packages.  The
plain PyTorch forms are held to the JAX jnp forms and to the Pallas kernels
run in interpret mode (as tests/test_ring_flash.py runs them); N is not a
block multiple, so the key-mask and zero-row paths are exercised.  On the
CPU the kernel wrappers must take the plain forms and count no launch; the
CUDA kernels themselves are checked on the card by chip_smoke.py.
"""

import re

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

    @pytest.mark.parametrize("splits", [1, 3])
    def test_every_launch_runs_under_its_tensors_device(self, monkeypatch,
                                                        splits):
        """The ``ctypes`` entry points launch into the calling thread's
        current device, so each of the four launches must run inside
        ``_on_device`` for the tensor it launches on.  The library and the
        guard are replaced by recorders; the tensors lie on the CPU with
        the CPU check bypassed, so the launch paths run here."""
        guards: list[torch.Tensor] = []
        calls: list[tuple[str, int | None, tuple]] = []

        class Guard:
            def __init__(self, tensor):
                self.tensor = tensor

            def __enter__(self):
                guards.append(self.tensor)

            def __exit__(self, *exc):
                guards.pop()

        class Lib:
            def __getattr__(self, name):
                def launch(*args):
                    calls.append((name, guards[-1].data_ptr() if guards
                                  else None, args))
                    return 0
                return launch

        monkeypatch.setattr(ca, "_on_device", Guard)
        monkeypatch.setattr(ca, "_lib", Lib)
        monkeypatch.setattr(ca, "_on_cpu", lambda *ts: False)
        monkeypatch.setattr(ca, "_stream", lambda t: 0)
        monkeypatch.setattr(ca, "gram_splits", lambda *a: splits)
        monkeypatch.setattr(ca, "_sm_count", lambda device: 132)
        before = dict(ca.launches)
        q, k, v = t(*qkv(n=64))
        ca.flash_position_attention(q, k, v)
        x = torch.from_numpy(tokens(n=64))
        ca.cam_apply(ca.cam_energy(x), x)
        assert [c[0] for c in calls] == ["dptpu_pam_forward", "dptpu_cam_gram",
                                         "dptpu_cam_softmax", "dptpu_cam_apply"]
        for name, guarded, args in calls:
            # the guard's tensor is one the launch reads or writes
            assert guarded is not None and guarded in args, name
        assert not guards
        assert {n: ca.launches[n] - before[n] for n in before} == \
            {"position_attention": 1, "cam_energy": 1, "cam_apply": 1}
        ca.launches.update(before)

    def test_device_guard_is_the_tensors_device(self, monkeypatch):
        seen = []
        monkeypatch.setattr(torch.cuda, "device", lambda d: seen.append(d))
        ca._on_device(torch.zeros(2, device="meta"))
        assert seen == [torch.device("meta")]

    @pytest.mark.parametrize("batch,channels,n_tok,sms,splits", [
        (1, 512, 4096, 132, 13),  # serving shape at B = 1: 10 tiles x 13
        (8, 512, 4096, 132, 3),   # 80 tiles: 240 blocks, two to most SMs
        (2, 512, 4225, 132, 13),  # ragged N
        (1, 128, 4096, 132, 16),  # narrow head: capped at 16 slices
        (2, 128, 65, 132, 1),     # short N: no slice under 256 tokens
        (2, 100, 4225, 132, 16),  # odd C: one ragged tile
        (1, 67, 257, 132, 1),
        (1, 512, 4096, 114, 11),  # an H100 PCIe: 11 x 10 blocks fit one wave
        (16, 512, 4096, 132, 1),  # 160 blocks already
        (0, 512, 4096, 132, 1),   # nothing to launch
    ])
    def test_gram_splits(self, batch, channels, n_tok, sms, splits):
        got = ca.gram_splits(batch, channels, n_tok, sms)
        assert got == splits
        side = -(-channels // 128)
        tiles = side * (side + 1) // 2  # on and above the diagonal
        assert got == 1 or tiles * batch * got <= 2 * sms  # all resident
        assert got == 1 or n_tok // got >= 256

    @pytest.mark.parametrize("batch,channels,n_tok,splits", [
        (1, 512, 4096, 13), (16, 512, 4096, 1), (2, 100, 4225, 16)])
    def test_gram_buffers(self, monkeypatch, batch, channels, n_tok, splits):
        monkeypatch.setattr(ca, "_sm_count", lambda device: 132)
        partial, attn = ca._gram_buffers(torch.zeros(batch, n_tok, channels))
        assert attn.shape == (batch, channels, channels)
        assert partial.shape == (batch, splits, channels, channels)
        assert partial.dtype == attn.dtype == torch.float32
        # one slice: the softmax runs in place on the Gram's output
        assert (partial.data_ptr() == attn.data_ptr()) == (splits == 1)


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
        entries = {"dptpu_pam_forward", "dptpu_cam_gram", "dptpu_cam_softmax",
                   "dptpu_cam_apply"}
        for entry in entries:
            assert f"int {entry}(" in src
        assert set(ca._SIGNATURES) == entries

    @pytest.mark.parametrize("cu_name,py_name", [
        ("kGramTile", "_GRAM_TILE"), ("kGramMaxSplits", "_GRAM_MAX_SPLITS"),
        ("kPamMaxCk", "MAX_CK")])
    def test_constants_agree(self, cu_name, py_name):
        src = (_build.CSRC / "attention.cu").read_text()
        (value,) = re.findall(rf"constexpr int {cu_name} = (\d+);", src)
        assert int(value) == getattr(ca, py_name)

    def test_channel_kernels_use_tensor_cores(self):
        src = (_build.CSRC / "attention.cu").read_text()
        assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
        assert "atomicAdd" not in src  # fixed-order sums only
        assert "tile_fma" not in src  # no CUDA-core tile product left
        # the position kernel too: bf16 inputs on the bf16 tensor-core
        # instruction, and no scalar fma product anywhere
        assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
        assert not re.search(r"\bfmaf?\(", src)
        assert "to_f32(" not in src  # nothing widens bf16 to a float32 loop


def tf32_rna(a):
    """numpy twin of the kernels' big part: TF32 rounded to nearest, ties
    away from zero (the bits of cvt.rna.tf32.f32 for finite inputs), by the
    same two integer operations, on float32 arrays."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_read(a):
    """The value a tensor core's m16n8k8.tf32 takes from a float32 bit
    pattern: its top 19 bits (toward zero)."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def mma_product(a, b, passes, acc=None):
    """float32 ``acc`` + (M, K)·(K, N) the way the kernels take it: over
    8-deep steps, each adding its pass products to a float32 accumulator
    (zero unless ``acc`` is given) in the given order; ``passes`` maps
    (a, b) of one step to the list of operand pairs, which the tensor core
    reads as ``tf32_read`` does."""
    if acc is None:
        acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(0, a.shape[1], 8):
        for pa, pb in passes(a[:, k:k + 8], b[k:k + 8]):
            term = tf32_read(pa).astype(np.float64) @ tf32_read(pb).astype(np.float64)
            acc = (acc.astype(np.float64) + term).astype(np.float32)
    return acc


def split(v):
    """The kernels' split: big rounded to nearest, small = v - big exact in
    float32 and handed to the tensor core as it is."""
    big = tf32_rna(v)
    with np.errstate(invalid="ignore"):
        return big, (v - big).astype(np.float32)


def three_tf32(a, b):
    (ab, as_), (bb, bs) = split(a), split(b)
    return [(as_, bb), (ab, bs), (ab, bb)]  # the two small terms first


def one_tf32(a, b):
    return [(tf32_rna(a), tf32_rna(b))]


class TestThreeTf32Numerics:
    """The kernels' split-float products, emulated in numpy, against float64
    at a reduced serving shape (unit-variance features): inside the
    1e-4 x max bound the card's checks enforce, where one TF32 pass is not."""

    N, C = 1024, 64

    def features(self, seed=11):
        return np.random.RandomState(seed).randn(self.N, self.C).astype(np.float32)

    def test_rounding_matches_tf32(self):
        v = np.array([1.0, 1 + 2 ** -11, 1 + 2 ** -10 + 2 ** -11, -(1 + 2 ** -11),
                      3.14159265, 0.0], np.float32)
        r = tf32_rna(v)
        assert np.all(r.view(np.uint32) & 0x1FFF == 0)
        # ties go away from zero; other values to nearest
        np.testing.assert_array_equal(
            r, np.array([1.0, 1 + 2 ** -10, 1 + 2 ** -9, -(1 + 2 ** -10),
                         3.140625, 0.0], np.float32))
        big, small = split(v)
        np.testing.assert_array_equal(big.astype(np.float64) + small, v)  # exact
        # what the tensor core reads of the two parts: within 2^-21 |v|
        np.testing.assert_allclose(big.astype(np.float64) + tf32_read(small), v,
                                   rtol=2 ** -21)

    @pytest.mark.parametrize("bits,small_nan", [
        (0x7FFFFFFF, True),  # the device's NaN: rounding carries it into a zero
        (0xFFFFFFFF, True),
        (0x7F800001, True),  # low payload only: rounding masks it into an infinity
        (0x7FC00000, True),
        (0x7F800000, True),  # an infinity: inf - inf
        (0xFF800000, True),
        (0x7F7FFFFF, False),  # finite, but big rounds to infinity: small is -inf
    ])
    def test_split_keeps_nan(self, bits, small_nan):
        """Whatever the rounding makes of a NaN, the small part the tensor
        core reads is a NaN, so every product with it is; an infinity (or a
        value whose big part rounds to one) comes out as NaN too."""
        v = np.array([bits], np.uint32).view(np.float32)
        _, small = split(v)
        assert np.isnan(tf32_read(small)[0]) == small_nan
        with np.errstate(invalid="ignore"):
            out = mma_product(np.tile(v, (1, 8)), np.ones((8, 1), np.float32),
                              three_tf32)
        assert np.isnan(out[0, 0])

    @staticmethod
    def energy(gram):
        e = gram.max(-1, keepdims=True) - gram
        p = np.exp(e - e.max(-1, keepdims=True))
        return p / p.sum(-1, keepdims=True)

    def test_gram_and_map(self):
        x = self.features()
        ref = x.T.astype(np.float64) @ x
        got = mma_product(x.T.copy(), x, three_tf32)
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
        attn_ref = self.energy(ref)
        attn = self.energy(got.astype(np.float64))
        assert np.abs(attn - attn_ref).max() <= 1e-4 * attn_ref.max()
        # one TF32 pass misses the bound on the map by far
        one = self.energy(mma_product(x.T.copy(), x, one_tf32).astype(np.float64))
        assert np.abs(one - attn_ref).max() > 10 * 1e-4 * attn_ref.max()

    def test_apply(self):
        x = self.features(seed=12)
        attn = self.energy(x.T.astype(np.float64) @ x * 0.01).astype(np.float32)
        ref = x.astype(np.float64) @ attn.T
        got = mma_product(x, attn.T.copy(), three_tf32)
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()

    def test_bf16_inputs_need_fewer_passes(self):
        x = torch.from_numpy(self.features(seed=13)).to(torch.bfloat16).float().numpy()
        assert np.array_equal(tf32_rna(x), x)  # exact in TF32: small = 0
        ref = x.T.astype(np.float64) @ x
        got = mma_product(x.T.copy(), x, lambda a, b: [(a, b)])
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def bf16_round(a):
    """float32 values rounded to bfloat16, nearest even (an astype)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def pam_kernel_emulated(q, k, v, passes, p_cast=lambda p: p, stage=32):
    """The position kernel's arithmetic for one batch entry: keys in stages
    of 32 (the last one zero-padded, its keys past N scored -1e30), each
    stage's scores an ``mma_product`` with ``passes``, the online softmax
    in float32 (running max, sum over the unrounded p, rescaled
    accumulator), then ``p_cast(p)``·V added to the accumulator with the
    same passes (for 3xTF32, p split in registers), out = acc / max(sum,
    1e-30)."""
    n, cv = q.shape[0], v.shape[1]
    m = np.full((n, 1), -1e30, np.float32)
    total = np.zeros((n, 1), np.float32)
    acc = np.zeros((n, cv), np.float32)
    for k0 in range(0, n, stage):
        live = min(stage, n - k0)
        ks = np.zeros((stage, k.shape[1]), np.float32)
        vs = np.zeros((stage, cv), np.float32)
        ks[:live], vs[:live] = k[k0:k0 + live], v[k0:k0 + live]
        s = mma_product(q, ks.T.copy(), passes)
        s[:, live:] = np.float32(-1e30)
        m_new = np.maximum(m, s.max(-1, keepdims=True))
        corr = np.exp(m - m_new)
        p = np.exp(s - m_new)
        total = total * corr + p.sum(-1, keepdims=True, dtype=np.float32)
        acc = mma_product(p_cast(p), vs, passes, acc * corr)
        m = m_new
    return acc / np.maximum(total, np.float32(1e-30))


class TestPositionKernelNumerics:
    """The position kernel's arithmetic, emulated in numpy at a reduced
    serving shape (Ck = 64, Cv = 64; q and k at unit scale, where the
    unscaled softmax is sharp and one TF32 pass on the scores shows),
    against float64: inside the 1e-4 x max bound the card's checks
    enforce, where one TF32 pass on both products is not."""

    @staticmethod
    def inputs(n, seed=21):
        r = np.random.RandomState(seed)
        return tuple(r.randn(n, 64).astype(np.float32) for _ in range(3))

    @staticmethod
    def exact(q, k, v):
        s = q.astype(np.float64) @ k.astype(np.float64).T
        p = np.exp(s - s.max(-1, keepdims=True))
        return (p @ v) / p.sum(-1, keepdims=True)

    @pytest.mark.parametrize("n", [512, 500])  # 500: the last stage is ragged
    def test_three_tf32_inside_bound(self, n):
        q, k, v = self.inputs(n)
        ref = self.exact(q, k, v)
        limit = 1e-4 * np.abs(ref).max()
        got = pam_kernel_emulated(q, k, v, three_tf32)
        assert np.abs(got - ref).max() <= 0.1 * limit
        one = pam_kernel_emulated(q, k, v, one_tf32)
        assert np.abs(one - ref).max() > 5 * limit

    def test_bf16_one_pass_rounds_p(self):
        """bfloat16 inputs: one exact pass per product with p rounded to
        bfloat16 before P·V, as the TPU kernel's ``p.astype(v.dtype)``;
        against the Pallas kernel in interpret mode on the same inputs,
        with the same 32-key blocks (so p is rounded against the same
        running max), within the bfloat16 output's rounding."""
        q, k, v = (bf16_round(a) for a in self.inputs(300, seed=22))
        got = pam_kernel_emulated(q, k, v, lambda a, b: [(a, b)], bf16_round)
        ref = self.exact(q, k, v)
        assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()
        jq, jk, jv = (jnp.asarray(a[None], jnp.bfloat16) for a in (q, k, v))
        tpu = np.asarray(jpallas.flash_position_attention(
            jq, jk, jv, 128, 32, None, True).astype(jnp.float32))[0]
        ulp = 2.0 ** -8 * np.abs(tpu).max()
        assert np.abs(bf16_round(got) - tpu).max() <= ulp
