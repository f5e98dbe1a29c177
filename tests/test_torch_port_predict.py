"""The port's host path and Predictor against the JAX package's, on the CPU.

The numpy helpers and guidance maps are copies and must agree with the
originals (bit for bit where the arithmetic is the same; the JAX package's
guidance may run its native rasterizer, so those compare within 1e-3 on
the [0, 255] scale).  The port's resize follows cv2's conventions and is
held to cv2 within 1e-3 on [0, 255] data.  ``prepare_input`` agrees within
1e-3 on the crop and ``Predictor.predict`` within 1e-4 on probabilities,
with the same weights in both packages.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu import predict as jax_predict
from distributedpytorch_tpu.data import guidance as jax_guidance
from distributedpytorch_tpu.models import build_model as jax_build_model
from distributedpytorch_tpu.utils import helpers as jax_helpers
from distributedpytorch_tpu_torch import imaging, predict
from distributedpytorch_tpu_torch.data import guidance
from distributedpytorch_tpu_torch.models import build_model
from distributedpytorch_tpu_torch.utils import helpers
from distributedpytorch_tpu_torch.utils.weights import load_jax_params
from test_torch_port_model import randomize

POINTS = np.array([[20.0, 40.0], [60.0, 12.0], [110.0, 50.0], [58.0, 90.0]])


def smooth_image(h=96, w=128, seed=0):
    """An image-like (H, W, 3) uint8 array: smooth structure plus noise."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([127 + 100 * np.sin(xx / 9.0 + c) * np.cos(yy / 13.0 - c)
                    for c in range(3)], -1)
    img += np.random.default_rng(seed).normal(0, 2, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


class TestHelpersMatchJax:
    @pytest.mark.parametrize("zero_pad", [True, False])
    def test_bbox_and_crop(self, zero_pad):
        img = smooth_image()
        pad = 30 if zero_pad else 5
        bbox = helpers.get_bbox(img[..., 0], points=POINTS, pad=pad,
                                zero_pad=zero_pad)
        assert bbox == jax_helpers.get_bbox(img[..., 0], points=POINTS,
                                            pad=pad, zero_pad=zero_pad)
        np.testing.assert_array_equal(
            helpers.crop_from_bbox(img, bbox, zero_pad=zero_pad),
            jax_helpers.crop_from_bbox(img, bbox, zero_pad=zero_pad))

    def test_bbox_of_mask(self):
        mask = np.zeros((40, 50), np.uint8)
        mask[5:20, 10:33] = 1
        assert helpers.get_bbox(mask, pad=3) == jax_helpers.get_bbox(mask, pad=3)
        assert helpers.get_bbox(np.zeros((4, 4))) is None

    def test_out_of_bounds_crop_needs_zero_pad(self):
        with pytest.raises(ValueError, match="zero_pad"):
            helpers.crop_from_bbox(np.zeros((10, 10)), (-2, 0, 5, 5))

    @pytest.mark.parametrize("relax", [0, 10])
    def test_crop2fullmask(self, relax):
        prob = np.random.default_rng(1).random((64, 64)).astype(np.float32)
        bbox = (-10, 5, 90, 70)
        got = helpers.crop2fullmask(prob, bbox, (96, 128), zero_pad=True,
                                    relax=relax)
        ref = jax_helpers.crop2fullmask(prob, bbox, (96, 128), zero_pad=True,
                                        relax=relax)
        np.testing.assert_allclose(got, ref, atol=1e-5)

    def test_make_gt(self):
        target = np.zeros((40, 60))
        np.testing.assert_array_equal(
            helpers.make_gt(target, POINTS / 2, one_mask_per_point=True),
            jax_helpers.make_gt(target, POINTS / 2, one_mask_per_point=True))
        np.testing.assert_allclose(helpers.make_gt(target, POINTS / 2),
                                   jax_helpers.make_gt(target, POINTS / 2),
                                   atol=1e-6)


class TestGuidanceMatchesJax:
    @pytest.mark.parametrize("family", ["nellipse_gaussians", "nellipse",
                                        "extreme_points"])
    def test_crop_point_guidance(self, family):
        bbox = (-30, -18, 140, 120)
        got = guidance.crop_point_guidance(POINTS, bbox, (64, 72), alpha=0.6,
                                           family=family)
        ref = jax_guidance.crop_point_guidance(POINTS, bbox, (64, 72),
                                               alpha=0.6, family=family)
        assert got.dtype == np.float32 and got.shape == (64, 72)
        np.testing.assert_allclose(got, ref, atol=1e-3)

    def test_numpy_nellipse_matches_numpy_original(self):
        # the JAX package's own numpy branch (non-grid ranges skip native)
        xs, ys = np.arange(1, 40), np.arange(1, 30)
        np.testing.assert_array_equal(
            guidance.compute_nellipse(xs, ys, POINTS / 4),
            jax_guidance.compute_nellipse(xs, ys, POINTS / 4))

    def test_unknown_family_raises(self):
        with pytest.raises(ValueError, match="unknown guidance"):
            guidance.guidance_from_points((8, 8), POINTS, family="confidence")

    def test_scale_points_to_crop(self):
        bbox = (-5, 3, 120, 99)
        np.testing.assert_array_equal(
            guidance.scale_points_to_crop(POINTS, bbox, (512, 512)),
            jax_guidance.scale_points_to_crop(POINTS, bbox, (512, 512)))


class TestResizeMatchesCv2:
    FLAGS = {imaging.NEAREST: cv2.INTER_NEAREST,
             imaging.LINEAR: cv2.INTER_LINEAR,
             imaging.CUBIC: cv2.INTER_CUBIC}

    @pytest.mark.parametrize("mode", [0, 1, 2])
    @pytest.mark.parametrize("src,dst", [
        ((37, 53, 3), (64, 80)),      # the JAX package's native-parity case
        ((137, 91, 3), (512, 512)),   # a crop up to the model resolution
        ((301, 455, 3), (512, 512)),
        ((640, 480), (512, 512)),     # a large crop down to it
        ((512, 512), (512, 512)),
    ])
    def test_resize(self, mode, src, dst):
        a = np.random.RandomState(0).uniform(0, 255, src).astype(np.float32)
        got = imaging.resize(a, dst, mode)
        ref = cv2.resize(a, (dst[1], dst[0]), interpolation=self.FLAGS[mode])
        assert got.shape == ref.shape and got.dtype == np.float32
        assert float(np.abs(got - ref).max()) <= 1e-3

    @pytest.mark.parametrize("src,dst", [((512, 512), (301, 455)),
                                         ((137, 91), (77, 77))])
    def test_cubic_downscale_vs_cv2_float64(self, src, dst):
        # cv2's float32 path drifts by up to ~1e-2 here; its float64 path
        # is the exact arithmetic of the same conventions
        a = np.random.RandomState(1).uniform(0, 255, src)
        ref = cv2.resize(a, (dst[1], dst[0]), interpolation=cv2.INTER_CUBIC)
        got = imaging.resize(a.astype(np.float32), dst, imaging.CUBIC)
        assert float(np.abs(got - ref).max()) <= 1e-3

    def test_uint8_saturates(self):
        a = np.zeros((8, 8), np.uint8)
        a[4:, :] = 255
        out = imaging.resize(a, (16, 16), imaging.CUBIC)
        assert out.dtype == np.uint8
        np.testing.assert_array_equal(
            out, cv2.resize(a, (16, 16), interpolation=cv2.INTER_CUBIC))


@pytest.mark.parametrize("zero_pad,relax", [(True, 50), (False, 5)])
def test_prepare_input_matches_jax(zero_pad, relax):
    img = smooth_image()
    got, bbox = predict.prepare_input(img, POINTS, relax=relax,
                                      zero_pad=zero_pad, resolution=(64, 64))
    ref, ref_bbox = jax_predict.prepare_input(img, POINTS, relax=relax,
                                              zero_pad=zero_pad,
                                              resolution=(64, 64))
    assert bbox == ref_bbox and got.shape == (64, 64, 4)
    assert float(np.abs(got - ref).max()) <= 1e-3


def test_prepare_input_rejects_bad_clicks():
    with pytest.raises(ValueError, match="outside"):
        predict.prepare_input(smooth_image(), POINTS + 500)
    with pytest.raises(ValueError, match="4 xy"):
        predict.prepare_input(smooth_image(), POINTS[:3])


@pytest.fixture(scope="module")
def twin_predictors():
    """A JAX Predictor and the port's, on the same randomized weights."""
    model = jax_build_model("danet", nclass=1, backbone="resnet18",
                            output_stride=8, attention_impl="xla")
    variables = randomize(model.init(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 64, 64, 4)), train=False))
    ref = jax_predict.Predictor(model, variables["params"],
                                variables["batch_stats"],
                                resolution=(64, 64), relax=10)
    port_model = build_model("danet", nclass=1, backbone="resnet18")
    load_jax_params(port_model, variables["params"], variables["batch_stats"])
    port = predict.Predictor(port_model, resolution=(64, 64), relax=10,
                             device="cpu")
    return ref, port


def test_predict_matches_jax(twin_predictors):
    ref, port = twin_predictors
    img = smooth_image()
    got, want = port.predict(img, POINTS), ref.predict(img, POINTS)
    assert got.shape == img.shape[:2] and got.dtype == np.float32
    assert 0.0 < float(want.max()) and float(want.max()) < 1.0
    assert float(np.abs(got - want).max()) <= 1e-4


def test_predict_batch_matches_jax(twin_predictors):
    ref, port = twin_predictors
    img = smooth_image(seed=3)
    clicks = [POINTS, POINTS * 0.8 + 5]
    for g, w in zip(port.predict_batch(img, clicks),
                    ref.predict_batch(img, clicks)):
        assert float(np.abs(g - w).max()) <= 1e-4
    assert port.predict_batch(img, []) == []


class TestNoSilentCpu:
    def test_fresh_without_device_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            predict.Predictor.fresh(64, "resnet18", seed=0)

    def test_constructor_without_device_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            predict.Predictor(build_model("danet", backbone="resnet18"))
        with pytest.raises(RuntimeError):
            predict.resolve_device("cuda:0")
        assert predict.resolve_device("cpu") == torch.device("cpu")

    def test_fresh_is_seeded_and_gates_are_open(self):
        a = predict.Predictor.fresh(32, "resnet18", seed=3, device="cpu")
        b = predict.Predictor.fresh(32, "resnet18", seed=3, device="cpu")
        c = predict.Predictor.fresh(32, "resnet18", seed=4, device="cpu")
        sa, sb, sc = (p.model.state_dict() for p in (a, b, c))
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
        assert not torch.equal(sa["head.fused_cls.weight"],
                               sc["head.fused_cls.weight"])
        assert a.model.head.pam.gamma.item() > 0
        assert a.model.head.cam.gamma.item() > 0
        assert torch.all(a.model.backbone.BasicBlock_0.BatchNorm_1.weight > 0)

    def test_bf16_predictor_tracks_f32(self):
        img = smooth_image()
        f32 = predict.Predictor.fresh(64, "resnet18", seed=5, device="cpu",
                                      relax=10)
        bf16 = predict.Predictor.fresh(64, "resnet18", seed=5, device="cpu",
                                       relax=10, dtype=torch.bfloat16)
        # bf16 compute on float32 master weights, as the JAX package's dtype
        assert all(p.dtype == torch.float32 for p in bf16.model.parameters())
        x = torch.rand(1, 4, 64, 64) * 255
        with torch.no_grad():
            assert all(o.dtype == torch.bfloat16 for o in bf16.model(x))
        got, want = bf16.predict(img, POINTS), f32.predict(img, POINTS)
        assert got.dtype == np.float32 and np.isfinite(got).all()
        # bf16 keeps ~3 significant digits through 20 layers
        assert float(np.abs(got - want).max()) <= 0.1

    def test_unknown_guidance_raises(self):
        with pytest.raises(ValueError, match="clicks alone"):
            predict.Predictor(build_model("danet", backbone="resnet18"),
                              device="cpu", guidance="confidence")
