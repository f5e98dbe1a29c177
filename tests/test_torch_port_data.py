"""The port's host data layer against the JAX package's, on the CPU.

A ``make_fake_voc`` fixture is written by the JAX package (cv2 and PIL are
here) and read by both packages' ``VOCInstanceSegmentation``.  JAX's
n-ellipse takes its native rasterizer throughout
(``torch_port_jax_native``), as the port takes its library:

* raw samples (instance list, image, gt, void, meta) are bit-identical;
* val samples of each of the five guidance families are bit-identical
  except ``crop_image`` after the cubic resize (within the 1e-3 on the
  [0, 255] scale that ``imaging.resize`` is held to), and the guidance map
  and ``concat``'s guidance channel, within ``GUIDE_ATOL``;
* train samples of each family, with ``rots=(0, 0), scales=(1, 1)`` (the
  draws are still consumed, so the RNG stream is the same), likewise —
  there ``crop_image`` is uint8 before the resize, and uint8 resizes agree
  within one grey level; with the default random rotations and scales
  within 2 levels; each sample leaves its ``sample_rng`` where JAX's
  leaves its own (``confidence_gaussian`` draws no points);
* the confidence maps and the transforms ``CropFromMask`` (val and
  train), ``CreateBBMask``, ``NEllipse``, ``ExtremePoints``,
  ``AddConfidenceMap`` and ``ToImage`` against JAX's on a blob, a single
  pixel, an empty mask and a diagonal line (a near-singular pair of
  skewed axes): bit-identical, the n-ellipse within ``GUIDE_ATOL``;
* each family's host map against the port's device form
  (``ops/guidance_device.py``) at JAX's bounds for its own pair: 0.5 on
  [0, 255], 2e-3 for ``extreme_points`` on [0, 1];
* an unknown family raises JAX's ``ValueError``, word for word;
* ``warp_affine`` against the JAX package's (cv2, version 5.0 where these tests run) at random
  rotations and scales: NEAREST masks agree on >= 99.9% of pixels and CUBIC
  uint8 images are within 1 grey level on >= 99% (measured: masks on all
  pixels, images within 1 everywhere and off by 1 on ~0.003%).  The JAX
  native library's own ``warp_vs_cv2`` test fails against this cv2; the
  port follows OpenCV 5's float-coordinate warp;
* the loader's epoch order and collated batches are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu import imaging as jax_imaging
from distributedpytorch_tpu.data import fake as jax_fake
from distributedpytorch_tpu.data import pipeline as jax_pipeline
from distributedpytorch_tpu.data import voc as jax_voc
from distributedpytorch_tpu.data import transforms as jax_T
from distributedpytorch_tpu.ops import guidance_device as jax_guidance_device
from distributedpytorch_tpu_torch import imaging
from distributedpytorch_tpu_torch.data import fake, pipeline, voc
from distributedpytorch_tpu_torch.data import guidance
from distributedpytorch_tpu_torch.data import transforms as T
from distributedpytorch_tpu_torch.ops import guidance_device
from distributedpytorch_tpu.data import guidance as jax_guidance
from torch_port_jax_native import jax_native_lib, jax_native_path  # noqa: F401

#: the host guidance families, as ``data.guidance`` names them
FAMILIES = ("nellipse_gaussians", "nellipse", "extreme_points",
            "confidence_l1l2", "confidence_gaussian")
#: the guidance maps against JAX's native n-ellipse, on [0, 255]
GUIDE_ATOL = 1e-3
#: each family's map key
GUIDE_KEYS = ("nellipseWithGaussians", "nellipse", "extreme_points")
#: keys compared within a tolerance (see the module docstring)
LOOSE = ("crop_image", "concat") + GUIDE_KEYS


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc"))
    jax_fake.make_fake_voc(root, n_images=6, size=(96, 128), n_val=2, seed=3)
    return root


def _gap(g, w) -> float:
    return float(np.abs(np.asarray(g, np.float64) - w).max()) if np.size(w) \
        else 0.0


def assert_samples_equal(got: dict, want: dict, loose=(), atol=1e-3):
    """Equal keys and values: bitwise, or for ``loose`` keys within
    ``atol``, except the guidance maps (and ``concat``'s fourth channel),
    within ``GUIDE_ATOL`` whatever ``atol`` is."""
    assert set(got) == set(want)
    for key in want:
        g, w = got[key], want[key]
        if key == "meta":
            assert g == w
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, key
        if key in GUIDE_KEYS:
            assert _gap(g, w) <= GUIDE_ATOL, key
        elif key in loose:
            assert _gap(g, w) <= atol, key
            if key == "concat" and w.shape[-1] == 4:
                assert _gap(g[..., 3], w[..., 3]) <= GUIDE_ATOL, key
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


def test_raw_samples_bit_identical(fixture_root):
    for split in ("train", "val"):
        ref = jax_voc.VOCInstanceSegmentation(fixture_root, split=split,
                                              preprocess=True, area_thres=50)
        got = voc.VOCInstanceSegmentation(fixture_root, split=split,
                                          area_thres=50)
        assert got.obj_list == ref.obj_list and got.obj_dict == ref.obj_dict
        assert len(got) == len(ref) > 0 and got.num_images == ref.num_images
        for i in range(len(ref)):
            assert_samples_equal(got[i], ref[i])


@pytest.mark.usefixtures("jax_native_path")
@pytest.mark.parametrize("family", FAMILIES)
def test_val_samples_match(fixture_root, family):
    kw = dict(crop_size=(64, 64), relax=10, zero_pad=True, guidance=family)
    ref = jax_voc.VOCInstanceSegmentation(
        fixture_root, split="val", preprocess=True,
        transform=jax_pipeline.build_eval_transform(**kw))
    got = voc.VOCInstanceSegmentation(
        fixture_root, split="val", transform=pipeline.build_eval_transform(**kw))
    for i in range(len(ref)):
        assert_samples_equal(got[i], ref[i], loose=LOOSE)


@pytest.mark.usefixtures("jax_native_path")
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("rots,scales,atol", [
    ((0, 0), (1, 1), 1.0),
    # warped: the images' rare one-level differences pass through the resize
    ((-20, 20), (0.75, 1.25), 2.0)])
def test_train_samples_match(fixture_root, rots, scales, atol, family):
    kw = dict(crop_size=(64, 64), relax=10, zero_pad=True, rots=rots,
              scales=scales, guidance=family)
    ref = jax_voc.VOCInstanceSegmentation(
        fixture_root, split="train", preprocess=True,
        transform=jax_pipeline.build_train_transform(**kw))
    got = voc.VOCInstanceSegmentation(
        fixture_root, split="train",
        transform=pipeline.build_train_transform(**kw))
    for i in range(len(ref)):
        rng = (pipeline.sample_rng(0, 1, i), jax_pipeline.sample_rng(0, 1, i))
        assert_samples_equal(got.__getitem__(i, rng=rng[0]),
                             ref.__getitem__(i, rng=rng[1]), loose=LOOSE,
                             atol=atol)
        # the sample consumed the stream as JAX's did
        assert rng[0].random() == rng[1].random()


def test_loader_order_and_batches_match(fixture_root):
    tf = dict(crop_size=(64, 64), relax=10)
    ref_set = jax_voc.VOCInstanceSegmentation(
        fixture_root, split="train", preprocess=True,
        transform=jax_pipeline.build_eval_transform(**tf))
    got_set = voc.VOCInstanceSegmentation(
        fixture_root, split="train", transform=pipeline.build_eval_transform(**tf))
    ref = jax_pipeline.DataLoader(ref_set, 2, shuffle=True, drop_last=True,
                                  seed=5, num_workers=2)
    got = pipeline.DataLoader(got_set, 2, shuffle=True, drop_last=True, seed=5,
                              num_workers=2)
    for epoch in (0, 3):
        ref.set_epoch(epoch)
        got.set_epoch(epoch)
        np.testing.assert_array_equal(got.epoch_indices(), ref._epoch_indices())
        assert len(got) == len(ref)
        batches = list(got)
        assert len(batches) == len(ref)
        for g, w in zip(batches, ref):
            assert_samples_equal(g, w, loose=LOOSE)


def test_loader_surfaces_worker_errors():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i, rng=None):
            raise KeyError(f"sample {i}")

    with pytest.raises(KeyError):
        list(pipeline.DataLoader(Broken(), 2, num_workers=2))


def test_collate_keeps_ragged_keys_as_lists():
    samples = [{"a": np.zeros((2, 2)), "gt": np.zeros((3, 4)), "meta": {"i": 0}},
               {"a": np.ones((2, 2)), "gt": np.zeros((5, 4)), "meta": {"i": 1}}]
    got, want = pipeline.collate(samples), jax_pipeline.collate(samples)
    assert got["a"].shape == (2, 2, 2) and isinstance(got["gt"], list)
    np.testing.assert_array_equal(got["a"], want["a"])
    assert got["meta"] == want["meta"]


class TestImaging:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_warp_affine_matches_cv2(self, seed):
        r = np.random.default_rng(seed)
        yy, xx = np.mgrid[0:90, 0:120].astype(np.float32)
        img = np.stack([127 + 100 * np.sin(xx / 9 + c) * np.cos(yy / 13 - c)
                        for c in range(3)], -1)
        img = np.clip(img + r.normal(0, 4, img.shape), 0, 255).astype(np.uint8)
        mask = np.zeros((90, 120), np.uint8)
        mask[20:70, 30:95] = 1
        mask[18:20, 30:95] = 255
        for _ in range(4):
            m = jax_imaging.rotation_matrix((60.0, 45.0), r.uniform(-20, 20),
                                            r.uniform(0.75, 1.25))
            np.testing.assert_allclose(
                imaging.rotation_matrix((60.0, 45.0), *_angle_scale(m)), m,
                atol=1e-12)
            got = imaging.warp_affine(img, m, (90, 120), imaging.CUBIC, 0)
            want = jax_imaging.warp_affine(img, m, (90, 120), jax_imaging.CUBIC, 0)
            diff = np.abs(got.astype(int) - want.astype(int))
            assert got.dtype == np.uint8 and (diff <= 1).mean() >= 0.99
            for border in (0, 255):
                got = imaging.warp_affine(mask, m, (90, 120), imaging.NEAREST,
                                          border)
                want = jax_imaging.warp_affine(mask, m, (90, 120),
                                               jax_imaging.NEAREST, border)
                assert (got == want).mean() >= 0.999

    def test_flip_matches_cv2(self):
        a = np.arange(2 * 5 * 3, dtype=np.float32).reshape(2, 5, 3)
        np.testing.assert_array_equal(imaging.flip_h(a), jax_imaging.flip_h(a))
        np.testing.assert_array_equal(imaging.flip_h(a[..., 0]),
                                      jax_imaging.flip_h(a[..., 0]))


def _angle_scale(m):
    """The (angle in degrees, scale) of a rotation matrix."""
    return np.degrees(np.arctan2(m[0, 1], m[0, 0])), float(np.hypot(m[0, 0], m[0, 1]))


def test_extreme_points_match():
    mask = np.zeros((40, 50))
    mask[5:30, 8:41] = 1
    mask[2:5, 20:23] = 1
    for pert in (0, 3):
        np.testing.assert_array_equal(
            guidance.extreme_points(mask, pert, np.random.default_rng(pert)),
            jax_guidance.extreme_points(mask, pert, np.random.default_rng(pert)))
        np.testing.assert_array_equal(guidance.extreme_points_fixed(mask, pert),
                                      jax_guidance.extreme_points_fixed(mask, pert))


def test_fake_fixture_layout():
    tree = fake.make_fake_voc(n_images=8, size=(96, 128), n_val=3, seed=0)
    assert len(tree.split_ids("train")) == 5 and len(tree.split_ids("val")) == 3
    img, inst = tree.image("fake_000000"), tree.instances("fake_000000")
    assert img.shape == (96, 128, 3) and img.dtype == np.uint8
    assert inst.dtype == np.uint8 and 255 in inst and 1 in inst
    ds = voc.VOCInstanceSegmentation(tree, split="train", area_thres=0)
    sample = ds[0]
    assert sample["gt"].max() == 1 and sample["void_pixels"].max() == 1
    again = fake.make_fake_voc(n_images=8, size=(96, 128), n_val=3, seed=0)
    np.testing.assert_array_equal(again.image("fake_000004"),
                                  tree.image("fake_000004"))


def test_unported_guidance_raises():
    """An unknown family raises JAX's ``ValueError``, word for word."""
    with pytest.raises(ValueError) as want:
        jax_pipeline.build_train_transform(guidance="scribbles")
    with pytest.raises(ValueError) as got:
        pipeline.build_train_transform(guidance="scribbles")
    assert str(got.value) == str(want.value)
    assert "unknown guidance family" in str(got.value)


def _masks(size: int = 64) -> dict[str, np.ndarray]:
    """A blob, a single pixel, an empty mask and a diagonal line (its
    left and top, and its right and bottom, extremes coincide: the
    skewed axes are parallel)."""
    yy, xx = np.mgrid[0:size, 0:size]
    blob = (((xx - 30) / 17.0) ** 2 + ((yy - 26) / 11.0) ** 2 <= 1)
    single = np.zeros((size, size))
    single[40, 21] = 1
    line = np.zeros((size, size))
    line[np.arange(10, 41), np.arange(10, 41)] = 1
    return {"blob": blob.astype(np.float32), "single": single.astype(np.float32),
            "empty": np.zeros((size, size), np.float32),
            "line": line.astype(np.float32)}


@pytest.mark.parametrize("mask", ["blob", "single", "line"])
def test_confidence_maps_match_jax(mask):
    """The three confidence functions bit for bit, with and without the
    full-image weights and the distance threshold."""
    m = _masks()[mask]
    pts = guidance.extreme_points_fixed(m, 0)
    for full in (0, 1):
        np.testing.assert_array_equal(
            guidance.generate_mvgauss_image(m, full, tau=0.5),
            jax_guidance.generate_mvgauss_image(m, full, tau=0.5))
        for thresh in (None, 1.5):
            got = guidance.generate_mv_l1l2_image_skewed_axes(
                m, pts, full, d2_THRESH=thresh, tau=1.0)
            want = jax_guidance.generate_mv_l1l2_image_skewed_axes(
                m, pts, full, d2_THRESH=thresh, tau=1.0)
            for g, w in zip(got, want):
                assert np.isfinite(g).all()
                np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(guidance.normalize_wt_map(got[0]),
                                          jax_guidance.normalize_wt_map(want[0]))


#: (port, JAX) transforms of the same arguments
NEW_TRANSFORMS = {
    "crop_from_mask_val": lambda M: M.CropFromMask(
        crop_elems=("image", "gt"), zero_pad=True, d=64, is_val=True),
    "crop_from_mask_train": lambda M: M.CropFromMask(
        crop_elems=("image", "gt"), zero_pad=True, d=64, is_val=False),
    "create_bb_mask": lambda M: M.CreateBBMask(),
    "nellipse": lambda M: M.NEllipse(is_val=False),
    "extreme_points": lambda M: M.ExtremePoints(sigma=10, pert=5,
                                                elem="crop_gt", is_val=False),
    "confidence_l1l2": lambda M: M.AddConfidenceMap(hm_type="l1l2", pert=5,
                                                    is_val=False),
    "confidence_gaussian": lambda M: M.AddConfidenceMap(hm_type="gaussian",
                                                        is_val=True),
    "to_image": lambda M: M.ToImage(norm_elem=("image", "crop_image"),
                                    custom_max=255.0),
}


@pytest.mark.usefixtures("jax_native_path")
@pytest.mark.parametrize("name", NEW_TRANSFORMS)
def test_new_transforms_match_jax(name):
    """Each transform on each of :func:`_masks`, the same draws on both
    sides: the same keys and values, and the stream left at the same
    place."""
    img = np.random.default_rng(1).uniform(0, 255, (64, 64, 3)).astype(
        np.float32)
    for mask, m in _masks().items():
        samples = [{"image": img.copy(), "gt": m.copy(),
                    "crop_image": img.copy(), "crop_gt": m.copy()}
                   for _ in range(2)]
        rngs = [np.random.default_rng(5) for _ in range(2)]
        got = NEW_TRANSFORMS[name](T)(samples[0], rngs[0])
        want = NEW_TRANSFORMS[name](jax_T)(samples[1], rngs[1])
        assert set(got) == set(want), mask
        for key in want:
            g, w = np.asarray(got[key]), np.asarray(want[key])
            assert g.shape == w.shape and g.dtype == w.dtype, (mask, key)
            if key == "nellipse":
                assert _gap(g, w) <= GUIDE_ATOL, mask
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{mask} {key}")
        assert rngs[0].random() == rngs[1].random(), mask


@pytest.mark.parametrize("family", FAMILIES)
def test_host_forms_match_device_forms(family):
    """Each family's host map (the val transform, its fixed points)
    against the port's device form on the same masks, at the bounds JAX
    holds its own pair to: 0.5 on [0, 255], 2e-3 for ``extreme_points``
    on [0, 1].  The empty mask gives zeros on both sides.  Where JAX's own
    pair is further apart than its bound (``confidence_gaussian`` on the
    line: float32 moments of a near-singular covariance, 0.935 apart),
    the port's pair is held to JAX's pair's gap plus ``GUIDE_ATOL``."""
    stage = T.Compose(pipeline._guidance_stage(family, 0.6, is_val=True))
    jax_stage = jax_T.Compose(jax_pipeline._guidance_stage(family, 0.6,
                                                           is_val=True))
    atol = 2e-3 if family == "extreme_points" else 0.5
    masks = _masks()
    img = np.zeros((64, 64, 3), np.float32)
    got = guidance_device.guidance_map(
        torch.from_numpy(np.stack(list(masks.values()))), family=family,
        is_val=True).numpy()
    for (mask, m), dev in zip(masks.items(), got):
        host = stage({"crop_image": img, "crop_gt": m})["concat"][..., 3]
        gap = _gap(dev, host)
        if gap > atol:
            jax_host = jax_stage({"crop_image": img, "crop_gt": m})["concat"]
            jax_gap = _gap(jax_guidance_device.guidance_map(
                jnp.asarray(m), family=family, is_val=True),
                jax_host[..., 3])
            assert atol < jax_gap and gap <= jax_gap + GUIDE_ATOL, \
                (mask, gap, jax_gap)
