"""The port's host data layer against the JAX package's, on the CPU.

A ``make_fake_voc`` fixture is written by the JAX package (cv2 and PIL are
here) and read by both packages' ``VOCInstanceSegmentation``:

* raw samples (instance list, image, gt, void, meta) are bit-identical;
* val samples are bit-identical except ``crop_image`` after the cubic
  resize (within the 1e-3 on the [0, 255] scale that ``imaging.resize`` is
  held to) and the guidance map
  and ``concat``, for which the JAX package runs its native rasterizer
  (within 1e-3, as in the port's guidance tests);
* train samples, with ``rots=(0, 0), scales=(1, 1)`` (the draws are still
  consumed, so the RNG stream is the same), likewise — there ``crop_image``
  is uint8 before the resize, and uint8 resizes agree within one grey
  level; with the default random rotations and scales within 2 levels;
* ``warp_affine`` against the JAX package's (cv2, version 5.0 where these tests run) at random
  rotations and scales: NEAREST masks agree on >= 99.9% of pixels and CUBIC
  uint8 images are within 1 grey level on >= 99% (measured: masks on all
  pixels, images within 1 everywhere and off by 1 on ~0.003%).  The JAX
  native library's own ``warp_vs_cv2`` test fails against this cv2; the
  port follows OpenCV 5's float-coordinate warp;
* the loader's epoch order and collated batches are equal.
"""

import numpy as np
import pytest

from distributedpytorch_tpu import imaging as jax_imaging
from distributedpytorch_tpu.data import fake as jax_fake
from distributedpytorch_tpu.data import pipeline as jax_pipeline
from distributedpytorch_tpu.data import voc as jax_voc
from distributedpytorch_tpu_torch import imaging
from distributedpytorch_tpu_torch.data import fake, pipeline, voc
from distributedpytorch_tpu_torch.data import guidance
from distributedpytorch_tpu.data import guidance as jax_guidance

#: keys compared within a tolerance (see the module docstring)
LOOSE = ("crop_image", "nellipseWithGaussians", "concat")


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc"))
    jax_fake.make_fake_voc(root, n_images=6, size=(96, 128), n_val=2, seed=3)
    return root


def assert_samples_equal(got: dict, want: dict, loose=(), atol=1e-3):
    assert set(got) == set(want)
    for key in want:
        g, w = got[key], want[key]
        if key == "meta":
            assert g == w
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, key
        if key in loose:
            assert float(np.abs(g.astype(np.float64) - w).max()) <= atol, key
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


def test_val_samples_match(fixture_root):
    kw = dict(crop_size=(64, 64), relax=10, zero_pad=True)
    ref = jax_voc.VOCInstanceSegmentation(
        fixture_root, split="val", preprocess=True,
        transform=jax_pipeline.build_eval_transform(**kw))
    got = voc.VOCInstanceSegmentation(
        fixture_root, split="val", transform=pipeline.build_eval_transform(**kw))
    for i in range(len(ref)):
        assert_samples_equal(got[i], ref[i], loose=LOOSE)


@pytest.mark.parametrize("rots,scales,atol", [
    ((0, 0), (1, 1), 1.0),
    # warped: the images' rare one-level differences pass through the resize
    ((-20, 20), (0.75, 1.25), 2.0)])
def test_train_samples_match(fixture_root, rots, scales, atol):
    kw = dict(crop_size=(64, 64), relax=10, zero_pad=True, rots=rots,
              scales=scales)
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
    with pytest.raises(NotImplementedError, match="not ported"):
        pipeline.build_train_transform(guidance="extreme_points")
