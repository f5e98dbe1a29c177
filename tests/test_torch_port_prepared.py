"""The port's prepared-sample cache (``data/prepared.py``), its pipeline
builders and the prepared val fast path, against the JAX package on the
CPU.

Both packages read the JAX package's on-disk fake VOC tree (conftest's
``fake_voc_root``, 120x160):

* ``PreparedInstanceDataset``: the cached crop within 1 grey level of the
  JAX cache's on every pixel and within 0.5 on >= 99% (the imaging
  backends differ: the port's library against cv2, ROADMAP C
  "Accepted"; both round to uint8), ``crop_gt``, ``bbox`` and ``meta``
  equal; with ``eval_protocol`` the full-resolution ``gt`` and
  ``void_pixels`` equal JAX's and the source's bit for bit.
* ``PreparedSemanticDataset``: the image within 1 grey level, the class
  ids (nearest) and ``gt_full`` equal.
* Fill, then read: bitwise equal, in the same object and in a second one
  opened on the same directory (nothing recomputed), and after a pickle
  round trip (the maps reopen); the worker-process loader fills the cache
  from its workers and a second epoch reads it.
* The fingerprint: another crop size, relax, imaging backend or file
  content gives another directory; the eval cache has its own.
* ``Keep`` and the four prepared builders against JAX's (their keys);
  ``guidance='none'``.
* ``data/prepared.py`` imports no torch (a fresh interpreter).
* The prepared val path with device guidance (``data.prepared_cache``,
  ``data.val_prepared``, ``data.device_guidance``): the JAX trainer fits
  one epoch of two steps (ResNet-18 at 64²) and validates; the port
  validates the same epoch-end weights.  The Jaccard within 1e-2 and the
  loss within 1e-3 relative, the bounds of ``test_torch_port_fit_band.py``
  (the cached crops differ by the backends' rounding), and the port's
  within the same bound of its host-guidance validation of the same
  cache (all three 0.634725 here, the losses equal to 6 digits).
"""

import json
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from flax import linen as fnn

from distributedpytorch_tpu.data import PreparedInstanceDataset as JaxPrepared
from distributedpytorch_tpu.data import PreparedSemanticDataset as JaxPreparedSem
from distributedpytorch_tpu.data import VOCInstanceSegmentation as JaxVOC
from distributedpytorch_tpu.data import VOCSemanticSegmentation as JaxVOCSem
from distributedpytorch_tpu.data import pipeline as jax_pipeline
from distributedpytorch_tpu.data import transforms as jax_T
from distributedpytorch_tpu.train import Trainer as JaxTrainer
from distributedpytorch_tpu.train import config as jax_config
from distributedpytorch_tpu_torch.data import pipeline, prepared
from distributedpytorch_tpu_torch.data import transforms as T
from distributedpytorch_tpu_torch.data.grain_pipeline import GrainDataLoader
from distributedpytorch_tpu_torch.data.voc import (
    VOCInstanceSegmentation,
    VOCSemanticSegmentation,
)
from distributedpytorch_tpu_torch.train import config
from distributedpytorch_tpu_torch.train.trainer import Trainer
from distributedpytorch_tpu_torch.utils.weights import load_jax_params
from test_torch_port_train import _no_dropout

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROP = dict(crop_size=(64, 64), relax=10)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def base(fake_voc_root):
    return VOCInstanceSegmentation(fake_voc_root, split="train",
                                   area_thres=0)


def _jax_base(root, split="train"):
    return JaxVOC(root, split=split, transform=None, preprocess=True,
                  area_thres=0)


def _crop_close(got: np.ndarray, want: np.ndarray) -> None:
    d = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert d.max() <= 1.0 and (d <= 0.5).mean() >= 0.99, (d.max(),
                                                         (d > 0.5).mean())


class TestInstanceCache:
    def test_rows_match_jax(self, base, fake_voc_root, tmp_path):
        ds = prepared.PreparedInstanceDataset(base, str(tmp_path / "p"), **CROP)
        ref = JaxPrepared(_jax_base(fake_voc_root), str(tmp_path / "j"),
                          **CROP)
        assert len(ds) == len(ref) > 0
        for i in range(len(ds)):
            got, want = ds[i], ref[i]
            _crop_close(got["crop_image"], want["crop_image"])
            np.testing.assert_array_equal(got["crop_gt"], want["crop_gt"])
            np.testing.assert_array_equal(got["bbox"], want["bbox"])
            assert got["meta"] == {k: (tuple(v) if k == "im_size" else v)
                                   for k, v in want["meta"].items()}
            assert got["crop_image"].dtype == np.float32

    def test_fill_then_read_bitwise(self, base, tmp_path):
        d = str(tmp_path / "p")
        ds = prepared.PreparedInstanceDataset(base, d, **CROP)
        assert ds.n_prepared == 0
        first = [ds[i] for i in range(len(ds))]
        assert ds.n_prepared == len(ds)
        ds.flush()
        again = prepared.PreparedInstanceDataset(base, d, **CROP)
        assert again.n_prepared == len(again)  # reopened, nothing to fill
        unpickled = pickle.loads(pickle.dumps(ds))
        assert unpickled.n_prepared == len(ds)
        for i, want in enumerate(first):
            for other in (ds, again, unpickled):
                got = other[i]
                for k in ("crop_image", "crop_gt", "bbox"):
                    assert got[k].tobytes() == want[k].tobytes(), k
                assert got["meta"] == want["meta"]

    def test_eval_protocol_full_resolution_keys(self, fake_voc_root, tmp_path):
        raw = VOCInstanceSegmentation(fake_voc_root, split="val", area_thres=0)
        ds = prepared.PreparedInstanceDataset(
            raw, str(tmp_path / "p"), eval_protocol=True,
            post_transform=pipeline.build_prepared_eval_post_transform(), **CROP)
        ref = JaxPrepared(
            _jax_base(fake_voc_root, "val"), str(tmp_path / "j"),
            eval_protocol=True,
            post_transform=jax_pipeline.build_prepared_eval_post_transform(),
            **CROP)
        assert ds.cache_dir.endswith("-eval")
        for i in range(len(ds)):
            got, want, src = ds[i], ref[i], raw[i]
            assert set(got) == set(want) == {"concat", "crop_gt", "meta",
                                             "bbox", "gt", "void_pixels"}
            for k in ("gt", "void_pixels"):
                assert got[k].dtype == np.uint8
                np.testing.assert_array_equal(got[k], want[k])
                np.testing.assert_array_equal(got[k], src[k] > 0.5)
            assert got["concat"].shape == (64, 64, 4)
            np.testing.assert_array_equal(got["bbox"], want["bbox"])

    def test_fingerprint_invalidation(self, base, fake_voc_root, tmp_path,
                                      monkeypatch):
        d = str(tmp_path / "p")
        fp = prepared.PreparedInstanceDataset(base, d, **CROP).fingerprint
        assert prepared.PreparedInstanceDataset(
            base, d, crop_size=(48, 48), relax=10).fingerprint != fp
        assert prepared.PreparedInstanceDataset(
            base, d, crop_size=(64, 64), relax=20).fingerprint != fp
        monkeypatch.setenv("DPTPU_NATIVE", "0")
        assert prepared.PreparedInstanceDataset(base, d, **CROP).fingerprint \
            != fp
        monkeypatch.delenv("DPTPU_NATIVE")
        # a file regenerated in place: same name and count, new content
        path = base.tree.path("image", base.im_ids[0])
        st = os.stat(path)
        os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
        assert prepared.PreparedInstanceDataset(base, d, **CROP).fingerprint \
            != fp
        assert len(os.listdir(d)) == 5
        with pytest.raises(ValueError, match="untransformed"):
            prepared.PreparedInstanceDataset(VOCInstanceSegmentation(
                fake_voc_root, split="train", transform=T.Compose([])), d)

    def test_in_memory_tree_fingerprint_tracks_its_pixels(self, tmp_path):
        from distributedpytorch_tpu_torch.data.fake import make_fake_voc
        fps = [prepared.PreparedInstanceDataset(VOCInstanceSegmentation(
            make_fake_voc(n_images=4, size=(48, 64), seed=s), split="train"),
            str(tmp_path)).fingerprint for s in (0, 0, 1)]
        assert fps[0] == fps[1] != fps[2]

    def test_worker_processes_fill_and_read(self, base, tmp_path):
        ds = prepared.PreparedInstanceDataset(
            base, str(tmp_path / "p"),
            post_transform=pipeline.build_prepared_post_transform(
                guidance="none", flip=False, geom=False), **CROP)
        loader = GrainDataLoader(ds, 2, shuffle=True, seed=0, num_workers=2)
        try:
            loader.set_epoch(0)
            first = list(loader)
            assert ds.n_prepared == len(ds)  # filled by the workers
            loader.set_epoch(0)
            second = list(loader)
        finally:
            loader.close()
        assert sum(len(b["concat"]) for b in first) == len(ds)
        for a, b in zip(first, second):
            assert set(a) == {"concat", "crop_gt", "meta", "bbox"}
            assert a["concat"].tobytes() == b["concat"].tobytes()


class TestSemanticCache:
    @pytest.mark.parametrize("fullres", [False, True])
    def test_rows_match_jax(self, fake_voc_root, tmp_path, fullres):
        kw = dict(crop_size=(65, 65), keep_fullres=fullres)
        ds = prepared.PreparedSemanticDataset(
            VOCSemanticSegmentation(fake_voc_root, split="val"),
            str(tmp_path / "p"),
            post_transform=pipeline.build_prepared_semantic_eval_post_transform(),
            **kw)
        ref = JaxPreparedSem(
            JaxVOCSem(fake_voc_root, split="val", transform=None),
            str(tmp_path / "j"),
            post_transform=jax_pipeline.build_prepared_semantic_eval_post_transform(),
            **kw)
        for i in range(len(ds)):
            got, want = ds[i], ref[i]
            assert set(got) == set(want)
            _crop_close(got["concat"], want["concat"])
            np.testing.assert_array_equal(got["crop_gt"], want["crop_gt"])
            if fullres:
                np.testing.assert_array_equal(got["gt_full"], want["gt_full"])
            assert ds[i]["crop_gt"].tobytes() == got["crop_gt"].tobytes()


class TestBuilders:
    def test_keep_as_jax(self):
        sample = {"concat": 1, "crop_gt": 2, "crop_image": 3, "meta": 4}
        assert T.Keep(("concat", "crop_gt"))(dict(sample)) == \
            jax_T.Keep(("concat", "crop_gt"))(dict(sample))

    def test_prepared_builders_keys_as_jax(self):
        r = np.random.default_rng(0)
        sample = {"crop_image": r.uniform(0, 255, (32, 32, 3)).astype(np.float32),
                  "crop_gt": np.zeros((32, 32), np.float32), "meta": {}}
        sample["crop_gt"][8:20, 10:24] = 1.0
        sem = {"image": sample["crop_image"], "gt": sample["crop_gt"] * 3,
               "meta": {}}
        pairs = [
            (pipeline.build_prepared_post_transform(),
             jax_pipeline.build_prepared_post_transform(), sample),
            (pipeline.build_prepared_eval_post_transform(guidance="none"),
             jax_pipeline.build_prepared_eval_post_transform(guidance="none"),
             sample),
            (pipeline.build_prepared_semantic_post_transform(),
             jax_pipeline.build_prepared_semantic_post_transform(), sem),
            (pipeline.build_prepared_semantic_eval_post_transform(),
             jax_pipeline.build_prepared_semantic_eval_post_transform(), sem),
        ]
        for ours, theirs, s in pairs:
            got = ours(dict(s), np.random.default_rng(1))
            want = theirs(dict(s), np.random.default_rng(1))
            assert set(got) == set(want)
            assert got["concat"].shape == want["concat"].shape
        # the bare image for the device guidance; the val guidance on it
        got = pipeline.build_prepared_eval_post_transform(guidance="none")(
            dict(sample))
        assert got["concat"].shape == (32, 32, 3)
        full = pipeline.build_prepared_eval_post_transform()(dict(sample))
        want = jax_pipeline.build_prepared_eval_post_transform()(dict(sample))
        assert np.abs(full["concat"] - want["concat"]).max() <= 1e-3

    def test_host_flip_and_geom_flags(self):
        names = lambda tf: [type(t).__name__ for t in tf.transforms]  # noqa
        tf = pipeline.build_train_transform(guidance="none", flip=False,
                                            geom=False)
        assert "RandomHorizontalFlip" not in names(tf)
        assert "ScaleNRotate" not in names(tf)
        assert "ClampRange" in names(tf)  # no uint8 cast bounds the resize
        tf = pipeline.build_semantic_train_transform(flip=False)
        assert names(tf)[0] == "ScaleNRotate"


def test_prepared_module_imports_no_torch():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; import distributedpytorch_tpu_torch.data.prepared; "
         "import distributedpytorch_tpu_torch.data; "
         "print(json.dumps(sorted(m for m in ('torch', 'jax') "
         "if m in sys.modules)))".replace("json.dumps", "__import__('json').dumps")],
        cwd=REPO, capture_output=True, text=True, timeout=120, check=True)
    assert json.loads(out.stdout) == []


#: one epoch of two steps, then validation: ResNet-18 at 64², on the JAX
#: package's fake tree, with the device guidance and the prepared val path
FIT = ["model.backbone=resnet18", "data.crop_size=[64,64]", "data.relax=10",
       "data.area_thres=0", "data.train_batch=4", "data.val_batch=1",
       "data.num_workers=0", "seed=0", "optim.lr=1e-2", "epochs=1",
       'log_writers=["jsonl"]', "checkpoint.keep_latest=1"]


def test_prepared_val_with_device_guidance_matches_jax(fake_voc_root, tmp_path):
    common = FIT + [f"data.root={fake_voc_root}", "data.device_guidance=true"]
    jtr = JaxTrainer(jax_config.apply_overrides(jax_config.Config(), common + [
        "mesh.data=4", "mesh.model=2", "checkpoint.async_save=false",
        f"data.prepared_cache={tmp_path / 'jcache'}",
        f"work_dir={tmp_path / 'jax'}"]))
    port = Trainer(config.apply_overrides(config.Config(), common + [
        f"data.prepared_cache={tmp_path / 'cache'}",
        f"work_dir={tmp_path / 'port'}"]), device="cpu")
    # the same cache validated with the guidance made on the host
    host = Trainer(config.apply_overrides(config.Config(), FIT + [
        f"data.root={fake_voc_root}", f"data.prepared_cache={tmp_path / 'cache'}",
        f"work_dir={tmp_path / 'host'}"]), device="cpu")
    try:
        assert port._val_device_guidance and not host._val_device_guidance
        assert str(port.val_set).startswith("PreparedEval")
        # the JAX fit's epoch-end weights, validated by both packages
        with fnn.intercept_methods(_no_dropout):
            (want,) = jtr.fit()["val"]
        for tr in (port, host):
            load_jax_params(tr.model, jax.device_get(jtr.state.params),
                            jax.device_get(jtr.state.batch_stats))
        got, ref = port.validate(), host.validate()
    finally:
        jtr.close()
        port.close()
        host.close()
    assert got["n_samples"] == want["n_samples"] == ref["n_samples"] > 0
    assert abs(got["jaccard"] - want["jaccard"]) <= 1e-2
    assert abs(got["loss"] - want["loss"]) <= 1e-3 * abs(want["loss"])
    assert abs(got["jaccard"] - ref["jaccard"]) <= 1e-2
    print(f"prepared val + device guidance: Jaccard {got['jaccard']:.6f} vs "
          f"JAX {want['jaccard']:.6f} vs host guidance {ref['jaccard']:.6f}; "
          f"loss {got['loss']:.6f} vs {want['loss']:.6f}")
