"""SBD and the dataset combiner of the port against the JAX package's, on
the CPU.

The JAX package writes a fake VOC tree and a fake SBD tree
(``make_fake_sbd``) whose train split repeats one VOC val id (which a
combined set must exclude) and one VOC train id (which it must dedupe);
the port writes its own SBD tree with the same arguments.

* Both packages' SBD readers, on both trees, give the same ``obj_list``,
  ``obj_dict`` and raw samples, bit for bit, for the instance and the
  semantic sets (so JAX's reader reads the port's writer's tree too).
* ``CombinedDataset([voc_train, sbd], excluded=[voc_val])``: the index,
  the image ids, the length and ``str`` equal to JAX's, with and without
  ``dedupe``; a mix of sample schemas raises JAX's ``ValueError``.
* The prepared cache over the combined set stamps the SBD part's files
  and gives its samples that part's ``meta``.
* The first collated batch of the loader over the combined set, under
  the default train stack, equal to JAX's (the tolerances of
  ``test_torch_port_data``; JAX's n-ellipse on its native rasterizer).
* ``Trainer(cfg, device="cpu")`` with ``data.sbd_root`` on each task
  (ResNet-18 at 32² or 33²) builds the combined set JAX's classes build
  under the JAX trainer's recipe, with the same first sample, and fits
  an epoch of a step or two.
"""

import os

import numpy as np
import pytest
import torch

from distributedpytorch_tpu.data import combine as jax_combine
from distributedpytorch_tpu.data import fake as jax_fake
from distributedpytorch_tpu.data import pipeline as jax_pipeline
from distributedpytorch_tpu.data import sbd as jax_sbd
from distributedpytorch_tpu.data import voc as jax_voc
from distributedpytorch_tpu_torch.data import (
    CombinedDataset,
    SBDInstanceSegmentation,
    SBDSemanticSegmentation,
    VOCInstanceSegmentation,
    VOCSemanticSegmentation,
    make_fake_sbd,
    pipeline,
)
from distributedpytorch_tpu_torch.train import config
from distributedpytorch_tpu_torch.train.trainer import Trainer
from test_torch_port_data import LOOSE, assert_samples_equal
from torch_port_jax_native import jax_native_lib, jax_native_path  # noqa: F401

SIZE = (48, 64)
#: the instance train stack's knobs, at 64²
TF = dict(crop_size=(64, 64), relax=10, zero_pad=True)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs in several
    processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The VOC root, and the SBD roots written by JAX and by the port."""
    base = tmp_path_factory.mktemp("sbd")
    voc_root = str(base / "voc")
    jax_fake.make_fake_voc(voc_root, n_images=5, size=SIZE, n_val=2, seed=3)
    splits = {s: jax_voc.VOCSemanticSegmentation(voc_root, split=s).im_ids
              for s in ("train", "val")}
    overlap = [splits["val"][0], splits["train"][0]]
    kw = dict(n_images=4, size=SIZE, n_val=1, seed=1, overlap_ids=overlap)
    roots = {"voc": voc_root, "jax": str(base / "sbd_jax"),
             "port": str(base / "sbd_port")}
    jax_fake.make_fake_sbd(roots["jax"], **kw)
    make_fake_sbd(roots["port"], **kw)
    return roots


def _equal_samples(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        if k == "meta":
            assert a[k] == b[k]
        else:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("task", ["instance", "semantic"])
def test_raw_samples_bit_identical(trees, writer, task):
    root, split = trees[writer], ["train", "val"]
    if task == "instance":
        ref = jax_sbd.SBDInstanceSegmentation(root, split=split,
                                              preprocess=True, area_thres=50)
        got = SBDInstanceSegmentation(root, split=split, area_thres=50)
        assert got.obj_list == ref.obj_list and got.obj_dict == ref.obj_dict
        assert -1 in sum(ref.obj_dict.values(), [])  # the filter acted
    else:
        ref = jax_sbd.SBDSemanticSegmentation(root, split=split)
        got = SBDSemanticSegmentation(root, split=split)
    assert got.im_ids == ref.im_ids and str(got) == str(ref)
    assert len(got) == len(ref) > 0
    for i in range(len(ref)):
        assert got.sample_image_id(i) == ref.sample_image_id(i)
        _equal_samples(got[i], ref[i])


def _voc_sets(voc_root, task, transform=None):
    """(JAX train, JAX val, port train, port val) of ``task``."""
    if task == "instance":
        return (jax_voc.VOCInstanceSegmentation(voc_root, split="train",
                                                preprocess=True,
                                                transform=transform[1]),
                jax_voc.VOCInstanceSegmentation(voc_root, split="val",
                                                preprocess=True),
                VOCInstanceSegmentation(voc_root, split="train",
                                        transform=transform[0]),
                VOCInstanceSegmentation(voc_root, split="val"))
    return (jax_voc.VOCSemanticSegmentation(voc_root, split="train"),
            jax_voc.VOCSemanticSegmentation(voc_root, split="val"),
            VOCSemanticSegmentation(voc_root, split="train"),
            VOCSemanticSegmentation(voc_root, split="val"))


@pytest.mark.parametrize("dedupe", [True, False])
@pytest.mark.parametrize("task", ["instance", "semantic"])
def test_combined_index_matches_jax(trees, task, dedupe):
    jtrain, jval, train, val = _voc_sets(trees["voc"], task, (None, None))
    split = ["train", "val"]
    if task == "instance":
        jsbd = jax_sbd.SBDInstanceSegmentation(trees["jax"], split=split,
                                               preprocess=True)
        sbd = SBDInstanceSegmentation(trees["jax"], split=split)
    else:
        jsbd = jax_sbd.SBDSemanticSegmentation(trees["jax"], split=split)
        sbd = SBDSemanticSegmentation(trees["jax"], split=split)
    ref = jax_combine.CombinedDataset([jtrain, jsbd], excluded=[jval],
                                      dedupe=dedupe)
    got = CombinedDataset([train, sbd], excluded=[val], dedupe=dedupe)
    assert got.index == ref.index and str(got) == str(ref)
    ids = [got.sample_image_id(i) for i in range(len(got))]
    assert ids == [ref.sample_image_id(i) for i in range(len(ref))]
    assert not set(ids) & set(val.im_ids)  # the overlap with val excluded
    # the overlap with train: VOC's samples of it, and SBD's only
    # without dedupe
    dup = train.im_ids[0]
    n_train, n_sbd = (sum(ds.sample_image_id(i) == dup for i in range(len(ds)))
                      for ds in (train, sbd))
    assert n_sbd > 0 and ids.count(dup) == n_train + (0 if dedupe else n_sbd)


def test_mixed_schemas_raise_jax_error(trees):
    jinst, _, inst, _ = _voc_sets(trees["voc"], "instance", (None, None))
    jsem, _, sem, _ = _voc_sets(trees["voc"], "semantic")
    with pytest.raises(ValueError) as want:
        jax_combine.CombinedDataset([jinst, jsem])
    with pytest.raises(ValueError) as got:
        CombinedDataset([inst, sem])
    assert str(got.value) == str(want.value)
    both = CombinedDataset([inst, sem], allow_mixed_schemas=True, dedupe=False)
    assert len(both) == len(inst) + len(sem)


def test_prepared_cache_over_the_combined_set(trees, tmp_path):
    """The prepared cache wraps the combined set: its fingerprint stamps
    the SBD part's image and ``.mat`` files, and a sample of the SBD part
    comes back with that part's ``meta``."""
    from distributedpytorch_tpu_torch.data import PreparedInstanceDataset
    from distributedpytorch_tpu_torch.data.prepared import _content_stamp

    _, _, train, val = _voc_sets(trees["voc"], "instance", (None, None))
    sbd = SBDInstanceSegmentation(trees["port"], split=["train", "val"])
    combined = CombinedDataset([train, sbd], excluded=[val])
    stamped = {row[0] for row in _content_stamp(combined)}
    for kind in ("image", "instances", "classes"):
        assert sbd.tree.path(kind, sbd.im_ids[-1]) in stamped
    cache = PreparedInstanceDataset(combined, str(tmp_path), **TF)
    i = len(combined) - 1  # the last sample: SBD's
    assert combined.index[i][0] == 1
    got = cache[i]
    assert got["meta"] == {k: v for k, v in combined[i]["meta"].items()}
    assert got["crop_image"].shape == (64, 64, 3) and got["crop_gt"].max() == 1


@pytest.mark.usefixtures("jax_native_path")
def test_first_loader_batch_matches_jax(trees):
    tfs = (pipeline.build_train_transform(**TF),
           jax_pipeline.build_train_transform(**TF))
    jtrain, jval, train, val = _voc_sets(trees["voc"], "instance", tfs)
    split = ["train", "val"]
    ref = jax_combine.CombinedDataset(
        [jtrain, jax_sbd.SBDInstanceSegmentation(
            trees["jax"], split=split, preprocess=True, transform=tfs[1])],
        excluded=[jval])
    got = CombinedDataset([train, SBDInstanceSegmentation(
        trees["jax"], split=split, transform=tfs[0])], excluded=[val])
    kw = dict(batch_size=4, shuffle=True, drop_last=True, seed=2,
              num_workers=2)
    (want,) = [b for b, _ in zip(jax_pipeline.DataLoader(ref, **kw), range(1))]
    (batch,) = [b for b, _ in zip(pipeline.DataLoader(got, **kw), range(1))]
    assert batch["concat"].shape == (4, 64, 64, 4)
    assert_samples_equal(batch, want, loose=LOOSE, atol=1.0)


#: each task's overrides: a step or two over the combined set
TASKS = {
    "instance": ["data.train_batch=8", "data.area_thres=0"],
    "semantic": ["task=semantic", "model.name=deeplabv3", "model.nclass=21",
                 "model.in_channels=3", "data.crop_size=[33,33]",
                 "data.train_batch=4"],
}


@pytest.mark.parametrize("task", ["instance", "semantic"])
def test_trainer_combines_sbd_and_takes_a_step(trees, task, tmp_path):
    cfg = config.apply_overrides(config.Config(), [
        "model.backbone=resnet18", "data.crop_size=[32,32]", "data.relax=10",
        "data.num_workers=0", "epochs=1",
        "log_every_steps=1", 'log_writers=["jsonl"]',
        "checkpoint.keep_latest=1", f"data.root={trees['voc']}",
        f"data.sbd_root={trees['port']}", f"work_dir={tmp_path}",
        *TASKS[task]])
    d = cfg.data
    if task == "instance":
        tf = jax_pipeline.build_train_transform(
            crop_size=tuple(d.crop_size), relax=d.relax, zero_pad=d.zero_pad,
            rots=tuple(d.rots), scales=tuple(d.scales),
            alpha=d.guidance_alpha, guidance=d.guidance)
        jtrain = jax_voc.VOCInstanceSegmentation(
            d.root, split=d.train_split, transform=tf, preprocess=True,
            area_thres=d.area_thres)
        jval = jax_voc.VOCInstanceSegmentation(d.root, split=d.val_split,
                                               preprocess=True,
                                               area_thres=d.area_thres)
        jsbd = jax_sbd.SBDInstanceSegmentation(
            d.sbd_root, split=["train", "val"], transform=tf,
            preprocess=True, area_thres=d.area_thres)
    else:
        tf = jax_pipeline.build_semantic_train_transform(
            crop_size=tuple(d.crop_size), rots=tuple(d.rots),
            scales=tuple(d.scales))
        jtrain = jax_voc.VOCSemanticSegmentation(d.root, split=d.train_split,
                                                 transform=tf)
        jval = jax_voc.VOCSemanticSegmentation(d.root, split=d.val_split)
        jsbd = jax_sbd.SBDSemanticSegmentation(
            d.sbd_root, split=["train", "val"], transform=tf)
    ref = jax_combine.CombinedDataset([jtrain, jsbd], excluded=[jval])

    trainer = Trainer(cfg, device="cpu")
    try:
        got = trainer.train_set
        assert isinstance(got, CombinedDataset) and got.index == ref.index
        assert str(got) == str(ref) and str(got).startswith("Combined(")
        rngs = (pipeline.sample_rng(0, 0, 0), jax_pipeline.sample_rng(0, 0, 0))
        assert_samples_equal(got.__getitem__(0, rngs[0]),
                             ref.__getitem__(0, rngs[1]), loose=LOOSE,
                             atol=1.0)
        history = trainer.fit()
    finally:
        trainer.close()
    steps = len(ref) // d.train_batch
    assert trainer.state.step == steps >= 1
    assert np.isfinite(history["train_loss"][0])
    with open(os.path.join(trainer.run_dir, f"{cfg.experiment_name}.txt")) as f:
        assert f"train_set: {ref}\n" in f.read()
