"""Fit-level acceptance: a short fit of the port's ``Trainer`` tracks the
JAX package's ``Trainer`` on the same data from the same weights, for
both tasks, on the CPU.

The JAX package writes its on-disk fake VOC tree
(``distributedpytorch_tpu.data.fake.make_fake_voc``) and both trainers read
it (``data.root``), so both see the same pixels, in the same order, with
the same augmentation draws.  Each fit is ResNet-18 at 64², two optimizer
steps and one validation; the port's model is loaded with the JAX
trainer's initial weights (``load_jax_params``), and dropout is off on
both sides (flax's ``nn.Dropout`` intercepted, the port's rates 0).  The
JAX trainer runs on the conftest mesh as 4 data x 2 model devices (train
batch 4), which keeps its arithmetic that of the global batch.

Band: the train loss at every step within 1e-3 relative, and the
validation metric (the instance task's best-threshold Jaccard, the
semantic task's mIoU, and its pixel accuracy) within 1e-2 absolute, the
validation loss within 1e-3 relative.  Gaps measured: instance losses
2.0e-5 relative, Jaccard 2.2e-4 (0.3978 against 0.3981); semantic losses
4.2e-6, mIoU 0 (both 0 after two steps from random weights, which is why
the losses are held too).  The test prints them.
"""

import json
import os

import jax
import numpy as np
import pytest
from flax import linen as fnn

from distributedpytorch_tpu.data.fake import make_fake_voc
from distributedpytorch_tpu.train import Trainer as JaxTrainer
from distributedpytorch_tpu.train import config as jax_config
from distributedpytorch_tpu_torch.models.deeplab import set_dropout
from distributedpytorch_tpu_torch.train import config
from distributedpytorch_tpu_torch.train.trainer import Trainer
from distributedpytorch_tpu_torch.utils.weights import load_jax_params
from test_torch_port_train import _no_dropout

COMMON = ["model.backbone=resnet18", "data.crop_size=[64,64]",
          "data.train_batch=4", "data.val_batch=1", "data.num_workers=0",
          "optim.lr=1e-2", "log_every_steps=1", "seed=0",
          "checkpoint.keep_latest=1"]
TASKS = {
    # 11 train objects: two steps of 4 in one epoch
    "instance": ["data.relax=10", "data.area_thres=0", "epochs=1"],
    # 5 train images: one step of 4 per epoch, validated after the second
    "semantic": ["task=semantic", "model.name=deeplabv3", "model.nclass=21",
                 "model.in_channels=3", "model.aux_head=true",
                 "model.loss_weights=[1.0,0.4]", "epochs=2", "eval_every=2"],
}


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc"))
    make_fake_voc(root, n_images=8, size=(96, 128), n_val=3, seed=0)
    return root


def _step_losses(run_dir: str) -> dict[int, float]:
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f if line.strip()]
    return {int(r["step"]): r["train/loss"] for r in records if "train/loss" in r}


@pytest.mark.parametrize("task", ["instance", "semantic"])
def test_fit_tracks_jax(task, voc_root, tmp_path):
    overrides = COMMON + TASKS[task] + [f"data.root={voc_root}"]
    jcfg = jax_config.apply_overrides(jax_config.Config(), overrides + [
        "mesh.data=4", "mesh.model=2", "checkpoint.async_save=false",
        "log_writers=[\"jsonl\"]", f"work_dir={tmp_path / 'jax'}"])
    cfg = config.apply_overrides(config.Config(), overrides + [
        "log_writers=[\"jsonl\"]", f"work_dir={tmp_path / 'port'}"])

    jtr = JaxTrainer(jcfg)
    port = Trainer(cfg, device="cpu")
    load_jax_params(port.model, jax.device_get(jtr.state.params),
                    jax.device_get(jtr.state.batch_stats))
    if task == "semantic":
        set_dropout(port.model, False)
    else:
        port.model.head.dropout_rate = 0.0
    try:
        with fnn.intercept_methods(_no_dropout):
            jhist = jtr.fit()
        hist = port.fit()
    finally:
        jtr.close()
        port.close()

    want, got = _step_losses(jtr.run_dir), _step_losses(port.run_dir)
    assert sorted(got) == sorted(want) == [1, 2]
    loss_gap = max(abs(got[s] - want[s]) / abs(want[s]) for s in want)
    assert loss_gap <= 1e-3, (got, want)
    (jval,), (val,) = jhist["val"], hist["val"]
    assert val["n_samples"] == jval["n_samples"] > 0
    metric_gap = abs(val["jaccard"] - jval["jaccard"])
    assert metric_gap <= 1e-2, (val["jaccard"], jval["jaccard"])
    # the validation loss too: two steps from random weights leave the
    # semantic mIoU near 0 on both sides, but not the loss
    assert abs(val["loss"] - jval["loss"]) <= 1e-3 * abs(jval["loss"])
    if task == "semantic":
        assert val["jaccard"] == val["miou"] and jval["jaccard"] == jval["miou"]
        assert abs(val["pixel_acc"] - jval["pixel_acc"]) <= 1e-2
    print(f"{task}: losses {[got[s] for s in sorted(got)]} vs "
          f"{[want[s] for s in sorted(want)]}, worst gap {loss_gap:.2e} relative; "
          f"val {val['jaccard']:.6f} vs {jval['jaccard']:.6f}, gap {metric_gap:.2e}; "
          f"val loss {val['loss']:.6f} vs {jval['loss']:.6f}")
