"""The port's trainer surface against the JAX package's, on the CPU.

* Config: the JSON form is identical in both packages, default and with
  overrides, and each package reads the other's; a knob the port does not
  run yet, set away from its default, makes the ``Trainer`` raise and name
  it; ``model.aux_head``, ``encnet_codes`` and ``ccnet_recurrence`` set
  for DANet raise the JAX package's ``ValueError``, message for message.
* Weights both ways: JAX trees -> port ``state_dict`` -> JAX trees is bit
  for bit the identity.
* ``np_jaccard`` and ``np_jaccard_thresholds`` bit for bit.
* ``evaluate``: the port's protocol against the JAX package's on the same
  DANet-R18 weights and the same fixture: every threshold's mean Jaccard
  within 1e-4, the same sample count.
* ``Trainer.fit`` on the CPU (R18, 64², the in-memory fake fixture, one
  epoch) writes ``config.json``, ``metrics.jsonl`` and a committed
  checkpoint; ``Predictor.from_run`` on that run, and the serve CLI's
  ``--run-dir``, give the trained model's logits bit for bit.  A
  ``model.guidance_inject=head`` fit of two steps resumes for two more,
  and its run serves a session whose warm click is the stateless mask.
* ``param_digest`` sees every tensor, 0-dim ones included.
* The semantic task through the CLI on the CPU (DeepLabV3-R18 at 65²,
  full-res validation): mIoU logged and used as the checkpoint gate, the
  run served by ``SemanticPredictor`` and resumed; the JAX trainer's task
  refusals with its messages, the families still refused by name;
  ``--predict`` refusing training flags; a DeepLab warm start from a
  torchvision ResNet-18 layout.
"""

import argparse
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.data import fake as jax_fake
from distributedpytorch_tpu.data import pipeline as jax_pipeline
from distributedpytorch_tpu.data import voc as jax_voc
from distributedpytorch_tpu.models import build_model as jax_build_model
from distributedpytorch_tpu.ops import metrics as jax_metrics
from distributedpytorch_tpu.parallel import TrainState as JaxTrainState
from distributedpytorch_tpu.parallel import make_eval_step as jax_make_eval_step
from distributedpytorch_tpu.train import config as jax_config
from distributedpytorch_tpu.train.evaluate import evaluate as jax_evaluate
from distributedpytorch_tpu_torch import __main__ as cli
from distributedpytorch_tpu_torch.data import pipeline, voc
from distributedpytorch_tpu_torch.models import build_model
from distributedpytorch_tpu_torch.ops import metrics
from distributedpytorch_tpu_torch.parallel.step import TrainState, make_eval_step
from distributedpytorch_tpu_torch.predict import Predictor
from distributedpytorch_tpu_torch.serve.__main__ import build_predictor
from distributedpytorch_tpu_torch.serve.service import InferenceService
from distributedpytorch_tpu_torch.train import config, precision
from distributedpytorch_tpu_torch.train.checkpoint import param_digest
from distributedpytorch_tpu_torch.train.evaluate import evaluate
from distributedpytorch_tpu_torch.train.logging import make_writer
from distributedpytorch_tpu_torch.train.trainer import Trainer
from distributedpytorch_tpu_torch.utils.weights import (
    load_jax_params,
    state_dict_to_jax,
)
from test_torch_port_model import randomize

OVERRIDES = ["data.fake=true", "optim.lr=1e-3", "data.crop_size=[64,64]",
             "model.backbone=resnet18", "eval_thresholds=[0.4,0.6]",
             "optim.lr_mult={\"head\": 10.0}", "optim.freeze=[\"backbone\"]",
             "checkpoint.keep_latest=2"]
#: the port's tiny CPU run
TINY = ["data.fake=true", "model.backbone=resnet18", "data.crop_size=[64,64]",
        "data.relax=10", "data.area_thres=0", "data.train_batch=2",
        "data.num_workers=0", "epochs=1", "log_every_steps=2",
        "checkpoint.keep_latest=1"]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs in several
    processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


class TestConfig:
    @pytest.mark.parametrize("overrides", [
        [], OVERRIDES, OVERRIDES + ["model.guidance_inject=head"]])
    def test_json_identical_both_ways(self, overrides):
        port = config.apply_overrides(config.Config(), overrides)
        ref = jax_config.apply_overrides(jax_config.Config(), overrides)
        assert config.to_json(port) == jax_config.to_json(ref)
        assert config.to_json(config.from_json(jax_config.to_json(ref))) \
            == jax_config.to_json(ref)
        assert jax_config.to_json(jax_config.from_json(config.to_json(port))) \
            == config.to_json(port)

    @pytest.mark.parametrize("knob", ["model.pam_impl=ring",
                                      "data.source=packed", "mesh.model=2",
                                      "data.uint8_transfer=true",
                                      "sentinel.enabled=true"])
    def test_unported_knob_raises(self, knob, tmp_path):
        cfg = config.apply_overrides(config.Config(), TINY + [
            knob, f"work_dir={tmp_path}"])
        with pytest.raises(NotImplementedError, match=knob.split("=")[0]):
            Trainer(cfg, device="cpu")

    @pytest.mark.parametrize("knob", ["model.aux_head=true",
                                      "model.encnet_codes=16",
                                      "model.ccnet_recurrence=3"])
    def test_danet_refuses_other_families_knobs(self, knob, tmp_path):
        """As the JAX package's ``build_model`` does for DANet, with its
        message."""
        cfg = config.apply_overrides(config.Config(), TINY + [
            knob, f"work_dir={tmp_path}"])
        name, value = knob.split("=")
        kw = {name.split(".")[1]: json.loads(value)}
        with pytest.raises(ValueError) as want:
            jax_build_model("danet", nclass=1, backbone="resnet18", **kw)
        with pytest.raises(ValueError) as got:
            Trainer(cfg, device="cpu")
        assert str(got.value) == str(want.value)
        assert name.split(".")[1] in str(got.value)

    def test_unknown_field_raises(self):
        with pytest.raises(KeyError):
            config.apply_overrides(config.Config(), ["optim.learning_rate=1"])


def test_precision_policy():
    precision.apply_policy("float32")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    # bf16 compute keeps TF32 off for its float32 islands too
    assert precision.apply_policy("bfloat16").compute_dtype == "bfloat16"
    assert not torch.backends.cudnn.allow_tf32
    with pytest.raises(ValueError):
        precision.apply_policy("fp8")


def test_unported_writers_raise(tmp_path, monkeypatch, capsys):
    """``comet`` without the SDK is a no-op writer, as in the JAX package
    (it no longer raises as unported)."""
    monkeypatch.setitem(sys.modules, "comet_ml", None)  # the import fails
    writer = make_writer("comet", str(tmp_path))
    assert "CometWriter disabled" in capsys.readouterr().out
    assert not writer.takes_figures
    writer.scalars({"loss": 1.0}, 1)
    writer.figure("val_panels", object(), 1)
    writer.hparams({"lr": 1.0})
    writer.close()
    assert os.listdir(tmp_path) == []


@pytest.fixture(scope="module")
def r18():
    model = jax_build_model("danet", nclass=1, backbone="resnet18",
                            output_stride=8, attention_impl="xla")
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 4)), train=False))
    return model, randomize(shapes, seed=4)


def test_weights_round_trip_bit_identical(r18):
    _, variables = r18
    model = build_model("danet", backbone="resnet18")
    load_jax_params(model, variables["params"], variables["batch_stats"])
    params, stats = state_dict_to_jax(model.state_dict())
    for got, want in ((params, variables["params"]),
                      (stats, variables["batch_stats"])):
        got_flat = jax.tree_util.tree_leaves_with_path(got)
        want_flat = jax.tree_util.tree_leaves_with_path(want)
        assert [p for p, _ in got_flat] == [p for p, _ in want_flat]
        for (_, g), (_, w) in zip(got_flat, want_flat):
            assert np.asarray(g).dtype == np.float32
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_jaccard_metrics_match_jax():
    """Both host metrics bit for bit, with and without void pixels, an
    empty union included."""
    r = np.random.default_rng(7)
    prob = r.random((40, 50)).astype(np.float32)
    gt = r.random((40, 50)) < 0.3
    void = r.random((40, 50)) < 0.1
    for v in (None, void):
        assert metrics.np_jaccard(prob > 0.5, gt, v) == \
            jax_metrics.np_jaccard(prob > 0.5, gt, v)
        np.testing.assert_array_equal(
            metrics.np_jaccard_thresholds(prob, (0.8, 0.3, 0.5), gt, v),
            jax_metrics.np_jaccard_thresholds(prob, (0.8, 0.3, 0.5), gt, v))
    empty = np.zeros((4, 4))
    assert metrics.np_jaccard(empty, empty) == jax_metrics.np_jaccard(empty, empty) == 1.0


def test_evaluate_matches_jax(r18, tmp_path):
    jmodel, variables = r18
    root = str(tmp_path)
    jax_fake.make_fake_voc(root, n_images=5, size=(96, 128), n_val=3, seed=1)
    kw = dict(crop_size=(64, 64), relax=10)
    ref_loader = jax_pipeline.DataLoader(
        jax_voc.VOCInstanceSegmentation(
            root, split="val", preprocess=True,
            transform=jax_pipeline.build_eval_transform(**kw)), 2,
        num_workers=0)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32),
                           params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=(), rng=jax.random.PRNGKey(0))
    ref = jax_evaluate(jax_make_eval_step(jmodel), jstate, ref_loader,
                       thresholds=(0.3, 0.5, 0.8), relax=10)
    model = build_model("danet", backbone="resnet18")
    load_jax_params(model, variables["params"], variables["batch_stats"])
    state = TrainState(model, None, None, None)
    loader = pipeline.DataLoader(
        voc.VOCInstanceSegmentation(root, split="val",
                                    transform=pipeline.build_eval_transform(**kw)),
        2, num_workers=0)
    got = evaluate(make_eval_step(), state, loader, relax=10)
    assert got["n_samples"] == ref["n_samples"] > 2
    assert got["jaccard_per_threshold"].keys() == ref["jaccard_per_threshold"].keys()
    for t, want in ref["jaccard_per_threshold"].items():
        assert abs(got["jaccard_per_threshold"][t] - want) <= 1e-4
    assert 0.0 < max(ref["jaccard_per_threshold"].values()) < 1.0
    assert abs(got["loss"] - ref["loss"]) <= 1e-4 * abs(ref["loss"])


def test_fit_then_predictor_from_run(tmp_path):
    cfg = config.apply_overrides(config.Config(),
                                 TINY + [f"work_dir={tmp_path}"])
    trainer = Trainer(cfg, device="cpu")
    history = trainer.fit()
    trainer.close()
    run = trainer.run_dir
    assert len(history["train_loss"]) == 1 and np.isfinite(history["train_loss"][0])
    assert 0.0 <= history["val"][0]["jaccard"] <= 1.0
    with open(os.path.join(run, "checkpoints", "COMMITTED.json")) as f:
        committed = json.load(f)
    assert committed["latest"] == [trainer.state.step] > [0]
    assert config.to_json(config.from_json(os.path.join(run, "config.json"))) \
        == config.to_json(cfg)
    with open(os.path.join(run, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert any("train/epoch_loss" in r for r in records)
    with open(os.path.join(run, "fit_summary.json")) as f:
        assert json.load(f)["final_step"] == trainer.state.step

    pred = Predictor.from_run(run, step=trainer.state.step, device="cpu")
    assert pred.resolution == (64, 64) and pred.relax == 10
    x = torch.rand(2, 4, 64, 64) * 255
    with torch.no_grad():
        want = trainer.model.eval()(x)
        got = pred.model(x)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    # default: the best checkpoint, here the only one; the serve CLI's
    # --run-dir takes the same path
    assert torch.equal(Predictor.from_run(run, device="cpu").model(x)[0], got[0])
    served = build_predictor(argparse.Namespace(run_dir=run, step=None,
                                                device="cpu"))
    assert torch.equal(served.model(x)[0], got[0])


def test_head_fit_resumes_and_serves_sessions(tmp_path):
    over = TINY + ["model.guidance_inject=head", "data.train_batch=4",
                   f"work_dir={tmp_path}"]
    first = Trainer(config.apply_overrides(config.Config(), over),
                    device="cpu")
    first.fit()
    first.close()
    assert first.state.step == 2
    assert first.model.backbone.Conv_0.in_channels == 3
    assert first.model.guidance_proj.weight.shape == (512, 1, 1, 1)
    resumed = Trainer(config.apply_overrides(
        config.Config(), over + ["epochs=2", "resume=auto"]),
        device="cpu")
    assert resumed.state.step == 2
    resumed.fit()
    resumed.close()
    assert resumed.state.step == 4
    # the projection trained away from its zero init
    assert resumed.model.guidance_proj.weight.abs().max() > 0

    pred = Predictor.from_run(resumed.run_dir, device="cpu")
    assert pred.supports_sessions and pred.resolution == (64, 64)
    x = torch.rand(2, 4, 64, 64) * 255
    with torch.no_grad():
        assert torch.equal(pred.model(x)[0],
                           resumed.model.eval()(x)[0])
    image = np.random.default_rng(0).integers(
        0, 256, (80, 96, 3)).astype(np.uint8)
    points = np.array([[20, 40], [70, 40], [45, 15], [45, 65]], float)
    with InferenceService(pred, max_batch=2, max_wait_s=0.0) as svc:
        stateless = svc.predict(image, points, timeout=60)
        cold = svc.predict(image, points, timeout=60, session_id="u")
        warm = svc.predict(image, points, timeout=60, session_id="u")
        sessions = svc.health()["sessions"]
    np.testing.assert_array_equal(cold, stateless)
    np.testing.assert_array_equal(warm, stateless)
    assert (sessions["hits"], sessions["misses"], sessions["live"]) \
        == (1, 1, 1)


def test_param_digest_covers_every_tensor():
    """0-dim tensors (the residual gates, BatchNorm's counters) included:
    flipping any one bit changes the digest."""
    model = build_model("danet", backbone="resnet18")
    state = model.state_dict()
    digest = param_digest(state)
    assert param_digest(model.state_dict()) == digest
    for key in ("head.pam.gamma", "backbone.BatchNorm_0.num_batches_tracked",
                "head.fused_cls.weight"):
        flipped = dict(state)
        flipped[key] = state[key].clone()
        flipped[key].view(-1)[0] += 1
        assert param_digest(flipped) != digest, key


def test_cli_needs_a_card_unless_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--fake-data", *TINY, f"work_dir={tmp_path}"])
    assert cli.main(["--device", "cpu", "--validate-only", *TINY,
                     f"work_dir={tmp_path}"]) == 0


#: the port's tiny semantic CPU run (5 fake train images: batch <= 5)
SEMANTIC = ["--device", "cpu", "--fake-data", "task=semantic",
            "model.name=deeplabv3", "model.nclass=21", "model.in_channels=3",
            "model.backbone=resnet18", "model.aux_head=true",
            "model.loss_weights=[1.0,0.4]", "data.crop_size=[65,65]",
            "data.train_batch=4", "data.val_batch=2", "data.num_workers=0",
            "eval_full_res=true", "epochs=1"]


def test_semantic_fit_through_the_cli(tmp_path):
    """``task=semantic`` trains, validates by mIoU at native resolution,
    commits its checkpoint by the uniform ``jaccard`` gate (= mIoU),
    ``SemanticPredictor.from_run`` serves the trained weights, and
    ``resume=auto`` continues the run."""
    from distributedpytorch_tpu_torch.predict import SemanticPredictor

    assert cli.main([*SEMANTIC, f"work_dir={tmp_path}"]) == 0
    run = tmp_path / "run_0"
    with open(run / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    (val,) = [r for r in records if "val/miou" in r]
    assert 0.0 <= val["val/miou"] <= 1.0 and 0.0 <= val["val/pixel_acc"] <= 1.0
    assert val["val/jaccard"] == val["val/miou"]
    assert len(val["val/per_class_iou"]) == 21 and val["val/n_samples"] == 3
    losses = [x for r in records for x in r.get("train/step_losses", [])]
    assert len(losses) == 1 and np.isfinite(losses[0])
    with open(run / "checkpoints" / "COMMITTED.json") as f:
        committed = json.load(f)
    assert committed["latest"] == [1]
    pred = SemanticPredictor.from_run(str(run), device="cpu")
    assert pred.resolution == (65, 65)
    classes = pred.predict(np.full((40, 30, 3), 128.0))
    assert classes.shape == (40, 30) and classes.dtype == np.uint8
    # and resumes: a second epoch continues from the committed step
    assert cli.main([*SEMANTIC, "epochs=2", "resume=auto",
                     f"work_dir={tmp_path}"]) == 0
    with open(tmp_path / "run_1" / "fit_summary.json") as f:
        summary = json.load(f)
    assert summary["resumed_from_step"] == 1 and summary["final_step"] == 2
    assert summary["start_epoch"] == 1 and summary["completed"]


@pytest.mark.parametrize("overrides,error,match", [
    (["eval_tta_flip=true"], ValueError, "semantic task only"),
    (["eval_tta_scales=[0.5,1.0]"], ValueError, "semantic task only"),
    (["eval_full_res=true"], ValueError, "semantic task only"),
    (["model.nclass=21"], ValueError,
     r"requires model.nclass=1 \(binary sigmoid head\), got 21; use "
     "task='semantic' for multi-class"),
    (["task=panoptic"], ValueError, "unknown task"),
    (["task=semantic", "model.name=pspnet", "model.nclass=21"],
     NotImplementedError, "model.name='pspnet'"),
    (["task=semantic", "model.name=deeplabv3", "model.nclass=21",
      "model.attention_impl=flash"], ValueError, "DANet-only"),
])
def test_task_refusals(overrides, error, match, tmp_path):
    """The JAX trainer's task checks, with its messages, and the families
    still refused by name."""
    cfg = config.apply_overrides(config.Config(), TINY + overrides + [
        f"work_dir={tmp_path}"])
    with pytest.raises(error, match=match):
        Trainer(cfg, device="cpu")


def test_predict_refuses_training_flags(tmp_path, capsys):
    for extra in (["--fake-data"], ["--config", "c.json"], ["--validate-only"],
                  ["--dist-backend", "gloo"], ["epochs=2"]):
        with pytest.raises(SystemExit) as e:
            cli.main(["--predict", "x.png", "--run-dir", str(tmp_path), *extra])
        assert e.value.code == 2
        assert "do not apply" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli.main(["--predict", "x.png"])
    assert "--run-dir" in capsys.readouterr().err


def _torchvision_resnet18_state(seed: int = 0) -> dict:
    """A state dict with torchvision's ResNet-18 key names and shapes, drawn
    from ``seed`` (the head ``fc`` included)."""
    from distributedpytorch_tpu_torch.utils import weights

    model = build_model("deeplabv3", nclass=21, backbone="resnet18",
                        in_channels=3)
    shapes = model.state_dict()
    keys = ["conv1.weight"] + [f"bn1.{p}" for p in
                               ("weight", "bias", "running_mean", "running_var")]
    for stage in range(1, 5):
        for block in range(2):
            base = f"layer{stage}.{block}"
            keys += [f"{base}.conv1.weight", f"{base}.conv2.weight"]
            keys += [f"{base}.bn{k}.{p}" for k in (1, 2) for p in
                     ("weight", "bias", "running_mean", "running_var")]
            if stage > 1 and block == 0:
                keys += [f"{base}.downsample.0.weight"] + [
                    f"{base}.downsample.1.{p}" for p in
                    ("weight", "bias", "running_mean", "running_var")]
    rename = weights.torchvision_resnet_rename(18)
    r = np.random.default_rng(seed)
    state = {k: torch.from_numpy(r.uniform(0.5, 1.5, tuple(shapes[rename(k)].shape))
                                 .astype(np.float32)) for k in keys}
    state["fc.weight"] = torch.zeros(1000, 512)
    state["fc.bias"] = torch.zeros(1000)
    return state


def test_warm_start_deeplab_from_torchvision_resnet(tmp_path):
    """A torchvision ResNet-18 state dict builds into DeepLabV3's backbone
    (the 3-channel stem as it is); the heads keep their fresh values."""
    from distributedpytorch_tpu_torch.utils import weights

    state = _torchvision_resnet18_state()
    path = tmp_path / "resnet18.pth"
    torch.save(state, path)
    cfg = config.apply_overrides(config.Config(), TINY + [
        "task=semantic", "model.name=deeplabv3", "model.nclass=21",
        "model.in_channels=3", f"checkpoint.warm_start={path}",
        f"work_dir={tmp_path}"])
    trainer = Trainer(cfg, device="cpu")
    fresh = Trainer(config.apply_overrides(cfg, ["checkpoint.warm_start=null"]),
                    device="cpu")
    got, init = trainer.model.state_dict(), fresh.model.state_dict()
    rename = weights.torchvision_resnet_rename(18)
    for key, value in state.items():
        if not key.startswith("fc."):
            assert torch.equal(got[rename(key)], value), key
    heads = [k for k in got if not k.startswith("backbone.")
             and not k.endswith("num_batches_tracked")]
    assert heads and all(torch.equal(got[k], init[k]) for k in heads)
    assert trainer.state.step == 0
