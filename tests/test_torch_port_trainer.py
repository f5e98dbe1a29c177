"""The port's trainer surface against the JAX package's, on the CPU.

* Config: the JSON form is identical in both packages, default and with
  overrides, and each package reads the other's; a knob the port does not
  run yet, set away from its default, makes the ``Trainer`` raise and name
  it.
* Weights both ways: JAX trees -> port ``state_dict`` -> JAX trees is bit
  for bit the identity.
* ``np_jaccard`` and ``np_jaccard_thresholds`` bit for bit.
* ``evaluate``: the port's protocol against the JAX package's on the same
  DANet-R18 weights and the same fixture: every threshold's mean Jaccard
  within 1e-4, the same sample count.
* ``Trainer.fit`` on the CPU (R18, 64², the in-memory fake fixture, one
  epoch) writes ``config.json``, ``metrics.jsonl`` and a committed
  checkpoint; ``Predictor.from_run`` on that run, and the serve CLI's
  ``--run-dir``, give the trained model's logits bit for bit.
* ``param_digest`` sees every tensor, 0-dim ones included.
"""

import argparse
import json
import os

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
        "data.num_workers=0", "epochs=1", "log_every_steps=2"]


class TestConfig:
    @pytest.mark.parametrize("overrides", [[], OVERRIDES])
    def test_json_identical_both_ways(self, overrides):
        port = config.apply_overrides(config.Config(), overrides)
        ref = jax_config.apply_overrides(jax_config.Config(), overrides)
        assert config.to_json(port) == jax_config.to_json(ref)
        assert config.to_json(config.from_json(jax_config.to_json(ref))) \
            == jax_config.to_json(ref)
        assert jax_config.to_json(jax_config.from_json(config.to_json(port))) \
            == config.to_json(port)

    @pytest.mark.parametrize("knob", ["model.bn_fp32_stats=false",
                                      "data.source=packed", "mesh.model=2",
                                      "model.guidance_inject=head",
                                      "sentinel.enabled=true"])
    def test_unported_knob_raises(self, knob, tmp_path):
        cfg = config.apply_overrides(config.Config(), TINY + [
            knob, f"work_dir={tmp_path}"])
        with pytest.raises(NotImplementedError, match=knob.split("=")[0]):
            Trainer(cfg, device="cpu")

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


def test_unported_writers_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="tensorboard"):
        make_writer("tensorboard", str(tmp_path))


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
