"""The port's validation and observability layer against the JAX
package's, on the CPU (ResNet-18 at 64², the JAX package's on-disk fake
VOC tree).

* Look-ahead: ``evaluate`` and ``evaluate_semantic`` (crop, full-res on
  the host, and TTA over scales and flips) give metrics bitwise equal to
  the one-batch-at-a-time loop (``_look_ahead`` replaced by a serial
  runner), with batch i + 1's forward launched before batch i's host
  half; against the JAX evaluators from the same weights and batches the
  metric is within the fit band's 1e-2 and the loss within 1e-3
  relative.  ``_first_batch`` has JAX's keys and shapes.
* Writers: ``make_val_panels`` draws the JAX figure's 2 x 4 axes and
  titles; TensorBoard scalars read back with tensorboard's
  ``EventAccumulator``; ``CometWriter`` against a fake ``comet_ml``,
  scenario for scenario the JAX writer's record; ``make_writer`` selects
  each backend and refuses an unknown one with JAX's message.
* Overlapped validation: ``val_overlap`` true against false gives the
  same histories bit for bit and a best checkpoint; an error on the
  thread surfaces at the next log cadence; a SIGTERM with a validation
  pending leaves no thread; the launch counter stays exact under
  concurrent increments.
* ``profile_epoch``: a Chrome trace under ``run_dir/profile``; an epoch
  outside the range prints JAX's warning.
* ``utils/profiling``: ``percentile`` equal to JAX's; ``StepTimer``,
  ``throughput`` and ``device_memory_stats`` on the CPU.
"""

import glob
import json
import os
import signal
import sys
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.data.fake import make_fake_voc
from distributedpytorch_tpu.models import build_model as jax_build_model
from distributedpytorch_tpu.parallel import TrainState as JaxTrainState
from distributedpytorch_tpu.parallel import make_eval_step as jax_make_eval_step
from distributedpytorch_tpu.train.evaluate import evaluate as jax_evaluate
from distributedpytorch_tpu.train.evaluate import \
    evaluate_semantic as jax_evaluate_semantic
from distributedpytorch_tpu.train import logging as jax_logging
from distributedpytorch_tpu.utils import profiling as jax_profiling
from distributedpytorch_tpu_torch.data import pipeline, voc
from distributedpytorch_tpu_torch.models import build_model
from distributedpytorch_tpu_torch.ops import cuda_attention
from distributedpytorch_tpu_torch.parallel.step import TrainState, make_eval_step
from distributedpytorch_tpu_torch.train import config
from distributedpytorch_tpu_torch.train import evaluate as evaluate_mod
from distributedpytorch_tpu_torch.train import logging as port_logging
from distributedpytorch_tpu_torch.train.preemption import PreemptionGuard
from distributedpytorch_tpu_torch.train.trainer import Trainer
from distributedpytorch_tpu_torch.utils import profiling
from distributedpytorch_tpu_torch.utils.weights import load_jax_params
from test_torch_port_model import randomize


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs in several
    processes at once, and torch's default of a thread per core in each
    of them oversubscribes the CPUs many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


HW = 64


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc"))
    make_fake_voc(root, n_images=6, size=(96, 128), n_val=3, seed=3)
    return root


def _serial(finishers):
    """The one-batch-at-a-time loop: each batch finished before the next
    one is launched."""
    for finish in finishers:
        if finish is not None:
            finish()


def _without_seconds(metrics: dict) -> dict:
    return {k: v for k, v in metrics.items() if k not in ("seconds", "_first_batch")}


def _jax_state(variables):
    return JaxTrainState(step=jnp.zeros((), jnp.int32),
                         params=variables["params"],
                         batch_stats=variables["batch_stats"],
                         opt_state=(), rng=jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def instance(voc_root):
    """DANet-R18 weights in both packages and the port's val batches of 2."""
    jmodel = jax_build_model("danet", nclass=1, backbone="resnet18",
                             output_stride=8, attention_impl="xla")
    variables = randomize(jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 4)), train=False)), seed=5)
    model = build_model("danet", backbone="resnet18")
    load_jax_params(model, variables["params"], variables["batch_stats"])
    dataset = voc.VOCInstanceSegmentation(
        voc_root, split="val", area_thres=0,
        transform=pipeline.build_eval_transform(crop_size=(HW, HW), relax=10))
    batches = list(pipeline.DataLoader(dataset, 2, num_workers=0))
    return types.SimpleNamespace(jmodel=jmodel, variables=variables,
                                 state=TrainState(model, None, None, None),
                                 batches=batches)


class TestLookAhead:
    def test_instance_bitwise_serial_and_ordered(self, instance, monkeypatch):
        events = []
        step = make_eval_step()

        def logged_step(state, batch):
            events.append("forward")
            return step(state, batch)

        paste = evaluate_mod.crop2fullmask

        def logged_paste(*args, **kwargs):
            events.append("paste")
            return paste(*args, **kwargs)

        monkeypatch.setattr(evaluate_mod, "crop2fullmask", logged_paste)
        ahead = evaluate_mod.evaluate(logged_step, instance.state,
                                      instance.batches, relax=10)
        order = list(events)
        events.clear()
        monkeypatch.setattr(evaluate_mod, "_look_ahead", _serial)
        serial = evaluate_mod.evaluate(logged_step, instance.state,
                                       instance.batches, relax=10)
        assert _without_seconds(ahead) == _without_seconds(serial)
        assert len(instance.batches) >= 3
        # look-ahead: the second forward precedes the first paste-back
        assert order.index("forward", 1) < order.index("paste")
        assert events.index("paste") < events.index("forward", 1)
        for a, b in zip(ahead["_first_batch"]["outputs"],
                        serial["_first_batch"]["outputs"]):
            assert np.array_equal(a, b)

    def test_instance_matches_jax_and_first_batch(self, instance):
        got = evaluate_mod.evaluate(make_eval_step(), instance.state,
                                    instance.batches, relax=10)
        ref = jax_evaluate(
            jax_make_eval_step(instance.jmodel), _jax_state(instance.variables),
            instance.batches, relax=10)
        assert got["n_samples"] == ref["n_samples"] > 4
        assert abs(got["jaccard"] - ref["jaccard"]) <= 1e-2
        assert abs(got["loss"] - ref["loss"]) <= 1e-3 * abs(ref["loss"])
        mine, theirs = got["_first_batch"], ref["_first_batch"]
        assert mine.keys() == theirs.keys() == {"batch", "outputs"}
        assert mine["batch"] is instance.batches[0]
        assert [o.shape for o in mine["outputs"]] == \
            [np.asarray(o).shape for o in theirs["outputs"]] == [(2, HW, HW, 1)] * 3
        for a, b in zip(mine["outputs"], theirs["outputs"]):
            b = np.asarray(b)
            assert np.abs(a - b).max() <= 1e-3 * max(1.0, np.abs(b).max())

    @pytest.mark.parametrize("protocol", ["crop", "fullres", "tta"])
    def test_semantic_bitwise_serial_and_jax(self, voc_root, protocol,
                                             monkeypatch):
        jmodel = jax_build_model("deeplabv3", nclass=21, backbone="resnet18")
        variables = randomize(jax.eval_shape(lambda: jmodel.init(
            jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)), train=False)),
            seed=6)
        model = build_model("deeplabv3", nclass=21, backbone="resnet18",
                            in_channels=3)
        load_jax_params(model, variables["params"], variables["batch_stats"])
        dataset = voc.VOCSemanticSegmentation(
            voc_root, split="val",
            transform=pipeline.build_semantic_eval_transform(
                crop_size=(HW, HW), keep_fullres=protocol != "crop"))
        batches = list(pipeline.DataLoader(dataset, 1, num_workers=0))
        kw = dict(nclass=21, device_fullres=None)
        if protocol == "tta":
            kw.update(tta_scales=(0.75, 1.0), tta_flip=True)
        state = TrainState(model, None, None, None)
        ahead = evaluate_mod.evaluate_semantic(make_eval_step(
            loss_type="multi_softmax"), state, batches, **kw)
        with monkeypatch.context() as m:
            m.setattr(evaluate_mod, "_look_ahead", _serial)
            serial = evaluate_mod.evaluate_semantic(make_eval_step(
                loss_type="multi_softmax"), state, batches, **kw)
        assert _without_seconds(ahead) == _without_seconds(serial)
        assert ahead["n_samples"] == len(batches) == 3
        if protocol == "tta":
            return  # the JAX side would compile a program per scale
        ref = jax_evaluate_semantic(
            jax_make_eval_step(jmodel, loss_type="multi_softmax"),
            _jax_state(variables), batches, **kw)
        for key in ("miou", "pixel_acc"):
            assert abs(ahead[key] - ref[key]) <= 1e-2, key
        assert abs(ahead["loss"] - ref["loss"]) <= 1e-3 * abs(ref["loss"])


class FakeExperiment:
    """Records the ``comet_ml.Experiment`` calls a writer makes."""

    instances: list = []

    def __init__(self, **kw):
        self.kw, self.metrics, self.figures = kw, [], []
        self.params, self.name, self.ended = None, None, False
        FakeExperiment.instances.append(self)

    def set_name(self, name):
        self.name = name

    def log_metrics(self, d, step=None):
        self.metrics.append((dict(d), step))

    def log_figure(self, figure_name=None, figure=None, step=None):
        self.figures.append((figure_name, step))

    def log_parameters(self, d):
        self.params = dict(d)

    def end(self):
        self.ended = True


@pytest.fixture
def fake_comet(monkeypatch):
    mod = types.ModuleType("comet_ml")
    mod.Experiment = FakeExperiment
    monkeypatch.setitem(sys.modules, "comet_ml", mod)
    monkeypatch.setenv("COMET_API_KEY", "test-key")
    FakeExperiment.instances = []
    return mod


def _flaky(exp, fail_at):
    """``exp.log_metrics`` failing on the calls numbered in ``fail_at``."""
    calls = {"n": 0}
    log = exp.log_metrics

    def flaky(d, step=None):
        calls["n"] += 1
        if calls["n"] in fail_at:
            raise ConnectionError("down")
        log(d, step)

    exp.log_metrics = flaky


def _comet_scenario(cls, case, monkeypatch):
    """Drive one ``CometWriter`` class through ``case``; the record of what
    the (fake) SDK saw and what the writer printed and kept."""
    if case == "no_key":
        monkeypatch.delenv("COMET_API_KEY", raising=False)
    if case == "no_sdk":
        monkeypatch.setitem(sys.modules, "comet_ml", None)
    FakeExperiment.instances = []
    w = cls(project="proj", workspace="ws", experiment_name="run-1") \
        if case == "full" else cls()
    fails0 = w._fails if case in ("fails_counter", "transient") else None
    exp = FakeExperiment.instances[0] if FakeExperiment.instances else None
    m = cls._MAX_FAILS
    if case == "full":
        w.scalars({"loss": 1.5, "note": "skipme"}, step=3)
        w.figure("panels", object(), step=3)
        w.hparams({"lr": 5e-8})
    elif case == "nonconsecutive":
        _flaky(exp, set(range(1, m)) | set(range(m + 1, 2 * m)))
        for i in range(2 * m - 1):
            w.scalars({"a": float(i)}, i)
    elif case == "transient":
        _flaky(exp, {1, 2})
        for i in (1, 2, 3):
            w.scalars({"a": float(i)}, i)
    elif case == "persistent":
        _flaky(exp, set(range(1, m + 1)))
        for i in range(m):
            w.scalars({"a": float(i)}, i)
    else:
        w.scalars({"loss": 1.0}, 1)
        w.figure("x", object(), 0)
    alive = w._exp is not None
    w.close()
    return {"alive": alive, "fails0": fails0, "fails": w._fails,
            "exp": None if exp is None else
            (exp.kw, exp.name, exp.metrics, exp.figures, exp.params, exp.ended)}


@pytest.mark.parametrize("case", ["full", "no_key", "no_sdk", "fails_counter",
                                  "nonconsecutive", "transient", "persistent"])
def test_comet_writer_as_jax(case, fake_comet, monkeypatch, capsys):
    """Each scenario of the JAX package's Comet tests, run against both
    writers: the same SDK calls, the same survival, the same messages."""
    want = _comet_scenario(jax_logging.CometWriter, case, monkeypatch)
    want_out = capsys.readouterr().out
    got = _comet_scenario(port_logging.CometWriter, case, monkeypatch)
    assert got == want
    assert capsys.readouterr().out == want_out
    expect = {"full": "", "no_key": "CometWriter disabled",
              "no_sdk": "CometWriter disabled", "fails_counter": "",
              "nonconsecutive": "will retry", "transient": "will retry",
              "persistent": "disabled after"}[case]
    assert expect in want_out
    if case == "full":
        kw, name, metrics, figures, params, ended = got["exp"]
        assert (kw["project_name"], kw["workspace"], name) == ("proj", "ws", "run-1")
        assert metrics == [({"loss": 1.5}, 3)] and figures == [("panels", 3)]
        assert params == {"lr": "5e-08"} and ended
    assert got["alive"] == (case not in ("no_key", "no_sdk", "persistent"))


def test_make_writer_selects_each_backend(tmp_path, fake_comet):
    run = str(tmp_path)
    kinds = {"console": port_logging.ConsoleWriter,
             "jsonl": port_logging.JsonlWriter,
             "tensorboard": port_logging.TensorBoardWriter,
             "comet": port_logging.CometWriter}
    for name, cls in kinds.items():
        assert type(port_logging.make_writer(name, run, comet_project="p")) is cls
    assert FakeExperiment.instances[-1].kw["project_name"] == "p"
    with pytest.raises(ValueError) as got:
        port_logging.make_writer("wandb", run)
    with pytest.raises(ValueError) as want:
        jax_logging.make_writer("wandb", run)
    assert str(got.value) == str(want.value)


def test_tensorboard_scalars_and_figure_read_back(tmp_path, instance):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )
    first = evaluate_mod.evaluate(make_eval_step(), instance.state,
                                  instance.batches[:1], relax=10)["_first_batch"]
    fig = port_logging.make_val_panels(first)
    w = port_logging.make_writer("tensorboard", str(tmp_path))
    assert w.takes_figures
    w.scalars({"val/jaccard": 0.25, "note": "text is skipped"}, 3)
    w.scalars({"val/jaccard": 0.5}, 7)
    w.figure("val_panels", fig, 7)
    w.hparams({"optim.lr": 1e-3})
    w.close()
    acc = EventAccumulator(str(tmp_path / "tb"), size_guidance={"images": 0})
    acc.Reload()
    assert [(e.step, e.value) for e in acc.Scalars("val/jaccard")] == \
        [(3, 0.25), (7, 0.5)]
    assert "note" not in acc.Tags()["scalars"]
    assert [e.step for e in acc.Images("val_panels")] == [7]


def test_val_panels_are_jax_figure(instance):
    import matplotlib.pyplot as plt

    got = evaluate_mod.evaluate(make_eval_step(), instance.state,
                                instance.batches[:1], relax=10)["_first_batch"]
    want = jax_evaluate(
        jax_make_eval_step(instance.jmodel), _jax_state(instance.variables),
        instance.batches[:1], relax=10)["_first_batch"]
    figs = [port_logging.make_val_panels(got), jax_logging.make_val_panels(want)]
    try:
        shapes = [(len(f.axes), [a.get_title() for a in f.axes]) for f in figs]
        assert shapes[0] == shapes[1]
        assert shapes[0][0] == 2 * 4
        assert shapes[0][1][:4] == ["image+gt", "fused", "pam", "cam"]
    finally:
        for f in figs:
            plt.close(f)


#: the port's small CPU fit on the JAX package's on-disk fake tree
def tiny(voc_root, work, *extra) -> config.Config:
    return config.apply_overrides(config.Config(), [
        f"data.root={voc_root}", "model.backbone=resnet18",
        "data.crop_size=[64,64]", "data.relax=10", "data.area_thres=0",
        "data.train_batch=2", "data.val_batch=2", "data.num_workers=0",
        "optim.lr=1e-3", "log_every_steps=1", "checkpoint.keep_latest=1",
        'log_writers=["jsonl"]', f"work_dir={work}", *extra])


def _overlap_threads() -> list:
    return [t for t in threading.enumerate() if t.name.startswith("val-overlap")]


class TestOverlappedValidation:
    def test_histories_equal_serial_and_best_lands(self, voc_root, tmp_path):
        hists, runs = {}, {}
        for flag in ("false", "true"):
            tr = Trainer(tiny(voc_root, tmp_path / flag, "epochs=3",
                              f"val_overlap={flag}"), device="cpu")
            hists[flag] = tr.fit()
            tr.close()
            runs[flag] = tr.run_dir
        serial, overlap = hists["false"], hists["true"]
        assert overlap["train_loss"] == serial["train_loss"]
        assert len(overlap["val"]) == len(serial["val"]) == 3
        for a, b in zip(serial["val"], overlap["val"]):
            assert _without_seconds(a) == _without_seconds(b)
        for run in runs.values():
            assert glob.glob(os.path.join(run, "checkpoints", "best", "*"))
            with open(os.path.join(run, "fit_summary.json")) as f:
                summary = json.load(f)
            # the CPU path runs the plain forms: nothing launched, exactly
            assert summary["kernel_launches"] == {k: 0 for k in cuda_attention.launches}
        assert not _overlap_threads()

    def test_thread_error_surfaces_at_next_poll(self, voc_root, tmp_path,
                                                monkeypatch):
        tr = Trainer(tiny(voc_root, tmp_path, "epochs=3", "val_overlap=true"),
                     device="cpu")
        steps_per_epoch = len(tr.train_loader)

        def boom(state, epoch=None):
            raise FloatingPointError("val diverged")

        step = tr.train_step

        def step_after_the_failure(state, batch):
            if state.step == steps_per_epoch:  # epoch 1's first step
                tr._pending_val[3].join(60)  # the thread has failed by now
            return step(state, batch)

        monkeypatch.setattr(tr, "_eval_metrics", boom)
        tr.train_step = step_after_the_failure
        with pytest.raises(FloatingPointError, match="val diverged"):
            tr.fit()
        tr.close()
        # raised at epoch 1's first log cadence, not at the epoch's end
        assert tr.state.step == steps_per_epoch + 1 < 2 * steps_per_epoch
        assert not _overlap_threads()

    def test_sigterm_with_validation_pending_leaves_no_thread(
            self, voc_root, tmp_path, monkeypatch):
        tr = Trainer(tiny(voc_root, tmp_path, "epochs=3", "val_overlap=true",
                          "checkpoint.preempt_check_every=1"), device="cpu")
        steps_per_epoch = len(tr.train_loader)
        evaluate = tr._eval_metrics
        sent = threading.Event()

        def pending_until_signalled(state, epoch=None):
            sent.wait(60)
            return evaluate(state, epoch)

        step = tr.train_step

        def step_then_signal(state, batch):
            loss = step(state, batch)
            if state.step == steps_per_epoch + 1:
                assert _overlap_threads(), "no validation pending"
                os.kill(os.getpid(), signal.SIGTERM)
                sent.set()
            return loss

        monkeypatch.setattr(tr, "_eval_metrics", pending_until_signalled)
        tr.train_step = step_then_signal
        hist = tr.fit()
        tr.close()
        assert hist["preempted"] and tr.state.step == steps_per_epoch + 1
        assert not _overlap_threads()
        assert [v["epoch"] for v in hist["val"]] == [0]

    def test_launch_counter_exact_under_threads(self):
        cuda_attention.reset_launches()
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=lambda: [
                cuda_attention._count("cam_apply") for _ in range(2000)])
                for _ in range(2 * (os.cpu_count() or 2))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            assert not any(t.is_alive() for t in threads)
        finally:
            sys.setswitchinterval(interval)
        assert cuda_attention.launches["cam_apply"] == 2000 * len(threads)
        cuda_attention.reset_launches()


class TestProfileEpoch:
    def test_trace_written(self, voc_root, tmp_path):
        tr = Trainer(tiny(voc_root, tmp_path, "epochs=1", "eval_every=0",
                          "profile_epoch=0"), device="cpu")
        tr.fit()
        tr.close()
        traces = glob.glob(os.path.join(tr.run_dir, "profile", "*.pt.trace.json"))
        assert len(traces) == 1
        with open(traces[0]) as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        assert "aten::convolution" in names

    def test_epoch_outside_range_warns_as_jax(self, voc_root, tmp_path, capsys):
        tr = Trainer(tiny(voc_root, tmp_path, "epochs=1", "eval_every=0",
                          "profile_epoch=5"), device="cpu")
        tr.fit()
        tr.close()
        assert ("warning: profile_epoch=5 outside the epoch range [0, 1) — no "
                "trace will be written") in capsys.readouterr().out
        assert not os.path.exists(os.path.join(tr.run_dir, "profile"))


class TestProfiling:
    def test_percentile_equals_jax(self):
        r = np.random.default_rng(0)
        for n in (1, 2, 7, 100):
            values = r.normal(size=n).tolist()
            for q in (0.0, 1.0, 50.0, 90.0, 99.0, 100.0):
                assert profiling.percentile(values, q) == \
                    jax_profiling.percentile(values, q)
        for args in (([], 50.0), ([1.0], 101.0)):
            with pytest.raises(ValueError) as got:
                profiling.percentile(*args)
            with pytest.raises(ValueError) as want:
                jax_profiling.percentile(*args)
            assert str(got.value) == str(want.value)

    def test_step_timer_throughput_and_memory_on_cpu(self):
        timer = profiling.StepTimer(warmup=1)
        for _ in range(4):
            timer.tick(torch.ones(2))
        summary = timer.summary(items_per_step=2)
        assert summary["steps"] == 2 and summary["items_per_sec"] > 0
        assert summary["p99_s"] == max(timer.times)
        with pytest.raises(ValueError):
            profiling.StepTimer(sync="nope")
        res = profiling.throughput(lambda: torch.ones(3) * 2, 3, items_per_step=4)
        assert res["steps"] == 3 and res["items_per_sec"] > 0
        assert profiling.device_memory_stats("cpu") == {
            "bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0}
        with profiling.annotate("region"):
            pass
