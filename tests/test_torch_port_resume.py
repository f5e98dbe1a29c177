"""Restartable training in the port against the JAX package's, on the CPU.

* ``PreemptionGuard``: the port's and the JAX package's guards, each put
  through the same checks — a signal sets the flag and the handlers come
  back, ``trip``, the ``check_every`` cadence, ``shield`` absorbing a
  second signal, a second SIGINT escalating to ``KeyboardInterrupt``.
* ``DataLoader.set_epoch(epoch, start_batch)`` yields the tail of the
  epoch's fixed order, bit for bit the JAX loader's batches.
* Run directories: ``next_run_dir`` picks the JAX package's index;
  ``latest_checkpoint_dir`` skips the caller's own run and runs with no
  committed step.
* Resume, bf16 DANet-R18 at 32², train batch 2 (5 steps per epoch), 2
  epochs: a fit stopped by ``guard.trip()`` at step 7 saves once with the
  epoch position; ``resume=auto`` in the same ``work_dir`` restores that
  exact state (weights, momentum, step, dropout generator), continues at
  batch 2 of epoch 1, and ends bitwise equal to a straight run (weights,
  BatchNorm statistics, the last three step losses).  ``exact_resume=false``
  and a changed ``train_batch`` replay the epoch; a torn newest checkpoint
  falls back to the older committed one; a stop on an epoch's last batch
  replays that batch; with no earlier run ``resume=auto`` starts fresh.
* ``Predictor.from_run`` of the bf16 run computes in bf16 on float32
  weights, its three logits bitwise equal to the trained model's.
* Warm start: a JAX ``params_to_torch_state_dict`` export imports bit for
  bit and gives the JAX model's logits (within 1e-4 x max(1, max |logit|),
  float32 summation order); a torchvision-named ResNet-18 built key by key
  imports into the backbone with its stem inflated to 4 channels and the
  head left fresh, leaf for leaf what the JAX ``Trainer._warm_start`` makes
  of the same file; a depth mismatch and a file matching nothing raise.
  Step count and optimizer stay fresh.
"""

import json
import os
import shutil
import signal
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.data import pipeline as jax_pipeline
from distributedpytorch_tpu.models import build_model as jax_build_model
from distributedpytorch_tpu.parallel import TrainState as JaxTrainState
from distributedpytorch_tpu.train import checkpoint as jax_checkpoint
from distributedpytorch_tpu.train import config as jax_config
from distributedpytorch_tpu.train.preemption import \
    PreemptionGuard as JaxPreemptionGuard
from distributedpytorch_tpu.train.trainer import Trainer as JaxTrainer
from distributedpytorch_tpu.utils.torch_interop import params_to_torch_state_dict
from distributedpytorch_tpu_torch.data import pipeline
from distributedpytorch_tpu_torch.models import build_model
from distributedpytorch_tpu_torch.predict import Predictor
from distributedpytorch_tpu_torch.train import checkpoint, config
from distributedpytorch_tpu_torch.train.preemption import PreemptionGuard
from distributedpytorch_tpu_torch.train.trainer import Trainer
from distributedpytorch_tpu_torch.utils.weights import state_dict_to_jax
from test_torch_port_model import randomize

GUARDS = {"port": PreemptionGuard, "jax": JaxPreemptionGuard}


@pytest.mark.parametrize("impl", sorted(GUARDS))
class TestPreemptionGuard:
    def test_signal_sets_flag_and_handlers_restored(self, impl):
        before = signal.getsignal(signal.SIGTERM)
        with GUARDS[impl]() as guard:
            assert not guard.triggered
            signal.raise_signal(signal.SIGTERM)
            assert guard.triggered and guard.should_stop()
            assert guard.signals_received == 1
        assert signal.getsignal(signal.SIGTERM) == before

    def test_trip_and_cadence(self, impl):
        guard = GUARDS[impl](check_every=4)
        assert not guard.should_stop(4)
        guard.trip()
        assert guard.triggered
        assert [guard.should_stop(s) for s in (5, 6, 7, 8)] == \
            [False, False, False, True]
        assert guard.should_stop()

    def test_shield_absorbs_then_second_sigint_escalates(self, impl):
        with GUARDS[impl](signals=(signal.SIGINT,)) as guard:
            signal.raise_signal(signal.SIGINT)
            assert guard.triggered
            with guard.shield():
                signal.raise_signal(signal.SIGINT)  # absorbed
            with pytest.raises(KeyboardInterrupt):
                signal.raise_signal(signal.SIGINT)


class Toy:
    """Samples that record their index and draw from their RNG."""

    def __len__(self):
        return 11

    def __getitem__(self, index, rng=None):
        return {"x": np.array([index, rng.random()], np.float64)}


@pytest.mark.parametrize("workers", [0, 2])
def test_start_batch_yields_the_tail_as_jax(workers):
    kw = dict(batch_size=2, shuffle=True, drop_last=True, seed=3,
              num_workers=workers)
    port, ref = pipeline.DataLoader(Toy(), **kw), jax_pipeline.DataLoader(Toy(), **kw)
    port.set_epoch(1)
    full = [b["x"] for b in port]
    port.set_epoch(1, start_batch=2)
    ref.set_epoch(1, start_batch=2)
    tail, want = [b["x"] for b in port], [b["x"] for b in ref]
    assert len(port) == len(full) == 5 and len(tail) == 3
    for a, b, c in zip(tail, full[2:], want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    port.set_epoch(1)
    assert len(list(port)) == 5


def test_run_dirs(tmp_path):
    work = str(tmp_path)
    assert checkpoint.latest_checkpoint_dir(work) is None
    for want in (0, 1):
        got = checkpoint.next_run_dir(work)
        assert got.endswith(f"run_{want}") and os.path.isdir(got)
    assert jax_checkpoint.next_run_index(work) == 2
    assert checkpoint.next_run_dir(work, resume_run=0).endswith("run_0")
    # run_0 gets a committed step, run_1 stays empty
    mgr = checkpoint.CheckpointManager(os.path.join(work, "run_0", "checkpoints"))
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    state = types.SimpleNamespace(model=model, optimizer=opt, step=3,
                                  generator=torch.Generator())
    mgr.save(3, state, extra={"epoch": 0})
    found = checkpoint.latest_checkpoint_dir(work)
    assert found == os.path.join(work, "run_0", "checkpoints")
    assert checkpoint.latest_checkpoint_dir(
        work, exclude_run=os.path.join(work, "run_0")) is None


#: the tiny bf16 run: 11 train objects at train batch 2 -> 5 steps/epoch
TINY = ["data.fake=true", "model.backbone=resnet18", "data.crop_size=[32,32]",
        "data.relax=10", "data.area_thres=0", "data.train_batch=2",
        "data.val_batch=8", "data.num_workers=0", "epochs=2",
        "log_every_steps=100",
        "train.precision=bfloat16", "checkpoint.preempt_check_every=1",
        "optim.lr=1e-3"]


def tiny(work, *extra) -> config.Config:
    return config.apply_overrides(config.Config(),
                                  TINY + [f"work_dir={work}", *extra])


class StopAt(PreemptionGuard):
    """A guard that trips itself once the step count reaches ``at``."""

    def __init__(self, at: int):
        super().__init__(check_every=1)
        self.at = at

    def should_stop(self, step=None):
        if step is not None and step >= self.at:
            self.trip()
        return super().should_stop(step)


def fit(cfg, guard=None):
    trainer = Trainer(cfg, device="cpu")
    if guard is None:
        trainer.fit()
    else:
        with guard:
            trainer.fit(guard=guard)
    trainer.close()
    return trainer


def epoch_records(trainer) -> list[dict]:
    with open(os.path.join(trainer.run_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "train/step_losses" in r]


def snapshot(trainer) -> dict:
    st = trainer.state
    return {"model": {k: v.clone() for k, v in st.model.state_dict().items()},
            "momentum": {n: st.optimizer.state[p]["momentum_buffer"].clone()
                         for n, p in st.model.named_parameters()},
            "step": st.step, "generator": st.generator.get_state()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A straight run, a run stopped at step 7 (epoch 1, 2 batches in) and
    its ``resume=auto`` continuation, with the continuation's state right
    after the restore."""
    straight = fit(tiny(tmp_path_factory.mktemp("straight")))
    work = str(tmp_path_factory.mktemp("preempted"))
    stopped = fit(tiny(work), StopAt(7))
    resumed = Trainer(tiny(work, "resume=auto"), device="cpu")
    restored = snapshot(resumed)
    restored["best_metric"] = resumed.ckpt.best_metric
    resumed.fit()
    resumed.close()
    return types.SimpleNamespace(straight=straight, stopped=stopped,
                                 resumed=resumed, restored=restored,
                                 stopped_state=snapshot(stopped))


def test_preempted_fit_saves_its_position(runs):
    tr = runs.stopped
    with open(os.path.join(tr.run_dir, "fit_summary.json")) as f:
        summary = json.load(f)
    assert summary["preempted"] and not summary["completed"]
    assert summary["final_step"] == tr.state.step == 7
    payload, meta = tr.ckpt.load()
    assert tr.ckpt.committed_steps() == [5, 7]
    assert meta["step"] == 7 and meta["epoch"] == 0
    assert meta["interrupted_epoch"] == 1 and meta["epoch_steps_done"] == 2
    assert (meta["train_batch"], meta["seed"], meta["echo"]) == (2, 0, 1)
    assert payload["step"] == 7


def test_resume_restores_the_exact_state(runs):
    got, want = runs.restored, runs.stopped_state
    assert got["step"] == want["step"] == 7
    for part in ("model", "momentum"):
        assert got[part].keys() == want[part].keys()
        for k, v in want[part].items():
            assert torch.equal(got[part][k], v), k
    assert torch.equal(got["generator"], want["generator"])
    tr = runs.resumed
    assert tr.resume_meta["interrupted_epoch"] == 1
    assert tr.start_epoch == 1 and tr.resume_fallback_steps == []
    assert tr.run_dir != runs.stopped.run_dir
    assert got["best_metric"] == runs.stopped.ckpt.best_metric > 0


def test_resumed_run_equals_straight_run(runs):
    a, b = runs.resumed, runs.straight
    assert a.state.step == b.state.step == 10
    for k, v in b.model.state_dict().items():
        assert torch.equal(a.model.state_dict()[k], v), k
    resumed_epoch, = epoch_records(a)
    assert resumed_epoch["train/resumed_at_batch"] == 2
    assert resumed_epoch["train/step_losses"] == \
        epoch_records(b)[1]["train/step_losses"][2:]
    with open(os.path.join(a.run_dir, "fit_summary.json")) as f:
        summary = json.load(f)
    assert (summary["start_step"], summary["final_step"]) == (7, 10)
    assert summary["resumed_from_step"] == 7 and summary["completed"]


def test_resume_auto_without_runs_starts_fresh(tmp_path, capsys):
    tr = Trainer(tiny(tmp_path, "resume=auto"), device="cpu")
    assert (tr.start_epoch, tr.state.step, tr.resume_meta) == (0, 0, {})
    assert "starting fresh" in capsys.readouterr().out


@pytest.mark.parametrize("extra,replay", [
    ("checkpoint.exact_resume=false", True),
    ("data.train_batch=1", True),
    ("seed=0", False),
])
def test_exact_resume_or_replay(runs, tmp_path, extra, replay):
    src = os.path.join(runs.stopped.run_dir, "checkpoints")
    tr = Trainer(tiny(tmp_path, f"resume={src}", extra), device="cpu")
    assert tr.state.step == 7 and tr.start_epoch == 1
    assert tr._resume_start_batch == (0 if replay else 2)


def test_torn_latest_falls_back_to_older_committed(runs, tmp_path):
    src = str(tmp_path / "checkpoints")
    shutil.copytree(os.path.join(runs.stopped.run_dir, "checkpoints"), src)
    with open(os.path.join(src, "latest", "7", "state.pt"), "r+b") as f:
        f.truncate(100)
    tr = Trainer(tiny(tmp_path / "w", f"resume={src}"), device="cpu")
    assert tr.resume_fallback_steps == [7]
    assert tr.state.step == 5 and tr.start_epoch == 1
    assert tr._resume_start_batch == 0
    # a pinned step does not fall back
    with pytest.raises(Exception):
        checkpoint.CheckpointManager(src).restore(tr.state, step=7)


def test_stop_on_last_batch_replays_it(tmp_path):
    stopped = fit(tiny(tmp_path, "epochs=1"), StopAt(5))
    _, meta = stopped.ckpt.load()
    assert (meta["interrupted_epoch"], meta["epoch_steps_done"]) == (0, 5)
    src = os.path.join(stopped.run_dir, "checkpoints")
    tr = Trainer(tiny(tmp_path, "epochs=1", f"resume={src}"), device="cpu")
    assert (tr.start_epoch, tr._resume_start_batch) == (0, 4)


def test_predictor_serves_the_bf16_run(runs):
    tr = runs.resumed
    pred = Predictor.from_run(tr.run_dir, step=tr.state.step, device="cpu")
    assert pred.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in pred.model.parameters())
    x = torch.rand(2, 4, 32, 32) * 255
    with torch.no_grad():
        got = pred.model(x)
        want = tr.model.eval()(x)
    assert all(g.dtype == torch.bfloat16 for g in got)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _chip_smoke():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_rules", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_resume_rule_refuses_a_wrong_batch(runs, tmp_path):
    """``chip_smoke.py``'s resumed-vs-straight rule (6f and dist (c): per
    tensor against the movement or the straight runs' spread, and the
    whole model's L2) passes the exact resume and refuses one that lands
    one batch early (batch 1 of epoch 1 trained twice).  On the CPU the
    straight runs are bitwise repeatable, so their spread is 0."""
    rules = _chip_smoke()
    src = os.path.join(runs.stopped.run_dir, "checkpoints")
    wrong = Trainer(tiny(tmp_path / "wrong", f"resume={src}"), device="cpu")
    assert wrong._resume_start_batch == 2
    wrong._resume_start_batch = 1
    wrong.fit()
    wrong.close()
    init = Trainer(tiny(tmp_path / "init"), device="cpu").model.state_dict()
    straight = runs.straight.model.state_dict()
    ok, rows, _ = rules.resume_check(torch, init, [straight] * 3,
                                     runs.resumed.model.state_dict(), tag="cpu")
    assert ok == [] and all(d == 0.0 for _, d, _ in rows)
    bad, _, l2 = rules.resume_check(torch, init, [straight] * 3,
                                    wrong.model.state_dict(), tag="cpu")
    assert any(f.startswith("L2 distance") for f in bad)
    assert l2["resumed"] > rules.RESUME_L2_TOL * l2["moved"] and l2["spread"] == 0


@pytest.fixture(scope="module")
def jax_export(tmp_path_factory):
    """A JAX DANet-R18's randomized variables and their torch export."""
    model = jax_build_model("danet", nclass=1, backbone="resnet18",
                            output_stride=8, attention_impl="xla")
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 4)), train=False))
    variables = randomize(shapes, seed=3)
    sd = params_to_torch_state_dict(variables["params"],
                                    variables["batch_stats"])
    path = str(tmp_path_factory.mktemp("export") / "jax_export.pth")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, path)
    return model, variables, sd, path


def test_warm_start_from_jax_export(jax_export, tmp_path):
    jmodel, variables, sd, path = jax_export
    tr = Trainer(tiny(tmp_path, "train.precision=float32",
                      f"checkpoint.warm_start={path}"), device="cpu")
    state = tr.model.state_dict()
    assert set(sd) == {k for k in state if not k.endswith("num_batches_tracked")}
    for k, v in sd.items():
        np.testing.assert_array_equal(state[k].numpy(), v)
    assert tr.state.step == 0 and not tr.state.optimizer.state
    x = np.random.default_rng(4).uniform(0, 255, (2, 64, 64, 4)).astype(np.float32)
    ref = jmodel.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tr.model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, r in zip(got, ref):
        r = np.asarray(r)[..., 0]
        assert np.abs(g[:, 0].numpy() - r).max() <= 1e-4 * max(1.0, np.abs(r).max())


def torchvision_resnet18(seed: int = 0) -> dict:
    """A torchvision-named ResNet-18 state_dict with random values."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(key, cout, cin, k):
        sd[key] = rng.normal(size=(cout, cin, k, k)).astype(np.float32) * 0.1

    def bn(prefix, c):
        sd[f"{prefix}.weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[f"{prefix}.bias"] = rng.normal(size=c).astype(np.float32) * 0.1
        sd[f"{prefix}.running_mean"] = rng.normal(size=c).astype(np.float32) * 0.1
        sd[f"{prefix}.running_var"] = rng.uniform(0.5, 2, c).astype(np.float32)
        sd[f"{prefix}.num_batches_tracked"] = np.array(7)

    conv("conv1.weight", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for stage, c in enumerate((64, 128, 256, 512), start=1):
        for i in range(2):
            pre = f"layer{stage}.{i}"
            conv(f"{pre}.conv1.weight", c, cin, 3)
            bn(f"{pre}.bn1", c)
            conv(f"{pre}.conv2.weight", c, c, 3)
            bn(f"{pre}.bn2", c)
            if i == 0 and stage > 1:
                conv(f"{pre}.downsample.0.weight", c, cin, 1)
                bn(f"{pre}.downsample.1", c)
            cin = c
    sd["fc.weight"] = rng.normal(size=(1000, 512)).astype(np.float32)
    sd["fc.bias"] = np.zeros(1000, np.float32)
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def test_warm_start_torchvision_as_jax(tmp_path):
    path = str(tmp_path / "resnet18.pth")
    sd = torchvision_resnet18()
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, path)
    cfg = tiny(tmp_path, "train.precision=float32")
    fresh = Trainer(cfg, device="cpu").model.state_dict()
    tr = Trainer(config.apply_overrides(cfg, [f"checkpoint.warm_start={path}"]),
                 device="cpu")
    got = tr.model.state_dict()
    stem = got["backbone.Conv_0.weight"]
    assert stem.shape[1] == 4 and not stem[:, 3].any()
    assert torch.equal(stem[:, :3], sd["conv1.weight"])
    assert torch.equal(got["backbone.BasicBlock_2.Conv_2.weight"],
                       sd["layer2.0.downsample.0.weight"])
    for k, v in got.items():
        if k.startswith("head."):
            assert torch.equal(v, fresh[k]), k
    # the JAX package's _warm_start on the same file, from the same fresh
    # weights
    params, stats = state_dict_to_jax(fresh)
    jcfg = jax_config.apply_overrides(jax_config.Config(),
                                      ["model.backbone=resnet18"])
    jself = types.SimpleNamespace(cfg=jcfg, is_main=False, state=JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=jax.tree.map(jnp.asarray, params),
        batch_stats=jax.tree.map(jnp.asarray, stats), opt_state=(),
        rng=jax.random.PRNGKey(0)))
    JaxTrainer._warm_start(jself, path, False)
    got_params, got_stats = state_dict_to_jax(got)
    for got_tree, want_tree in ((got_params, jself.state.params),
                                (got_stats, jself.state.batch_stats)):
        got_flat = jax.tree_util.tree_leaves_with_path(got_tree)
        want_flat = jax.tree_util.tree_leaves_with_path(want_tree)
        assert [p for p, _ in got_flat] == [p for p, _ in want_flat]
        for (path_, g), (_, w) in zip(got_flat, want_flat):
            np.testing.assert_array_equal(g, np.asarray(w),
                                          jax.tree_util.keystr(path_))


def test_warm_start_refusals(tmp_path):
    path = str(tmp_path / "resnet18.pth")
    torch.save(torchvision_resnet18(), path)
    with pytest.raises(ValueError, match="resnet18 checkpoint"):
        Trainer(tiny(tmp_path, "model.backbone=resnet34",
                     f"checkpoint.warm_start={path}"), device="cpu")
    other = str(tmp_path / "other.pth")
    torch.save({"encoder.weight": torch.zeros(3)}, other)
    with pytest.raises(ValueError, match="imported 0"):
        Trainer(tiny(tmp_path, f"checkpoint.warm_start={other}",
                     "checkpoint.warm_start_partial=true"), device="cpu")
    with pytest.raises(KeyError):
        Trainer(tiny(tmp_path, f"checkpoint.warm_start={other}"), device="cpu")
