"""The port's feed governor against the JAX package's, on the CPU.

The same seeded sequence of (busy, wait) ticks, across epoch boundaries,
goes through both packages' ``FeedGovernor`` in ``observe`` mode with the
same stub actuators and one injected clock: ``governor.jsonl`` must hold
the same lines, and ``summary_block()``, ``feed_block()``, the decisions
and the registry's action counters must be equal.  The port's trainer
adapter answers the rung-2 flip eligibility and the rung-0 pack status as
the JAX trainer does for the same config; ``observe`` calls no setter;
``data.governor=auto`` and ``data.echo`` stay refused by name."""

import dataclasses
import json
import types

import numpy as np
import pytest

from distributedpytorch_tpu.data import governor as jax_governor
from distributedpytorch_tpu.telemetry import get_registry as jax_get_registry
from distributedpytorch_tpu.train import Trainer as JaxTrainer
from distributedpytorch_tpu.train import config as jax_config
from distributedpytorch_tpu_torch.data import governor
from distributedpytorch_tpu_torch.telemetry import get_registry
from distributedpytorch_tpu_torch.train import config
from distributedpytorch_tpu_torch.train.trainer import (
    Trainer,
    _TrainerFeedActuators,
)


class _Stub:
    """Duck-typed actuators: the values the governor reads; any setter
    call is recorded (observe must make none)."""

    def __init__(self, packed=False, flip=(True, "move flip augmentation "
                                                 "on device"), can_echo=True):
        self.calls = []
        self._packed, self._flip, self._can = packed, flip, can_echo

    def get_prefetch(self):
        return 2, 2

    def set_prefetch(self, host, device):
        self.calls.append(("set_prefetch", host, device))

    def flip_available(self):
        return self._flip

    def flip_device_path(self):
        self.calls.append(("flip",))

    def get_echo(self):
        return 1

    def base_echo(self):
        return 1

    def can_set_echo(self):
        return (True, "") if self._can else (False, "steps_per_dispatch > 1")

    def set_echo(self, factor):
        self.calls.append(("set_echo", factor))

    def pack_status(self):
        return self._packed, (None if self._packed else "dptpu-pack ...")


def _ticks(seed: int):
    """Per epoch, per tick: (busy_s, wait_s) — a stall, a calm epoch, a
    stall again, then calm, with seeded noise."""
    rng = np.random.default_rng(seed)
    stall = (0.45, 0.02, 0.6, 0.01)
    return [[(float(rng.uniform(0.8, 1.2)),
              float(max(0.0, rng.normal(level, 0.03))))
             for _ in range(9)] for level in stall]


def _drive(mod, path, stub, seed, **kw):
    gov = mod.FeedGovernor("observe", 0.1, stub, max_echo=4,
                           window=None, jsonl_path=str(path),
                           clock=lambda: 1234.5, **kw)
    step = 0
    for epoch, ticks in enumerate(_ticks(seed)):
        for busy, wait in ticks:
            step += 1
            gov.tick(busy, wait, step=step, epoch=epoch)
        gov.epoch_boundary(epoch=epoch, step=step)
    return gov


def _actions(reg) -> dict:
    return {c.labels: c.value for f in reg.collect()
            if f.name == "train_governor_actions_total" for c in f.children()}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("stub_kw", [
    {}, {"packed": True}, {"flip": (False, "grain loader builds its "
                                           "pipeline up front")},
    {"can_echo": False}], ids=["fs", "packed", "no_flip", "no_echo"])
def test_observe_ladder_matches_jax(tmp_path, seed, stub_kw, capsys):
    before, jbefore = _actions(get_registry()), _actions(jax_get_registry())
    ours, theirs = _Stub(**stub_kw), _Stub(**stub_kw)
    gov = _drive(governor, tmp_path / "port.jsonl", ours, seed)
    shout = capsys.readouterr().err
    jgov = _drive(jax_governor, tmp_path / "jax.jsonl", theirs, seed)
    assert shout == capsys.readouterr().err  # the same loud shortfall
    lines = (tmp_path / "port.jsonl").read_text().splitlines()
    assert lines == (tmp_path / "jax.jsonl").read_text().splitlines()
    assert lines, "the seeded stalls must make the ladder decide"
    assert [json.loads(x)["applied"] for x in lines] == [False] * len(lines)
    assert gov.decisions == jgov.decisions
    assert gov.summary_block() == jgov.summary_block()
    assert gov.summary_block()["mode"] == "observe"
    report = {"buckets": {"step": 3.0, "compile": 1.0, "input_wait": 0.5}}
    assert governor.feed_block(report, "observe", 1) == \
        jax_governor.feed_block(report, "observe", 1)
    assert governor.feed_block(None) == jax_governor.feed_block(None)
    # nothing actuated: no setter called, the knobs as configured
    assert ours.calls == theirs.calls == []
    grew = {k: v - before.get(k, 0.0) for k, v in _actions(get_registry()).items()}
    jgrew = {k: v - jbefore.get(k, 0.0)
             for k, v in _actions(jax_get_registry()).items()}
    assert {k: v for k, v in grew.items() if v} == \
        {k: v for k, v in jgrew.items() if v}


def test_consensus_reduces_like_jax(tmp_path, monkeypatch):
    """Under ``consensus`` the stall goes through the module seam: with a
    simulated most-starved peer host, both ladders act on the max."""
    for mod in (governor, jax_governor):
        monkeypatch.setattr(mod, "governor_consensus",
                            lambda v, reduce, label: max(v, 0.5)
                            if reduce == "max" else v)
    gov = _drive(governor, tmp_path / "p.jsonl", _Stub(), 0, consensus=True)
    jgov = _drive(jax_governor, tmp_path / "j.jsonl", _Stub(), 0,
                  consensus=True)
    assert gov.decisions == jgov.decisions
    assert {d["stall"] for d in gov.decisions} == {0.5}
    # the real seam, single process: the identity
    monkeypatch.undo()
    assert governor.governor_consensus(0.25, "max", "t") == 0.25


def test_echo_factor_matches_jax():
    for stall in np.linspace(-0.1, 1.1, 25):
        for cur in (1, 2, 3):
            for target in (None, 0.05, 0.1, 0.3):
                args = (float(stall), 4, cur, target)
                assert governor.echo_factor(*args) == \
                    jax_governor.echo_factor(*args)


CONFIGS = [
    [],
    ["data.loader=grain"],
    ["data.guidance=none"],
    ["task=semantic", "model.name=deeplabv3", "model.nclass=21"],
    ["data.prepared_cache=/tmp/x"],
    ["data.device_augment=true", "data.device_guidance=true"],
    ["data.guidance=no_such_family"],
]


@pytest.mark.parametrize("overrides", CONFIGS, ids=lambda o: ",".join(o) or "default")
def test_flip_and_pack_answers_match_jax_trainer(overrides):
    cfg = config.apply_overrides(config.Config(),
                                 overrides + ["data.root=/data/voc"])
    jcfg = jax_config.apply_overrides(jax_config.Config(),
                                      overrides + ["data.root=/data/voc"])
    ours = types.SimpleNamespace(cfg=cfg, _feed_flipped=False)
    theirs = types.SimpleNamespace(cfg=jcfg, _feed_flipped=False,
                                   _data_root="/data/voc")
    assert Trainer._feed_flip_available(ours) == \
        JaxTrainer._feed_flip_available(theirs)
    assert Trainer._pack_status(ours) == JaxTrainer._pack_status(theirs)
    ours._feed_flipped = theirs._feed_flipped = True
    assert Trainer._feed_flip_available(ours) == \
        JaxTrainer._feed_flip_available(theirs)


def test_trainer_adapter_observes_only():
    cfg = config.Config()
    fake = types.SimpleNamespace(
        cfg=cfg, _host_prefetch=2, _device_prefetch=2, _echo=1,
        _feed_flip_available=lambda: (True, "x"),
        _pack_status=lambda: (False, "y"))
    act = _TrainerFeedActuators(fake)
    assert act.get_prefetch() == (2, 2) and act.get_echo() == 1
    assert act.base_echo() == cfg.data.echo and act.can_set_echo() == (True, "")
    for setter, args in ((act.set_prefetch, (4, 4)), (act.set_echo, (2,)),
                         (act.flip_device_path, ())):
        with pytest.raises(NotImplementedError):
            setter(*args)


def test_governor_knobs_ported_auto_and_echo_refused():
    base = config.Config()
    for ok in (["data.governor=off"], ["data.governor=observe"],
               ["data.governor_target=0.2", "data.governor_window=8",
                "data.max_echo=2"]):
        assert config.unported_knobs(config.apply_overrides(base, ok)) == []
    assert config.unported_knobs(config.apply_overrides(
        base, ["data.governor=auto"])) == ["data.governor='auto'"]
    assert config.unported_knobs(config.apply_overrides(
        base, ["data.echo=2"])) == ["data.echo=2"]
    assert dataclasses.asdict(base.data)["governor"] == "observe"
    assert base.telemetry is True
