"""Fit-level telemetry parity (C4): the port's default fit writes what the
JAX fit writes.

Both trainers read the JAX package's on-disk fake VOC tree (ResNet-18 at
64², train batch 4, 1 epoch of 2 steps, one validation; the JAX trainer on
the conftest mesh as 4 data x 2 model devices, the port on the CPU), with
``telemetry`` and
``data.governor`` at their defaults, under one seeded latency fault at
``trainer/batch_fetch`` (each package's own plan module, the same plan).
They must agree on:

* the key sets of ``history["goodput"]`` (and its buckets and counts),
  ``history["mfu"]`` and ``history["feed"]``; ``fit_summary.json`` holds
  every JAX key (``recovery`` null, ``feed`` the governor's block) plus the
  port's own (:data:`PORT_ONLY`);
* the ``(source, kind)`` sequence of the flight recorder, chaos firings
  included;
* the ``goodput/*`` and ``mfu*`` scalar names in ``metrics.jsonl``;
* the fault: ``input_wait`` at least 0.9 x delay x firings in both.

With ``telemetry=false`` neither writes an events file or
``governor.jsonl``, and both summaries carry ``recovery`` and ``feed`` as
null.  The model FLOPs: the port's ``FlopCounterMode`` count of the global
step against XLA's cost analysis of the JAX step (``xla_step_cost``, the
per-device program of one sample, times the 4 data-parallel devices):
ratio 1.66 here.  The counter counts 2 FLOPs per multiply-add of the
matrix products and convolutions only; XLA's CPU cost model gives this
network's forward 0.58x the counter's count (0.995e9 against 1.707e9 at
B = 1), the forward + backward 0.58x too, though it also counts the
elementwise work.  So the port's count must lie in [1.5, 1.9] x XLA's: a
count that loses the backward (about 1/3) or the attention falls out of
it.  The overlapped validation books
its ``eval`` bucket on its own thread, as the JAX trainer's
``_eval_metrics`` does on its ``val_overlap`` thread."""

import json
import os
import threading

import pytest
import torch

from distributedpytorch_tpu.chaos import faults as jax_faults
from distributedpytorch_tpu.chaos import sites as jax_sites
from distributedpytorch_tpu.data.fake import make_fake_voc
from distributedpytorch_tpu import telemetry as jax_telemetry
from distributedpytorch_tpu.train import Trainer as JaxTrainer
from distributedpytorch_tpu.train import config as jax_config
from distributedpytorch_tpu_torch.chaos import faults, sites
from distributedpytorch_tpu_torch import telemetry
from distributedpytorch_tpu_torch.telemetry import events, goodput
from distributedpytorch_tpu_torch.train import config
from distributedpytorch_tpu_torch.train.trainer import Trainer

COMMON = ["model.backbone=resnet18", "data.crop_size=[64,64]",
          "data.train_batch=4", "data.val_batch=1", "data.num_workers=0",
          "log_every_steps=1", "seed=0", "checkpoint.keep_latest=1",
          "data.relax=10", "data.area_thres=0", "epochs=1",
          'log_writers=["jsonl"]']
DELAY = 0.1
PLAN = {"name": "slow_feed", "seed": 0, "faults": [
    {"site": "trainer/batch_fetch", "kind": "latency", "delay_s": DELAY}]}
#: what the port's summary adds to the JAX keys: its resume origin, the
#: device and group, the precision block and the kernels' launch counts
PORT_ONLY = {"start_step", "resumed_from_step", "device", "world_size",
             "final_step_by_rank", "precision", "kernel_launches"}


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _jax_fit(root, work, *extra, plan=None):
    cfg = jax_config.apply_overrides(jax_config.Config(), COMMON + [
        f"data.root={root}", "mesh.data=4", "mesh.model=2",
        "checkpoint.async_save=false", f"work_dir={work}", *extra])
    tr = JaxTrainer(cfg)
    try:
        if plan is None:
            hist = tr.fit()
        else:
            with jax_sites.armed_plan(jax_faults.FaultPlan.from_dict(plan)):
                hist = tr.fit()
    finally:
        tr.close()
    return tr.run_dir, hist


def _port_fit(root, work, *extra, plan=None):
    cfg = config.apply_overrides(config.Config(), COMMON + [
        f"data.root={root}", f"work_dir={work}", *extra])
    tr = Trainer(cfg, device="cpu")
    try:
        if plan is None:
            hist = tr.fit()
        else:
            with sites.armed_plan(faults.FaultPlan.from_dict(plan)):
                hist = tr.fit()
    finally:
        tr.close()
    return tr.run_dir, hist


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc"))
    make_fake_voc(root, n_images=8, size=(96, 128), n_val=3, seed=0)
    work = tmp_path_factory.mktemp("runs")
    try:
        return {
            "jax": _jax_fit(root, work / "jax", plan=PLAN),
            "jax_off": _jax_fit(root, work / "jax_off", "telemetry=false"),
            "port": _port_fit(root, work / "port", plan=PLAN),
            "port_off": _port_fit(root, work / "port_off", "telemetry=false"),
        }
    finally:
        # a telemetry=false fit switches the process-wide flags off (in
        # both packages, by design); later tests in this process want them
        for mod in (jax_telemetry, telemetry):
            mod.set_enabled(True)
            mod.get_accountant().reset(enabled=True)


def _summary(run_dir) -> dict:
    with open(os.path.join(run_dir, "fit_summary.json")) as f:
        return json.load(f)


def _events(run_dir) -> list[tuple[str, str]]:
    (name,) = os.listdir(os.path.join(run_dir, "events"))
    return [(r["source"], r["kind"]) for r in events.read_events_file(
        os.path.join(run_dir, "events", name))]


def _scalar_names(run_dir) -> set[str]:
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        names = {k for line in f if line.strip() for k in json.loads(line)}
    return {k for k in names if k.startswith(("goodput/", "mfu"))}


def test_history_and_summary_keys_match_jax(fits):
    (jrun, jhist), (run, hist) = fits["jax"], fits["port"]
    for key in ("goodput", "mfu", "feed"):
        assert set(hist[key]) == set(jhist[key]), key
    for key in ("buckets", "counts"):
        assert set(hist["goodput"][key]) == set(jhist["goodput"][key])
    assert hist["recovery"] is None and jhist["recovery"] is None
    summary, jsummary = _summary(run), _summary(jrun)
    assert set(jsummary) <= set(summary)
    assert set(summary) - set(jsummary) == PORT_ONLY
    assert summary["recovery"] is None
    assert summary["feed"] == hist["feed"]
    assert set(summary["feed"]) == set(jsummary["feed"])
    assert summary["feed"]["mode"] == jsummary["feed"]["mode"] == "observe"
    assert hist["mfu"]["flops_source"] == "flop_counter"
    assert hist["mfu"]["peak_source"] == "fallback"  # the CPU
    gp = hist["goodput"]
    assert all(v >= 0 for v in gp["buckets"].values())
    assert sum(gp["buckets"].values()) == pytest.approx(gp["total_s"])
    assert gp["counts"]["compile"] == jhist["goodput"]["counts"]["compile"]


def test_event_sequence_matches_jax(fits):
    seq = _events(fits["port"][0])
    assert seq == _events(fits["jax"][0])
    assert seq[0] == ("trainer", "fit_start") and seq[-1] == ("trainer", "fit_end")
    assert ("checkpoint", "commit") in seq and ("chaos", "latency") in seq
    log = events.read_events_file(os.path.join(
        fits["port"][0], "events", os.listdir(
            os.path.join(fits["port"][0], "events"))[0]))
    assert log[-1]["payload"]["goodput"]["buckets"] == \
        fits["port"][1]["goodput"]["buckets"]


def test_goodput_scalar_names_match_jax(fits):
    names = _scalar_names(fits["port"][0])
    assert names == _scalar_names(fits["jax"][0])
    assert "goodput/input_wait_s" in names and "mfu" in names


def test_telemetry_off_writes_nothing_in_both(fits):
    for key in ("jax_off", "port_off"):
        run, hist = fits[key]
        assert not os.path.exists(os.path.join(run, "events")), key
        assert not os.path.exists(os.path.join(run, "governor.jsonl")), key
        summary = _summary(run)
        assert summary["recovery"] is None and summary["feed"] is None, key
        assert "goodput" not in hist and "mfu" not in hist
        assert not _scalar_names(run)


def test_latency_fault_raises_input_wait_in_both(fits):
    for key in ("jax", "port"):
        gp = fits[key][1]["goodput"]
        fetches = 2  # two batches, each fetch visited the site
        assert gp["buckets"]["input_wait"] >= 0.9 * DELAY * fetches, key


def _flops_scalar(run_dir) -> float:
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        (value,) = [r["mfu/flops_per_step"] for r in map(json.loads, f)
                    if "mfu/flops_per_step" in r]
    return value


def test_flop_count_against_xla(fits):
    ours = _flops_scalar(fits["port"][0])
    xla = _flops_scalar(fits["jax"][0]) * 4  # per device x data parallel
    assert fits["jax"][1]["mfu"]["flops_source"] == "xla_cost_analysis"
    assert ours == fits["port"][1]["mfu"]["flops_per_step"]  # world 1
    print(f"port FlopCounterMode {ours:.4e}, XLA {xla:.4e}, "
          f"ratio {ours / xla:.4f}")
    assert 1.5 <= ours / xla <= 1.9


def test_overlapped_validation_books_eval_on_its_thread(tmp_path,
                                                        monkeypatch):
    make_fake_voc(str(tmp_path / "voc"), n_images=8, size=(96, 128),
                  n_val=3, seed=0)
    acct = goodput.get_accountant()
    seen = []
    real = acct.account

    def account(bucket):
        if bucket == "eval":
            seen.append(threading.current_thread().name)
        return real(bucket)

    monkeypatch.setattr(acct, "account", account)
    _, hist = _port_fit(str(tmp_path / "voc"), tmp_path / "w", "epochs=2",
                        "val_overlap=true")
    assert seen == ["val-overlap-0", "val-overlap-1"]
    assert hist["goodput"]["counts"]["eval"] == 2
    assert hist["goodput"]["buckets"]["eval"] > 0
    assert len(hist["val"]) == 2


def _span_paths(reg) -> set[str]:
    return {c.labels[0][1] for f in reg.collect() if f.name == "span_seconds"
            for c in f.children()}


def test_fits_record_the_jax_spans(fits):
    """The spans sit where the JAX package puts them: both fits of this
    module recorded the evaluation and checkpoint spans by the same
    paths."""
    want = {"eval/dispatch", "eval/pasteback", "checkpoint/save",
            "checkpoint/wait"}
    assert want <= _span_paths(telemetry.get_registry())
    assert want <= _span_paths(jax_telemetry.get_registry())
