"""The port's telemetry and chaos core against the JAX package's, on the
CPU: the same operations, drawn from a numpy seed, go through both
packages' modules and give the same results.

* the registry and ``render_text``: byte-identical Prometheus text;
* nested spans: the same ``span_seconds`` label set, nothing when
  telemetry is off;
* the goodput accountant under one scripted ``perf_counter``: equal
  ``snapshot()`` and ``report()`` (and the gauges it publishes);
* the event log: the same lines once ``ts_wall``, ``ts_mono``, ``host``
  and ``pid`` are dropped, non-finite floats written as null;
* fault plans: the same parse and the same fired sequence of a seeded
  plan; the port's NaN poisoning of torch tensors;
* ``ServeMetrics``: the same text for the same operations;
* ``mfu_estimate``: the JAX formula and keys over the H100 table, the
  fallback for an unknown device;
* ``step_flops``: one DANet-R18 step at 64 px counts the same through
  the kernel route and the plain route (the count always takes the plain
  forms on a meta copy; the kernels are invisible to the counter);
* the on-demand trace: a bounded CPU capture, and a start refused and
  counted while another ``torch.profiler`` runs;
* the HTTP fronts under an ``error`` fault at ``serve/enqueue``: the
  request's connection closes unanswered on both, and the next request is
  served; ``GET /metrics`` parses as Prometheus text.

Every module here runs with 2 intra-op threads (see
``test_torch_port_observe.py``)."""

import http.client
import json
import math
import os
import threading
import time
import urllib.request
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from distributedpytorch_tpu.chaos import faults as jax_faults
from distributedpytorch_tpu.chaos import sites as jax_sites
from distributedpytorch_tpu.serve import metrics as jax_serve_metrics
from distributedpytorch_tpu.telemetry import events as jax_events
from distributedpytorch_tpu.telemetry import goodput as jax_goodput
from distributedpytorch_tpu.telemetry import prometheus as jax_prometheus
from distributedpytorch_tpu.telemetry import registry as jax_registry
from distributedpytorch_tpu.telemetry import spans as jax_spans
from distributedpytorch_tpu_torch.chaos import faults, sites
from distributedpytorch_tpu_torch.models import build_model
from distributedpytorch_tpu_torch.predict import Predictor
from distributedpytorch_tpu_torch.serve import metrics as serve_metrics
from distributedpytorch_tpu_torch.serve.__main__ import make_server
from distributedpytorch_tpu_torch.serve.client import encode_array
from distributedpytorch_tpu_torch.serve.service import InferenceService
from distributedpytorch_tpu_torch.telemetry import events, goodput, prometheus
from distributedpytorch_tpu_torch.telemetry import registry, spans
from distributedpytorch_tpu_torch.telemetry.trace import TraceCapture


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _registry_ops(seed: int):
    """A seeded list of registry operations: (kind, name, labels, value)."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(200):
        kind = ["counter", "gauge", "histogram"][rng.integers(3)]
        name = f"{kind}_{rng.integers(3)}"
        labels = {"bucket": str(rng.integers(4)),
                  "note": ['a"b', "c\\d", "e\nf", "plain"][rng.integers(4)]} \
            if rng.random() < 0.5 else None
        value = float(rng.choice([rng.random() * 10, rng.integers(5),
                                  1e20, 1e-7]))
        ops.append((kind, name, labels, value))
    return ops


def _apply(reg, ops):
    for kind, name, labels, value in ops:
        if kind == "counter":
            reg.counter(name, "help for " + name + "\\ \n x", labels).inc(value)
        elif kind == "gauge":
            g = reg.gauge(name, "", labels)
            g.set(value) if value > 1 else g.dec(value)
        else:
            reg.histogram(name, "histogram help", labels,
                          reservoir=64).observe(value)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_renders_byte_identical(seed):
    ops = _registry_ops(seed)
    ours, theirs = registry.MetricsRegistry(), jax_registry.MetricsRegistry()
    _apply(ours, ops)
    _apply(theirs, ops)
    text = prometheus.render_text(ours)
    assert text == jax_prometheus.render_text(theirs)
    assert prometheus.CONTENT_TYPE == jax_prometheus.CONTENT_TYPE
    assert text.count("# TYPE") == len(ours.collect())
    h = ours.histogram("histogram_0", labels=None)
    assert h.snapshot() == theirs.histogram("histogram_0").snapshot()


def test_registry_refuses_as_jax_does():
    for mod in (registry, jax_registry):
        reg = mod.MetricsRegistry()
        reg.counter("x_total")
        with pytest.raises(ValueError):
            reg.gauge("x_total")
        with pytest.raises(ValueError):
            reg.counter("bad name")
        with pytest.raises(ValueError):
            reg.counter("y_total").inc(-1)


def _span_tree(span, reg):
    with span("fit", reg):
        with span("epoch", reg):
            with span("checkpoint", reg):
                pass
            with span("eval", reg):
                pass
        try:
            with span("boom", reg):
                raise RuntimeError
        except RuntimeError:
            pass
        with span("epoch", reg):
            pass


def _span_labels(reg) -> list:
    return [c.labels for f in reg.collect() if f.name == "span_seconds"
            for c in f.children()]


def test_spans_nest_and_switch_off_like_jax():
    registry.set_enabled(True)
    jax_registry.set_enabled(True)
    ours, theirs = registry.MetricsRegistry(), jax_registry.MetricsRegistry()
    _span_tree(spans.span, ours)
    _span_tree(jax_spans.span, theirs)
    assert _span_labels(ours) == _span_labels(theirs)
    assert ("span", "fit/epoch/checkpoint") in \
        [pair for labels in _span_labels(ours) for pair in labels]
    assert spans.current_span() == "" == jax_spans.current_span()
    counts = {c.labels: c.count for f in ours.collect() for c in f.children()}
    assert counts[(("span", "fit/epoch"),)] == 2
    off = registry.MetricsRegistry()
    registry.set_enabled(False)
    try:
        _span_tree(spans.span, off)
    finally:
        registry.set_enabled(True)
    assert off.collect() == []


class _Clock:
    t = 100.0

    def __call__(self):
        return self.t


def _drive_accountant(acct, clock):
    """A seeded script of nested accounts with the clock moved between."""
    rng = np.random.default_rng(3)
    clock.t = 100.0
    acct.reset(enabled=True)
    for _ in range(40):
        outer = goodput.BUCKETS[rng.integers(5)]
        with acct.account(outer):
            clock.t += float(rng.random())
            if rng.random() < 0.5:
                with acct.account(goodput.BUCKETS[rng.integers(5)]):
                    clock.t += float(rng.random())
            clock.t += float(rng.random())
        clock.t += float(rng.random()) * 0.1  # idle
    return acct.snapshot(), acct.report(publish=True)


def test_accountant_matches_jax_under_one_clock(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(time, "perf_counter", clock)
    assert goodput.BUCKETS == jax_goodput.BUCKETS
    ours, theirs = registry.MetricsRegistry(), jax_registry.MetricsRegistry()
    snap, rep = _drive_accountant(goodput.GoodputAccountant(ours), clock)
    jsnap, jrep = _drive_accountant(jax_goodput.GoodputAccountant(theirs),
                                    clock)
    assert snap == jsnap
    assert rep == jrep
    assert math.isclose(sum(rep["buckets"].values()), rep["total_s"])
    assert prometheus.render_text(ours) == jax_prometheus.render_text(theirs)
    acct = goodput.GoodputAccountant(ours)
    acct.reset(enabled=False)
    assert acct.account("step") is acct.account("eval")  # the shared no-op
    with pytest.raises(ValueError):
        goodput.GoodputAccountant(ours).account("sleep")


def test_feed_window_matches_jax():
    rng = np.random.default_rng(4)
    ours, theirs = goodput.FeedWindow(5), jax_goodput.FeedWindow(5)
    for _ in range(30):
        busy, wait = rng.normal(1.0, 0.7), rng.random() * 0.3
        ours.push(busy, wait)
        theirs.push(busy, wait)
        assert ours.totals() == theirs.totals()
        assert ours.stall_fraction() == theirs.stall_fraction()
    assert ours.dropped == theirs.dropped > 0
    assert goodput.FeedWindow().stall_fraction() is None


def _emit_script(log):
    log.emit("trainer", "fit_start", step=0, epoch=0,
             payload={"epochs": 2, "resumed": False})
    log.emit("checkpoint", "save", step=5, epoch=0,
             payload={"best": True, "loss": float("nan"),
                      "spread": [1.0, float("inf"), -float("inf")],
                      "np": np.float32(2.5), "nested": {"x": (1, 2)}})
    log.emit("governor", "raise_prefetch", step=7, epoch=1,
             payload={"detail": {"host": [2, 4]}, "obj": object})
    log.emit("trainer", "fit_end", step=9, generation=4)


def _strip(path: str) -> list[dict]:
    out = []
    for rec in events.read_events_file(path):
        for key in ("ts_wall", "ts_mono", "host", "pid"):
            rec.pop(key)
        out.append(rec)
    return out


def test_event_log_lines_match_jax(tmp_path):
    ours = events.EventLog(str(tmp_path / "port" / "run_3"))
    theirs = jax_events.EventLog(str(tmp_path / "jax" / "run_3"))
    for log in (ours, theirs):
        _emit_script(log)
        log.close()
    assert ours.generation == theirs.generation == 3
    lines = _strip(ours.path)
    assert lines == _strip(theirs.path)
    assert lines[1]["payload"]["loss"] is None
    assert lines[1]["payload"]["spread"] == [1.0, None, None]
    assert ours.block() == dict(theirs.block(), path=ours.path)
    assert events.EVENT_KEYS == jax_events.EVENT_KEYS
    assert events.SOURCES == jax_events.SOURCES
    with open(ours.path) as f:
        assert all("NaN" not in line and "Infinity" not in line for line in f)


def test_event_log_stack_and_drops(tmp_path, monkeypatch):
    monkeypatch.setattr(events, "_STACK", [])  # whatever ran before
    events.emit("trainer", "ignored")  # no log configured: a no-op
    assert events.events_block() == {"emitted": None, "dropped": None,
                                     "path": None}
    outer = events.configure(str(tmp_path / "outer"))
    log = events.configure(str(tmp_path / "run_0"))
    events.emit("trainer", "fit_start")
    assert events.events_block()["emitted"] == 1 and outer.emitted == 0
    events.release(log)
    assert events.current() is outer
    log.emit("trainer", "after_close")
    assert log.dropped == 1
    events.release(outer)


PLAN = {"name": "seeded", "seed": 7, "faults": [
    {"site": "trainer/batch_fetch", "kind": "latency", "delay_s": 0.0,
     "every": 2, "after": 1},
    {"site": "trainer/batch_fetch", "kind": "nan", "p": 0.4},
    {"site": "serve/enqueue", "kind": "error", "at": [2, 5], "times": 1},
    {"site": "checkpoint/save", "kind": "latency", "delay_s": 0.0,
     "p": 0.5, "times": 3},
]}


def _fire_all(mod, plan):
    out = []
    for visit in range(12):
        for site in ("trainer/batch_fetch", "serve/enqueue",
                     "checkpoint/save", "device/put"):
            try:
                payload = plan.fire(site, payload=np.ones(3, np.float32))
                out.append((site, bool(np.isnan(payload).any())))
            except mod.InjectedFaultError as e:
                out.append((site, str(e)))
    return out


def test_fault_plan_parses_and_fires_like_jax():
    text = json.dumps(PLAN)
    ours, theirs = faults.FaultPlan.from_json(text), \
        jax_faults.FaultPlan.from_json(text)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.sites() == theirs.sites()
    assert _fire_all(faults, ours) == _fire_all(jax_faults, theirs)
    assert ours.firings == theirs.firings and ours.firings
    assert ours.injected_total() == theirs.injected_total()
    assert sites.SITES == jax_sites.SITES and sites.PLAN_ENV == \
        jax_sites.PLAN_ENV == "DPTPU_CHAOS_PLAN"
    for bad in ({"site": "x", "kind": "melt"},
                {"site": "x", "kind": "error", "every": 0},
                {"site": "x", "kind": "error", "p": 2.0}):
        with pytest.raises(ValueError):
            faults.FaultSpec(**bad)


def test_plan_from_env_and_torch_poison(monkeypatch, tmp_path):
    path = tmp_path / "plan.json"
    path.write_text(json.dumps({"name": "wrapped", "plan": PLAN}))
    monkeypatch.setenv("DPTPU_CHAOS_PLAN", str(path))
    try:
        plan = sites.maybe_arm_from_env()
        assert sites.armed() is plan and plan.name == "seeded"
        assert sites.maybe_arm_from_env() is plan
    finally:
        sites.disarm()
    assert sites.fire("trainer/batch_fetch", payload=1) == 1
    x = torch.arange(6, dtype=torch.float32)
    poisoned = faults.poison_payload({"concat": x, "ids": torch.arange(3),
                                      "np": np.ones(2), "f": 1.0, "n": 3})
    assert torch.isnan(poisoned["concat"]).all() \
        and poisoned["concat"].device == x.device
    assert torch.equal(poisoned["ids"], torch.arange(3))
    assert np.isnan(poisoned["np"]).all() and math.isnan(poisoned["f"])
    assert poisoned["n"] == 3


def _serve_ops(m):
    rng = np.random.default_rng(5)
    for _ in range(50):
        r = rng.random()
        if r < 0.4:
            m.count(["requests", "completed", "failed", "shed_queue_full",
                     "shed_deadline"][rng.integers(5)], int(rng.integers(1, 3)))
        elif r < 0.7:
            m.observe_batch(int(2 ** rng.integers(4)), int(rng.integers(1, 9)))
        else:
            m.observe_latency(float(rng.random() * 0.2))


def test_serve_metrics_render_like_jax():
    ours, theirs = registry.MetricsRegistry(), jax_registry.MetricsRegistry()
    mine = serve_metrics.ServeMetrics(registry=ours)
    _serve_ops(mine)
    _serve_ops(jax_serve_metrics.ServeMetrics(registry=theirs))
    text = prometheus.render_text(ours)
    assert text == jax_prometheus.render_text(theirs)
    for family in ("serve_requests_total", "serve_batch_dispatches_total",
                   "serve_latency_seconds"):
        assert f"# TYPE {family}" in text
    snap = mine.snapshot()
    assert set(snap) == {"counts", "latency_p50_ms", "latency_p99_ms",
                         "batches_by_bucket", "lane_fill"}
    assert snap["counts"]["requests"] == mine.requests
    again = serve_metrics.ServeMetrics(registry=ours)  # per-service deltas
    assert again.requests == 0 and again.snapshot()["counts"] == {}


def test_mfu_over_the_h100_table():
    for kind, key, peak in (("NVIDIA H100 80GB HBM3", "h100", 989.4e12),
                            ("NVIDIA H100 PCIe", "h100 pcie", 756e12),
                            ("Some Future Card", "fallback", 756e12),
                            ("cpu", "fallback", 756e12)):
        assert goodput.peak_flops_for(kind) == (peak, key)
        est = goodput.mfu_estimate(2e12, 0.25, device_kind=kind)
        ref = jax_goodput.mfu_estimate(2e12, 0.25, device_kind="TPU v4")
        assert set(est) == set(ref)
        assert est["achieved_flops_per_sec"] == ref["achieved_flops_per_sec"]
        assert est["mfu"] == est["achieved_flops_per_sec"] / peak
        assert est["peak_source"] == key
    assert jax_goodput.peak_flops_for("cpu")[1] == "fallback"
    assert goodput.FALLBACK_PEAK_FLOPS == min(goodput.PEAK_FLOPS_BY_KIND.values())
    assert set(goodput.PEAK_HBM_BY_KIND) == set(goodput.PEAK_FLOPS_BY_KIND)
    with pytest.raises(ValueError):
        goodput.mfu_estimate(0.0, 1.0, device_kind="cpu")


def _meta_danet(impl: str):
    with torch.device("meta"):
        return build_model("danet", backbone="resnet18", attention_impl=impl,
                           in_channels=4).train()


def test_step_flops_same_on_kernel_and_plain_routes():
    """``step_flops`` counts a meta copy through the plain forms; a model
    configured for the kernels refuses meta tensors (the kernels are
    ``ctypes`` launches the counter cannot see), so the trainer's copy
    always takes ``attention_impl="xla"``, and the kernel path and the
    plain path give the same count.  The count is forward + backward:
    about 3x the forward's."""
    x = torch.zeros((4, 4, 64, 64), device="meta")
    plain = goodput.step_flops(_meta_danet("xla"), x)
    with pytest.raises(ValueError, match="meta"):
        goodput.step_flops(_meta_danet("flash"), x)
    torch.manual_seed(0)
    cpu = build_model("danet", backbone="resnet18", attention_impl="xla",
                      in_channels=4)
    assert goodput.step_flops(cpu, torch.randn(4, 4, 64, 64)) == plain
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        _meta_danet("xla")(x)
    assert 2.5 < plain / counter.get_total_flops() < 3.5
    # PERF.md's formula for the position branch: 2·N²·(Ck + Cv) per image
    n, ck, cv = (64 // 8) ** 2, 512 // 8 // 8, 512 // 8
    assert plain > 4 * 2 * n * n * (ck + cv)


def test_trace_capture_bounded_and_one_at_a_time(tmp_path):
    reg = registry.MetricsRegistry()
    trig = TraceCapture(str(tmp_path / "od"), default_steps=2, registry=reg)
    target = trig.request()
    assert target.endswith("trace_000") and trig.request() is None
    for _ in range(4):
        trig.tick(1)
        torch.ones(8, 8).sum()
    trig.close()
    assert not trig.active
    assert any(f.endswith(".pt.trace.json") for f in os.listdir(target))
    assert reg.counter("trace_captures_total").value == 1
    # a start while another profiler runs (profile_epoch) is refused,
    # counted, and never raises into the loop
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert trig.request(steps=1).endswith("trace_001")
        trig.tick(1)
        assert not trig.active
    assert reg.counter("trace_capture_failures_total").value == 1
    trig.close()
    assert reg.counter("trace_captures_total").value == 1


class _JaxStubService:
    """What the JAX front's POST path touches of a service: ``submit``,
    through the JAX package's own ``serve/enqueue`` site."""

    trace = None

    def submit(self, image, points, deadline_s=None, session_id=None):
        jax_sites.fire("serve/enqueue")
        fut = Future()
        fut.set_result(np.zeros(np.asarray(image).shape[:2], np.float32))
        return fut


def _post(port: int, body: bytes):
    """(status, reply) of one POST /v1/predict, or the exception type the
    client saw."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", "/v1/predict", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    except (http.client.HTTPException, ConnectionError) as e:
        return type(e).__name__, None
    finally:
        conn.close()


def _serve(server):
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return thread


def _stop(server, thread):
    server.shutdown()
    server.server_close()
    thread.join(timeout=30)
    assert not thread.is_alive()


ERROR_PLAN = {"name": "front_door", "faults": [
    {"site": "serve/enqueue", "kind": "error", "at": [1]}]}
IMAGE = np.random.default_rng(0).integers(0, 255, (80, 100, 3), np.uint8)
POINTS = [[10.0, 40.0], [50.0, 8.0], [90.0, 40.0], [50.0, 70.0]]


def test_front_under_an_enqueue_fault_behaves_as_jax_front():
    from distributedpytorch_tpu.serve.__main__ import (
        _HealthCache,
        _Server,
        make_handler,
    )

    body = json.dumps({"image": encode_array(IMAGE),
                       "points": POINTS}).encode()
    jax_server = _Server(("127.0.0.1", 0),
                         make_handler(_JaxStubService(), _HealthCache()))
    jthread = _serve(jax_server)
    try:
        with jax_sites.armed_plan(jax_faults.FaultPlan.from_dict(ERROR_PLAN)):
            want = [_post(jax_server.server_port, body) for _ in range(2)]
    finally:
        _stop(jax_server, jthread)

    pred = Predictor.fresh(64, "resnet18", seed=0, device="cpu", relax=10)
    with InferenceService(pred, max_batch=2) as svc:
        server = make_server(svc, port=0)
        thread = _serve(server)
        try:
            with sites.armed_plan(faults.FaultPlan.from_dict(ERROR_PLAN)):
                got = [_post(server.server_port, body) for _ in range(2)]
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{server.server_port}/metrics",
                    timeout=30) as resp:
                ctype = resp.headers["Content-Type"]
                text = resp.read().decode()
        finally:
            _stop(server, thread)
    print(f"port front {got[0]}, JAX front {want[0]}")
    # the faulted request: no reply, the same failure on both fronts
    assert got[0] == want[0] and got[0][1] is None, (got, want)
    # the next one is served
    assert got[1][0] == want[1][0] == 200
    assert np.asarray(got[1][1]["mask"]["shape"]).tolist() == [80, 100]
    assert ctype == prometheus.CONTENT_TYPE
    assert "serve_completed_total" in text and "chaos_injected_total" in text
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            float(value)
            assert name.split("{")[0].replace("_", "").isalnum()


@pytest.mark.parametrize("overrides", [
    ["model.backbone=resnet18", "data.crop_size=[64,64]", "data.relax=10",
     "model.attention_impl=flash"],
    ["task=semantic", "model.name=deeplabv3", "model.nclass=21",
     "model.in_channels=3", "model.backbone=resnet18", "model.aux_head=true",
     "model.loss_weights=[1.0,0.4]", "data.crop_size=[65,65]",
     "model.remat=true"]], ids=["danet_flash", "deeplabv3_remat"])
def test_trainer_counts_flops_for_every_family(overrides, tmp_path):
    """The trainer's count takes the plain forms and no remat on its meta
    copy, for DANet configured for the kernels and for the DeepLab family
    (which has no ``attention_impl``): the FLOP counter, not the
    parameter estimate."""
    from distributedpytorch_tpu_torch.train import config
    from distributedpytorch_tpu_torch.train.trainer import Trainer

    cfg = config.apply_overrides(config.Config(), overrides + [
        "data.fake=true", "data.train_batch=4", "data.area_thres=0",
        "data.num_workers=0", 'log_writers=["jsonl"]',
        f"work_dir={tmp_path}"])
    tr = Trainer(cfg, device="cpu")
    try:
        c = cfg.model.in_channels
        tr._note_step_cost({"concat": np.zeros((4, *cfg.data.crop_size, c),
                                               np.float32)})
    finally:
        tr.close()
    assert tr._flops_source == "flop_counter"
    assert tr._flops_per_step > 6.0 * tr.n_params  # > 1 sample's estimate


def test_drain_fault_fails_its_batch_and_the_service_serves_on():
    """``serve/drain`` as in the JAX service: a raised fault fails the
    drained batch's requests (counted as failed) and the worker serves
    the next batch."""
    pred = Predictor.fresh(64, "resnet18", seed=0, device="cpu", relax=10)
    plan = faults.FaultPlan.from_dict({"faults": [
        {"site": "serve/drain", "kind": "error", "at": [1]}]})
    with sites.armed_plan(plan), InferenceService(pred, max_batch=2) as svc:
        with pytest.raises(faults.InjectedFaultError):
            svc.predict(IMAGE, POINTS, timeout=60)
        mask = svc.predict(IMAGE, POINTS, timeout=60)
        stats = svc.metrics.snapshot()
    assert mask.shape == IMAGE.shape[:2]
    assert stats["counts"]["failed"] == 1 and stats["counts"]["completed"] == 1
    assert plan.firings == [("serve/drain", "error", 1)]


def test_checkpoint_sites_spans_and_events(tmp_path):
    """The checkpoint manager's telemetry, as the JAX manager's: a
    ``truncate`` fault at ``checkpoint/save`` tears the landed step (the
    restore then falls back), each save books a ``save`` and a ``commit``
    event, the firing a ``chaos`` one, and the restore a ``restore``
    naming the skipped step, inside
    the ``checkpoint/*`` spans and the ``checkpoint`` goodput bucket."""
    from distributedpytorch_tpu_torch.parallel.step import create_train_state
    from distributedpytorch_tpu_torch.train.checkpoint import CheckpointManager

    model = torch.nn.Linear(64, 64)
    state = create_train_state(model, torch.optim.SGD(model.parameters(), 0.1),
                               lambda step: 0.1, 0, torch.device("cpu"))
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep_latest=2)
    log = events.configure(str(tmp_path / "run_0"))
    acct = goodput.get_accountant()
    acct.reset(enabled=True)
    plan = faults.FaultPlan.from_dict({"faults": [
        {"site": "checkpoint/save", "kind": "truncate", "at": [2]}]})
    try:
        with sites.armed_plan(plan):
            for step in (1, 2):
                state.step = step
                mgr.save(step, state, extra={"epoch": 0})
        mgr.wait()
        meta = mgr.restore(state)
    finally:
        events.release(log)
    assert meta["step"] == 1 and mgr.last_restore_fallback == [2]
    recs = events.read_events_file(log.path)
    assert [(r["source"], r["kind"], r["step"]) for r in recs] == [
        ("checkpoint", "save", 1), ("checkpoint", "commit", 1),
        ("checkpoint", "save", 2), ("checkpoint", "commit", 2),
        ("chaos", "truncate", None), ("checkpoint", "restore", 1)]
    assert recs[-1]["payload"]["fallback_steps"] == [2]
    assert acct.snapshot()["checkpoint"] > 0
    assert acct.report(publish=False)["counts"]["checkpoint"] == 4
    paths = {c.labels[0][1] for f in registry.get_registry().collect()
             if f.name == "span_seconds" for c in f.children()}
    assert {"checkpoint/save", "checkpoint/wait",
            "checkpoint/restore"} <= paths


def test_preemption_publishes_like_jax_guard(tmp_path):
    """A SIGTERM seen by the guard is published at its next check, as the
    JAX guard does: ``preemption_signals_total``,
    ``preemption_stop_pending`` and one ``preemption preempt`` event."""
    import signal

    from distributedpytorch_tpu_torch.train.preemption import PreemptionGuard

    reg = registry.get_registry()
    before = reg.counter("preemption_signals_total").value
    log = events.configure(str(tmp_path / "run_0"))
    try:
        with PreemptionGuard(check_every=1) as guard:
            assert not guard.should_stop(1)
            assert reg.gauge("preemption_stop_pending").value == 0.0
            os.kill(os.getpid(), signal.SIGTERM)
            assert guard.should_stop(2) and guard.should_stop()
    finally:
        events.release(log)
    assert reg.counter("preemption_signals_total").value == before + 1
    assert reg.gauge("preemption_stop_pending").value == 1.0
    recs = events.read_events_file(log.path)
    assert [(r["source"], r["kind"], r["payload"]) for r in recs] == [
        ("preemption", "preempt", {"signals_received": 1})]
