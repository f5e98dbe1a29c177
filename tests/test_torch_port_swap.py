"""Hot swap with canary generations: the port's ``serve/swap.py`` and
``InferenceService.swap`` against the JAX package's, on the CPU.

* The generation pool: the JAX ``PredictorPool`` and the port's driven by
  the same scripts (placeholder predictors, private registries) give the
  same return values, snapshots and swap counts after every step, the
  same ``serve`` events, and the same routing for 1000 session ids and
  1000 stateless calls.
* The service: the cases of JAX's ``tests/test_sessions.py::TestHotSwap``
  on the port's split predictors (DANet-R18 at 64², ``guidance_inject=
  "head"``, weights from two seeds): session affinity across a promote,
  a rollback's evictions (and a second swap refused until the first is
  decided), a NaN canary failing over, a drained generation retired and
  the service's predictor re-pointed, a resolution mismatch refused, and
  NaN pixels counted as a plain failure.
* ``load_swap_predictor``: the base's settings inherited, the new weights
  in, and the ``serve/swap_params`` chaos site poisoning them.
"""

import gc
import time
import types
import weakref

import numpy as np
import pytest
import torch

from distributedpytorch_tpu.serve import swap as jax_swap
from distributedpytorch_tpu.telemetry import events as jax_events
from distributedpytorch_tpu.telemetry.registry import MetricsRegistry as JaxRegistry
from distributedpytorch_tpu_torch.chaos import sites
from distributedpytorch_tpu_torch.chaos.faults import FaultPlan
from distributedpytorch_tpu_torch.predict import Predictor
from distributedpytorch_tpu_torch.serve import PredictorPool, SwapInProgressError
from distributedpytorch_tpu_torch.serve import swap as port_swap
from distributedpytorch_tpu_torch.serve.service import (
    InferenceService,
    _NonFiniteInputError,
)
from distributedpytorch_tpu_torch.telemetry import events as port_events
from distributedpytorch_tpu_torch.telemetry.registry import MetricsRegistry

RES = 64


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs in several
    processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------- the pool

#: placeholder predictors: the pool only holds and hands them back
P0, P1, P2 = (types.SimpleNamespace(name=f"p{i}") for i in range(3))

#: each script: pool settings, then steps (method, *args); every step's
#: return value (or exception) and the snapshot after it are compared
SCRIPTS = {
    "promote_after": ({"promote_after": 3}, [
        ("begin_swap", P1, "v2", 0.5),
        ("observe", 1, True), ("observe", 0, True), ("observe", 1, True),
        ("observe", 1, True), ("observe", 1, True),
        ("route", "after"), ("swaps",),
    ]),
    "manual_promote": ({"promote_after": None}, [
        ("begin_swap", P1, "", None),
        *[("observe", 1, True)] * 5,
        ("promote",), ("promote",), ("observe", 0, False), ("swaps",),
    ]),
    "error_rate_rollback": ({"min_observations": 4, "max_error_rate": 0.25}, [
        ("begin_swap", P1, "v2", 0.2),
        ("observe", 1, True), ("observe", 1, False), ("observe", 1, False),
        ("observe", 1, True), ("observe", 1, True), ("rollback",),
        ("observe", 7, True), ("swaps",),
    ]),
    "nonfinite_rollback": ({}, [
        ("begin_swap", P1, "bad", 1.0),
        ("observe", 1, True, False), ("observe", 1, False, True),
        ("observe", 1, True), ("route", "s"), ("swaps",),
    ]),
    "swap_in_progress": ({}, [
        ("begin_swap", P1, "v2", 0.3), ("begin_swap", P2, "v3", 0.9),
        ("rollback",), ("begin_swap", P2, "v3", 0.9), ("promote",),
        ("swaps",),
    ]),
    "gc_held_then_released": ({}, [
        ("begin_swap", P1, "v2", 1.0), ("track_inflight", 0, 1),
        ("track_inflight", 1, 2), ("promote",),
        ("gc", {0: 1}), ("gc", {}), ("is_resident", P0),
        ("track_inflight", 0, -1), ("gc", {0: 2}), ("gc", {1: 3}),
        ("is_resident", P0), ("is_resident", P1), ("active_predictor",),
        ("track_inflight", 9, 1), ("gc", {}),
    ]),
}


def _pools(settings: dict):
    return (jax_swap.PredictorPool(P0, registry=JaxRegistry(), **settings),
            PredictorPool(P0, registry=MetricsRegistry(), **settings))


def _call(pool, method, *args):
    """(kind, value) of one step: its return value, or its exception's
    type name and message."""
    try:
        if method == "active_predictor":
            return "ok", pool.active_predictor
        if method == "route":
            gen, pred = pool.route(*args)
            return "ok", (gen, pred)
        return "ok", getattr(pool, method)(*args)
    except Exception as e:  # noqa: BLE001 — compared across packages
        return type(e).__name__, str(e)


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_pool_matches_jax(script):
    settings, steps = SCRIPTS[script]
    ref, port = _pools(settings)
    assert port.snapshot() == ref.snapshot()
    for step in steps:
        want, got = _call(ref, *step), _call(port, *step)
        assert got == want, step
        assert port.snapshot() == ref.snapshot(), step
    assert port.swaps() == ref.swaps()
    assert (port.active_generation, port.canary_generation) == \
        (ref.active_generation, ref.canary_generation)


def test_pool_refusals_and_gauge():
    """Both in-progress refusals are the port's own type; the live-weights
    gauge follows admission and retirement."""
    reg = MetricsRegistry()
    pool = PredictorPool(P0, registry=reg)
    live = reg.gauge("serve_params_generations_live")
    assert live.value == 1.0
    pool.begin_swap(P1)
    with pytest.raises(SwapInProgressError, match="still canarying"):
        pool.begin_swap(P2)
    assert live.value == 2.0
    pool.promote()
    assert pool.gc({}) == [0] and live.value == 1.0
    assert issubclass(SwapInProgressError, RuntimeError)
    assert port_swap.STATES == jax_swap.STATES


def test_pool_events_match_jax(tmp_path):
    """The flight recorder's ``serve`` events (admit, promote, rollback)
    with JAX's kinds and payloads."""
    records = []
    for events, pool, run in ((jax_events, _pools({})[0], tmp_path / "jax"),
                              (port_events, _pools({})[1], tmp_path / "port")):
        log = events.configure(str(run), generation=0)
        try:
            pool.begin_swap(P1, "v2", 0.25)
            pool.observe(1, True)
            pool.promote()
            pool.begin_swap(P2, "", None)
            pool.observe(2, False, True)
        finally:
            events.release(log)
        records.append([(r["source"], r["kind"], r["payload"])
                        for r in events.read_events_file(log.path)])
    assert records[1] == records[0]
    assert [kind for _, kind, _ in records[1]] == \
        ["swap_admit", "swap_promote", "swap_admit", "swap_rollback"]


@pytest.mark.parametrize("fraction", [0.1, 0.5])
def test_routing_matches_jax(fraction):
    ref, port = _pools({})
    ref.begin_swap(P1, canary_fraction=fraction)
    port.begin_swap(P1, canary_fraction=fraction)
    rng = np.random.default_rng(11)
    ids = ["".join(chr(c) for c in rng.integers(33, 127, rng.integers(1, 24)))
           for _ in range(1000)]
    routed = [port.route(sid)[0] for sid in ids]
    assert routed == [ref.route(sid)[0] for sid in ids]
    stateless = [port.route(None)[0] for _ in range(1000)]
    assert stateless == [ref.route(None)[0] for _ in range(1000)]
    # the round robin sends exactly the fraction of 1000 calls
    assert stateless.count(1) == round(fraction * 1000)
    assert 0 < routed.count(1) < 1000


# ------------------------------------------------------------- the service

def _image(size=RES, seed=0):
    return np.random.RandomState(seed).randint(
        0, 256, (size, size, 3)).astype(np.uint8)


def _points(size=RES):
    q, m = size // 4, size // 2
    return np.array([[q, m], [size - q, m], [m, q], [m, size - q]],
                    np.float64)


def _split(seed: int) -> Predictor:
    return Predictor.fresh(RES, "resnet18", seed=seed, device="cpu",
                           guidance_inject="head", relax=10)


@pytest.fixture(scope="module")
def preds():
    """Two split predictors, weights from seeds 0 and 7."""
    return _split(0), _split(7)


def _poisoned(pred: Predictor) -> dict:
    return {k: torch.full_like(v, float("nan")) if v.is_floating_point()
            else v for k, v in pred.model.state_dict().items()}


def _service(pred, **kw) -> InferenceService:
    svc = InferenceService(pred, max_batch=4, max_wait_s=0.0, **kw)
    svc.warmup()
    return svc


class TestHotSwap:
    def test_promote_keeps_old_sessions_bitwise(self, preds):
        base, new = preds
        img, pts = _image(), _points()
        with _service(base) as svc:
            before = svc.predict(img, pts, timeout=120, session_id="old")
            assert svc.swap(new, label="v2", canary_fraction=1.0) == 1
            during = svc.predict(img, pts, timeout=120, session_id="old")
            svc.promote()
            after = svc.predict(img, pts, timeout=120, session_id="old")
            np.testing.assert_array_equal(before, during)
            np.testing.assert_array_equal(before, after)
            fresh = svc.predict(img, pts, timeout=120, session_id="new")
            assert not np.array_equal(before, fresh)
            np.testing.assert_array_equal(fresh, new.predict(img, pts))
            health = svc.health()
        assert health["swap"]["swaps"]["promoted"] == 1
        assert health["sessions"]["by_generation"] == {"0": 1, "1": 1}
        assert health["sessions"]["hits"] == 2
        gens = {g["gen"]: g for g in health["swap"]["generations"]}
        assert (gens[0]["state"], gens[1]["state"]) == ("draining", "active")
        assert gens[0]["inflight"] == gens[1]["inflight"] == 0

    def test_rollback_evicts_canary_sessions(self, preds):
        """A rollback evicts the canary's sessions, which re-encode cold
        on the active weights; a second swap is refused (thresholds
        untouched) until the first is decided."""
        base, new = preds
        img, pts = _image(), _points()
        with _service(base) as svc:
            keep = svc.predict(img, pts, timeout=120, session_id="keep")
            gen = svc.swap(new, canary_fraction=1.0)
            canary = svc.predict(img, pts, timeout=120, session_id="canary")
            assert not np.array_equal(canary, keep)
            assert svc.health()["sessions"]["by_generation"] == \
                {"0": 1, str(gen): 1}
            with pytest.raises(SwapInProgressError):
                svc.swap(base, min_observations=99)
            assert svc._pool.min_observations == 20
            gc.disable()
            try:
                # a warm click's request holds the session: once done, it
                # must not keep the features alive past their eviction
                np.testing.assert_array_equal(svc.predict(
                    img, pts, timeout=120, session_id="canary"), canary)
                features = weakref.ref(svc._store.get("canary").features)
                svc.rollback()
                deadline = time.time() + 5  # the worker's next poll drops it
                while features() is not None and time.time() < deadline:
                    time.sleep(0.01)
                assert features() is None
            finally:
                gc.enable()
            snap = svc.health()["sessions"]
            assert snap["by_generation"] == {"0": 1}
            assert snap["evictions"]["generation"] == 1
            again = svc.predict(img, pts, timeout=120, session_id="canary")
            np.testing.assert_array_equal(again, keep)
            np.testing.assert_array_equal(
                svc.predict(img, pts, timeout=120, session_id="keep"), keep)
            with pytest.raises(RuntimeError, match="no canary"):
                svc.rollback()
            assert svc.swap(new, canary_fraction=1.0) == gen + 1
            assert svc.health()["swap"]["swaps"] == \
                {"promoted": 0, "rolled_back": 1}

    def test_nan_canary_fails_over_and_rolls_back(self, preds):
        base, _ = preds
        img, pts = _image(), _points()
        with _service(base) as svc:
            good = svc.predict(img, pts, timeout=120, session_id="a")
            bad = port_swap.load_swap_predictor(base, _poisoned(base))
            svc.swap(bad, label="bad", canary_fraction=1.0)
            mask = svc.predict(img, pts, timeout=120, session_id="b")
            # the client got the active generation's answer, not an error
            np.testing.assert_array_equal(mask, good)
            health = svc.health()
        sw = health["swap"]
        assert sw["swaps"]["rolled_back"] == 1 and sw["canary"] is None
        gens = {g["gen"]: g for g in sw["generations"]}
        assert (gens[1]["state"], gens[1]["nonfinite"]) == ("draining", 1)
        # the failed-over session lives on the generation that served it
        assert health["sessions"]["by_generation"] == {"0": 2}
        assert "failed" not in health["stats"]["counts"]

    def test_drained_generation_is_retired(self, preds):
        base, new = preds
        img, pts = _image(), _points()
        with _service(base, session_ttl_s=0.05) as svc:
            svc.predict(img, pts, timeout=120, session_id="old")
            svc.swap(new, canary_fraction=1.0)
            svc.promote()
            # the old generation's only session expires; the worker's
            # 1 Hz sweep then retires the drained generation
            deadline = time.time() + 10
            while time.time() < deadline:
                gens = {g["gen"]: g["state"]
                        for g in svc.health()["swap"]["generations"]}
                if gens.get(0) == "retired" and svc.predictor is new:
                    break
                time.sleep(0.05)
            assert gens.get(0) == "retired"
            assert svc.predictor is new
            assert not svc._pool.is_resident(base)
            np.testing.assert_array_equal(
                svc.predict(img, pts, timeout=120), new.predict(img, pts))

    def test_swap_refusals(self, preds):
        base, new = preds
        with _service(base) as svc:
            with pytest.raises(ValueError, match="resolution"):
                svc.swap(Predictor(new.model, resolution=(96, 96),
                                   device="cpu"))
            with pytest.raises(ValueError, match="encode/decode split"):
                svc.swap(types.SimpleNamespace(supports_sessions=False,
                                               resolution=(RES, RES)))
            assert svc.health()["swap"]["generations"] == [
                {"gen": 0, "label": "initial", "state": "active", "ok": 0,
                 "errors": 0, "nonfinite": 0, "inflight": 0}]

    def test_nan_pixels_are_a_plain_failure(self, preds):
        """Both generations non-finite for one request: a failure of that
        request, not a canary signal."""
        base, new = preds
        img = np.full((RES, RES, 3), np.nan, np.float32)
        with _service(base) as svc:
            svc.swap(new, canary_fraction=1.0)
            with pytest.raises(_NonFiniteInputError, match="BOTH"):
                svc.predict(img, _points(), timeout=120)
            sw = svc.health()["swap"]
            failed = svc.health()["stats"]["counts"]["failed"]
        assert sw["canary"] == 1 and sw["swaps"]["rolled_back"] == 0
        gens = {g["gen"]: g for g in sw["generations"]}
        assert (gens[1]["errors"], gens[1]["nonfinite"]) == (1, 0)
        assert failed == 1


def test_load_swap_predictor_inherits_and_fires_site(preds):
    base, new = preds
    pred = port_swap.load_swap_predictor(base, new.model.state_dict())
    for attr in ("resolution", "relax", "zero_pad", "alpha", "guidance",
                 "in_channels", "device", "dtype", "supports_sessions"):
        assert getattr(pred, attr) == getattr(base, attr), attr
    assert pred.model is not base.model
    x = np.random.default_rng(5).uniform(0, 255, (1, RES, RES, 4)) \
        .astype(np.float32)
    np.testing.assert_array_equal(pred.forward_prepared(x),
                                  new.forward_prepared(x))
    plan = FaultPlan.from_dict({"seed": 0, "faults": [
        {"site": "serve/swap_params", "kind": "nan", "at": [1]}]})
    with sites.armed_plan(plan):
        poisoned = port_swap.load_swap_predictor(
            base, base.model.state_dict(), relax=20)
    assert poisoned.relax == 20
    assert not np.isfinite(poisoned.forward_prepared(x)).any()
    assert np.isfinite(base.forward_prepared(x)).all()
