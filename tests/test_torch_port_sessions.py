"""Session serving of the port against the JAX package's, on the CPU.

The network is the JAX session tests' (``_make_serve_predictor("head")``:
DANet-R18 at 64², ``guidance_inject="head"``, flax's init from
``PRNGKey(0)``), with ``guidance_proj`` and both residual gates drawn
non-zero from a numpy seed (at their zero init the guidance and the
attention branches would not reach the logits), carried into the port
with ``load_jax_params``.

* The model split: the port's encode features (NCHW against NHWC) within
  1e-5 of JAX's; the guidance resize within 1e-5 of ``jax.image.resize``
  (antialiased); ``prepare_guidance`` bitwise the cold click's channel,
  and against each of JAX's n-ellipse paths, its native rasterizer
  (``torch_port_jax_native``) and its numpy form; ``decode(encode(x))`` the
  full forward bit for bit; JAX's ``ValueError`` messages word for word.
* Decode and full-forward probabilities within 1e-5 of JAX's with gates
  drawn in [2e-3, 5e-3].  At gates of 0.5-1 the logits agree within 1e-5
  of their largest value, but not the probabilities: at flax's init the
  BatchNorm statistics are (0, 1), so the position branch's scores reach
  ~1e5 and its softmax picks among near-ties by float32 summation order
  (4.2e-4 apart in probability, 7.8e-6 of the logits' scale).
* The session store: the JAX store's contracts (TTL, LRU under a byte
  budget, an oversized entry admitted, generation counts, the gauges),
  and the same snapshot as the JAX store after the same operations.
* The service: a warm click bitwise the cold and the stateless click at
  the same bucket, warm clicks of several sessions in one decode, budget
  and TTL eviction, re-encoding for a click outside the crop or another
  image, the per-session lane, features kept as tensors on the device.
* The HTTP wire: ``session_id`` with the stateless default, the
  session-lane 429 arriving as :class:`SessionLaneFullError`.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributedpytorch_tpu import predict as jax_predict
from distributedpytorch_tpu.models import build_model as jax_build_model
from distributedpytorch_tpu.parallel import create_train_state
from distributedpytorch_tpu.serve.sessions import SessionStore as JaxStore
from distributedpytorch_tpu.serve.swap import load_swap_predictor as jax_load_swap
from distributedpytorch_tpu_torch.models import build_model
from distributedpytorch_tpu_torch.models.danet import resize_guidance
from distributedpytorch_tpu_torch.predict import Predictor, _split_channel_stats
from distributedpytorch_tpu_torch.serve.__main__ import make_server, parse_fresh_spec
from distributedpytorch_tpu_torch.serve.client import ServeClient
from distributedpytorch_tpu_torch.serve.service import (
    InferenceService,
    QueueFullError,
    SessionLaneFullError,
)
from distributedpytorch_tpu_torch.serve.sessions import SessionStore, image_digest
from distributedpytorch_tpu_torch.serve.swap import load_swap_predictor
from distributedpytorch_tpu_torch.utils.weights import (
    load_jax_params,
    state_dict_to_jax,
)
from torch_port_jax_native import jax_native_lib, jax_native_path  # noqa: F401

RES = 64
ATOL = 1e-5
#: the port's guidance against the JAX package's numpy n-ellipse: JAX's
#: own native and numpy paths differ by 1.37e-4 on [0, 255] at this
#: file's points and crop (float32 rounding of the two forms; at most
#: 1.68e-4 over 12 point sets and crops of 64²), so this bound
NUMPY_PATH_ATOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs in several
    processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _image(size=RES, seed=0):
    return np.random.RandomState(seed).randint(
        0, 256, (size, size, 3)).astype(np.uint8)


def _points(size=RES, dx=0.0, dy=0.0):
    q, m = size // 4, size // 2
    return np.array([[q, m], [size - q, m], [m, q], [m, size - q]],
                    np.float64) + np.array([dx, dy])


def _crops(b=2, seed=3):
    return np.random.RandomState(seed).uniform(
        0, 255, (b, RES, RES, 4)).astype(np.float32)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).float().numpy()


@pytest.fixture(scope="module")
def jax_net():
    """The JAX session net and its variables, with ``guidance_proj`` and
    the gates drawn: ``gated`` (gates in [0.5, 1]) and ``quiet`` (gates
    in [2e-3, 5e-3]), the same projection in both."""
    model = jax_build_model("danet", nclass=1, backbone="resnet18",
                            output_stride=8, guidance_inject="head")
    # flax's init traced once by XLA: bitwise its eager init, in half the
    # time
    state = jax.jit(lambda key: create_train_state(
        key, model, optax.sgd(1e-3), (1, RES, RES, 4)))(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, jax.device_get(state.params))
    stats = jax.tree.map(np.asarray, jax.device_get(state.batch_stats))
    rng = np.random.default_rng(7)
    kernel = params["guidance_proj"]["kernel"]
    params["guidance_proj"] = {"kernel": rng.normal(
        0.0, 0.02, kernel.shape).astype(np.float32)}
    sets = {}
    for name, (lo, hi) in (("gated", (0.5, 1.0)), ("quiet", (2e-3, 5e-3))):
        p = jax.tree.map(lambda a: a, params)
        for branch in ("pam", "cam"):
            p["head"][branch]["gamma"] = np.float32(rng.uniform(lo, hi))
        sets[name] = p
    return model, sets, stats


def _port_predictor(params, stats, **kwargs) -> Predictor:
    model = build_model("danet", nclass=1, backbone="resnet18",
                        output_stride=8, guidance_inject="head")
    load_jax_params(model, params, stats)
    return Predictor(model, resolution=(RES, RES), relax=10, device="cpu",
                     **kwargs)


@pytest.fixture(scope="module")
def pred(jax_net):
    """The port's split predictor on the gated weights."""
    _, sets, stats = jax_net
    return _port_predictor(sets["gated"], stats)


@pytest.fixture(scope="module")
def quiet(jax_net):
    """The JAX and port predictors on the quiet weights, and JAX's encode,
    decode and full forward of :func:`_crops`."""
    model, sets, stats = jax_net
    ref = jax_predict.Predictor(model, sets["quiet"], stats,
                                resolution=(RES, RES), relax=10)
    x = _crops()
    feats = np.asarray(ref.encode_jitted(x[..., :-1]))
    return {"jax": ref, "port": _port_predictor(sets["quiet"], stats),
            "x": x, "feats": feats,
            "decode": np.asarray(ref.decode_jitted(feats, x[..., -1:]))[..., 0],
            "full": ref.forward_prepared(x)}


class TestModelSplit:
    def test_encode_features_match_jax(self, quiet):
        got = quiet["port"].encode(quiet["x"][..., :-1])
        assert got.shape == (2, 512, 8, 8) and got.dtype == torch.float32
        np.testing.assert_allclose(_nhwc(got), quiet["feats"], atol=ATOL)

    def test_decode_matches_jax(self, quiet):
        feats = torch.from_numpy(quiet["feats"]).permute(0, 3, 1, 2)
        got = quiet["port"].decode(feats.contiguous(), quiet["x"][..., -1:])
        np.testing.assert_allclose(got, quiet["decode"], atol=ATOL)

    def test_full_forward_matches_jax(self, quiet):
        np.testing.assert_allclose(quiet["port"].forward_prepared(quiet["x"]),
                                   quiet["full"], atol=ATOL)

    def test_gated_logits_match_jax(self, jax_net, pred):
        model, sets, stats = jax_net
        x = _crops(seed=5)
        ref = model.apply({"params": sets["gated"], "batch_stats": stats},
                          jnp.asarray(x), train=False)
        with torch.no_grad():
            got = pred.model(torch.from_numpy(x).permute(0, 3, 1, 2))
        for r, g in zip(ref, got):
            r = np.asarray(r)
            bound = ATOL * max(1.0, float(np.abs(r).max()))
            assert float(np.abs(_nhwc(g) - r).max()) <= bound

    @pytest.mark.parametrize("src,dst", [(512, 64), (64, 8), (65, 9),
                                         (100, 13), (8, 64)])
    def test_guidance_resize_matches_jax(self, src, dst):
        g = np.random.default_rng(src).uniform(
            0, 1, (2, src, src, 1)).astype(np.float32)
        ref = np.asarray(jax.image.resize(g, (2, dst, dst, 1), "bilinear"))
        got = resize_guidance(torch.from_numpy(g).permute(0, 3, 1, 2),
                              (dst, dst))
        np.testing.assert_allclose(_nhwc(got), ref, atol=ATOL)

    def test_guidance_map_resize_matches_jax(self, pred):
        _, bbox = pred.prepare(_image(), _points())
        g = pred.prepare_guidance(_points(), bbox)[None]
        ref = np.asarray(jax.image.resize(g, (1, 8, 8, 1), "bilinear"))
        got = resize_guidance(torch.from_numpy(g).permute(0, 3, 1, 2), (8, 8))
        np.testing.assert_allclose(_nhwc(got), ref, atol=ATOL * 255)

    @pytest.mark.parametrize("b", [1, 2])
    def test_decode_of_encode_is_the_full_forward(self, pred, b):
        x = _crops(b, seed=9)
        staged = pred.decode(pred.encode(x[..., :-1]), x[..., -1:])
        with torch.no_grad():
            logits = pred.model(
                torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())[0]
        np.testing.assert_array_equal(
            staged, torch.sigmoid(logits.float())[:, 0].numpy())
        np.testing.assert_array_equal(staged, pred.forward_prepared(x))

    def test_bf16_stages_are_the_full_forward(self, jax_net):
        _, sets, stats = jax_net
        p = _port_predictor(sets["gated"], stats, dtype=torch.bfloat16)
        x = _crops(seed=11)
        feats = p.encode(x[..., :-1])
        assert feats.dtype == torch.bfloat16
        with torch.no_grad():
            logits = p.model(
                torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())[0]
        np.testing.assert_array_equal(
            p.decode(feats, x[..., -1:]),
            torch.sigmoid(logits.float())[:, 0].numpy())
        assert p.feature_struct(1).nbytes == 8 * 8 * 512 * 2

    def test_guidance_reaches_the_head(self, pred):
        feats = pred.encode(_crops(1)[..., :-1])
        d0 = pred.decode(feats, np.zeros((1, RES, RES, 1), np.float32))
        d1 = pred.decode(feats, np.full((1, RES, RES, 1), 255.0, np.float32))
        assert not np.array_equal(d0, d1)

    @pytest.mark.parametrize("b", [1, 3])
    def test_feature_struct(self, pred, b):
        s = pred.feature_struct(b)
        assert s.shape == (b, 512, 8, 8) and s.dtype == torch.float32
        assert s.nbytes == b * 8 * 8 * 512 * 4
        assert s.shape == tuple(pred.encode(_crops(b)[..., :-1]).shape)

    @pytest.mark.parametrize("jax_path", ["native", "numpy"])
    def test_prepare_guidance_matches_jax_and_the_cold_channel(
            self, quiet, pred, jax_path, request, monkeypatch):
        """The port (its own library) against each of JAX's n-ellipse
        paths: its native rasterizer at ``ATOL``, its numpy form at
        ``NUMPY_PATH_ATOL``."""
        img, pts = _image(), _points(dx=3.0)
        concat, bbox = pred.prepare(img, pts)
        warm = pred.prepare_guidance(pts, bbox)
        assert warm.shape == (RES, RES, 1) and warm.dtype == np.float32
        np.testing.assert_array_equal(warm[..., 0], concat[..., 3])
        if jax_path == "native":
            request.getfixturevalue("jax_native_path")
            atol = ATOL
        else:
            monkeypatch.setenv("DPTPU_NATIVE", "0")
            atol = NUMPY_PATH_ATOL
        np.testing.assert_allclose(
            warm, quiet["jax"].prepare_guidance(pts, bbox), atol=atol)

    def test_prepare_guidance_refuses_bad_points(self, pred):
        with pytest.raises(ValueError, match="4 xy extreme points"):
            pred.prepare_guidance(np.zeros((3, 2)), (0, 0, 10, 10))

    @pytest.mark.parametrize("norm", ["broadcast", "per_channel"])
    def test_normalization_matches_jax(self, jax_net, norm):
        model, sets, stats = jax_net
        kw = ({"mean": (127.5,), "std": (64.0,)} if norm == "broadcast"
              else {"mean": (120.0, 115.0, 100.0, 30.0),
                    "std": (60.0, 58.0, 57.0, 80.0)})
        ref = jax_predict.Predictor(model, sets["quiet"], stats,
                                    resolution=(RES, RES), relax=10, **kw)
        got = _port_predictor(sets["quiet"], stats, **kw)
        x = _crops(1, seed=4)
        np.testing.assert_allclose(got.forward_prepared(x),
                                   ref.forward_prepared(x), atol=ATOL)

    def test_split_stats_refuse_a_partial_list(self):
        with pytest.raises(ValueError) as want:
            jax_predict._split_channel_stats((1.0, 2.0, 3.0), 4)
        with pytest.raises(ValueError) as got:
            _split_channel_stats((1.0, 2.0, 3.0), 4)
        assert str(got.value) == str(want.value)

    def test_swap_generation_matches_jax(self, jax_net, quiet):
        """A new generation from JAX weights (quiet gates, another
        projection) carried by ``load_jax_params``: the port's
        ``load_swap_predictor`` masks within ATOL of JAX's."""
        model, sets, stats = jax_net
        params = jax.tree.map(lambda a: a, sets["quiet"])
        params["head"]["pam"]["gamma"] = np.float32(4e-3)
        params["head"]["cam"]["gamma"] = np.float32(2.5e-3)
        params["guidance_proj"] = {
            "kernel": -1.5 * params["guidance_proj"]["kernel"]}
        carried = build_model("danet", nclass=1, backbone="resnet18",
                              output_stride=8, guidance_inject="head")
        load_jax_params(carried, params, stats)
        got = load_swap_predictor(quiet["port"], carried.state_dict())
        want = jax_load_swap(quiet["jax"], params, stats)
        assert got.relax == want.relax == 10
        img, pts = _image(), _points()
        mask = got.predict(img, pts)
        np.testing.assert_allclose(mask, want.predict(img, pts), atol=ATOL)
        assert np.abs(mask - quiet["port"].predict(img, pts)).max() > 1e-3

    def test_weights_round_trip(self, jax_net, pred):
        _, sets, stats = jax_net
        params, got_stats = state_dict_to_jax(pred.model.state_dict())
        assert params["guidance_proj"]["kernel"].shape == (1, 1, 1, 512)
        assert params["backbone"]["Conv_0"]["kernel"].shape == (7, 7, 3, 64)
        for got, want in ((params, sets["gated"]), (got_stats, stats)):
            assert jax.tree.all(jax.tree.map(np.array_equal, got, want))


class TestModelErrors:
    """The JAX model's ``ValueError``s, word for word."""

    @staticmethod
    def _messages(jax_call, port_call) -> tuple[str, str]:
        with pytest.raises(ValueError) as want:
            jax_call()
        with pytest.raises(ValueError) as got:
            port_call()
        return str(got.value), str(want.value)

    @pytest.mark.parametrize("stage", ["encode", "decode"])
    def test_stem_model_refuses_stages(self, stage):
        jm = jax_build_model("danet", nclass=1, backbone="resnet18",
                             output_stride=8)
        vs = {"params": {}}  # the refusal comes before any weight is read
        port = build_model("danet", nclass=1, backbone="resnet18").eval()
        got, want = self._messages(
            lambda: jm.apply(vs, jnp.zeros((1, 32, 32, 3)), train=False,
                             stage=stage),
            lambda: port(torch.zeros(1, 3, 32, 32), stage=stage))
        assert got == want and "guidance_inject='head'" in got

    def test_decode_needs_out_size(self, jax_net, pred):
        model, sets, stats = jax_net
        vs = {"params": sets["gated"], "batch_stats": stats}
        feats = jnp.zeros((1, 8, 8, 512))
        g = jnp.zeros((1, RES, RES, 1))
        got, want = self._messages(
            lambda: model.apply(vs, (feats, g), train=False, stage="decode"),
            lambda: pred.model((torch.zeros(1, 512, 8, 8),
                                torch.zeros(1, 1, RES, RES)), stage="decode"))
        assert got == want

    def test_unknown_stage(self, jax_net, pred):
        model, sets, stats = jax_net
        vs = {"params": sets["gated"], "batch_stats": stats}
        got, want = self._messages(
            lambda: model.apply(vs, jnp.zeros((1, RES, RES, 3)), train=False,
                                stage="both"),
            lambda: pred.model(torch.zeros(1, 3, RES, RES), stage="both"))
        assert got == want

    def test_unknown_inject(self):
        jm = jax_build_model("danet", nclass=1, backbone="resnet18",
                             guidance_inject="neck")
        got, want = self._messages(
            lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 4)),
                            train=False),
            lambda: build_model("danet", backbone="resnet18",
                                guidance_inject="neck"))
        assert got == want

    @pytest.mark.parametrize("name", ["deeplabv3", "fcn"])
    def test_other_families_refuse_the_knob(self, name):
        got, want = self._messages(
            lambda: jax_build_model(name, nclass=2, backbone="resnet18",
                                    guidance_inject="head"),
            lambda: build_model(name, nclass=2, backbone="resnet18",
                                guidance_inject="head"))
        assert got == want

    def test_stem_predictor_has_no_stages(self):
        stem = Predictor.fresh(32, "resnet18", device="cpu")
        assert not stem.supports_sessions
        for call in (lambda: stem.encode(np.zeros((1, 32, 32, 3))),
                     lambda: stem.feature_struct(1)):
            with pytest.raises(ValueError, match="guidance_inject='stem'"):
                call()


class TestSessionStore:
    def _feats(self, nbytes=1024):
        # numpy stands in for a tensor: the store reads shape and dtype
        return np.zeros(nbytes // 4, np.float32)

    def test_put_get_and_covers(self):
        store = SessionStore(budget_bytes=1 << 20, ttl_s=10.0)
        store.put("a", self._feats(), bbox=(10, 10, 50, 50),
                  shape_hw=(64, 64), generation=0, digest=5)
        sess = store.get("a")
        assert sess is not None and sess.generation == 0
        inside = np.array([[10, 10], [50, 50], [20, 30], [30, 20]])
        assert sess.covers(inside, (64, 64), digest=5)
        assert not sess.covers(inside, (64, 64), digest=6)
        assert not sess.covers(np.array([[5, 10], [50, 50], [20, 30],
                                         [30, 20]]), (64, 64))
        assert not sess.covers(inside, (65, 64))
        assert store.get("nope") is None

    def test_ttl_expiry(self):
        store = SessionStore(budget_bytes=1 << 20, ttl_s=5.0)
        t0 = 1000.0
        store.put("a", self._feats(), (0, 0, 10, 10), (32, 32), 0, now=t0)
        assert store.get("a", now=t0 + 4.9) is not None
        assert store.get("a", now=t0 + 10.1) is None
        assert store.snapshot()["evictions"]["ttl"] == 1
        assert len(store) == 0

    def test_sweep_reaps_expired(self):
        store = SessionStore(budget_bytes=1 << 20, ttl_s=5.0)
        t0 = 1000.0
        for k in "abc":
            store.put(k, self._feats(), (0, 0, 10, 10), (32, 32), 0, now=t0)
        assert store.sweep(now=t0 + 6.0) == 3
        assert store.live_bytes == 0

    def test_lru_eviction_under_budget(self):
        store = SessionStore(budget_bytes=4000, ttl_s=100.0)
        t0 = 1000.0
        for i, k in enumerate("abc"):    # 1024 B each; 3 fit in 4000
            store.put(k, self._feats(), (0, 0, 9, 9), (32, 32), 0,
                      now=t0 + i)
        store.get("a", now=t0 + 5)       # refresh a: b is now the LRU
        store.put("d", self._feats(), (0, 0, 9, 9), (32, 32), 0, now=t0 + 6)
        assert store.get("b", now=t0 + 7) is None
        assert store.get("a", now=t0 + 7) is not None
        assert store.snapshot()["evictions"]["lru"] == 1
        assert store.live_bytes == 3 * 1024

    def test_oversized_entry_still_admitted(self):
        store = SessionStore(budget_bytes=100, ttl_s=100.0)
        store.put("big", self._feats(4096), (0, 0, 9, 9), (32, 32), 0)
        assert store.get("big") is not None  # max(budget, one entry)

    def test_generation_eviction_and_counts(self):
        store = SessionStore(budget_bytes=1 << 20, ttl_s=100.0)
        for k, g in (("a", 0), ("b", 1), ("c", 1)):
            store.put(k, self._feats(), (0, 0, 9, 9), (32, 32), g)
        assert store.counts_by_generation() == {0: 1, 1: 2}
        assert store.evict_generation(1) == 2
        assert store.counts_by_generation() == {0: 1}
        assert store.snapshot()["evictions"]["generation"] == 2

    def test_live_bytes_gauge_tracks(self):
        from distributedpytorch_tpu_torch.telemetry import get_registry

        store = SessionStore(budget_bytes=1 << 20, ttl_s=100.0)
        store.put("a", self._feats(2048), (0, 0, 9, 9), (32, 32), 0)
        g = get_registry().gauge("serve_session_live_bytes")
        assert g.value == 2048.0
        assert store.evict("a") and not store.evict("a")
        assert g.value == 0.0

    @pytest.mark.parametrize("dtype,itemsize", [(torch.float32, 4),
                                                (torch.bfloat16, 2)])
    def test_tensor_bytes(self, dtype, itemsize):
        store = SessionStore(budget_bytes=1 << 20, ttl_s=100.0)
        sess = store.put("t", torch.zeros(1, 512, 8, 8, dtype=dtype),
                         (0, 0, 9, 9), (32, 32))
        assert sess.nbytes == store.live_bytes == 512 * 64 * itemsize

    def test_snapshot_matches_the_jax_store(self):
        """The same operations on both stores leave the same snapshot."""
        snaps = []
        for cls in (SessionStore, JaxStore):
            store = cls(budget_bytes=3000, ttl_s=5.0)
            t0 = 1000.0
            for i, k in enumerate("abcd"):
                store.put(k, self._feats(), (0, 0, 9, 9), (32, 32), i % 2,
                          now=t0 + i)
            store.get("c", now=t0 + 4)
            store.hit()
            store.miss()
            store.miss()
            store.evict("d")
            store.get("b", now=t0 + 20)
            snaps.append(store.snapshot())
        assert snaps[0] == snaps[1]

    def test_bad_settings_refused(self):
        with pytest.raises(ValueError, match="budget_bytes"):
            SessionStore(budget_bytes=0)
        with pytest.raises(ValueError, match="ttl_s"):
            SessionStore(ttl_s=0)

    def test_image_digest_is_the_jax_digest(self):
        from distributedpytorch_tpu.serve.sessions import image_digest as jd

        img = _image()
        assert image_digest(img) == jd(img)
        assert image_digest(img) != image_digest(_image(seed=1))


class TestServiceSessions:
    def test_warm_click_bitwise_equals_cold_and_stateless(self, pred):
        img, pts = _image(), _points()
        with InferenceService(pred, max_batch=4, max_wait_s=0.0) as svc:
            stateless = svc.predict(img, pts, timeout=60)
            cold = svc.predict(img, pts, timeout=60, session_id="s")
            warm = svc.predict(img, pts, timeout=60, session_id="s")
            # new clicks inside the crop: the same features, the guidance
            # of the new clicks drawn in the session's crop
            moved = svc.predict(img, _points(dx=2), timeout=60,
                                session_id="s")
            snap = svc.health()["sessions"]
        np.testing.assert_array_equal(stateless, cold)
        np.testing.assert_array_equal(cold, warm)
        concat, bbox = pred.prepare(img, pts)
        want = pred.decode(pred.encode(concat[None, ..., :-1]),
                           pred.prepare_guidance(_points(dx=2), bbox)[None])
        np.testing.assert_array_equal(
            moved, pred.paste_back(want[0], bbox, img.shape[:2]))
        assert not np.array_equal(moved, warm)
        assert (snap["hits"], snap["misses"], snap["live"]) == (2, 1, 1)

    def test_features_stay_on_the_device(self, pred):
        with InferenceService(pred, max_batch=2, max_wait_s=0.0) as svc:
            svc.predict(_image(), _points(), timeout=60, session_id="s")
            feats = svc._store.get("s").features
            live = svc.health()["sessions"]["live_bytes"]
        assert torch.is_tensor(feats) and feats.device == pred.device
        assert feats.shape == (1, 512, 8, 8) and feats.dtype == pred.dtype
        # a copy of its lane, not a view that keeps the batch alive
        assert feats.untyped_storage().nbytes() == live \
            == pred.feature_struct(1).nbytes

    def test_out_of_crop_click_re_encodes(self, pred):
        img = _image()
        with InferenceService(pred, max_batch=4, max_wait_s=0.0) as svc:
            svc.predict(img, _points(dx=10), timeout=60, session_id="s")
            pts2 = np.array([[2.0, 2.0], [20.0, 18.0], [10.0, 1.0],
                             [11.0, 21.0]])
            moved = svc.predict(img, pts2, timeout=60, session_id="s")
            np.testing.assert_array_equal(
                moved, svc.predict(img, pts2, timeout=60))
            assert svc.health()["sessions"]["misses"] == 2

    def test_another_image_under_the_same_id_re_encodes(self, pred):
        with InferenceService(pred, max_batch=2, max_wait_s=0.0) as svc:
            svc.predict(_image(), _points(), timeout=60, session_id="s")
            other = svc.predict(_image(seed=1), _points(), timeout=60,
                                session_id="s")
            np.testing.assert_array_equal(
                other, svc.predict(_image(seed=1), _points(), timeout=60))
            snap = svc.health()["sessions"]
        assert (snap["hits"], snap["misses"]) == (0, 2)

    def test_decode_batches_across_sessions(self, pred):
        """Warm clicks of three sessions drain into one bucketed decode,
        each within 1e-5 of its session's click served alone (another
        bucket: another batch shape)."""
        img = _image()
        sids = [f"s{i}" for i in range(3)]
        with InferenceService(pred, max_batch=4, max_wait_s=0.5) as svc:
            singles = [svc.predict(img, _points(dx=i), timeout=60,
                                   session_id=sid)
                       for i, sid in enumerate(sids)]
            before = svc.metrics.snapshot()
            futs = [svc.submit(img, _points(dx=i), session_id=sid)
                    for i, sid in enumerate(sids)]
            warm = [f.result(timeout=60) for f in futs]
            after = svc.metrics.snapshot()
            assert svc.health()["sessions"]["hits"] == 3
        for got, want in zip(warm, singles):
            np.testing.assert_allclose(got, want, atol=ATOL)
        assert after["batches_by_bucket"].get("4", 0) \
            - before["batches_by_bucket"].get("4", 0) == 1

    def test_budget_evicts_the_oldest_session(self, pred):
        per = pred.feature_struct(1).nbytes
        img = _image()
        with InferenceService(pred, max_batch=2, max_wait_s=0.0,
                              session_budget_bytes=2 * per) as svc:
            for i in range(3):
                svc.predict(img, _points(dx=i), timeout=60,
                            session_id=f"s{i}")
            snap = svc.health()["sessions"]
            assert (snap["live"], snap["live_bytes"]) == (2, 2 * per)
            assert snap["evictions"]["lru"] == 1
            svc.predict(img, _points(), timeout=60, session_id="s0")
            assert svc.health()["sessions"]["misses"] == 4

    def test_ttl_expired_session_re_encodes(self, pred):
        with InferenceService(pred, max_batch=2, max_wait_s=0.0,
                              session_ttl_s=0.05) as svc:
            svc.predict(_image(), _points(), timeout=60, session_id="s")
            time.sleep(0.1)
            svc.predict(_image(), _points(), timeout=60, session_id="s")
            snap = svc.health()["sessions"]
        assert (snap["hits"], snap["misses"]) == (0, 2)
        assert snap["evictions"]["ttl"] == 1

    @pytest.mark.parametrize("points,match", [
        (np.zeros((3, 2)), "4 xy extreme points"),
        (np.array([[10.0, 10.0], [70.0, 10.0], [20.0, 5.0], [20.0, 30.0]]),
         "outside image")])
    def test_warm_path_validates_clicks(self, pred, points, match):
        with InferenceService(pred, max_batch=2, max_wait_s=0.0) as svc:
            svc.predict(_image(), _points(), timeout=60, session_id="s")
            with pytest.raises(ValueError, match=match):
                svc.submit(_image(), points, session_id="s")
            assert svc.metrics.requests == 1

    def test_session_on_stem_predictor_rejected(self):
        stem = Predictor.fresh(32, "resnet18", device="cpu")
        with InferenceService(stem, max_batch=2) as svc:
            assert svc.health()["sessions"] is None
            with pytest.raises(ValueError, match="guidance_inject"):
                svc.submit(_image(32), _points(32), session_id="s")

    def test_session_lane_shed_is_429_taxonomy(self, pred):
        """One session at its lane cap sheds SessionLaneFullError (a
        QueueFullError); another session is still admitted."""
        img, pts = _image(), _points()
        # not started: requests queue without draining, so the lane fills
        svc = InferenceService(pred, max_batch=2, queue_depth=16,
                               max_wait_s=0.0, session_lane_depth=2)
        for _ in range(2):
            svc.submit(img, pts, session_id="chatty")
        with pytest.raises(SessionLaneFullError) as e:
            svc.submit(img, pts, session_id="chatty")
        assert isinstance(e.value, QueueFullError)
        svc.submit(img, pts, session_id="polite")
        assert svc.metrics.shed_session_lane == 1
        svc.start()
        svc.stop()
        assert svc._lanes == {}


class TestSessionWire:
    @pytest.fixture()
    def server(self, pred):
        svc = InferenceService(pred, max_batch=4, queue_depth=16,
                               max_wait_s=0.002, session_lane_depth=1)
        svc.start()
        httpd = make_server(svc, port=0)
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        try:
            yield svc, f"http://127.0.0.1:{httpd.server_port}"
        finally:
            httpd.shutdown()
            httpd.server_close()
            svc.stop()

    def test_session_roundtrip_and_backcompat(self, server):
        svc, url = server
        client = ServeClient(url)
        img, pts = _image(), _points()
        legacy = client.predict(img, pts)
        cold = client.predict(img, pts, session_id="w")
        warm = client.predict(img, pts, session_id="w")
        np.testing.assert_array_equal(legacy, cold)
        np.testing.assert_array_equal(cold, warm)
        health = client.health()
        assert health["sessions"]["hits"] == 1
        assert health["sessions"]["live"] == 1

    def test_session_lane_429_roundtrips_type(self, server):
        svc, url = server
        client = ServeClient(url)
        img, pts = _image(), _points()
        client.predict(img, pts, session_id="chatty")
        gate = threading.Event()
        decode = svc.predictor.decode
        errs = []

        def gated(*a, **kw):
            gate.wait(timeout=30)
            return decode(*a, **kw)

        def fill():
            try:
                client.predict(img, pts, session_id="chatty")
            except Exception as e:  # noqa: BLE001 — examined below
                errs.append(e)

        svc.predictor.decode = gated
        t1 = threading.Thread(target=fill)
        try:
            t1.start()
            deadline = time.time() + 10
            while svc._lanes.get("chatty", 0) == 0 and time.time() < deadline:
                time.sleep(0.01)
            with pytest.raises(SessionLaneFullError) as e:
                client.predict(img, pts, session_id="chatty")
            assert isinstance(e.value, QueueFullError)
        finally:
            gate.set()
            t1.join(timeout=60)
            del svc.predictor.decode
        assert not errs, errs
        assert svc.metrics.shed_session_lane == 1


@pytest.mark.parametrize("spec,want", [
    ("64:resnet18:0", (64, "resnet18", 0, "stem")),
    ("64:resnet18:3:head", (64, "resnet18", 3, "head")),
    ("512:resnet101:0:stem", (512, "resnet101", 0, "stem")),
])
def test_fresh_spec(spec, want):
    assert parse_fresh_spec(spec) == want


@pytest.mark.parametrize("spec", ["64:resnet18", "64:resnet18:0:neck",
                                  "64:resnet18:head"])
def test_fresh_spec_refused(spec):
    with pytest.raises(SystemExit):
        parse_fresh_spec(spec)
