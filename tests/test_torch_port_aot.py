"""The port's AOT program cache (``serve/aot.py``), the predictor's program
table and the service's warm boot and retrace tripwire, on the CPU.

The cases of the JAX package's ``tests/test_aot.py``: the build and its
round trip (the loaded package within 1e-5 of the eager forward and within
``test_torch_port_predict.py``'s 1e-4 of JAX's ``Predictor`` on the same
weights, bitwise in a fresh process), the warm boot with 0 compiles on the
``CompileWatchdog``, every fingerprint key missing by name, the checksum
refusing a flipped byte (on disk and through the ``serve/aot_load`` chaos
site) and a truncated entry, the typed manifest errors, the service booting
through each, and the ``--verify`` CLI.  DANet-R18 at 32² with
``attention_impl="flash"``: its export holds the three ``dptpu`` kernel
operators, which take their plain forms on CPU tensors.  One AOTInductor
build (bucket 1, through the CLI with an injected predictor) serves the
module; every test that damages the cache copies it first.  The split
ladder is checked through ``torch.export`` alone.
"""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu import predict as jax_predict
from distributedpytorch_tpu.models import build_model as jax_build_model
from distributedpytorch_tpu.serve import aot as jax_aot
from distributedpytorch_tpu_torch.chaos import sites as chaos_sites
from distributedpytorch_tpu_torch.chaos.faults import FaultPlan
from distributedpytorch_tpu_torch.models import build_model
from distributedpytorch_tpu_torch.predict import Predictor
from distributedpytorch_tpu_torch.serve import aot
from distributedpytorch_tpu_torch.serve.aot import (
    AotCache,
    AotCacheError,
    AotCacheMiss,
    cache_fingerprint,
    fingerprint_mismatch,
)
from distributedpytorch_tpu_torch.serve.quantize import quantize_predictor
from distributedpytorch_tpu_torch.serve.service import (
    InferenceService,
    ServiceUnhealthyError,
)
from distributedpytorch_tpu_torch.utils.compile_watchdog import CompileWatchdog
from distributedpytorch_tpu_torch.utils.weights import load_jax_params
from test_torch_port_model import randomize

RES = 32
#: the loaded package against the eager forward on the CPU
EAGER_TOL = 1e-5
#: the port against JAX's Predictor (test_torch_port_predict.py's bound)
JAX_TOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: JAX's warm-up record keys (its service's last_warmup)
WARMUP_KEYS = {"warmup_seconds", "programs_compiled", "programs_loaded",
               "aot_cache", "programs"}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs in several
    processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _image(seed=0):
    return np.random.RandomState(seed).randint(
        0, 256, (40, 48, 3)).astype(np.uint8)


def _points(d=0.0):
    return np.array([[8.0, 20.0], [40.0, 20.0], [24.0, 6.0],
                     [24.0, 34.0]]) + d


@pytest.fixture(scope="module")
def jax_stem():
    """JAX's stem net at 32² on randomized weights."""
    model = jax_build_model("danet", nclass=1, backbone="resnet18",
                            output_stride=8, attention_impl="xla")
    variables = randomize(jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, RES, RES, 4)), train=False)))
    return model, variables


def _port_stem(jax_stem, **kwargs) -> Predictor:
    """A port predictor on JAX's weights, its kernels' operators in the
    graph (``flash``; the plain forms run inside them on the CPU)."""
    _, variables = jax_stem
    model = build_model("danet", nclass=1, backbone="resnet18",
                        output_stride=8, attention_impl="flash")
    load_jax_params(model, variables["params"], variables["batch_stats"])
    return Predictor(model, resolution=(RES, RES), relax=10, device="cpu",
                     **kwargs)


@pytest.fixture(scope="module")
def stem_cache(jax_stem, tmp_path_factory):
    """The module's one build: bucket 1 of the stem ladder, through the CLI
    with an injected predictor, under a CompileWatchdog."""
    d = str(tmp_path_factory.mktemp("aot_stem"))
    pred = _port_stem(jax_stem)
    out = io.StringIO()
    with CompileWatchdog() as wd, contextlib.redirect_stdout(out):
        rc = aot.main(["--cache-dir", d, "--max-batch", "1"], predictor=pred)
    return {"cache": AotCache(d), "rc": rc, "summary": json.loads(
        out.getvalue()), "counts": dict(wd.counts), "pred": pred}


def _copy(stem_cache, tmp_path, tag) -> str:
    d = str(tmp_path / tag)
    shutil.copytree(stem_cache["cache"].cache_dir, d)
    return d


def _entry_path(d, name="forward_b1") -> tuple[str, dict]:
    ent = AotCache(d).manifest()["entries"][name]
    return os.path.join(d, ent["file"]), ent


def _x(pred, b=1):
    crops = [pred.prepare(_image(), _points(i))[0] for i in range(b)]
    return torch.from_numpy(np.stack(crops))


class TestBuildAndVerify:
    def test_build_with_injected_predictor(self, stem_cache):
        summary = stem_cache["summary"]
        assert stem_cache["rc"] == 0
        assert summary["programs"] == ["forward_b1"]
        assert summary["seconds"]["forward_b1"] > 0
        assert summary["fingerprint"] == cache_fingerprint(stem_cache["pred"])

    def test_build_writes_entries_and_manifest(self, stem_cache):
        cache = stem_cache["cache"]
        man = cache.manifest()
        assert set(man["entries"]) == {"forward_b1"}
        for ent in man["entries"].values():
            path = os.path.join(cache.cache_dir, ent["file"])
            assert os.path.getsize(path) == ent["bytes"]
        assert man["fingerprint"]["params_digest"]
        # nothing but the packages and the manifest is left behind
        assert sorted(os.listdir(cache.cache_dir)) == ["forward_b1.pt2",
                                                       "manifest.json"]

    def test_build_compiles_each_program_fresh(self, stem_cache):
        """The build's Inductor graph compile is counted by the watchdog:
        Inductor's caches are off, so a second build could not be served
        from the first one's."""
        assert stem_cache["counts"].get("inductor", 0) >= 1
        assert stem_cache["summary"]["compiles"]["inductor"] >= 1

    def test_package_bakes_the_weights(self, stem_cache):
        weights = sum(t.numel() * t.element_size() for t in
                      stem_cache["pred"].model.state_dict().values())
        assert stem_cache["summary"]["bytes"] >= weights

    def test_verify_clean(self, stem_cache):
        rep = stem_cache["cache"].verify()
        assert rep["entries"] == 1 and not rep["bad"] and not rep["missing"]


class TestPrograms:
    def test_exported_graph_holds_the_kernel_operators(self, jax_stem):
        """A ``flash`` model's exported forward calls the three dptpu
        operators and traces none of their plain forms (no softmax, no
        batched product); an ``xla`` model's traces them."""
        pred = _port_stem(jax_stem)
        name, module, meta, _ = aot.ladder_programs(pred, (1,))[0]
        targets = [str(n.target) for n in aot.export_program(
            module, aot.example_inputs(meta, pred.device)).graph.nodes]
        ops = sorted(t for t in targets if "dptpu" in t)
        assert ops == ["dptpu.cam_apply.default", "dptpu.cam_energy.default",
                       "dptpu.pam_forward.default"]
        assert not [t for t in targets if "softmax" in t or "bmm" in t]
        pred.model.set_attention_impl("xla")
        plain = [str(n.target) for n in aot.export_program(
            module, aot.example_inputs(meta, pred.device)).graph.nodes]
        assert not [t for t in plain if "dptpu" in t]
        assert [t for t in plain if "softmax" in t]

    def test_operators_are_the_wrappers(self):
        """Each dptpu operator gives its wrapper's result on CPU tensors, and
        its fake implementation (the meta kernel) only the output's shape
        and dtype."""
        from distributedpytorch_tpu_torch.ops import cuda_attention as ca

        g = torch.Generator().manual_seed(0)
        q, k = (torch.randn(2, 40, 8, generator=g) for _ in range(2))
        v, x = (torch.randn(2, 40, 16, generator=g) for _ in range(2))
        attn = ca.cam_energy(x)
        assert torch.equal(torch.ops.dptpu.pam_forward(q, k, v, 16, None),
                           ca.flash_position_attention(q, k, v, block_k=16))
        assert torch.equal(torch.ops.dptpu.cam_energy(x), attn)
        assert torch.equal(torch.ops.dptpu.cam_apply(attn, x),
                           ca.cam_apply(attn, x))

        def meta(*shape, dtype=torch.float32):
            return torch.empty(shape, dtype=dtype, device="meta")

        out = torch.ops.dptpu.pam_forward(meta(2, 40, 8), meta(2, 40, 8),
                                          meta(2, 40, 16, dtype=torch.bfloat16),
                                          16, 0.5)
        assert (out.shape, out.dtype) == ((2, 40, 16), torch.bfloat16)
        out = torch.ops.dptpu.cam_energy(meta(2, 40, 16, dtype=torch.bfloat16))
        assert (out.shape, out.dtype) == ((2, 16, 16), torch.float32)
        out = torch.ops.dptpu.cam_apply(meta(2, 16, 16),
                                        meta(2, 40, 16, dtype=torch.bfloat16))
        assert (out.shape, out.dtype) == ((2, 40, 16), torch.bfloat16)
        with pytest.raises(ValueError, match="expected"):
            torch.ops.dptpu.cam_apply(meta(2, 8, 8), meta(2, 40, 16))

    def test_stem_program_is_forward_prepared(self, jax_stem):
        pred = _port_stem(jax_stem, mean=(120.0, 110.0, 100.0, 0.0),
                          std=(60.0, 61.0, 62.0, 255.0))
        x = _x(pred, 2)
        _, module, _, _ = aot.ladder_programs(pred, (2,))[0]
        with torch.inference_mode():
            got = module(x).numpy()
        np.testing.assert_array_equal(got, pred.forward_prepared(x.numpy()))

    def test_split_ladder_names_and_keys_match_jax(self, split_pair):
        port, ref = split_pair
        got = aot.ladder_programs(port, (1, 2))
        want = jax_aot.ladder_programs(ref, (1, 2))
        assert [p[0] for p in got] == [p[0] for p in want] == [
            "encode_b1", "decode_b1", "encode_b2", "decode_b2"]
        assert [p[3] for p in got] == [p[3] for p in want]
        # the example inputs carry JAX's shapes, in the port's layouts
        enc, dec = got[2][2], got[3][2]
        assert tuple(enc[0].shape) == want[2][2][0].shape
        assert tuple(dec[1].shape) == want[3][2][1].shape
        assert dec[0].shape[0] == 2 and enc[0].device.type == "meta"

    def test_split_programs_export_and_are_the_stages(self, split_pair):
        port, _ = split_pair
        x = _x(port, 2).numpy()
        progs = {p[0]: p for p in aot.ladder_programs(port, (2,))}
        _, enc, enc_meta, _ = progs["encode_b2"]
        _, dec, dec_meta, _ = progs["decode_b2"]
        for module, meta, kernels in ((enc, enc_meta, 0), (dec, dec_meta, 3)):
            ep = aot.export_program(module, aot.example_inputs(meta, "cpu"))
            ops = [n for n in ep.graph.nodes if "dptpu" in str(n.target)]
            assert len(ops) == kernels
        with torch.inference_mode():
            feats = enc(torch.from_numpy(x[..., :-1]))
            probs = dec(feats, torch.from_numpy(x[..., -1:])).numpy()
        want_feats = port.encode(x[..., :-1])
        assert torch.equal(feats, want_feats)
        np.testing.assert_array_equal(probs,
                                      port.decode(want_feats, x[..., -1:]))

    def test_moe_head_exports(self):
        """The MoE head's index form has no data-dependent shape: its
        ladder exports, so the build refuses nothing."""
        model = build_model("danet", nclass=1, backbone="resnet18",
                            output_stride=8, moe_experts=2, moe_k=2)
        pred = Predictor(model, resolution=(RES, RES), device="cpu")
        _, module, meta, _ = aot.ladder_programs(pred, (1,))[0]
        ep = aot.export_program(module, aot.example_inputs(meta, "cpu"))
        assert any("index_add" in str(n.target) for n in ep.graph.nodes)


@pytest.fixture(scope="module")
def split_pair():
    """The port's split predictor (``guidance_inject="head"``, flash) and
    JAX's, on the same randomized weights."""
    model = jax_build_model("danet", nclass=1, backbone="resnet18",
                            output_stride=8, attention_impl="xla",
                            guidance_inject="head")
    variables = randomize(jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, RES, RES, 4)), train=False)))
    ref = jax_predict.Predictor(model, variables["params"],
                                variables["batch_stats"],
                                resolution=(RES, RES), relax=10)
    port_model = build_model("danet", nclass=1, backbone="resnet18",
                             output_stride=8, attention_impl="flash",
                             guidance_inject="head")
    load_jax_params(port_model, variables["params"], variables["batch_stats"])
    return Predictor(port_model, resolution=(RES, RES), relax=10,
                     device="cpu"), ref


class TestRoundTrip:
    def test_loaded_package_matches_eager_and_jax(self, stem_cache, jax_stem):
        cache, pred = stem_cache["cache"], stem_cache["pred"]
        program = cache.load("forward_b1", cache_fingerprint(pred))
        x = _x(pred)
        with torch.inference_mode():
            got = program(x).numpy()
        assert got.shape == (1, RES, RES) and got.dtype == np.float32
        eager = pred.forward_prepared(x.numpy())
        assert float(np.abs(got - eager).max()) <= EAGER_TOL
        model, variables = jax_stem
        ref = jax_predict.Predictor(model, variables["params"],
                                    variables["batch_stats"],
                                    resolution=(RES, RES), relax=10)
        want = ref.forward_prepared(x.numpy())
        assert 0.0 < float(want.max()) < 1.0
        assert float(np.abs(got - want).max()) <= JAX_TOL

    def test_repeat_runs_are_bitwise(self, stem_cache):
        cache, pred = stem_cache["cache"], stem_cache["pred"]
        program = cache.load("forward_b1", cache_fingerprint(pred))
        x = _x(pred)
        with torch.inference_mode():
            assert torch.equal(program(x), program(x))

    def test_loading_compiles_nothing(self, stem_cache):
        cache, pred = stem_cache["cache"], stem_cache["pred"]
        fp = cache_fingerprint(pred)
        with CompileWatchdog() as wd:
            program = cache.load("forward_b1", fp)
            with torch.inference_mode():
                program(_x(pred))
        assert wd.total == 0, dict(wd.counts)

    def test_install_dispatches_at_its_shape_only(self, stem_cache, jax_stem):
        cache, pred = stem_cache["cache"], stem_cache["pred"]
        fresh = _port_stem(jax_stem)
        program = cache.load("forward_b1", cache_fingerprint(pred))
        calls = []

        def counted(x):
            calls.append(tuple(x.shape))
            return program(x)

        with pytest.raises(ValueError, match="does not match"):
            fresh.install_aot(("encode", 1), program)
        fresh.install_aot(("forward", (1, RES, RES, 4)), counted)
        assert fresh.aot_programs == [("forward", (1, RES, RES, 4))]
        x = _x(pred, 2).numpy()
        one = fresh.forward_prepared(x[:1])
        two = fresh.forward_prepared(x)
        assert calls == [(1, RES, RES, 4)]
        np.testing.assert_array_equal(two, pred.forward_prepared(x))
        assert float(np.abs(one - two[:1]).max()) <= EAGER_TOL

    def test_fresh_process_round_trip(self, stem_cache, tmp_path):
        """A process that never built the program loads the entry and gives
        bitwise this process's loaded output, without importing Inductor."""
        cache, pred = stem_cache["cache"], stem_cache["pred"]
        x = _x(pred).numpy()
        inp, out = str(tmp_path / "x.npy"), str(tmp_path / "probs.npy")
        np.save(inp, x)
        with torch.inference_mode():
            want = cache.load("forward_b1", cache_fingerprint(pred))(
                torch.from_numpy(x)).numpy()
        code = f"""
import sys
import numpy as np, torch
torch.set_num_threads(2)
from distributedpytorch_tpu_torch.serve.aot import AotCache
cache = AotCache({cache.cache_dir!r})
program = cache.load("forward_b1", cache.manifest()["fingerprint"])
with torch.inference_mode():
    np.save({out!r}, program(torch.from_numpy(np.load({inp!r}))).numpy())
assert "torch._inductor" not in sys.modules
print("fresh-ok")
"""
        r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, timeout=300, cwd=REPO,
                           env=dict(os.environ, PYTHONPATH=REPO))
        assert r.returncode == 0, r.stderr[-2000:]
        assert "fresh-ok" in r.stdout
        np.testing.assert_array_equal(np.load(out), want)


class TestWarmBoot:
    def test_zero_compile_warm_boot_watchdog_verified(self, stem_cache,
                                                      jax_stem):
        """A boot from the cache compiles nothing through its warm-up and
        the traffic after it, counted by a CompileWatchdog around both."""
        fresh = _port_stem(jax_stem)
        svc = InferenceService(fresh, max_batch=1, max_wait_s=0.0,
                               aot_cache=stem_cache["cache"])
        img = _image()
        with CompileWatchdog() as wd:
            warm = svc.warmup()
            with svc:
                m1 = svc.predict(img, _points(), timeout=120)
                m2 = svc.predict(img, _points(1), timeout=120)
        assert set(warm) == WARMUP_KEYS
        assert warm["aot_cache"] == "hit"
        assert warm["programs_compiled"] == 0 and warm["programs_loaded"] == 1
        assert wd.total == 0, dict(wd.counts)
        assert fresh.aot_programs == [("forward", (1, RES, RES, 4))]
        want = stem_cache["pred"].predict(img, _points())
        assert float(np.abs(m1 - want).max()) <= EAGER_TOL
        assert np.isfinite(m2).all()
        assert svc.metrics.retrace_failures == 0
        assert svc.health()["unhealthy_reason"] is None

    def test_warmup_measures_and_logs_either_way(self, jax_stem, capsys):
        """No cache: every program warms eagerly, and the record and the
        stderr lines say so."""
        svc = InferenceService(_port_stem(jax_stem), max_batch=2,
                               max_wait_s=0.0)
        warm = svc.warmup()
        assert set(warm) == WARMUP_KEYS and svc.last_warmup is warm
        assert warm["aot_cache"] == "off"
        assert warm["programs_compiled"] == 2 and warm["programs_loaded"] == 0
        assert warm["warmup_seconds"] > 0
        assert [e["program"] for e in warm["programs"]] \
            == ["forward_b1", "forward_b2"]
        assert all(e["outcome"] == "eager" and e["fallback"] is None
                   and e["ms"] >= 0 for e in warm["programs"])
        assert "serve/warmup: forward_b1: eager" in capsys.readouterr().err

    def test_partial_boot_loads_what_the_cache_has(self, stem_cache, jax_stem,
                                                   capsys):
        svc = InferenceService(_port_stem(jax_stem), max_batch=2,
                               max_wait_s=0.0, aot_cache=stem_cache["cache"])
        warm = svc.warmup()
        assert warm["aot_cache"] == "partial"
        outcomes = {e["program"]: (e["outcome"], e["fallback"])
                    for e in warm["programs"]}
        assert outcomes == {"forward_b1": ("load", None),
                            "forward_b2": ("eager", "miss")}
        assert "serve/aot: miss for 'forward_b2'" in capsys.readouterr().err
        with svc:
            assert np.isfinite(svc.predict(_image(), _points(),
                                           timeout=120)).all()

    def test_split_boot_warms_both_stages(self, split_pair, tmp_path):
        """A split predictor's cache miss (nothing built) warms its encode
        and decode eagerly per bucket, and serves sessions."""
        port, _ = split_pair
        svc = InferenceService(port, max_batch=2, max_wait_s=0.0,
                               aot_cache=str(tmp_path / "none"))
        warm = svc.warmup()
        assert warm["aot_cache"] == "miss" and warm["programs_loaded"] == 0
        assert [e["program"] for e in warm["programs"]] == [
            "encode_b1", "decode_b1", "encode_b2", "decode_b2"]
        with svc:
            cold = svc.predict(_image(), _points(), timeout=120,
                               session_id="s")
            hot = svc.predict(_image(), _points(1), timeout=120,
                              session_id="s")
        assert np.isfinite(cold).all() and np.isfinite(hot).all()
        assert svc.health()["sessions"]["hits"] >= 1
        assert svc.metrics.retrace_failures == 0


class TestFallbackMatrix:
    """Every way a cache can lie, and the typed refusal each earns."""

    def test_missing_manifest_is_miss(self, tmp_path, stem_cache):
        with pytest.raises(AotCacheMiss, match="no AOT manifest"):
            AotCache(str(tmp_path)).load(
                "forward_b1", cache_fingerprint(stem_cache["pred"]))

    @pytest.mark.parametrize("key,bogus", [
        ("cache_version", 0), ("torch", "0.0.0"), ("cuda", "99.9"),
        ("platform", "cuda"), ("device", "NVIDIA H100 80GB HBM3 sm_90"),
        ("resolution", [512, 512]), ("in_channels", 3), ("split", True),
        ("model", {"name": "danet", "output_stride": 16}), ("code", "0" * 64),
        ("dtype", "bfloat16"), ("normalize", [[0.0], [1.0]]),
        ("quantization", {"weight_dtype": "int8"}),
        ("params_digest", "deadbeef")])
    def test_each_fingerprint_key_misses_naming_itself(self, stem_cache, key,
                                                       bogus):
        good = cache_fingerprint(stem_cache["pred"])
        assert key in good and good[key] != bogus
        with pytest.raises(AotCacheMiss, match=f"{key}: cached") as e:
            stem_cache["cache"].load("forward_b1", dict(good, **{key: bogus}))
        assert str(e.value).count(": cached") == 1

    def test_another_output_stride_misses_by_name(self, stem_cache,
                                                  jax_stem):
        """``output_stride`` changes the forward, not the ``state_dict``:
        the ``model`` key alone tells the two apart."""
        _, variables = jax_stem
        model = build_model("danet", nclass=1, backbone="resnet18",
                            output_stride=16, attention_impl="flash")
        load_jax_params(model, variables["params"], variables["batch_stats"])
        pred = Predictor(model, resolution=(RES, RES), relax=10, device="cpu")
        with pytest.raises(AotCacheMiss) as e:
            stem_cache["cache"].load("forward_b1", cache_fingerprint(pred))
        assert str(e.value).count(": cached") == 1
        assert "model: cached" in str(e.value)

    def test_a_model_not_built_by_build_model_has_no_key(self, jax_stem):
        pred = _port_stem(jax_stem)
        del pred.model.build_args
        with pytest.raises(ValueError, match="build_model"):
            cache_fingerprint(pred)

    def test_code_digest_follows_the_traced_sources(self, tmp_path,
                                                    monkeypatch):
        """An edit to the model's code changes the ``code`` key; an edit
        to a module no package traces does not."""
        root = str(tmp_path / "pkg")
        shutil.copytree(aot._PACKAGE_ROOT, root,
                        ignore=shutil.ignore_patterns("__pycache__", "csrc"))
        monkeypatch.setattr(aot, "_PACKAGE_ROOT", root)
        digest = aot.code_fingerprint()
        assert digest == aot.code_fingerprint()
        with open(os.path.join(root, "serve", "service.py"), "a") as f:
            f.write("# not traced\n")
        assert aot.code_fingerprint() == digest
        with open(os.path.join(root, "models", "danet.py"), "a") as f:
            f.write("# a fix to the head\n")
        assert aot.code_fingerprint() != digest

    def test_fingerprint_mismatch_names_all_differing_keys(self):
        saved = {"a": 1, "b": 2}
        live = {"a": 1, "b": 3, "c": 4}
        names = " ".join(fingerprint_mismatch(saved, live))
        assert "b:" in names and "c:" in names and "a:" not in names
        assert fingerprint_mismatch(live, dict(live)) == []

    def test_absent_program_is_miss(self, stem_cache):
        with pytest.raises(AotCacheMiss, match="forward_b8"):
            stem_cache["cache"].load(
                "forward_b8", cache_fingerprint(stem_cache["pred"]))

    def test_missing_package_file_is_miss(self, stem_cache, tmp_path):
        d = _copy(stem_cache, tmp_path, "gone")
        os.remove(_entry_path(d)[0])
        with pytest.raises(AotCacheMiss, match="file missing"):
            AotCache(d).load("forward_b1",
                             cache_fingerprint(stem_cache["pred"]))
        assert AotCache(d).verify()["missing"] == ["forward_b1"]

    def test_bitflipped_entry_is_checksum_error(self, stem_cache, tmp_path):
        d = _copy(stem_cache, tmp_path, "flip")
        path, ent = _entry_path(d)
        with open(path, "r+b") as f:
            f.seek(ent["bytes"] // 2)
            byte = f.read(1)
            f.seek(ent["bytes"] // 2)
            f.write(bytes([byte[0] ^ 0xFF]))
        with pytest.raises(AotCacheError, match="checksum"):
            AotCache(d).load("forward_b1",
                             cache_fingerprint(stem_cache["pred"]))
        assert AotCache(d).verify()["bad"] == ["forward_b1"]

    def test_chaos_bitflip_at_aot_load_is_checksum_error(self, stem_cache):
        """A ``bitflip`` armed at ``serve/aot_load`` flips a byte between the
        disk and the checksum: the load refuses it, the file is intact."""
        plan = FaultPlan.from_dict({"name": "rot", "faults": [
            {"site": "serve/aot_load", "kind": "bitflip", "offset": 4096}]})
        cache = stem_cache["cache"]
        fp = cache_fingerprint(stem_cache["pred"])
        with chaos_sites.armed_plan(plan):
            with pytest.raises(AotCacheError, match="checksum"):
                cache.load("forward_b1", fp)
        assert [f[0] for f in plan.firings] == ["serve/aot_load"]
        assert cache.verify()["bad"] == []
        cache.load("forward_b1", fp)

    def test_truncated_entry_is_checksum_error(self, stem_cache, tmp_path):
        d = _copy(stem_cache, tmp_path, "trunc")
        path, ent = _entry_path(d)
        with open(path, "r+b") as f:
            f.truncate(ent["bytes"] // 2)
        with pytest.raises(AotCacheError, match="checksum"):
            AotCache(d).load("forward_b1",
                             cache_fingerprint(stem_cache["pred"]))

    def test_schema_corrupt_manifest_is_typed_error(self, stem_cache,
                                                    tmp_path):
        """Valid JSON, a mangled entry record: a typed error (a boot warms
        eagerly), never a TypeError escaping the warm-up."""
        d = _copy(stem_cache, tmp_path, "schema")
        bad = AotCache(d)
        man = bad.manifest()
        man["entries"]["forward_b1"] = "not-a-record"
        with open(bad.manifest_path(), "w") as f:
            json.dump(man, f)
        with pytest.raises(AotCacheError, match="malformed"):
            bad.load("forward_b1", cache_fingerprint(stem_cache["pred"]))
        svc = InferenceService(stem_cache["pred"], max_batch=1,
                               max_wait_s=0.0, aot_cache=d)
        warm = svc.warmup()
        assert warm["programs"][0]["fallback"] == "error"
        with svc:
            assert np.isfinite(svc.predict(_image(), _points(),
                                           timeout=120)).all()

    def test_torn_manifest_is_typed_error(self, stem_cache, tmp_path):
        d = _copy(stem_cache, tmp_path, "tornman")
        man_path = os.path.join(d, aot.MANIFEST)
        with open(man_path, "r+b") as f:
            f.truncate(os.path.getsize(man_path) // 2)
        with pytest.raises(AotCacheError, match="manifest"):
            AotCache(d).load("forward_b1",
                             cache_fingerprint(stem_cache["pred"]))

    def test_service_boot_survives_every_fallback(self, stem_cache, jax_stem,
                                                  tmp_path, capsys):
        """A rotten entry warms eagerly with a loud line, the absent one
        too, and the service serves the eager forward's masks."""
        d = _copy(stem_cache, tmp_path, "rotten")
        with open(_entry_path(d)[0], "r+b") as f:
            f.truncate(1)
        fresh = _port_stem(jax_stem)
        svc = InferenceService(fresh, max_batch=2, max_wait_s=0.0,
                               aot_cache=d)
        warm = svc.warmup()
        with svc:
            mask = svc.predict(_image(), _points(), timeout=120)
        assert warm["aot_cache"] == "miss" and fresh.aot_programs == []
        outcomes = {e["program"]: (e["outcome"], e["fallback"])
                    for e in warm["programs"]}
        assert outcomes == {"forward_b1": ("eager", "error"),
                            "forward_b2": ("eager", "miss")}
        np.testing.assert_array_equal(
            mask, stem_cache["pred"].predict(_image(), _points()))
        assert "REFUSING cache entry 'forward_b1'" in capsys.readouterr().err

    def test_failed_fingerprint_disables_the_cache(self, stem_cache, jax_stem,
                                                   monkeypatch, capsys):
        def broken(pred):
            raise RuntimeError("no digest")

        monkeypatch.setattr(aot, "cache_fingerprint", broken)
        svc = InferenceService(_port_stem(jax_stem), max_batch=1,
                               max_wait_s=0.0, aot_cache=stem_cache["cache"])
        warm = svc.warmup()
        assert warm["aot_cache"] == "miss"
        assert warm["programs"][0]["outcome"] == "eager"
        assert "cache disabled for this boot" in capsys.readouterr().err

    def test_quantized_and_f32_caches_never_cross(self, stem_cache):
        """The int8 twin of the cached weights misses on both its
        quantization block and its weights' digest."""
        qfp = cache_fingerprint(quantize_predictor(stem_cache["pred"]))
        with pytest.raises(AotCacheMiss) as e:
            stem_cache["cache"].load("forward_b1", qfp)
        assert "quantization" in str(e.value)
        assert "params_digest" in str(e.value)

    def test_bf16_and_f32_caches_never_cross(self, stem_cache, jax_stem):
        bf16 = _port_stem(jax_stem, dtype=torch.bfloat16)
        with pytest.raises(AotCacheMiss) as e:
            stem_cache["cache"].load("forward_b1", cache_fingerprint(bf16))
        assert str(e.value).count(": cached") == 1 and "dtype" in str(e.value)


class TestVerifyCli:
    def test_verify_clean_exits_zero(self, stem_cache, capsys):
        rc = aot.main(["--cache-dir", stem_cache["cache"].cache_dir,
                       "--verify"])
        assert rc == 0
        assert json.loads(capsys.readouterr().out)["entries"] == 1

    def test_verify_names_bad_entries_nonzero(self, stem_cache, tmp_path,
                                              capsys):
        d = _copy(stem_cache, tmp_path, "bad")
        with open(_entry_path(d)[0], "r+b") as f:
            f.truncate(3)
        rc = aot.main(["--cache-dir", d, "--verify"])
        captured = capsys.readouterr()
        assert rc == 1
        assert "forward_b1" in captured.err
        assert json.loads(captured.out)["bad"] == ["forward_b1"]

    def test_verify_missing_cache_exits_two(self, tmp_path, capsys):
        rc = aot.main(["--cache-dir", str(tmp_path / "nope"), "--verify"])
        assert rc == 2
        assert "manifest" in capsys.readouterr().err

    def test_build_without_source_errors(self, tmp_path):
        with pytest.raises(SystemExit):
            aot.main(["--cache-dir", str(tmp_path)])

    @pytest.mark.parametrize("flag,quantized", [([], False),
                                                (["--quantize", "int8"], True)])
    def test_build_resolves_the_servers_model_source(self, tmp_path,
                                                     monkeypatch, capsys,
                                                     flag, quantized):
        """``--fresh-init``/``--device``/``--quantize``/``--max-batch`` give
        the predictor and ladder the server would warm (the build itself
        replaced by a recorder)."""
        seen = {}

        def build(self, predictor, buckets):
            seen.update(pred=predictor, buckets=tuple(buckets))
            return {"programs": []}

        monkeypatch.setattr(AotCache, "build", build)
        rc = aot.main(["--cache-dir", str(tmp_path), "--fresh-init",
                       f"{RES}:resnet18:0", "--device", "cpu",
                       "--max-batch", "4", *flag])
        assert rc == 0 and seen["buckets"] == (1, 2, 4)
        want = Predictor.fresh(RES, "resnet18", seed=0, device="cpu")
        if quantized:
            want = quantize_predictor(want)
        assert cache_fingerprint(seen["pred"]) == cache_fingerprint(want)
        assert (seen["pred"].quant_policy is not None) == quantized


class TestServeCli:
    def test_boot_line_cold_start(self, stem_cache, jax_stem):
        """``--aot-cache`` reaches the service; the boot line's
        ``cold_start`` is the warm-up's block, null without ``--warmup``."""
        from distributedpytorch_tpu_torch.serve.__main__ import (
            boot_record,
            make_parser,
        )

        d = stem_cache["cache"].cache_dir
        args = make_parser().parse_args(["--fresh-init", f"{RES}:resnet18:0",
                                         "--device", "cpu", "--max-batch",
                                         "1", "--warmup", "--aot-cache", d])
        assert args.aot_cache == d
        pred = _port_stem(jax_stem)
        svc = InferenceService(pred, max_batch=1, aot_cache=args.aot_cache)
        assert boot_record(args, pred, svc, 1)["cold_start"] is None
        svc.warmup()
        cold = boot_record(args, pred, svc, 1)["cold_start"]
        assert set(cold) == WARMUP_KEYS - {"programs"}
        assert cold["aot_cache"] == "hit" and cold["programs_loaded"] == 1


def _compile_on_call(pred):
    """``pred.forward_prepared`` made to compile a new function on every
    call (``torch.compile``, eager backend): a serving path that retraces."""
    original = pred.forward_prepared
    tags = iter(range(1_000_000))

    def forward(x):
        tag = f"svc_retrace_{id(pred)}_{next(tags)}"

        def fn(t):
            return t + 1

        code = fn.__code__.replace(co_name=tag)
        torch.compile(types.FunctionType(code, fn.__globals__, tag),
                      backend="eager")(torch.ones(2))
        return original(x)

    pred.forward_prepared = forward


class TestRetraceTripwire:
    def test_eager_boot_imports_no_compiler(self):
        """The lifetime watchdog costs an eager server no import: a boot,
        its warm-up and a request leave Dynamo and Inductor unimported."""
        code = """
import sys
import numpy as np, torch
torch.set_num_threads(2)
from distributedpytorch_tpu_torch.predict import Predictor
from distributedpytorch_tpu_torch.serve.service import InferenceService
svc = InferenceService(Predictor.fresh(32, "resnet18", device="cpu"),
                       max_batch=1, max_wait_s=0.0)
svc.warmup()
with svc:
    image = np.zeros((40, 48, 3), np.uint8)
    points = np.array([[8.0, 20.0], [40.0, 20.0], [24.0, 6.0], [24.0, 34.0]])
    assert svc.predict(image, points, timeout=120).shape == (40, 48)
print(sorted(m for m in ("torch._dynamo", "torch._inductor")
             if m in sys.modules))
"""
        r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, timeout=300, cwd=REPO,
                           env=dict(os.environ, PYTHONPATH=REPO))
        assert r.returncode == 0, r.stderr[-2000:]
        assert r.stdout.strip().splitlines()[-1] == "[]"

    def test_warmed_buckets_read_zero(self, jax_stem):
        svc = InferenceService(_port_stem(jax_stem), max_batch=2,
                               max_wait_s=0.0)
        svc.warmup()
        with svc:
            for i in range(3):
                svc.predict(_image(i), _points(), timeout=120)
            health = svc.health()
        assert svc.metrics.retrace_failures == 0
        assert health["ok"] and health["unhealthy_reason"] is None
        assert svc.compile_counts == {}

    def test_a_compile_on_the_worker_trips_it(self, jax_stem):
        pred = _port_stem(jax_stem)
        svc = InferenceService(pred, max_batch=1, max_wait_s=0.0)
        svc.warmup()
        _compile_on_call(pred)
        with svc:
            svc.predict(_image(), _points(), timeout=120)
            health = svc.health()
            with pytest.raises(ServiceUnhealthyError, match="retrace"):
                svc.submit(_image(), _points())
        assert svc.metrics.retrace_failures >= 1
        assert not health["ok"]
        assert "steady-state retrace" in health["unhealthy_reason"]
        assert sum(svc.compile_counts.values()) == 1

    def test_lenient_service_keeps_serving(self, jax_stem):
        pred = _port_stem(jax_stem)
        svc = InferenceService(pred, max_batch=1, max_wait_s=0.0,
                               strict_retrace=False)
        svc.warmup()
        _compile_on_call(pred)
        with svc:
            for i in range(2):
                assert np.isfinite(svc.predict(_image(i), _points(),
                                               timeout=120)).all()
        assert svc.metrics.retrace_failures >= 1
        assert svc.health()["unhealthy_reason"]

    def test_a_cold_bucket_has_one_compile_of_budget(self, jax_stem):
        """JAX's budget: one compile per batch shape dispatched that no
        warm-up readied."""
        pred = _port_stem(jax_stem)
        svc = InferenceService(pred, max_batch=1, max_wait_s=0.0)
        _compile_on_call(pred)
        with svc:
            svc.predict(_image(), _points(), timeout=120)
        assert svc.metrics.retrace_failures == 0

    def test_swapped_generation_registers_its_own_shapes(self, jax_stem):
        pred = _port_stem(jax_stem)
        svc = InferenceService(pred, max_batch=1, max_wait_s=0.0)
        svc.warmup()
        new = _port_stem(jax_stem)
        svc.swap(new, canary_fraction=1.0)
        keys = {k[2] for k in svc._warm_shapes}
        assert keys == {id(pred), id(new)}
        with svc:
            svc.predict(_image(), _points(), timeout=120)
        assert ("forward", 1, id(new)) in svc._shapes_dispatched
        assert svc.metrics.retrace_failures == 0


def test_serve_namespace_exports_jax_aot_names():
    from distributedpytorch_tpu import serve as jax_serve
    from distributedpytorch_tpu_torch import serve

    names = ("AotCache", "AotCacheError", "AotCacheMiss")
    assert all(n in jax_serve.__all__ or hasattr(jax_serve, n) for n in names)
    assert all(getattr(serve, n) is getattr(aot, n) for n in names)
    assert set(names) <= set(serve.__all__)


def test_aot_load_site_fires_in_the_port():
    """``serve/aot_load`` is no longer among the sites that never fire."""
    doc = chaos_sites.__doc__.split("never fire")[0].rsplit(":data:", 1)[1]
    assert "serve/aot_load" not in doc
    assert "serve/aot_load" in chaos_sites.SITES
