"""int8 weight-only serving of the port (``serve/quantize.py``) against the
JAX package's ``serve/quantize.py``, on the CPU.

The networks are DANet-R18 at 64² (``guidance_inject`` stem and head, and
a MoE head for the weight selection), every leaf drawn from numpy, carried
into the port with ``load_jax_params``; the head model's ``guidance_proj``
is drawn at 0.02 with its first output channel zero (a zero channel
quantizes with scale 1.0).

* The leaf quantizer: ``q`` and ``scale`` bitwise JAX's ``_quantize_leaf``
  (torch's layout against flax's), zero channels and the [-127, 127] range
  included; the quantized set is JAX's ``kernel`` leaves with >= 2 dims
  under ``jax_to_state_dict``'s names, the MoE's stacks left float32; the
  byte report key for key JAX's.
* The int8 forward: the stem predictor's ``forward_prepared`` and the head
  predictor's encode and decode within 1e-5 of JAX's ``QuantizedPredictor``
  at buckets 1 and 4; int8 against float32 within the band JAX documents
  (max abs 0.25, mean abs 0.02), the mask IoU at 0.5 equal to JAX's within
  one pixel of the union (not gated at 0.99: random weights); two forwards
  bitwise; the base predictor and its outputs untouched.
* Composition: warm, cold and stateless session clicks bitwise; an int8
  canary swapped into a float32 service and rolled back; a float32 state
  swapped onto an int8 active generation.
* The knob: ``model.quantization=int8`` in ``config.json`` and accepted by
  the ``Trainer``; the serve CLI resolving ``--quantize`` against the run's
  config as JAX's ``build_predictor`` does, an unknown value raising JAX's
  ``ValueError``, the boot line's ``quantization`` block.
* ``SemanticPredictor``'s ``mean``/``std`` against JAX's.
"""

import argparse
import copy
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu import predict as jax_predict
from distributedpytorch_tpu.models import build_model as jax_build_model
from distributedpytorch_tpu.serve import __main__ as jax_serve_main
from distributedpytorch_tpu.serve import quantize as jax_quantize
from distributedpytorch_tpu.train import config as jax_config
from distributedpytorch_tpu_torch import predict
from distributedpytorch_tpu_torch.models import build_model
from distributedpytorch_tpu_torch.models.resnet import Conv2d
from distributedpytorch_tpu_torch.predict import Predictor, SemanticPredictor
from distributedpytorch_tpu_torch.serve import quantize
from distributedpytorch_tpu_torch.serve.__main__ import (
    boot_record,
    build_predictor,
    make_parser,
)
from distributedpytorch_tpu_torch.serve.service import InferenceService
from distributedpytorch_tpu_torch.serve.swap import load_swap_predictor
from distributedpytorch_tpu_torch.train import config
from distributedpytorch_tpu_torch.train.trainer import Trainer
from distributedpytorch_tpu_torch.utils.weights import load_jax_params
from test_torch_port_model import randomize

RES = 64
#: the int8 forward against JAX's int8 forward (the float32 forward's own
#: parity bound)
ATOL = 1e-5
#: the band JAX's quantize documents against the float32 forward
BAND_MAX_ABS = 0.25
BAND_MEAN_ABS = 0.02
BUCKETS = (1, 2, 4)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs in several
    processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _variables(model, size=RES, seed=1):
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 4)), train=False))
    # a MoE model's init also returns the aux loss it sows
    return randomize({k: shapes[k] for k in ("params", "batch_stats")},
                     seed=seed)


def _twins(inject: str, seed: int) -> dict:
    """JAX's and the port's DANet-R18 predictors on the same weights, and
    each package's int8 predictor of them."""
    model = jax_build_model("danet", nclass=1, backbone="resnet18",
                            output_stride=8, attention_impl="xla",
                            guidance_inject=inject)
    variables = _variables(model, seed=seed)
    params, stats = variables["params"], variables["batch_stats"]
    if inject == "head":
        proj = np.random.default_rng(seed).normal(
            0.0, 0.02, params["guidance_proj"]["kernel"].shape)
        proj[..., 0] = 0.0
        params["guidance_proj"]["kernel"] = proj.astype(np.float32)
    ref = jax_predict.Predictor(model, params, stats, resolution=(RES, RES),
                                relax=10)
    port_model = build_model("danet", nclass=1, backbone="resnet18",
                             output_stride=8, guidance_inject=inject)
    load_jax_params(port_model, params, stats)
    port = Predictor(port_model, resolution=(RES, RES), relax=10, device="cpu")
    return {"params": params, "ref": ref, "port": port,
            "qref": jax_quantize.quantize_predictor(ref),
            "qport": quantize.quantize_predictor(port)}


@pytest.fixture(scope="module")
def stem():
    return _twins("stem", seed=1)


@pytest.fixture(scope="module")
def head():
    return _twins("head", seed=2)


@pytest.fixture(scope="module")
def moe():
    model = jax_build_model("danet", nclass=1, backbone="resnet18",
                            output_stride=8, attention_impl="xla",
                            moe_experts=2)
    variables = _variables(model, size=32, seed=4)
    port = build_model("danet", nclass=1, backbone="resnet18", output_stride=8,
                       attention_impl="xla", moe_experts=2)
    load_jax_params(port, variables["params"], variables["batch_stats"])
    return {"params": variables["params"], "port": port,
            "qport": quantize.quantize_model(port)}


def _jax_qtensors(params) -> dict:
    """``layer.weight`` -> JAX's QTensor, for every quantized leaf."""
    flat = jax.tree_util.tree_flatten_with_path(
        jax_quantize.quantize_params(params),
        is_leaf=lambda x: isinstance(x, jax_quantize.QTensor))[0]
    return {".".join(str(p.key) for p in path[:-1]) + ".weight": leaf
            for path, leaf in flat if isinstance(leaf, jax_quantize.QTensor)}


def _crops(b, seed=3):
    return np.random.default_rng(seed).uniform(
        0, 255, (b, RES, RES, 4)).astype(np.float32)


def _image(seed=0):
    return np.random.RandomState(seed).randint(
        0, 256, (RES, RES, 3)).astype(np.uint8)


def _points(d=0.0):
    q, m = RES // 4, RES // 2
    return np.array([[q, m], [RES - q, m], [m, q], [m, RES - q]],
                    np.float64) + d


def _iou(a, b) -> tuple[float, int]:
    ma, mb = a > 0.5, b > 0.5
    union = int((ma | mb).sum())
    return float((ma & mb).sum() / max(union, 1)), union


# ------------------------------------------------------------ the quantizer

class TestLeaf:
    @pytest.mark.parametrize("shape", [(3, 3, 8, 16), (1, 1, 1, 8),
                                       (7, 7, 4, 64), (1, 1, 512, 3)])
    def test_q_and_scale_bitwise_match_jax(self, shape):
        """HWIO weights through JAX's leaf, OIHW through the port's: the
        same int8 values and float32 scales, a zero channel's scale 1.0,
        every other channel reaching +-127 and none beyond."""
        rng = np.random.default_rng(sum(shape))
        w = (rng.normal(size=shape) * 0.1).astype(np.float32)
        w[..., 0] = 0.0
        w.reshape(-1, shape[-1])[0, -1] = 3.0  # an outlier
        want = jax_quantize._quantize_leaf(w, jax_quantize.QuantPolicy())
        got = quantize.quantize_leaf(w.transpose(3, 2, 0, 1))
        assert got.q.dtype == np.int8 and got.scale.dtype == np.float32
        assert got.scale.shape == (shape[-1], 1, 1, 1)
        np.testing.assert_array_equal(got.q, np.asarray(want.q).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(got.scale.reshape(-1),
                                      np.asarray(want.scale).reshape(-1))
        assert got.scale.reshape(-1)[0] == 1.0 and not got.q[0].any()
        peak = np.abs(got.q.astype(np.int32)).reshape(shape[-1], -1).max(1)
        assert (peak[1:] == quantize.QuantPolicy.QMAX).all()

    def test_dequantize_within_half_a_step(self):
        w = np.random.default_rng(0).normal(0, 0.1, (16, 8, 3, 3)) \
            .astype(np.float32)
        leaf = quantize.quantize_leaf(w)
        recon = leaf.dequantize()
        step = np.abs(w).max(axis=(1, 2, 3), keepdims=True) / 127
        assert (np.abs(recon - w) <= step / 2 + 1e-7).all()
        on_torch = quantize.QTensor(torch.from_numpy(leaf.q),
                                    torch.from_numpy(leaf.scale))
        np.testing.assert_array_equal(on_torch.dequantize().numpy(), recon)
        assert on_torch.shape == leaf.shape == w.shape
        assert on_torch.dtype == torch.float32 and leaf.dtype == np.float32


@pytest.mark.parametrize("name", [None, "", "none", "int8", "fp4"])
def test_policy_mapping_matches_jax(name):
    try:
        want = jax_quantize.quantization_block(jax_quantize.quant_policy(name))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            quantize.quant_policy(name)
        assert str(got.value) == str(e)
        return
    policy = quantize.quant_policy(name)
    assert quantize.quantization_block(policy) == want
    assert (policy is None) == (name != "int8")
    if policy is not None:
        assert policy == quantize.QuantPolicy() and policy.QMAX == 127


@pytest.mark.parametrize("net", ["stem", "head", "moe"])
def test_quantized_set_and_report_match_jax(net, request):
    twins = request.getfixturevalue(net)
    qmodel = twins["qport"] if net == "moe" else twins["qport"].model
    float_model = twins["port"] if net == "moe" else twins["port"].model
    assert set(quantize.quantized_weights(qmodel)) == \
        set(_jax_qtensors(twins["params"]))
    assert quantize.quantize_report(qmodel) == jax_quantize.quantize_report(
        jax_quantize.quantize_params(twins["params"]))
    assert quantize.quantize_report(float_model) == \
        jax_quantize.quantize_report(twins["params"])
    left = {n: p.dtype for n, p in qmodel.named_parameters() if p.ndim >= 2}
    if net == "moe":
        assert left == {f"head.moe.{k}": torch.float32
                        for k in ("w_gate", "w1", "b1", "w2", "b2")}
    else:
        assert left == {}


@pytest.mark.parametrize("net", ["stem", "head"])
def test_weights_bitwise_match_jax(net, request):
    twins = request.getfixturevalue(net)
    want = _jax_qtensors(twins["params"])
    got = quantize.quantized_weights(twins["qport"].model)
    for name, leaf in got.items():
        ref = want[name]
        assert leaf.q.dtype == torch.int8 and leaf.scale.dtype == torch.float32
        np.testing.assert_array_equal(
            leaf.q.numpy(), np.asarray(ref.q).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(leaf.scale.numpy().reshape(-1),
                                      np.asarray(ref.scale).reshape(-1))
    scale = got["guidance_proj.weight"].scale.reshape(-1) if net == "head" \
        else None
    assert scale is None or scale[0] == 1.0


# ------------------------------------------------------------ the forward

@pytest.mark.parametrize("b", [1, 4])
def test_stem_forward_matches_jax(stem, b):
    x = _crops(b)
    got = stem["qport"].forward_prepared(x)
    want = stem["qref"].forward_prepared(x)
    assert got.shape == (b, RES, RES) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("b", [1, 4])
def test_head_stages_match_jax(head, b):
    """The encode features (NCHW against NHWC) within 1e-5 of their scale,
    the decode of JAX's features and the whole forward within 1e-5."""
    x = _crops(b, seed=4)
    port, ref = head["qport"], head["qref"]
    feats = np.array(ref.encode_jitted(x[..., :-1]))
    got = port.encode(x[..., :-1]).permute(0, 2, 3, 1).numpy()
    assert float(np.abs(got - feats).max()) <= \
        ATOL * max(1.0, float(np.abs(feats).max()))
    want = np.asarray(ref.decode_jitted(feats, x[..., -1:]))[..., 0]
    t = torch.from_numpy(feats).permute(0, 3, 1, 2).contiguous()
    np.testing.assert_allclose(port.decode(t, x[..., -1:]), want, atol=ATOL)
    np.testing.assert_allclose(port.forward_prepared(x),
                               ref.forward_prepared(x), atol=ATOL)


@pytest.mark.parametrize("net", ["stem", "head"])
def test_band_and_iou_against_float32(net, request):
    """int8 against float32 within the documented band at every bucket;
    the mask IoU at 0.5 printed beside JAX's on the same inputs, equal to
    it within one pixel of the union."""
    twins = request.getfixturevalue(net)
    worst = 0.0
    for b in BUCKETS:
        x = _crops(b, seed=10 + b)
        f32, int8 = twins["port"].forward_prepared(x), \
            twins["qport"].forward_prepared(x)
        diff = np.abs(f32 - int8)
        assert diff.max() <= BAND_MAX_ABS, f"bucket {b}: max {diff.max():.4f}"
        assert diff.mean() <= BAND_MEAN_ABS, f"bucket {b}: mean {diff.mean():.5f}"
        iou, union = _iou(f32, int8)
        ref_iou, _ = _iou(twins["ref"].forward_prepared(x),
                          twins["qref"].forward_prepared(x))
        print(f"{net} bucket {b}: max {diff.max():.4f} mean {diff.mean():.5f} "
              f"IoU port {iou:.4f} JAX {ref_iou:.4f}")
        assert abs(iou - ref_iou) <= 1.0 / max(union, 1)
        worst = max(worst, float(diff.max()))
    assert worst > 0.0  # int8 really differs: the band is not vacuous


def test_int8_forward_is_deterministic(stem):
    x = _crops(2, seed=6)
    np.testing.assert_array_equal(stem["qport"].forward_prepared(x),
                                  stem["qport"].forward_prepared(x))


def test_base_untouched_and_no_float_kernels(stem):
    """Quantizing leaves the base predictor's model and outputs as they
    were; the int8 model holds no float conv weight and carries the base's
    settings."""
    base = stem["port"]
    x = _crops(1, seed=7)
    before = base.forward_prepared(x)
    state = {k: v.clone() for k, v in base.model.state_dict().items()}
    qpred = quantize.quantize_predictor(base)
    np.testing.assert_array_equal(base.forward_prepared(x), before)
    after = base.model.state_dict()
    assert after.keys() == state.keys()
    assert all(torch.equal(after[k], v) for k, v in state.items())
    assert base.quant_policy is None
    assert qpred.quant_policy == quantize.QuantPolicy()
    assert not [k for k, v in qpred.model.state_dict().items()
                if v.is_floating_point() and v.ndim == 4
                and v.shape[1:] != (1, 1, 1)]
    convs = [m for m in qpred.model.modules() if isinstance(m, Conv2d)]
    assert convs and all(m.quantized and "weight" not in m._parameters
                         for m in convs)
    for attr in ("resolution", "relax", "zero_pad", "alpha", "guidance",
                 "in_channels", "device", "dtype", "mean", "std",
                 "supports_sessions"):
        assert getattr(qpred, attr) == getattr(base, attr), attr


def test_carries_mean_std_and_bf16(head):
    """mean, std and a bf16 compute dtype carry over to the int8 predictor,
    which then serves within the band of the float one."""
    base = Predictor(copy.deepcopy(head["port"].model), resolution=(RES, RES),
                     relax=10,
                     device="cpu", dtype=torch.bfloat16,
                     mean=(120.0, 110.0, 100.0, 0.0),
                     std=(60.0, 60.0, 60.0, 255.0))
    qpred = quantize.quantize_predictor(base)
    assert (qpred.dtype, qpred.mean, qpred.std) == \
        (torch.bfloat16, base.mean, base.std)
    x = _crops(2, seed=8)
    got, want = qpred.forward_prepared(x), base.forward_prepared(x)
    assert np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= BAND_MAX_ABS


# ------------------------------------------------------------- composition

def test_session_clicks_bitwise(head):
    """On the int8 split predictor a warm click (cached features, new
    guidance) is the cold and the stateless click, bit for bit."""
    qpred = head["qport"]
    assert qpred.supports_sessions
    concat, _ = qpred.prepare(_image(), _points())
    full = qpred.forward_prepared(concat[None])
    warm = qpred.decode(qpred.encode(concat[None][..., :-1]),
                        concat[None][..., -1:])
    np.testing.assert_array_equal(full, warm)
    with InferenceService(qpred, max_batch=2, max_wait_s=0.0) as svc:
        stateless = svc.predict(_image(), _points(), timeout=120)
        cold = svc.predict(_image(), _points(), timeout=120, session_id="q1")
        again = svc.predict(_image(), _points(), timeout=120, session_id="q1")
        health = svc.health()["sessions"]
    np.testing.assert_array_equal(cold, stateless)
    np.testing.assert_array_equal(again, stateless)
    assert health["hits"] == 1 and health["misses"] == 1


def test_int8_canary_rolls_back(head):
    base, qpred = head["port"], head["qport"]
    img, pts = _image(1), _points()
    with InferenceService(base, max_batch=2, max_wait_s=0.0) as svc:
        gen = svc.swap(qpred, label="int8", canary_fraction=1.0)
        assert svc.health()["swap"]["canary"] == gen
        np.testing.assert_array_equal(svc.predict(img, pts, timeout=120),
                                      qpred.predict(img, pts))
        svc.rollback()
        assert svc.health()["swap"]["canary"] is None
        np.testing.assert_array_equal(svc.predict(img, pts, timeout=120),
                                      base.predict(img, pts))


def test_float_swap_onto_int8_base(head):
    """A float32 state dict onto an int8 active generation: a float32
    generation (a plain Predictor, every conv weight a float parameter)
    that serves as a Predictor on those weights does, the base intact."""
    qbase = head["qport"]
    img, pts = _image(2), _points()
    before = qbase.predict(img, pts)
    new_model = build_model("danet", nclass=1, backbone="resnet18",
                            output_stride=8, guidance_inject="head")
    predict._randomize_(new_model, torch.Generator().manual_seed(7))
    state = new_model.state_dict()
    gen1 = load_swap_predictor(qbase, state)
    assert type(gen1) is Predictor and gen1.quant_policy is None
    assert not any(m.quantized for m in gen1.model.modules()
                   if isinstance(m, Conv2d))
    for attr in ("resolution", "relax", "in_channels", "device", "dtype"):
        assert getattr(gen1, attr) == getattr(qbase, attr)
    own = Predictor(new_model, resolution=(RES, RES), relax=10, device="cpu")
    np.testing.assert_array_equal(gen1.predict(img, pts), own.predict(img, pts))
    with InferenceService(qbase, max_batch=2, max_wait_s=0.0) as svc:
        old = svc.predict(img, pts, timeout=120, session_id="old")
        svc.swap(gen1, label="f32", canary_fraction=1.0)
        fresh = svc.predict(img, pts, timeout=120, session_id="new")
        svc.promote()
        np.testing.assert_array_equal(
            svc.predict(img, pts, timeout=120, session_id="old"), old)
    np.testing.assert_array_equal(old, before)
    np.testing.assert_array_equal(fresh, own.predict(img, pts))
    np.testing.assert_array_equal(qbase.predict(img, pts), before)


# --------------------------------------------------------- knob and server

TINY = ["data.fake=true", "model.backbone=resnet18", "data.crop_size=[64,64]",
        "data.relax=10", "data.area_thres=0", "data.train_batch=2",
        "data.num_workers=0", "epochs=1"]


def test_config_knob_round_trips_and_trainer_accepts(tmp_path):
    overrides = TINY + ["model.quantization=int8", f"work_dir={tmp_path}"]
    cfg = config.apply_overrides(config.Config(), overrides)
    assert config.Config().model.quantization == ""
    assert config.unported_knobs(cfg) == []
    assert config.to_json(cfg) == jax_config.to_json(
        jax_config.apply_overrides(jax_config.Config(), overrides))
    trainer = Trainer(cfg, device="cpu")
    written = config.from_json(f"{trainer.run_dir}/config.json")
    assert written.model.quantization == "int8"
    assert jax_config.from_json(
        f"{trainer.run_dir}/config.json").model.quantization == "int8"


#: (``--quantize``, the run config's ``model.quantization``)
RESOLUTIONS = [(None, ""), (None, "int8"), ("none", "int8"), ("int8", ""),
               ("int8", "int8"), (None, "fp4")]


@pytest.mark.parametrize("flag,knob", RESOLUTIONS)
def test_build_predictor_resolves_as_jax(flag, knob, tmp_path, monkeypatch):
    """The serve CLI's ``--run-dir`` path: the flag against the run's
    ``model.quantization``, decided as the JAX CLI decides it (its
    predictor and quantizer stubbed: only the decision is compared)."""
    cfg = config.apply_overrides(config.Config(), [
        "model.backbone=resnet18", "data.crop_size=[32,32]",
        f"model.quantization={knob}"])
    config.to_json(cfg, str(tmp_path / "config.json"))
    jax_cfg = jax_config.from_json(str(tmp_path / "config.json"))
    monkeypatch.setattr(jax_predict, "load_run_config", lambda run: jax_cfg)
    monkeypatch.setattr(jax_predict.Predictor, "from_run", classmethod(
        lambda cls, *a, **k: types.SimpleNamespace(quant_policy=None)))
    monkeypatch.setattr(jax_quantize, "quantize_predictor",
                        lambda pred, policy: types.SimpleNamespace(
                            quant_policy=policy))
    small = Predictor.fresh(32, "resnet18", seed=0, device="cpu")
    monkeypatch.setattr(Predictor, "from_run", classmethod(
        lambda cls, *a, **k: small))
    args = argparse.Namespace(run_dir=str(tmp_path), step=None, device="cpu",
                              quantize=flag, fresh_init=None, torch=None)
    try:
        want = jax_quantize.quantization_block(
            jax_serve_main.build_predictor(args).quant_policy)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            build_predictor(args)
        assert str(got.value) == str(e)
        return
    pred = build_predictor(args)
    assert quantize.quantization_block(pred.quant_policy) == want
    assert isinstance(pred, quantize.QuantizedPredictor) == (want is not None)


@pytest.mark.parametrize("flag", [[], ["--quantize", "none"],
                                  ["--quantize", "int8"]])
def test_fresh_init_boot_line_and_requests(flag):
    """``--fresh-init ... --quantize``: the boot line's ``quantization`` is
    JAX's ``quantization_block`` of the flag, and the server answers."""
    args = make_parser().parse_args(
        ["--fresh-init", "32:resnet18:0", "--device", "cpu", *flag])
    pred = build_predictor(args)
    svc = InferenceService(pred, max_batch=2, max_wait_s=0.0)
    record = json.loads(json.dumps(boot_record(args, pred, svc, 8801)))
    assert record["quantization"] == jax_quantize.quantization_block(
        jax_quantize.quant_policy(flag[1] if flag else None))
    with svc:
        mask = svc.predict(np.full((40, 48, 3), 128, np.uint8),
                           np.array([[8, 20], [40, 20], [24, 6], [24, 34]],
                                    np.float64), timeout=120)
    assert mask.shape == (40, 48) and np.isfinite(mask).all()


# ------------------------------------------------- SemanticPredictor mean/std

@pytest.mark.parametrize("name,os_", [("fcn", 8), ("deeplabv3", 16)])
def test_semantic_predictor_mean_std_matches_jax(name, os_):
    jmodel = jax_build_model(name, nclass=5, backbone="resnet18",
                             output_stride=os_)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, RES, RES, 3)), train=False))
    variables = randomize(shapes, seed=5)
    mean, std = (123.7, 116.3, 103.5), (58.4, 57.1, 57.4)
    ref = jax_predict.SemanticPredictor(
        jmodel, variables["params"], variables["batch_stats"],
        resolution=(RES, RES), mean=mean, std=std)
    model = build_model(name, nclass=5, backbone="resnet18", output_stride=os_,
                        in_channels=3)
    load_jax_params(model, variables["params"], variables["batch_stats"])
    port = SemanticPredictor(model, resolution=(RES, RES), device="cpu",
                             mean=mean, std=std)
    x = np.random.default_rng(9).uniform(0, 255, (2, RES, RES, 3)) \
        .astype(np.float32)
    want = np.asarray(ref._forward_probs(jnp.asarray(x)))
    got = port.forward_probs(x)
    np.testing.assert_allclose(got, want, atol=ATOL)
    classes = port.forward_classes(x)
    np.testing.assert_array_equal(classes, np.asarray(ref._forward(jnp.asarray(x))))
    plain = SemanticPredictor(model, resolution=(RES, RES), device="cpu")
    assert not np.allclose(plain.forward_probs(x), got, atol=1e-3)
