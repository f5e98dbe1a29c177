"""The port's semantic task and DeepLab family against the JAX package's,
on the CPU.

* Models: ``deeplabv3``, ``deeplabv3plus`` and ``fcn`` (ResNet-18, 5
  classes) at output stride 8 and 16, at 64² and at the odd 65² (flax's
  other ``SAME`` split), every leaf of a JAX tree redrawn from numpy and
  loaded strictly with ``load_jax_params``: the logits of eval mode, and
  of train mode with flax's dropout made the identity and the port's off,
  plus the BatchNorm statistics train mode moved, within 1e-4 x max |ref|;
  the same weights without the aux head give the same primary logits.
  Largest differences seen: 2.5e-6 of max |ref|.  In bf16 compute each
  logit map is within 3 x JAX bf16's own distance from JAX float32
  (0.82 seen).
* Loss: ``softmax_xent_ignore`` and the multi-output softmax loss with
  mixed voids, an all-void batch (loss 0, gradient 0) and a ``-inf``
  logit in a class that is not the label's: values within 1e-6 relative,
  gradients within 1e-6 x max |g|.
* Metrics: the confusion counts exactly, mIoU, per-class IoU (absent
  classes ``None``) and pixel accuracy equal.
* Data: ``VOCSemanticSegmentation`` on the JAX package's on-disk fake
  tree, raw samples bit for bit; the semantic train and eval stacks with
  the same per-sample rng: ``crop_gt``, ``gt_full`` and ``meta`` bit for
  bit, ``concat`` within the 1e-3 that ``imaging.resize`` is held to
  unwarped (2 grey levels warped, as in ``test_torch_port_data.py``).
* Evaluation: ``evaluate_semantic`` against JAX's with one deterministic
  eval step on both sides (logits a fixed function of the input), for the
  plain, TTA ((0.75, 1.0, 1.25) + flip, bf16 and float32 readback) and
  full-resolution protocols, host and device: confusion counts within 4
  pixels of 1.2e4 (argmax ties of float32 softmax arithmetic), metrics
  within 1e-3; the TTA pass structure of ``tests/test_semantic.py``;
  ``fullres_argmax`` and ``resize_bilinear_ragged`` against JAX's.
* Serving: ``SemanticPredictor`` in resize and slide modes against JAX's
  on the same weights (class maps equal on >= 99.9% of pixels), and
  ``predict_cli`` and the ``--predict`` CLI for both tasks.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from distributedpytorch_tpu.data import fake as jax_fake
from distributedpytorch_tpu.data import pipeline as jax_pipeline
from distributedpytorch_tpu.data import voc as jax_voc
from distributedpytorch_tpu.models import build_model as jax_build_model
from distributedpytorch_tpu.ops import losses as jax_losses
from distributedpytorch_tpu.ops import metrics as jax_metrics
from distributedpytorch_tpu.ops import warp as jax_warp
from distributedpytorch_tpu.predict import SemanticPredictor as JaxSemanticPredictor
from distributedpytorch_tpu.train.evaluate import evaluate_semantic as jax_evaluate_semantic
from distributedpytorch_tpu_torch import __main__ as cli
from distributedpytorch_tpu_torch.data import pipeline, voc
from distributedpytorch_tpu_torch.models import build_model
from distributedpytorch_tpu_torch.models.deeplab import set_dropout
from distributedpytorch_tpu_torch.ops import losses, metrics, warp
from distributedpytorch_tpu_torch.parallel.step import create_train_state
from distributedpytorch_tpu_torch.predict import SemanticPredictor, predict_cli
from distributedpytorch_tpu_torch.train import config
from distributedpytorch_tpu_torch.train.checkpoint import CheckpointManager
from distributedpytorch_tpu_torch.train.evaluate import evaluate_semantic
from distributedpytorch_tpu_torch.train.optim import make_optimizer
from distributedpytorch_tpu_torch.utils.weights import (
    jax_to_state_dict,
    load_jax_params,
)
from test_torch_port_model import randomize
from test_torch_port_train import _no_dropout

NCLASS = 5


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max()) / max(1e-30, float(np.abs(ref).max()))


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


# ------------------------------------------------------------------ models

def _jax_model(name, os_, size, seed=1):
    model = jax_build_model(name, nclass=NCLASS, backbone="resnet18",
                            output_stride=os_, aux_head=True)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), train=False))
    return model, randomize(shapes, seed=seed)


def _port_model(name, os_, variables, aux_head=True):
    model = build_model(name, nclass=NCLASS, backbone="resnet18",
                        output_stride=os_, aux_head=aux_head, in_channels=3)
    params, stats = variables["params"], variables["batch_stats"]
    if not aux_head:
        params = {k: v for k, v in params.items() if k != "aux"}
        stats = {k: v for k, v in stats.items() if k != "aux"}
    return load_jax_params(model, params, stats)


@pytest.mark.parametrize("name,os_,size", [
    ("deeplabv3", 16, 65), ("deeplabv3", 8, 64),
    ("deeplabv3plus", 16, 64), ("deeplabv3plus", 8, 65),
    ("fcn", 8, 65), ("fcn", 16, 64)])
def test_models_match_jax(name, os_, size):
    jmodel, variables = _jax_model(name, os_, size)
    x = np.random.default_rng(2).uniform(0, 255, (2, size, size, 3)).astype(np.float32)
    ref_eval = jmodel.apply(variables, jnp.asarray(x), train=False)
    with fnn.intercept_methods(_no_dropout):
        ref_train, mutated = jmodel.apply(variables, jnp.asarray(x), train=True,
                                          mutable=["batch_stats"])
    port = _port_model(name, os_, variables)
    no_aux = _port_model(name, os_, variables, aux_head=False).eval()
    with torch.no_grad():
        got_eval = port.eval()(nchw(x))
        got_plain = no_aux(nchw(x))
        set_dropout(port, False)
        got_train = port.train()(nchw(x))
    assert len(got_eval) == len(got_train) == 2 and len(got_plain) == 1
    worst = 0.0
    for refs, gots in ((ref_eval, got_eval), (ref_train, got_train),
                       (ref_eval[:1], got_plain)):
        for r, g in zip(refs, gots):
            r = np.asarray(r).transpose(0, 3, 1, 2)
            assert g.shape == r.shape == (2, NCLASS, size, size)
            err = rel_err(g.numpy(), r)
            worst = max(worst, err)
            assert err <= 1e-4
    want = jax_to_state_dict({}, jax.device_get(mutated["batch_stats"]))
    state = port.state_dict()
    for key, w in want.items():
        assert rel_err(state[key].numpy(), w.numpy()) <= 1e-4, key
    print(f"{name} OS {os_} {size}^2: worst logit error {worst:.2e} of max |ref|")


def test_bf16_forward_tracks_jax():
    """DeepLabV3-R18 in bf16 compute on float32 weights: each logit map
    within 3 x JAX bf16's own distance from JAX float32 (the precision
    tests' form; the resizes run in float32 here, once rounded), in bf16."""
    jmodel, variables = _jax_model("deeplabv3plus", 16, 64)
    j16 = jax_build_model("deeplabv3plus", nclass=NCLASS, backbone="resnet18",
                          aux_head=True, dtype="bfloat16")
    x = np.random.default_rng(2).uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
    ref32 = jmodel.apply(variables, jnp.asarray(x), train=False)
    ref16 = j16.apply(variables, jnp.asarray(x, jnp.bfloat16), train=False)
    port = _port_model("deeplabv3plus", 16, variables).eval()
    port.set_compute_dtype(torch.bfloat16)
    with torch.no_grad():
        got = port(nchw(x))
    for g, r16, r32 in zip(got, ref16, ref32):
        assert g.dtype == torch.bfloat16
        r16 = np.asarray(r16.astype(jnp.float32)).transpose(0, 3, 1, 2)
        r32 = np.asarray(r32).transpose(0, 3, 1, 2)
        own = np.abs(r16 - r32).max()
        diff = np.abs(g.float().numpy() - r16).max()
        print(f"bf16 logits: {diff:.3e} from JAX bf16, {diff / own:.3f} x its "
              f"distance from JAX float32")
        assert 0 < diff <= 3 * own


def test_strict_load_and_dropout_modes():
    jmodel, variables = _jax_model("deeplabv3plus", 16, 64)
    model = _port_model("deeplabv3plus", 16, variables)
    with pytest.raises(RuntimeError):  # no aux head: the aux leaves are left over
        load_jax_params(build_model("deeplabv3plus", nclass=NCLASS,
                                    backbone="resnet18", in_channels=3),
                        variables["params"], variables["batch_stats"])
    rates = {type(m).__name__: m.dropout_rate for m in model.modules()
             if hasattr(m, "dropout_rate")}
    assert rates == {"ASPP": 0.5, "FCNHead": 0.1}
    off = build_model("fcn", backbone="resnet18", aux_head=True, dropout_rate=0.0)
    assert {m.dropout_rate for m in off.modules() if hasattr(m, "dropout_rate")} == {0.0}
    with pytest.raises(ValueError, match="dropout rates"):
        build_model("deeplabv3", backbone="resnet18", dropout_rate=0.2)
    for knob in ({"attention_impl": "flash"}, {"pam_score_dtype": "bfloat16"}):
        with pytest.raises(ValueError, match="DANet-only"):
            build_model("fcn", backbone="resnet18", **knob)
    # train mode at batch 1: the pool branch's BatchNorm sees one value
    # per channel (torch's batch norm refuses it), which flax normalises
    # to its bias
    x = np.random.default_rng(3).uniform(0, 255, (1, 64, 64, 3)).astype(np.float32)
    with fnn.intercept_methods(_no_dropout):
        ref, mutated = jmodel.apply(variables, jnp.asarray(x), train=True,
                                    mutable=["batch_stats"])
    set_dropout(model, False)
    with torch.no_grad():
        out = model.train()(nchw(x))
    for r, g in zip(ref, out):
        assert rel_err(g.numpy(), np.asarray(r).transpose(0, 3, 1, 2)) <= 1e-4
    pool = jax.device_get(mutated["batch_stats"]["aspp"]["pool_bn"])
    assert rel_err(model.aspp.pool_bn.running_var.numpy(), pool["var"]) <= 1e-6
    assert rel_err(model.aspp.pool_bn.running_mean.numpy(), pool["mean"]) <= 1e-5


# -------------------------------------------------------------------- loss

def test_softmax_xent_matches_jax():
    r = np.random.default_rng(3)
    logits = (r.normal(size=(2, 6, 7, NCLASS)) * 3).astype(np.float32)
    labels = r.integers(0, NCLASS, (2, 6, 7))
    labels[r.random(labels.shape) < 0.3] = 255
    logits[0, 0, 0, (labels[0, 0, 0] + 1) % NCLASS] = -np.inf
    labels[0, 0, 0] = labels[0, 0, 0] % NCLASS
    aux = (r.normal(size=logits.shape) * 2).astype(np.float32)
    cases = [(labels, None), (np.full_like(labels, 255), None)]
    for lab, _ in cases:
        def jloss(a, b):
            return (jax_losses.softmax_xent_ignore(a, jnp.asarray(lab))
                    + 0.4 * jax_losses.softmax_xent_ignore(b, jnp.asarray(lab)))

        ref, (ga, gb) = jax.value_and_grad(jloss, argnums=(0, 1))(
            jnp.asarray(logits), jnp.asarray(aux))
        ta, tb = nchw(logits).requires_grad_(), nchw(aux).requires_grad_()
        got = losses.multi_softmax_loss([ta, tb], torch.from_numpy(lab))
        got.backward()
        assert np.isfinite(float(got))
        if (lab == 255).all():
            assert float(got) == float(ref) == 0.0
            assert not ta.grad.any() and not tb.grad.any()
            continue
        assert abs(float(got) - float(ref)) <= 1e-6 * abs(float(ref))
        for g, w in ((ta.grad, ga), (tb.grad, gb)):
            w = np.asarray(w).transpose(0, 3, 1, 2)
            assert np.abs(g.numpy() - w).max() <= 1e-6 * np.abs(w).max()
    # one pixel of [1, 1, -inf, 1] labelled 0: log 3
    one = torch.tensor([1.0, 1.0, -np.inf, 1.0]).reshape(1, 4, 1, 1)
    got = losses.softmax_xent_ignore(one, torch.zeros(1, 1, 1, dtype=torch.long))
    assert float(got) == pytest.approx(np.log(3.0), rel=1e-6)
    with pytest.raises(ValueError, match="do not match"):
        losses.softmax_xent_ignore(torch.zeros(2, 3, 4, 4), torch.zeros(2, 1, 4, 4))


def test_global_valid_count_normalises():
    """Two halves' losses, each over the whole batch's valid count, sum to
    the whole batch's loss."""
    r = np.random.default_rng(8)
    logits = torch.from_numpy(r.normal(size=(4, NCLASS, 5, 6)).astype(np.float32))
    labels = torch.from_numpy(r.integers(0, NCLASS, (4, 5, 6)))
    labels[:1][torch.from_numpy(r.random((1, 5, 6)) < 0.8)] = 255
    n = losses.valid_count(labels[:2]) + losses.valid_count(labels[2:])
    halves = sum(losses.softmax_xent_ignore(logits[s], labels[s], n_valid=n)
                 for s in (slice(0, 2), slice(2, 4)))
    whole = losses.softmax_xent_ignore(logits, labels)
    assert abs(float(halves) - float(whole)) <= 1e-6 * float(whole)


# ----------------------------------------------------------------- metrics

def test_confusion_and_miou_match_jax():
    r = np.random.default_rng(4)
    pred = r.integers(0, 6, (3, 9, 11))
    label = r.integers(0, 6, (3, 9, 11))
    label[r.random(label.shape) < 0.2] = 255
    pred[pred == 4] = 0   # class 4 never predicted
    label[label == 5] = 3  # class 5 never true: with 4, IoU of absent ones
    pred[pred == 5] = 2    # class 5 absent from both
    ref = np.asarray(jax_metrics.confusion_matrix(jnp.asarray(pred),
                                                  jnp.asarray(label), 6))
    got = metrics.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(label), 6)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert jax_metrics.miou_from_confusion(ref) == metrics.miou_from_confusion(got)
    out = metrics.miou_from_confusion(got)
    assert out["per_class_iou"][5] is None and out["per_class_iou"][4] == 0.0
    assert metrics.miou_from_confusion(np.zeros((3, 3))) == \
        jax_metrics.miou_from_confusion(np.zeros((3, 3)))


# -------------------------------------------------------------------- data

@pytest.fixture(scope="module")
def tree_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc"))
    jax_fake.make_fake_voc(root, n_images=5, size=(96, 128), n_val=2, seed=3)
    return root


def _assert_sample(got, want, atol):
    assert set(got) == set(want)
    for key in want:
        if key == "meta":
            assert got[key] == want[key]
            continue
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.shape == w.shape and g.dtype == w.dtype, key
        if key == "concat":
            assert np.abs(g.astype(np.float64) - w).max() <= atol, key
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


def test_semantic_dataset_raw_bit_identical(tree_root):
    for split in ("train", "val"):
        ref = jax_voc.VOCSemanticSegmentation(tree_root, split=split)
        got = voc.VOCSemanticSegmentation(tree_root, split=split)
        assert len(got) == len(ref) > 0 and got.im_ids == ref.im_ids
        for i in range(len(ref)):
            _assert_sample(got[i], ref[i], 0.0)
            assert 255.0 in got[i]["gt"]


@pytest.mark.parametrize("rots,scales,atol", [
    ((0, 0), (1, 1), 1e-3), ((-10, 10), (0.5, 2.0), 2.0)])
def test_semantic_train_stack_matches_jax(tree_root, rots, scales, atol):
    kw = dict(crop_size=(64, 64), rots=rots, scales=scales)
    ref = jax_voc.VOCSemanticSegmentation(
        tree_root, split="train",
        transform=jax_pipeline.build_semantic_train_transform(**kw))
    got = voc.VOCSemanticSegmentation(
        tree_root, split="train",
        transform=pipeline.build_semantic_train_transform(**kw))
    voids = 0
    for i in range(len(ref)):
        g = got.__getitem__(i, rng=pipeline.sample_rng(0, 2, i))
        w = ref.__getitem__(i, rng=jax_pipeline.sample_rng(0, 2, i))
        _assert_sample(g, w, atol)
        voids += int((g["crop_gt"] == 255).sum())
    assert voids > 0


@pytest.mark.parametrize("keep_fullres", [False, True])
def test_semantic_eval_stack_matches_jax(tree_root, keep_fullres):
    kw = dict(crop_size=(65, 65), keep_fullres=keep_fullres)
    ref = jax_voc.VOCSemanticSegmentation(
        tree_root, split="val",
        transform=jax_pipeline.build_semantic_eval_transform(**kw))
    got = voc.VOCSemanticSegmentation(
        tree_root, split="val",
        transform=pipeline.build_semantic_eval_transform(**kw))
    for i in range(len(ref)):
        g, w = got[i], ref[i]
        _assert_sample(g, w, 1e-3)
        assert ("gt_full" in g) == keep_fullres


def test_fake_semantic_view():
    from distributedpytorch_tpu_torch.data import fake

    tree = fake.make_fake_voc(n_images=8, size=(96, 128), n_val=3, seed=0)
    ds = voc.VOCSemanticSegmentation(tree, split="train")
    assert len(ds) == 5 and str(ds) == "VOC2012Semantic(split=['train'])"
    gt = ds[0]["gt"]
    np.testing.assert_array_equal(gt, tree.classes("fake_000000"))
    assert set(np.unique(gt)) - {0.0, 255.0} and 255.0 in gt


# -------------------------------------------------------------- evaluation

#: a fixed input -> logits map for both packages' eval steps
_MIX = np.random.default_rng(11).normal(size=(3, NCLASS)).astype(np.float32) / 40


def _logits(x: np.ndarray) -> np.ndarray:
    """(B, H, W, 3) -> (B, H, W, C): a fixed nonlinear function of each
    pixel and its column, so that resizes and flips change the argmax."""
    cols = np.arange(x.shape[2], dtype=np.float32)[None, None, :, None]
    return (x @ _MIX + np.sin(cols / 3.0 + np.arange(NCLASS)) * 0.5).astype(np.float32)


def _jax_step(state, batch):
    x = np.asarray(batch["concat"])
    return (jnp.asarray(_logits(x)),), jnp.float32(float(np.abs(x).mean()))


def _port_step(state, batch):
    x = np.asarray(batch["concat"])
    return (nchw(_logits(x)),), torch.tensor(float(np.abs(x).mean()))


def _eval_batches(keep_fullres: bool):
    r = np.random.default_rng(12)
    out = []
    for b in range(2):
        x = r.uniform(0, 255, (2, 24, 24, 3)).astype(np.float32)
        gt = r.integers(0, NCLASS, (2, 24, 24, 1)).astype(np.float32)
        gt[:, :3] = 255.0
        batch = {"concat": x, "crop_gt": gt}
        if keep_fullres:
            sizes = [(30 + 7 * b, 41), (19, 26 + b)]
            batch["gt_full"] = [np.where(r.random((h, w, 1)) < 0.1, 255.0,
                                         r.integers(0, NCLASS, (h, w, 1))
                                         ).astype(np.float32) for h, w in sizes]
        out.append(batch)
    return out


@pytest.mark.parametrize("protocol", ["plain", "tta_bf16", "tta_f32", "fullres_host",
                                      "fullres_device", "fullres_tta"])
def test_evaluate_semantic_matches_jax(protocol):
    kw = {}
    if protocol.startswith("tta") or protocol == "fullres_tta":
        kw = dict(tta_scales=(0.75, 1.0, 1.25), tta_flip=True)
    if protocol == "tta_f32":
        kw["bf16_probs"] = False
    if protocol == "fullres_device":
        kw["device_fullres"] = (40, 48)
    batches = _eval_batches(protocol.startswith("fullres"))
    ref = jax_evaluate_semantic(_jax_step, None, batches, nclass=NCLASS, **kw)
    got = evaluate_semantic(_port_step, None, batches, nclass=NCLASS, **kw)
    assert got["n_samples"] == ref["n_samples"] == 4
    assert abs(got["loss"] - ref["loss"]) <= 1e-6 * ref["loss"]
    for key in ("miou", "pixel_acc", "jaccard"):
        assert abs(got[key] - ref[key]) <= 1e-3, key
    for g, w in zip(got["per_class_iou"], ref["per_class_iou"]):
        assert (g is None) == (w is None) and (g is None or abs(g - w) <= 1e-3)
    assert 0.05 < ref["miou"] < 0.95


class TestTTAPassStructure:
    """The port's votes are exactly scales x flips, as in JAX's tests."""

    def _counting_step(self):
        calls = []

        def eval_step(state, batch):
            x = np.asarray(batch["concat"])
            calls.append(x.shape[1:3])
            return (nchw(np.concatenate([x, -x], axis=-1)),), torch.tensor(0.0)

        return eval_step, calls

    def _batch(self, w=8):
        ramp = np.tile(np.arange(w, dtype=np.float32), (1, w, 1))[..., None]
        return {"concat": ramp,
                "crop_gt": (ramp > w / 2).astype(np.float32)}

    def test_scale_list_without_base_runs_loss_pass_unvoted(self):
        step, calls = self._counting_step()
        evaluate_semantic(step, None, [self._batch()], nclass=2, tta_scales=(0.5,))
        assert calls == [(8, 8), (4, 4)]

    def test_flip_applies_at_every_scale(self):
        step, calls = self._counting_step()
        evaluate_semantic(step, None, [self._batch()], nclass=2,
                          tta_scales=(0.5, 1.0), tta_flip=True)
        assert sorted(calls) == sorted([(8, 8), (8, 8), (4, 4), (4, 4)])

    def test_duplicate_scales_rejected(self):
        with pytest.raises(ValueError, match="duplicate"):
            evaluate_semantic(lambda s, b: None, None, [], nclass=2,
                              tta_scales=(1.0, 1.0))


def test_fullres_warp_matches_jax():
    r = np.random.default_rng(5)
    probs = r.random((2, 17, 17, 21)).astype(np.float32)
    sizes = np.array([[31, 24], [12, 40]], np.int32)
    ref_full = np.asarray(jax_warp.resize_bilinear_ragged(
        jnp.asarray(probs), jnp.asarray(sizes), (48, 48)))
    got_full = warp.resize_bilinear_ragged(nchw(probs), torch.from_numpy(sizes),
                                           (48, 48)).numpy().transpose(0, 2, 3, 1)
    assert np.abs(got_full - ref_full).max() <= 1e-5
    ref = np.asarray(jax_warp.fullres_argmax(jnp.asarray(probs),
                                             jnp.asarray(sizes), (48, 48)))
    got = warp.fullres_argmax(nchw(probs), torch.from_numpy(sizes), (48, 48)).numpy()
    assert got.dtype == np.uint8 and got.shape == (2, 48, 48)
    for j, (h, w) in enumerate(sizes):
        assert (got[j, :h, :w] == ref[j, :h, :w]).mean() >= 0.999
        assert not got_full[j, h:].any() and not got_full[j, :, w:].any()


# ----------------------------------------------------------------- serving

@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """DeepLabV3-R18 weights at 64², as a JAX predictor and as a run of the
    port's trainer (config.json + a committed checkpoint)."""
    jmodel = jax_build_model("deeplabv3", nclass=NCLASS, backbone="resnet18",
                             aux_head=True)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    variables = randomize(shapes, seed=6)
    # logits that vary over the image, not one class everywhere: the
    # classifier's bias cancels each class's mean logit on a random image
    with torch.no_grad():
        calib = _port_model("deeplabv3", 16, variables).eval()(
            torch.rand(1, 3, 64, 64, generator=torch.Generator().manual_seed(0)) * 255)
    head = variables["params"]["classifier"]
    head["bias"] = head["bias"] - calib[0].mean(dim=(0, 2, 3)).numpy()
    run = tmp_path_factory.mktemp("run")
    cfg = config.apply_overrides(config.Config(), [
        "task=semantic", "model.name=deeplabv3", f"model.nclass={NCLASS}",
        "model.backbone=resnet18", "model.in_channels=3", "model.aux_head=true",
        "data.crop_size=[64,64]"])
    config.to_json(cfg, str(run / "config.json"))
    model = _port_model("deeplabv3", 16, variables)
    opt, sched = make_optimizer(cfg.optim, model, 1)
    state = create_train_state(model, opt, sched, 0, torch.device("cpu"))
    state.step = 1
    CheckpointManager(str(run / "checkpoints")).save(1, state, extra={"epoch": 0})
    ref = JaxSemanticPredictor(jmodel, variables["params"], variables["batch_stats"],
                               resolution=(64, 64))
    return ref, str(run)


@pytest.mark.parametrize("mode,shape", [("resize", (50, 70)), ("slide", (90, 110)),
                                        ("slide", (40, 50))])
def test_semantic_predictor_matches_jax(served, mode, shape):
    ref, run = served
    pred = SemanticPredictor.from_run(run, device="cpu")
    assert pred.resolution == (64, 64) and pred.model.nclass == NCLASS
    image = np.random.default_rng(7).uniform(0, 255, shape + (3,)).astype(np.float32)
    got = pred.predict(image, mode=mode)
    want = np.asarray(ref.predict(image, mode=mode))
    assert got.shape == want.shape == shape and got.dtype == np.uint8
    agree = (got == want).mean()
    assert agree >= 0.999, agree
    assert len(np.unique(got)) > 1
    with pytest.raises(ValueError, match="unknown mode"):
        pred.predict(image, mode="tile")


def _instance_run(tmp_path):
    tmp_path.mkdir()
    cfg = config.apply_overrides(config.Config(), [
        "model.backbone=resnet18", "data.crop_size=[64,64]", "data.relax=10"])
    config.to_json(cfg, str(tmp_path / "config.json"))
    torch.manual_seed(0)
    model = build_model("danet", backbone="resnet18")
    opt, sched = make_optimizer(cfg.optim, model, 1)
    state = create_train_state(model, opt, sched, 0, torch.device("cpu"))
    CheckpointManager(str(tmp_path / "checkpoints")).save(0, state, extra={"epoch": 0})
    return str(tmp_path)


def test_predict_cli_both_tasks(served, tmp_path, capsys):
    from PIL import Image

    _, run = served
    img = tmp_path / "img.png"
    image = np.random.default_rng(9).integers(0, 256, (60, 80, 3), dtype=np.uint8)
    Image.fromarray(image).save(img)
    out = tmp_path / "classes.png"
    summary = predict_cli(run, str(img), None, str(out),
                          overlay_path=str(tmp_path / "o.png"), device="cpu")
    classes = np.asarray(Image.open(out))
    want = SemanticPredictor.from_run(run, device="cpu").predict(image)
    np.testing.assert_array_equal(classes, want)
    assert summary["task"] == "semantic" and sum(summary["classes"].values()) == 60 * 80
    assert Image.open(tmp_path / "o.png").size == (80, 60)
    with pytest.raises(ValueError, match="do not apply"):
        predict_cli(run, str(img), "1,1 2,2 3,3 4,4", str(out), device="cpu")

    inst = _instance_run(tmp_path / "inst")
    assert cli.main(["--device", "cpu", "--predict", str(img), "--run-dir", inst,
                     "--points", "10,30 70,28 40,5 42,55",
                     "--out", str(tmp_path / "mask.png")]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["task"] == "instance" and printed["threshold"] == 0.5
    mask = np.asarray(Image.open(tmp_path / "mask.png"))
    assert mask.shape == (60, 80) and set(np.unique(mask)) <= {0, 255}
    with pytest.raises(ValueError, match="--slide does not apply"):
        predict_cli(inst, str(img), "10,30 70,28 40,5 42,55", str(out), slide=True,
                    device="cpu")
    with pytest.raises(ValueError, match="--points"):
        predict_cli(inst, str(img), None, str(out), device="cpu")
    with pytest.raises(ValueError, match="use SemanticPredictor"):
        from distributedpytorch_tpu_torch.predict import Predictor
        Predictor.from_run(run, device="cpu")
    with pytest.raises(ValueError, match="use Predictor"):
        SemanticPredictor.from_run(inst, device="cpu")
