"""The three knobs of the trainer/model path against the JAX package's,
on the CPU (ResNet-18 backbones at 32-64²).

* ``optim.name=adamw``: three updates against the optax chain of the JAX
  ``make_optimizer`` (warmup schedule, ``lr_mult``, ``freeze``, global-norm
  clipping) within 1e-6 x max(1, |leaf|); the first step against optax's
  closed form ``-lr * (g / (|g| + eps) + wd * p)`` (1e-5 relative, the JAX
  test's bound); ``lr_mult`` scaling the whole update; a fit stopped and
  resumed equal to a straight one bit for bit, AdamW's moments included.
* ``model.remat_policy``: each zero-argument policy's gradients equal the
  no-remat gradients within ``conftest.assert_grads_close`` (the JAX
  test's bound), and ``dots_saveable``'s equal JAX's with the same policy
  within 1e-4 x max(1, max |g|) per leaf; the running statistics equal
  the no-remat step's bit for bit (the recompute moves none); convolutions
  recomputed in the backward: every block's under ``nothing_saveable``,
  none under ``dots_saveable``; an unknown name raises
  ``AttributeError``, as in JAX.
* ``model.bn_fp32_stats=false``: one BatchNorm on bf16 input against
  flax's ``force_float32_reductions=False`` (output and input gradient
  within 1e-2 of max |ref|, bf16's resolution; running statistics within
  2e-3; scale and bias gradients within 1e-2); DANet-R18 bf16 train
  forward against JAX's with ``bn_fp32_stats=False``: the same trees,
  updated statistics within the JAX test's rtol 0.1 / atol 0.1, logits
  within 5e-2 x max(1, max |logit|); DeepLabV3 takes the flag.
* A fit with all three knobs is served by ``Predictor.from_run``, its
  logits bitwise the trained model's.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn
from torch.utils._python_dispatch import TorchDispatchMode

from conftest import assert_grads_close
from distributedpytorch_tpu.models import build_model as jax_build_model
from distributedpytorch_tpu.train import config as jax_config
from distributedpytorch_tpu.train import optim as jax_optim
from distributedpytorch_tpu_torch.models import build_model
from distributedpytorch_tpu_torch.models.resnet import FlaxBatchNorm2d, REMAT_POLICIES
from distributedpytorch_tpu_torch.predict import Predictor
from distributedpytorch_tpu_torch.train import config, optim
from distributedpytorch_tpu_torch.train.trainer import Trainer
from distributedpytorch_tpu_torch.utils.weights import (
    load_jax_params,
    state_dict_to_jax,
)
from test_torch_port_model import randomize
from test_torch_port_resume import StopAt, fit, tiny
from test_torch_port_train import Tiny, _no_dropout


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs in several
    processes at once, and torch's default of a thread per core in each
    of them oversubscribes the CPUs many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


ADAMW_CASES = {
    "plain": {},
    "warmup_lr_mult": {"warmup_steps": 2, "schedule": "poly",
                       "lr_mult": {"head": 10.0}},
    "freeze_clip": {"freeze": ("backbone",), "grad_clip_norm": 0.5,
                    "lr_mult": {"head": 3.0}},
}


class TestAdamW:
    @pytest.mark.parametrize("case", sorted(ADAMW_CASES))
    def test_three_updates_match_optax(self, case):
        kw = dict(name="adamw", lr=0.05, weight_decay=1e-2, adam_b1=0.8,
                  adam_b2=0.95, adam_eps=1e-6, **ADAMW_CASES[case])
        r = np.random.default_rng(7)
        tree = {"backbone": {"w": r.normal(size=(4, 3)).astype(np.float32),
                             "b": r.normal(size=3).astype(np.float32)},
                "head": {"w": r.normal(size=(3, 2)).astype(np.float32)}}
        tx, _ = jax_optim.make_optimizer(jax_config.OptimConfig(**kw), 10)
        params = jax.tree.map(jnp.asarray, tree)
        opt_state = tx.init(params)
        model = Tiny(tree)
        opt, sched = optim.make_optimizer(config.OptimConfig(**kw), model, 10)
        assert isinstance(opt, torch.optim.AdamW)
        named = dict(model.named_parameters())
        for step in range(3):
            grads = jax.tree.map(
                lambda a: (r.normal(size=a.shape) * 3).astype(np.float32), tree)
            updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads),
                                           opt_state, params)
            params = optax.apply_updates(params, updates)
            for mod, leaves in grads.items():
                for k, g in leaves.items():
                    p = named[f"{mod}.{k}"]
                    p.grad = torch.from_numpy(g) if p.requires_grad else None
            optim.apply_update(opt, sched, step, kw.get("grad_clip_norm"))
        for mod, leaves in params.items():
            for k, want in leaves.items():
                got = named[f"{mod}.{k}"].detach().numpy()
                assert np.abs(got - np.asarray(want)).max() <= \
                    1e-6 * max(1.0, float(np.abs(want).max())), (mod, k)

    def test_first_step_closed_form(self):
        """Adam's first step from zero moments: ``m_hat = g``, ``v_hat =
        g²``, so the update is ``-lr * (g / (|g| + eps)) - lr * wd * p``."""
        model = Tiny({"head": {"w": np.array([2.0, -1.5], np.float32)}})
        cfg = config.OptimConfig(name="adamw", lr=0.1, weight_decay=0.01)
        opt, sched = optim.make_optimizer(cfg, model, 10)
        (p,) = model.parameters()
        p0 = p.detach().clone().double()
        g = torch.tensor([0.5, 0.25])
        p.grad = g.clone()
        optim.apply_update(opt, sched, 0)
        want = -0.1 * (g.double() / (g.double().abs() + 1e-8)) - 0.1 * 0.01 * p0
        got = p.detach().double() - p0
        assert ((got - want).abs() / want.abs()).max() <= 1e-5

    def test_lr_mult_scales_the_whole_update(self):
        tree = {"frozen_tree": {"w": np.ones(1, np.float32)},
                "head": {"w": np.ones(1, np.float32)},
                "base": {"w": np.ones(1, np.float32)}}
        model = Tiny(tree)
        cfg = config.OptimConfig(name="adamw", lr=0.1, weight_decay=0.0,
                                 freeze=("frozen_tree",),
                                 lr_mult={"head": 10.0})
        opt, sched = optim.make_optimizer(cfg, model, 10)
        named = dict(model.named_parameters())
        for name, p in named.items():
            p.grad = None if not p.requires_grad else torch.full((1,), 0.5)
        optim.apply_update(opt, sched, 0)
        delta = {n: float(p.detach()) - 1.0 for n, p in named.items()}
        assert delta["frozen_tree.w"] == 0.0
        assert delta["head.w"] == pytest.approx(10.0 * delta["base.w"], rel=1e-5)

    def test_resume_equals_straight_run(self, tmp_path):
        adamw = ("optim.name=adamw", "checkpoint.keep_latest=1")
        straight = fit(tiny(tmp_path / "straight", *adamw))
        work = tmp_path / "preempted"
        stopped = fit(tiny(work, *adamw), StopAt(7))
        resumed = Trainer(tiny(work, *adamw, "resume=auto"),
                          device="cpu")
        restored = copy.deepcopy(resumed.state.optimizer.state_dict())
        resumed.fit()
        resumed.close()
        want = stopped.state.optimizer.state_dict()
        assert restored["state"].keys() == want["state"].keys()
        for i, st in want["state"].items():
            assert set(st) == {"step", "exp_avg", "exp_avg_sq"}
            for k, v in st.items():
                assert torch.equal(restored["state"][i][k], v), (i, k)
        assert resumed.state.step == straight.state.step == 10
        for k, v in straight.model.state_dict().items():
            assert torch.equal(resumed.model.state_dict()[k], v), k
        a, b = resumed.state.optimizer.state_dict(), straight.state.optimizer.state_dict()
        for i, st in b["state"].items():
            for k, v in st.items():
                assert torch.equal(a["state"][i][k], v), (i, k)


X_REMAT = np.random.RandomState(0).uniform(0, 255, (1, 32, 32, 4)).astype(np.float32)


@pytest.fixture(scope="module")
def r18_danet():
    jmodel = jax_build_model("danet", nclass=1, backbone="resnet18",
                             output_stride=8, attention_impl="xla")
    variables = randomize(jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 4)), train=False)), seed=9)
    return variables


def _port_grads(variables, policy=None, remat=True, dtype="float32",
                bn_fp32_stats=True, x=X_REMAT):
    """The port's DANet-R18 (dropout off) train-mode gradients of
    ``sum(out²)``, as a JAX params tree, and its state after the step."""
    model = build_model("danet", backbone="resnet18", dropout_rate=0.0,
                        remat=remat, remat_policy=policy, dtype=dtype,
                        bn_fp32_stats=bn_fp32_stats)
    load_jax_params(model, variables["params"], variables["batch_stats"])
    out = model.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    sum((o.float() ** 2).sum() for o in out).backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    grads.update(dict(model.named_buffers()))
    return state_dict_to_jax(grads)[0], model.state_dict(), out


class _CountConvolutions(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def no_remat_grads(r18_danet):
    """The step without remat, which every policy is held to."""
    return _port_grads(r18_danet, remat=False)


class TestRematPolicy:
    @pytest.mark.parametrize("policy", sorted(REMAT_POLICIES))
    def test_gradients_and_statistics_match_no_remat(self, r18_danet, policy,
                                                     no_remat_grads):
        g0, state0, _ = no_remat_grads
        g1, state1, _ = _port_grads(r18_danet, policy)
        assert_grads_close(g0, g1)
        for k, v in state0.items():
            assert torch.equal(state1[k], v), k

    def test_dots_saveable_matches_jax(self, r18_danet):
        m = jax_build_model("danet", nclass=1, backbone="resnet18",
                            output_stride=8, attention_impl="xla", remat=True,
                            remat_policy="dots_saveable")
        v = r18_danet

        def loss(p):
            with fnn.intercept_methods(_no_dropout):
                out, _ = m.apply({"params": p, "batch_stats": v["batch_stats"]},
                                 jnp.asarray(X_REMAT), train=True,
                                 mutable=["batch_stats"])
            return sum(jnp.sum(o.astype(jnp.float32) ** 2) for o in out)

        want = jax.grad(loss)(v["params"])
        got, _, _ = _port_grads(v, "dots_saveable")
        worst = 0.0
        for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                                jax.tree_util.tree_leaves(want)):
            w = np.asarray(w)
            bound = max(1.0, float(np.abs(w).max()))
            worst = max(worst, float(np.abs(np.asarray(g) - w).max()) / bound)
            assert np.abs(np.asarray(g) - w).max() <= 1e-4 * bound, \
                jax.tree_util.keystr(path)
        print(f"dots_saveable vs JAX: worst leaf {worst:.2e} of max(1, |g|)")

    @pytest.mark.parametrize("policy, recomputed", [
        ("nothing_saveable", "all"), ("dots_saveable", 0),
        ("dots_with_no_batch_dims_saveable", "all"),
        ("everything_saveable", 0)])
    def test_which_convolutions_are_recomputed(self, r18_danet, policy,
                                               recomputed):
        model = build_model("danet", backbone="resnet18", dropout_rate=0.0,
                            remat=True, remat_policy=policy)
        out = model.train()(torch.from_numpy(X_REMAT).permute(0, 3, 1, 2))
        counter = _CountConvolutions()
        with counter:
            sum((o ** 2).sum() for o in out).backward()
        block_convs = sum(1 for name, m in model.backbone.named_modules()
                          if "Block_" in name and isinstance(m, torch.nn.Conv2d))
        assert counter.n == (block_convs if recomputed == "all" else 0)

    def test_unknown_policy_raises_attribute_error(self):
        m = jax_build_model("danet", nclass=1, backbone="resnet18",
                            output_stride=8, remat=True,
                            remat_policy="no_such_policy")
        with pytest.raises(AttributeError):
            m.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 4)), train=False)
        with pytest.raises(AttributeError, match="no_such_policy"):
            build_model("danet", backbone="resnet18", remat=True,
                        remat_policy="no_such_policy")
        # as in JAX, the name is looked up only with remat on
        build_model("danet", backbone="resnet18", remat_policy="no_such_policy")


class TestBNStatDtype:
    def test_one_layer_matches_flax(self):
        r = np.random.default_rng(0)
        x = (r.normal(size=(2, 6, 7, 5)) * 3 + 1.5).astype(np.float32)
        dy = r.normal(size=x.shape).astype(np.float32)
        mean0 = r.normal(size=5).astype(np.float32)
        var0 = r.uniform(0.5, 2.0, 5).astype(np.float32)
        scale = r.uniform(0.5, 1.5, 5).astype(np.float32)
        bias = r.normal(size=5).astype(np.float32)
        bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                           epsilon=1e-5, dtype=jnp.bfloat16,
                           force_float32_reductions=False)

        def f(xx, s, b):
            return bn.apply({"params": {"scale": s, "bias": b},
                             "batch_stats": {"mean": mean0, "var": var0}},
                            xx, mutable=["batch_stats"])

        xb = jnp.asarray(x).astype(jnp.bfloat16)
        y, stats = f(xb, scale, bias)
        stats = stats["batch_stats"]
        _, vjp = jax.vjp(lambda a, s, b: f(a, s, b)[0], xb, jnp.asarray(scale),
                         jnp.asarray(bias))
        dx, ds, db = vjp(jnp.asarray(dy).astype(jnp.bfloat16))

        port = FlaxBatchNorm2d(5, eps=1e-5, momentum=0.1)
        port.fp32_stats = False
        with torch.no_grad():
            port.weight.copy_(torch.from_numpy(scale))
            port.bias.copy_(torch.from_numpy(bias))
            port.running_mean.copy_(torch.from_numpy(mean0))
            port.running_var.copy_(torch.from_numpy(var0))
        tx = torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16)
        tx.requires_grad_()
        out = port.train()(tx)
        assert out.dtype == torch.bfloat16
        assert port.running_mean.dtype == port.running_var.dtype == torch.float32
        out.backward(torch.from_numpy(dy).permute(0, 3, 1, 2).to(torch.bfloat16))

        def rel(got, want):
            got = np.asarray(got, np.float64)
            want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
            return np.abs(got - want).max() / np.abs(want).max()

        nhwc = lambda t: t.detach().float().permute(0, 2, 3, 1)
        assert rel(nhwc(out), y) <= 1e-2
        assert rel(nhwc(tx.grad), dx) <= 1e-2
        assert rel(port.running_mean, stats["mean"]) <= 2e-3
        assert rel(port.running_var, stats["var"]) <= 2e-3
        assert rel(port.weight.grad, ds) <= 1e-2
        assert rel(port.bias.grad, db) <= 1e-2

    def test_danet_bf16_train_forward_matches_jax(self, r18_danet):
        x = np.random.RandomState(0).uniform(0, 255, (2, 32, 32, 4)).astype(np.float32)
        m = jax_build_model("danet", nclass=1, backbone="resnet18",
                            output_stride=8, attention_impl="xla",
                            dtype="bfloat16", bn_fp32_stats=False)
        with fnn.intercept_methods(_no_dropout):
            out, upd = m.apply(r18_danet, jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
        model = build_model("danet", backbone="resnet18", dropout_rate=0.0,
                            dtype="bfloat16", bn_fp32_stats=False)
        load_jax_params(model, r18_danet["params"], r18_danet["batch_stats"])
        got = model.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
        params, stats = state_dict_to_jax(model.state_dict())
        assert jax.tree_util.tree_structure(params) == \
            jax.tree_util.tree_structure(r18_danet["params"])
        assert jax.tree_util.tree_structure(stats) == \
            jax.tree_util.tree_structure(upd["batch_stats"])
        for a, b in zip(jax.tree.leaves(stats), jax.tree.leaves(upd["batch_stats"])):
            np.testing.assert_allclose(np.asarray(a, np.float32),
                                       np.asarray(b, np.float32),
                                       rtol=0.1, atol=0.1)
        for g, w in zip(got, out):
            g = g.detach().float().permute(0, 2, 3, 1).numpy()
            w = np.asarray(w, np.float32)
            assert np.isfinite(g).all()
            assert np.abs(g - w).max() <= 5e-2 * max(1.0, np.abs(w).max())

    def test_semantic_model_accepts_flag_and_trees_cross(self):
        m = build_model("deeplabv3", nclass=21, backbone="resnet18",
                        in_channels=3, dtype="bfloat16", bn_fp32_stats=False,
                        aux_head=True)
        out = m.train()(torch.zeros(2, 3, 33, 33))
        assert all(torch.isfinite(o.float()).all() for o in out)
        plain = build_model("deeplabv3", nclass=21, backbone="resnet18",
                            in_channels=3, aux_head=True)
        plain.load_state_dict(m.state_dict(), strict=True)
        m.load_state_dict(plain.state_dict(), strict=True)


def test_fit_with_the_knobs_served_by_predictor(tmp_path):
    cfg = tiny(tmp_path, "epochs=1", "optim.name=adamw", "model.remat=true",
               "model.remat_policy=dots_saveable", "model.bn_fp32_stats=false")
    trainer = Trainer(cfg, device="cpu")
    trainer.fit()
    trainer.close()
    pred = Predictor.from_run(trainer.run_dir, device="cpu")
    x = torch.rand(1, 4, 32, 32) * 255
    model = trainer.model.eval()
    with torch.inference_mode():
        served, direct = pred.model(x), model(x)
    assert all(torch.equal(a, b) for a, b in zip(served, direct))
    assert os.path.isdir(os.path.join(trainer.run_dir, "checkpoints", "best"))
