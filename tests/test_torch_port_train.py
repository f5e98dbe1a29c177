"""The port's training pieces against the JAX package's, on the CPU.

* The attention autograd functions: on CPU tensors the forward is the
  plain form, so their backward (a recompute through the plain forms, as
  the JAX ``custom_vjp``s do) is checked here — by ``gradcheck`` in
  float64, and against ``jax.grad`` of the Pallas ``custom_vjp``s in
  interpret mode within 1e-5 x max |g| (float32).
* BatchNorm's train-mode statistics against flax's within 1e-6 relative
  (flax moves the running variance towards the biased batch variance).
* The balanced BCE and the multi-output loss within 1e-6 relative.
* SGD with weight decay and momentum, ``freeze``, ``lr_mult`` and
  ``grad_clip_norm``: five updates against the optax chain within 1e-6
  relative, and the schedules' values.
* Three train steps of DANet-R18 at 64², B = 2, lr 1e-2, from the same
  weights (``load_jax_params``): losses within 1e-4 relative per step,
  parameters and BatchNorm statistics after step 3 within 1e-4 x max(1,
  max |leaf|), for ``accum_steps`` 1 and 2.  JAX's dropout is made the
  identity with ``flax.linen.intercept_methods``; the port runs at rate 0.
  Largest differences seen: losses 5.3e-7 relative (``accum_steps`` 1) and
  1.3e-7 (2), leaves 9.8e-6 and 2.2e-5 of max(1, max |leaf|) (printed by
  the test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from distributedpytorch_tpu.models import build_model as jax_build_model
from distributedpytorch_tpu.ops import losses as jax_losses
from distributedpytorch_tpu.ops import pallas_attention as jpallas
from distributedpytorch_tpu.parallel import TrainState as JaxTrainState
from distributedpytorch_tpu.parallel import make_train_step as jax_make_train_step
from distributedpytorch_tpu.train import config as jax_config
from distributedpytorch_tpu.train import optim as jax_optim
from distributedpytorch_tpu_torch.models import build_model
from distributedpytorch_tpu_torch.models.resnet import FlaxBatchNorm2d
from distributedpytorch_tpu_torch.ops import attention as tatt
from distributedpytorch_tpu_torch.ops import cuda_attention as ca
from distributedpytorch_tpu_torch.ops import losses
from distributedpytorch_tpu_torch.parallel.step import (
    create_train_state,
    make_train_step,
)
from distributedpytorch_tpu_torch.train import config
from distributedpytorch_tpu_torch.train import optim
from distributedpytorch_tpu_torch.utils.weights import (
    load_jax_params,
    state_dict_to_jax,
)
from test_torch_port_model import randomize


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max()) / max(1e-30, float(np.abs(ref).max()))


class TestAttentionAutograd:
    def test_gradcheck_position_float64(self):
        r = np.random.RandomState(0)
        q, k, v = (torch.from_numpy(r.randn(1, 12, c)).requires_grad_()
                   for c in (3, 3, 5))
        assert torch.autograd.gradcheck(
            lambda q, k, v: ca.flash_position_attention(q, k, v, 8, 5), (q, k, v))
        assert torch.autograd.gradcheck(
            lambda q, k, v: ca.flash_position_attention(q, k, v, 8, 5, 0.5),
            (q, k, v))

    def test_gradcheck_channel_float64(self):
        x = torch.from_numpy(np.random.RandomState(1).randn(2, 7, 4) * 0.5)
        assert torch.autograd.gradcheck(ca.flash_channel_attention,
                                        (x.requires_grad_(),))

    @pytest.mark.parametrize("scale", [None, 0.125])
    def test_position_grads_match_jax_custom_vjp(self, scale):
        r = np.random.RandomState(2)
        q, k, v = (r.randn(2, 300, c).astype(np.float32) for c in (16, 16, 32))
        g = r.randn(2, 300, 32).astype(np.float32)

        def jloss(q, k, v):
            out = jpallas.flash_position_attention(q, k, v, 128, 128, scale, True)
            return jnp.sum(out * g)

        ref = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
        tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        out = ca.flash_position_attention(tq, tk, tv, 128, 128, scale=scale)
        (out * torch.from_numpy(g)).sum().backward()
        for got, want in zip((tq.grad, tk.grad, tv.grad), ref):
            want = np.asarray(want)
            assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()

    def test_channel_grads_match_jax_custom_vjp(self):
        r = np.random.RandomState(3)
        x = (r.randn(2, 100, 32) * 0.3).astype(np.float32)
        g = r.randn(2, 100, 32).astype(np.float32)
        ref = np.asarray(jax.grad(lambda x: jnp.sum(
            jpallas.flash_channel_attention(x, 64, True) * g))(jnp.asarray(x)))
        tx = torch.from_numpy(x).requires_grad_()
        (ca.flash_channel_attention(tx) * torch.from_numpy(g)).sum().backward()
        assert np.abs(tx.grad.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()

    def test_outputs_are_never_detached(self):
        q, k, v = (torch.randn(1, 20, c, requires_grad=True) for c in (4, 4, 6))
        assert ca.flash_position_attention(q, k, v).grad_fn is not None
        x = torch.randn(1, 20, 6, requires_grad=True)
        assert ca.flash_channel_attention(x).grad_fn is not None
        # only v requires grad: still attached, and only v gets a gradient
        q, k = q.detach(), k.detach()
        out = ca.flash_position_attention(q, k, v)
        assert out.grad_fn is not None
        out.sum().backward()
        assert q.grad is None and v.grad is not None

    def test_danet_kernel_path_trains_query_key_value(self):
        """The repaired fault: through the kernel functions the PAM convs
        upstream of attention get the plain path's gradients."""
        torch.manual_seed(0)
        model = build_model("danet", backbone="resnet18", dropout_rate=0.0)
        with torch.no_grad():
            model.head.pam.gamma.fill_(0.7)
            model.head.cam.gamma.fill_(0.4)
        x = torch.rand(1, 4, 32, 32) * 255
        grads = {}
        for impl in ("flash", "xla"):
            model.zero_grad()
            model.set_attention_impl(impl)
            sum(o.sum() for o in model.train()(x)).backward()
            grads[impl] = {n: p.grad.clone() for n, p in model.named_parameters()}
        for name in ("head.pam.query.weight", "head.pam.key.weight",
                     "head.pam.value.weight", "head.pam_in_conv.weight",
                     "head.cam_in_conv.weight"):
            got, want = grads["flash"][name], grads["xla"][name]
            assert want.abs().max() > 0
            assert (got - want).abs().max() <= 1e-4 * want.abs().max()


class TestBatchNormTrainMode:
    def test_running_stats_match_flax(self):
        r = np.random.default_rng(0)
        x = (r.normal(size=(2, 5, 6, 7)) * 3 + 1.5).astype(np.float32)
        mean0 = r.normal(size=7).astype(np.float32)
        var0 = r.uniform(0.5, 2.0, 7).astype(np.float32)
        scale = r.uniform(0.5, 1.5, 7).astype(np.float32)
        bias = r.normal(size=7).astype(np.float32)
        bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                           epsilon=1e-5)
        ref, mutated = bn.apply(
            {"params": {"scale": scale, "bias": bias},
             "batch_stats": {"mean": mean0, "var": var0}},
            jnp.asarray(x), mutable=["batch_stats"])
        port = FlaxBatchNorm2d(7, eps=1e-5, momentum=0.1)
        with torch.no_grad():
            port.weight.copy_(torch.from_numpy(scale))
            port.bias.copy_(torch.from_numpy(bias))
            port.running_mean.copy_(torch.from_numpy(mean0))
            port.running_var.copy_(torch.from_numpy(var0))
        out = port.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
        stats = mutated["batch_stats"]
        assert rel_err(port.running_mean, stats["mean"]) <= 1e-6
        assert rel_err(port.running_var, stats["var"]) <= 1e-6
        assert rel_err(out.detach().permute(0, 2, 3, 1), ref) <= 1e-5
        # torch's own module would move towards the unbiased variance
        plain = torch.nn.BatchNorm2d(7, momentum=0.1)
        plain.running_var.copy_(torch.from_numpy(var0))
        plain.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
        assert rel_err(plain.running_var, stats["var"]) > 1e-4


class TestLoss:
    @pytest.mark.parametrize("with_void", [False, True])
    @pytest.mark.parametrize("balanced", [True, False])
    def test_multi_output_loss_matches_jax(self, with_void, balanced):
        r = np.random.default_rng(4)
        outs = [(r.normal(size=(2, 1, 16, 20)) * 3).astype(np.float32)
                for _ in range(3)]
        gt = (r.random((2, 1, 16, 20)) < 0.2).astype(np.float32)
        void = (r.random((2, 1, 16, 20)) < 0.1).astype(np.float32) \
            if with_void else None
        nhwc = lambda a: None if a is None else jnp.asarray(a.transpose(0, 2, 3, 1))
        ref = jax_losses.multi_output_loss(
            tuple(map(nhwc, outs)), nhwc(gt), void=nhwc(void),
            weights=(1.0, 0.5, 0.25), balanced=balanced)
        got = losses.multi_output_loss(
            [torch.from_numpy(o) for o in outs], torch.from_numpy(gt),
            None if void is None else torch.from_numpy(void),
            weights=(1.0, 0.5, 0.25), balanced=balanced)
        assert rel_err(got, ref) <= 1e-6

    def test_batch_wide_balance_and_broadcast_trap(self):
        logits = torch.zeros(2, 1, 4, 4)
        gt = torch.zeros(2, 1, 4, 4)
        gt[0, 0, :2] = 1.0  # positives only in image 0: 8 of 32 pixels
        # w_pos = 1 - 8/32 over the batch; per image it would differ
        expect = np.log(2.0) * (8 * 0.75 + 24 * 0.25) / 32
        assert abs(float(losses.sigmoid_balanced_bce(logits, gt)) - expect) < 1e-6
        with pytest.raises(ValueError, match="one shape"):
            losses.sigmoid_balanced_bce(logits, gt[:, 0])


class Tiny(torch.nn.Module):
    """Parameters named ``backbone.w``, ``backbone.b``, ``head.w``."""

    def __init__(self, tree):
        super().__init__()
        for mod, leaves in tree.items():
            self.add_module(mod, torch.nn.ParameterDict(
                {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                 for k, v in leaves.items()}))


OPTIM_CASES = {
    "sgd_wd_momentum": {},
    "freeze": {"freeze": ("backbone",)},
    "lr_mult": {"lr_mult": {"head": 10.0}},
    "clip": {"grad_clip_norm": 1.0},
    "clip_freeze_mult": {"grad_clip_norm": 0.5, "freeze": ("head",),
                         "lr_mult": {"backbone": 3.0}},
}


class TestOptimizer:
    @pytest.mark.parametrize("case", sorted(OPTIM_CASES))
    def test_five_updates_match_optax(self, case):
        kw = dict(lr=0.1, weight_decay=1e-2, **OPTIM_CASES[case])
        r = np.random.default_rng(5)
        tree = {"backbone": {"w": r.normal(size=(4, 3)).astype(np.float32),
                             "b": r.normal(size=3).astype(np.float32)},
                "head": {"w": r.normal(size=(3, 2)).astype(np.float32)}}
        tx, _ = jax_optim.make_optimizer(jax_config.OptimConfig(**kw), 10)
        params = jax.tree.map(jnp.asarray, tree)
        opt_state = tx.init(params)
        model = Tiny(tree)
        opt, sched = optim.make_optimizer(config.OptimConfig(**kw), model, 10)
        named = dict(model.named_parameters())
        for step in range(5):
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
                    1e-6 * max(1.0, float(np.abs(want).max()))
        frozen = OPTIM_CASES[case].get("freeze", ())
        for name, p in named.items():
            assert p.requires_grad == (name.split(".")[0] not in frozen)

    @pytest.mark.parametrize("schedule", ["constant", "poly", "cosine"])
    @pytest.mark.parametrize("warmup", [0, 4])
    def test_schedules_match_optax(self, schedule, warmup):
        kw = dict(lr=0.02, schedule=schedule, warmup_steps=warmup)
        ref = jax_optim.make_schedule(jax_config.OptimConfig(**kw), 20)
        got = optim.make_schedule(config.OptimConfig(**kw), 20)
        for step in (0, 1, warmup, 7, 20):
            want = float(ref(step))
            assert abs(got(step) - want) <= 1e-6 * max(1e-30, abs(want)) + 1e-12
        if warmup:
            assert got(0) == 0.0

    def test_unmatched_prefix_and_adamw_raise(self):
        """An unmatched prefix raises; ``adamw`` no longer does (its parity
        with optax is ``test_torch_port_knobs.py``'s), an unknown
        optimizer still does."""
        model = Tiny({"head": {"w": np.zeros(2, np.float32)}})
        with pytest.raises(ValueError, match="matched no parameter"):
            optim.make_optimizer(config.OptimConfig(freeze=("neck",)), model, 1)
        with pytest.raises(ValueError, match="unknown optimizer"):
            optim.make_optimizer(config.OptimConfig(name="lion"), model, 1)


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, fnn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


@pytest.fixture(scope="module")
def r18_variables():
    model = jax_build_model("danet", nclass=1, backbone="resnet18",
                            output_stride=8, attention_impl="xla")
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 4)), train=False))
    return model, randomize(shapes)


@pytest.mark.parametrize("accum", [1, 2])
def test_three_step_trajectory_matches_jax(r18_variables, accum):
    jmodel, variables = r18_variables
    ocfg = dict(lr=1e-2)
    tx, _ = jax_optim.make_optimizer(jax_config.OptimConfig(**ocfg), 10)
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=jax.tree.map(jnp.asarray,
                                                    variables["batch_stats"]),
                           opt_state=tx.init(params),
                           rng=jax.random.PRNGKey(1))
    jstep = jax_make_train_step(jmodel, tx, accum_steps=accum, donate=False)

    model = build_model("danet", backbone="resnet18", dropout_rate=0.0)
    load_jax_params(model, variables["params"], variables["batch_stats"])
    opt, sched = optim.make_optimizer(config.OptimConfig(**ocfg), model, 10)
    state = create_train_state(model, opt, sched, 0, torch.device("cpu"))
    step = make_train_step(accum_steps=accum)

    r = np.random.default_rng(6)
    worst = 0.0
    for _ in range(3):
        batch = {"concat": r.uniform(0, 255, (2, 64, 64, 4)).astype(np.float32),
                 "crop_gt": (r.random((2, 64, 64, 1)) < 0.3).astype(np.float32)}
        with fnn.intercept_methods(_no_dropout):
            jstate, jloss = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        loss = step(state, batch)
        err = abs(float(loss) - float(jloss)) / abs(float(jloss))
        worst = max(worst, err)
        assert err <= 1e-4
    got_params, got_stats = state_dict_to_jax(model.state_dict())
    leaf_worst = 0.0
    for got_tree, want_tree in ((got_params, jstate.params),
                                (got_stats, jstate.batch_stats)):
        got_flat = jax.tree_util.tree_leaves_with_path(got_tree)
        want_flat = jax.tree_util.tree_leaves_with_path(want_tree)
        assert [p for p, _ in got_flat] == [p for p, _ in want_flat]
        for (path, g), (_, w) in zip(got_flat, want_flat):
            w = np.asarray(w)
            bound = max(1.0, float(np.abs(w).max()))
            diff = float(np.abs(np.asarray(g) - w).max())
            leaf_worst = max(leaf_worst, diff / bound)
            assert diff <= 1e-4 * bound, jax.tree_util.keystr(path)
    print(f"accum {accum}: worst loss rel {worst:.2e}, worst leaf "
          f"{leaf_worst:.2e} of max(1, |leaf|)")
    assert state.step == 3
