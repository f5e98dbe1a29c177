"""The port's bf16 mixed precision against the JAX package's, on the CPU.

Weights: flax's initialisation as the port draws it (``flax_init_``, seed
0), with the residual gates set to 0.5 and each block's last BatchNorm
scale drawn from U(0.1, 0.3) (at their init value of 0 they would cut the
attention branches and the residual branches out of the gradients); the
same values go into both packages.  Tolerances, each measured here first:

* Policy: names, casts and ``block()`` identical to JAX's.
* bf16 forward of DANet-R18 at 64², B = 2, eval mode.  The backbone's
  stem output (c1) is bf16 bit for bit JAX's at >= 99% of its elements
  (99.88% seen: a float32 rounding-order difference rarely flips a bf16
  rounding), and each stage within 2 x JAX bf16's own distance from JAX
  float32 (largest ratio seen 1.12, c4).  The head's unscaled attention
  softmax compounds the flips: each logit within 3 x that distance
  (largest ratio seen 1.66).  Parameters stay float32, logits are bf16.
* ``pam_score_dtype=bfloat16``: the plain form within 1e-3 x max |out| of
  JAX's (3.9e-7 seen; a float32 summation-order difference can flip a
  score's bf16 rounding), while rounding the scores moves the output by
  more than that (1.3e-2).
* One bf16 train step (SGD lr 1e-2, momentum 0.9, no weight decay, dropout
  off): the loss within 1e-3 relative of JAX's (2.6e-4 seen); each
  parameter's gradient (read from the momentum buffer, which the first
  step sets to it) within 5e-2 x its float32 max |g| of JAX's or within
  4 x JAX bf16's distance from the port's float32 gradient, the larger
  (largest ratio seen 2.5), and the median of those ratios at most 2 (1.14
  seen: two bf16 computations of one gradient sit about as far from each
  other as from float32); a detached or wrong gradient is off by ~1.  The
  PAM key bias, zero in exact arithmetic, is held to the key weight's
  scale.  Three steps: losses within 1e-3 relative, parameters within
  2e-3 x max(1, max |leaf|) (8.5e-4 seen).  Gradients and momentum are
  float32, and at the reference's lr 5e-8 the float32 master weights take
  updates that a bf16 weight would lose.
* The kernels' autograd functions on bf16 CPU tensors (plain forms) give
  bf16 gradients within 2e-2 x max |g| of ``jax.grad`` of the
  ``custom_vjp``s in bf16 (6.5e-3 seen).
* Remat: gradients bitwise equal to the plain forward's, and BatchNorm's
  running statistics moved exactly once, in float32 and bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from distributedpytorch_tpu.models import build_model as jax_build_model
from distributedpytorch_tpu.models.resnet import ResNet as JaxResNet
from distributedpytorch_tpu.ops import attention as jatt
from distributedpytorch_tpu.ops import pallas_attention as jpallas
from distributedpytorch_tpu.parallel import TrainState as JaxTrainState
from distributedpytorch_tpu.parallel import make_train_step as jax_make_train_step
from distributedpytorch_tpu.train import config as jax_config
from distributedpytorch_tpu.train import optim as jax_optim
from distributedpytorch_tpu.train import precision as jax_precision
from distributedpytorch_tpu_torch.models import build_model
from distributedpytorch_tpu_torch.models.resnet import FlaxBatchNorm2d
from distributedpytorch_tpu_torch.ops import attention as tatt
from distributedpytorch_tpu_torch.ops import cuda_attention as ca
from distributedpytorch_tpu_torch.parallel.step import (
    create_train_state,
    make_train_step,
)
from distributedpytorch_tpu_torch.train import config, optim, precision
from distributedpytorch_tpu_torch.utils.weights import (
    jax_to_state_dict,
    state_dict_to_jax,
)

BF16 = torch.bfloat16
#: parameters whose gradient is zero in exact arithmetic, held to another's
GRAD_SCALE_OF = {"head.pam.key.bias": "head.pam.key.weight"}


def rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max()) / max(1e-30, float(np.abs(ref).max()))


class TestPolicy:
    @pytest.mark.parametrize("name", [None, "", "float32", "bfloat16"])
    def test_policy_matches_jax(self, name):
        got, want = precision.precision_policy(name), \
            jax_precision.precision_policy(name)
        assert (got is None) == (want is None)
        assert precision.precision_block(got) == jax_precision.precision_block(want)
        if want is not None:
            assert got.block() == want.block()
            assert (got.compute_dtype, got.param_dtype, got.loss_dtype) == \
                (want.compute_dtype, want.param_dtype, want.loss_dtype)

    def test_unknown_policy_raises_in_both(self):
        with pytest.raises(ValueError):
            jax_precision.precision_policy("fp16")
        with pytest.raises(ValueError):
            precision.precision_policy("fp16")
        with pytest.raises(ValueError):
            precision.apply_policy("fp16")

    def test_casts_match_jax(self):
        x = np.random.default_rng(0).normal(size=(3, 5)).astype(np.float32) * 7
        ids = np.arange(4, dtype=np.int32)
        pol, jpol = precision.Policy(), jax_precision.Policy()
        got = pol.cast_to_compute({"x": torch.from_numpy(x),
                                   "ids": torch.from_numpy(ids)})
        want = jpol.cast_to_compute({"x": jnp.asarray(x), "ids": jnp.asarray(ids)})
        assert got["x"].dtype == BF16 and got["ids"].dtype == torch.int32
        np.testing.assert_array_equal(got["x"].float().numpy(),
                                      np.asarray(want["x"], np.float32))
        outs = pol.cast_to_loss((got["x"], got["x"] * 2))
        assert isinstance(outs, tuple)
        assert all(o.dtype == torch.float32 for o in outs)

    @pytest.mark.parametrize("name", ["float32", "bfloat16"])
    def test_apply_policy_keeps_tf32_off(self, name):
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        policy = precision.apply_policy(name)
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        assert (policy is None) == (name == "float32")


def init_like_training(model: torch.nn.Module, seed: int = 0) -> None:
    """Open the gates and the residual branches of a fresh model."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("gamma"):
                p.fill_(0.5)
        for module in model.modules():
            if hasattr(module, "last_norm"):
                w = module.last_norm.weight
                w.copy_(torch.from_numpy(
                    rng.uniform(0.1, 0.3, w.shape).astype(np.float32)))


@pytest.fixture(scope="module")
def r18():
    """(port f32 state_dict, JAX variables) of one DANet-R18."""
    torch.manual_seed(0)
    model = build_model("danet", backbone="resnet18")
    init_like_training(model)
    params, stats = state_dict_to_jax(model.state_dict())
    return model.state_dict(), {"params": params, "batch_stats": stats}


def port_model(state, **kw):
    model = build_model("danet", backbone="resnet18", dropout_rate=0.0, **kw)
    model.load_state_dict(state)
    return model


def jax_model(**kw):
    return jax_build_model("danet", nclass=1, backbone="resnet18",
                           output_stride=8, attention_impl="auto", **kw)


def crops(b=2, size=64, seed=2):
    return np.random.default_rng(seed).uniform(
        0, 255, (b, size, size, 4)).astype(np.float32)


def test_bf16_forward_matches_jax(r18):
    state, variables = r18
    x = crops()
    model = port_model(state, dtype="bfloat16").eval()
    assert all(p.dtype == torch.float32 for p in model.parameters())
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = model(xt)
        feats = model.backbone(xt.to(BF16))
    # the backbone's stages: the stem's output is bf16 bit for bit but for
    # rare rounding flips, which the deeper stages compound
    refs = {}
    for dtype in ("bfloat16", "float32"):
        backbone = JaxResNet(depth=18, output_stride=8, dtype=jnp.dtype(dtype))
        refs[dtype] = backbone.apply(
            {"params": variables["params"]["backbone"],
             "batch_stats": variables["batch_stats"]["backbone"]},
            jnp.asarray(x), train=False)
    for stage in ("c1", "c2", "c3", "c4"):
        g = feats[stage].float().permute(0, 2, 3, 1).numpy()
        r = np.asarray(refs["bfloat16"][stage], np.float32)
        r32 = np.asarray(refs["float32"][stage])
        same = float((g == r).mean())
        err, bf16_err = rel(g, r), rel(r, r32)
        print(f"{stage}: {same:.4f} of elements bitwise equal to JAX bf16; "
              f"vs JAX bf16 {err:.3e}; JAX bf16 vs f32 {bf16_err:.3e}")
        assert err <= 2 * bf16_err
        if stage == "c1":
            assert same >= 0.99
    ref = jax_model(dtype="bfloat16").apply(variables, jnp.asarray(x), train=False)
    ref32 = jax_model().apply(variables, jnp.asarray(x), train=False)
    for g, r, r32 in zip(got, ref, ref32):
        assert g.dtype == BF16 and r.dtype == jnp.bfloat16
        g = g[:, 0].float().numpy()
        r, r32 = np.asarray(r, np.float32)[..., 0], np.asarray(r32)[..., 0]
        err, bf16_err = rel(g, r), rel(r, r32)
        print(f"logit vs JAX bf16 {err:.3e}; JAX bf16 vs JAX f32 {bf16_err:.3e}")
        assert err <= 3 * bf16_err


def test_pam_score_dtype_matches_jax():
    r = np.random.default_rng(5)
    q, k = (r.normal(size=(2, 200, 16)).astype(np.float32) for _ in range(2))
    v = r.normal(size=(2, 200, 32)).astype(np.float32)
    want = np.asarray(jatt.position_attention(
        *map(jnp.asarray, (q, k, v)), score_dtype=jnp.bfloat16))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    got = tatt.position_attention(*t, score_dtype=BF16)
    plain = tatt.position_attention(*t)
    assert got.dtype == torch.float32
    err, moved = rel(got, want), rel(plain, want)
    print(f"score_dtype bf16 vs JAX {err:.3e}; unrounded scores {moved:.3e}")
    assert err <= 1e-3 < moved


@pytest.fixture(scope="module")
def bf16_steps(r18):
    """Three bf16 train steps of both packages from the same weights and
    batches: (JAX states, JAX losses, port states, port losses), each
    state after each step."""
    state, variables = r18
    ocfg = dict(lr=1e-2, weight_decay=0.0)
    jpol = jax_precision.precision_policy("bfloat16")
    jmodel = jax_model(dtype=jpol.compute_dtype)
    tx, _ = jax_optim.make_optimizer(jax_config.OptimConfig(**ocfg), 10)
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=jax.tree.map(jnp.asarray,
                                                    variables["batch_stats"]),
                           opt_state=tx.init(params), rng=jax.random.PRNGKey(1))
    jstep = jax_make_train_step(jmodel, tx, donate=False, precision=jpol)

    model = port_model(state, dtype="bfloat16")
    opt, sched = optim.make_optimizer(config.OptimConfig(**ocfg), model, 10)
    tstate = create_train_state(model, opt, sched, 0, torch.device("cpu"))
    step = make_train_step(precision=precision.precision_policy("bfloat16"))

    def no_dropout(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout):
            return args[0]
        return next_fun(*args, **kwargs)

    r = np.random.default_rng(6)
    out = {"jax": [], "jax_loss": [], "port": [], "port_loss": [],
           "port_grad_dtypes": set()}
    for _ in range(3):
        batch = {"concat": crops(seed=int(r.integers(1 << 30))),
                 "crop_gt": (r.random((2, 64, 64, 1)) < 0.3).astype(np.float32)}
        with fnn.intercept_methods(no_dropout):
            jstate, jloss = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        loss = step(tstate, batch)
        out["port_grad_dtypes"] |= {p.grad.dtype for p in model.parameters()}
        out["jax"].append(jax.device_get(jstate))
        out["jax_loss"].append(float(jloss))
        out["port"].append({
            "model": {k: v.clone() for k, v in model.state_dict().items()},
            "momentum": {n: opt.state[p]["momentum_buffer"].clone()
                         for n, p in model.named_parameters()}})
        out["port_loss"].append(float(loss))
    return out


def _jax_momentum(jstate) -> dict:
    """The SGD trace (momentum) leaves of a JAX state, in port keys."""
    traces = [s for s in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda s: isinstance(s, optax.TraceState))
        if isinstance(s, optax.TraceState)]
    assert len(traces) == 1
    return jax_to_state_dict(traces[0].trace, {})


def test_bf16_step_gradients_match_jax(r18, bf16_steps):
    state, _ = r18
    assert abs(bf16_steps["port_loss"][0] - bf16_steps["jax_loss"][0]) <= \
        1e-3 * abs(bf16_steps["jax_loss"][0])
    # float32 gradients of the same step through the port's float32 path
    model = port_model(state).train()
    opt, sched = optim.make_optimizer(config.OptimConfig(lr=1e-2, weight_decay=0.0),
                                      model, 10)
    r = np.random.default_rng(6)
    batch = {"concat": crops(seed=int(r.integers(1 << 30))),
             "crop_gt": (r.random((2, 64, 64, 1)) < 0.3).astype(np.float32)}
    make_train_step()(create_train_state(model, opt, sched, 0,
                                         torch.device("cpu")), batch)
    f32 = {n: p.grad.numpy() for n, p in model.named_parameters()}
    got = {n: g.numpy() for n, g in bf16_steps["port"][0]["momentum"].items()}
    want = {n: g.numpy() for n, g in _jax_momentum(bf16_steps["jax"][0]).items()}
    assert bf16_steps["port_grad_dtypes"] == {torch.float32}
    assert all(g.dtype == np.float32 for g in got.values())
    ratios, failures = [], []
    for name, w in want.items():
        scale = float(np.abs(f32[GRAD_SCALE_OF.get(name, name)]).max())
        diff = float(np.abs(got[name] - w).max())
        own = float(np.abs(w - f32[name]).max())
        ratios.append(diff / max(own, 1e-30))
        if not diff <= max(5e-2 * scale, 4 * own):
            failures.append(f"{name}: {diff:.3e} > 5e-2 x {scale:.3e} and > "
                            f"4 x {own:.3e}")
    print(f"bf16 grads port vs JAX over JAX bf16 vs f32: median "
          f"{np.median(ratios):.3f}, largest {max(ratios):.3f}")
    assert not failures, failures
    # two bf16 computations of one gradient: each about as far from the
    # other as from float32 (independent roundings: ~1.4x)
    assert np.median(ratios) <= 2.0


def test_bf16_three_steps_match_jax(bf16_steps):
    for got, want in zip(bf16_steps["port_loss"], bf16_steps["jax_loss"]):
        assert abs(got - want) <= 1e-3 * abs(want)
    got_params, got_stats = state_dict_to_jax(bf16_steps["port"][-1]["model"])
    jstate = bf16_steps["jax"][-1]
    worst = 0.0
    for got_tree, want_tree in ((got_params, jstate.params),
                                (got_stats, jstate.batch_stats)):
        for (path, g), (_, w) in zip(
                jax.tree_util.tree_leaves_with_path(got_tree),
                jax.tree_util.tree_leaves_with_path(want_tree)):
            g, w = np.asarray(g), np.asarray(w)
            assert g.dtype == w.dtype == np.float32
            bound = max(1.0, float(np.abs(w).max()))
            worst = max(worst, float(np.abs(g - w).max()) / bound)
            assert float(np.abs(g - w).max()) <= 2e-3 * bound, \
                jax.tree_util.keystr(path)
    print(f"three bf16 steps: worst leaf {worst:.3e} of max(1, |leaf|)")
    assert all(m.dtype == torch.float32
               for m in bf16_steps["port"][-1]["momentum"].values())


def test_float32_master_weights_keep_small_updates(r18):
    """At the reference's lr 5e-8 an update is far below a bf16 weight's
    resolution: the float32 master weights take it."""
    state, _ = r18
    model = port_model(state, dtype="bfloat16")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt, sched = optim.make_optimizer(config.OptimConfig(), model, 10)
    step = make_train_step(precision=precision.precision_policy("bfloat16"))
    r = np.random.default_rng(8)
    step(create_train_state(model, opt, sched, 0, torch.device("cpu")),
         {"concat": crops(), "crop_gt": (r.random((2, 64, 64, 1)) < 0.3)
          .astype(np.float32)})
    moved = lost = 0
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32
        changed = p.detach() != before[name]
        moved += int(changed.sum())
        # the same update applied to a bf16 weight
        lost += int((changed & (p.detach().to(BF16) == before[name].to(BF16))).sum())
    print(f"lr 5e-8: {moved} weights moved, {lost} of them by less than "
          "a bf16 weight could hold")
    assert moved > 0 and lost > 0.9 * moved


class TestKernelAutogradBf16:
    def test_position_grads_match_jax(self):
        r = np.random.default_rng(9)
        q, k = ((r.normal(size=(2, 300, 16)) * 0.5).astype(np.float32)
                for _ in range(2))
        v = r.normal(size=(2, 300, 32)).astype(np.float32)
        g = r.normal(size=(2, 300, 32)).astype(np.float32)
        jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, g)]
        ref = jax.grad(lambda q, k, v: jnp.sum(
            (jpallas.flash_position_attention(q, k, v, 128, 128, None, True)
             * jb[3]).astype(jnp.float32)), argnums=(0, 1, 2))(*jb[:3])
        tq, tk, tv = (torch.from_numpy(a).to(BF16).requires_grad_()
                      for a in (q, k, v))
        out = ca.flash_position_attention(tq, tk, tv, 128, 128)
        assert out.dtype == BF16
        (out.float() * torch.from_numpy(g).to(BF16).float()).sum().backward()
        for got, want in zip((tq.grad, tk.grad, tv.grad), ref):
            assert got.dtype == BF16 and want.dtype == jnp.bfloat16
            err = rel(got.float(), np.asarray(want, np.float32))
            print(f"position grad vs JAX custom_vjp, bf16: {err:.3e}")
            assert err <= 2e-2

    def test_channel_grads_match_jax(self):
        r = np.random.default_rng(10)
        x = (r.normal(size=(2, 100, 32)) * 0.3).astype(np.float32)
        g = r.normal(size=(2, 100, 32)).astype(np.float32)
        jx, jg = jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
        ref = jax.grad(lambda x: jnp.sum(
            (jpallas.flash_channel_attention(x, 64, True) * jg)
            .astype(jnp.float32)))(jx)
        tx = torch.from_numpy(x).to(BF16).requires_grad_()
        out = ca.flash_channel_attention(tx)
        assert out.dtype == BF16
        (out.float() * torch.from_numpy(g).to(BF16).float()).sum().backward()
        assert tx.grad.dtype == BF16 and ref.dtype == jnp.bfloat16
        err = rel(tx.grad.float(), np.asarray(ref, np.float32))
        print(f"channel grad vs JAX custom_vjp, bf16: {err:.3e}")
        assert err <= 2e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_is_bitwise_and_moves_bn_stats_once(r18, dtype):
    state, _ = r18
    x = torch.from_numpy(crops()).permute(0, 3, 1, 2)
    grads, stats = {}, {}
    for remat in (False, True):
        model = port_model(state, dtype=dtype, remat=remat).train()
        sum(o.float().sum() for o in model(x)).backward()
        grads[remat] = {n: p.grad for n, p in model.named_parameters()}
        stats[remat] = {n: b for n, b in model.named_buffers()}
        norms = [m for m in model.modules() if isinstance(m, FlaxBatchNorm2d)]
        assert all(int(m.num_batches_tracked) == 1 for m in norms)
    for name, g in grads[False].items():
        assert torch.equal(grads[True][name], g), name
    for name, b in stats[False].items():
        assert torch.equal(stats[True][name], b), name
    # the running statistics did move, once
    assert not torch.equal(stats[True]["backbone.BatchNorm_0.running_mean"],
                           state["backbone.BatchNorm_0.running_mean"])
