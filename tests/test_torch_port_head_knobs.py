"""DANet's head knobs in the port against the JAX package, on the CPU:
``pam_impl`` and ``pam_block_size`` (the position branch's forms) and the
mixture-of-experts head (``model.moe_*``).

Inputs come from numpy seeds and go through the JAX function and its port.

* ``blocked_position_attention`` against JAX's, float32 (within 1e-5 of
  the output's largest value) and bfloat16 (within 1e-2: one bf16
  rounding of the output), at a key block that divides N and at one that
  leaves a ragged last block; the output in ``v.dtype``.
  ``pam_score_dtype`` does not act on the blocked form (bitwise).
* ``build_model``'s resolution of ``pam_impl`` x ``attention_impl`` (and
  ``pam_block_size``) equal to JAX's; the DANet-only knobs refused on
  DeepLabV3 with JAX's messages; ``pam_impl=ring`` and unknown forms.
* ``router``: the (expert, slot, keep) routing written out as JAX's
  one-hot ``dispatch`` is equal to it, for k = 1 and 2, at capacity
  factors 1.25 and 0.5 (tokens drop); ``combine`` and ``aux`` within
  1e-6.  Each routing test first asserts that every token's gap between
  its k-th and (k+1)-th probability exceeds 1e-4, so that summation
  order cannot flip a choice.
* ``moe_ffn`` and ``moe_ffn_dense`` against JAX's ``moe_ffn``: output,
  aux and the gradients of ``x`` and the five parameters (``jax.grad``)
  within 1e-5 of each one's largest value.  ``MoEMlp`` against JAX's,
  and its init against flax's ``lecun_normal`` on the stacked shapes.
* DANet-R18 at 32² with ``moe_experts=2`` (weights carried across) in
  eval mode: the three logits within 1e-4 of max(1, max |logit|); the
  decode stage of a head-injected MoE model bitwise its full forward.
* The train loss with the aux term (weight 0.01) against JAX's
  ``_loss_and_updates`` within 1e-5 relative, ``w_gate`` getting a
  gradient; bf16 with remat and ``accum_steps=2`` trains, the MoE in
  float32.
* A 2-step MoE fit through ``Trainer`` resumed to 4 steps, bitwise a
  straight 4-step fit, served by ``Predictor.from_run``; the refusals by
  name (MoE at world size 2, ``pam_impl=ring``, ``k > E``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from distributedpytorch_tpu.models import build_model as jax_build_model
from distributedpytorch_tpu.models.danet import (
    PositionAttentionModule as JaxPositionAttention,
)
from distributedpytorch_tpu.ops import attention as jatt
from distributedpytorch_tpu.parallel import moe as jmoe
from distributedpytorch_tpu.parallel.step import _loss_and_updates
from distributedpytorch_tpu_torch.models import build_model
from distributedpytorch_tpu_torch.models.danet import PositionAttentionModule
from distributedpytorch_tpu_torch.ops import attention as tatt
from distributedpytorch_tpu_torch.parallel import mesh
from distributedpytorch_tpu_torch.parallel import moe
from distributedpytorch_tpu_torch.parallel.step import (
    create_train_state,
    make_train_step,
)
from distributedpytorch_tpu_torch.predict import Predictor
from distributedpytorch_tpu_torch.train import config, optim
from distributedpytorch_tpu_torch.train.precision import precision_policy
from distributedpytorch_tpu_torch.train.trainer import Trainer
from distributedpytorch_tpu_torch.utils.weights import (
    jax_to_state_dict,
    load_jax_params,
    state_dict_to_jax,
)
from test_torch_port_model import randomize
from test_torch_port_train import _no_dropout

#: every token's gap between its k-th and (k+1)-th router probability
MARGIN = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs in several
    processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = tol * max(1e-30, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= bound, \
        (float(np.abs(got - want).max()), bound)


def _assert_margin(probs, k):
    """No token's choice among its top ``k`` can flip: each gap between
    consecutive sorted probabilities up to the (k+1)-th exceeds
    :data:`MARGIN`."""
    p = -np.sort(-np.asarray(probs, np.float64), axis=-1)
    gaps = p[:, :k] - p[:, 1:k + 1]
    assert gaps.min() > MARGIN, gaps.min()


# -- the position branch's forms ---------------------------------------------

def _qkv(dtype, n=64, ck=8, cv=16, seed=0):
    r = np.random.default_rng(seed)
    q, k = (0.5 * r.normal(size=(2, n, ck)) for _ in range(2))
    v = r.normal(size=(2, n, cv))
    return [a.astype(np.float32) for a in (q, k, v)], dtype


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", [16, 24])  # 64 = 4 x 16 = 2 x 24 + 16
def test_blocked_matches_jax(dtype, block):
    (q, k, v), _ = _qkv(dtype)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = jatt.blocked_position_attention(
        *(jnp.asarray(a).astype(jd) for a in (q, k, v)), block)
    got = tatt.blocked_position_attention(
        *(_t(a).to(td) for a in (q, k, v)), block_size=block)
    assert got.dtype == td and want.dtype == jd
    _close(got.float(), np.asarray(want.astype(jnp.float32)),
           1e-5 if dtype == "float32" else 1e-2)
    # and the full form it stands for
    _close(got.float(), tatt.position_attention(
        *(_t(a).to(td) for a in (q, k, v))).float(),
        1e-5 if dtype == "float32" else 1e-2)


def test_score_dtype_does_not_act_on_the_blocked_form():
    torch.manual_seed(0)
    x = torch.randn(2, 16, 8, 8)
    plain = PositionAttentionModule(16, "einsum", block_size=24)
    rounded = PositionAttentionModule(16, "einsum", torch.bfloat16, 24)
    rounded.load_state_dict(plain.state_dict())
    with torch.no_grad():
        plain.gamma.fill_(0.7)
        rounded.gamma.fill_(0.7)
        assert torch.equal(plain(x), rounded(x))
        full = PositionAttentionModule(16, "einsum", torch.bfloat16)
        full.load_state_dict(plain.state_dict())
        assert not torch.equal(full(x), plain(x))


ATTENTION_IMPLS = ["auto", "xla", "flash"]
PAM_IMPLS = ["", "auto", "einsum", "flash"]


@pytest.mark.parametrize("attention_impl", ATTENTION_IMPLS)
@pytest.mark.parametrize("pam_impl", PAM_IMPLS)
def test_pam_impl_resolution_matches_jax(attention_impl, pam_impl):
    ref = jax_build_model("danet", backbone="resnet18",
                          attention_impl=attention_impl, pam_impl=pam_impl,
                          pam_block_size=128)
    with torch.device("meta"):
        got = build_model("danet", backbone="resnet18",
                          attention_impl=attention_impl, pam_impl=pam_impl,
                          pam_block_size=128)
    assert (got.head.pam.impl, got.head.cam.impl) == (ref.pam_impl,
                                                      ref.cam_impl)
    assert got.head.pam.block_size == ref.pam_block_size == 128


@pytest.mark.parametrize("knob", [
    "pam_block_size=256", "pam_impl=\"flash\"", "moe_experts=2",
    "moe_hidden=64", "moe_k=2", "moe_capacity_factor=2.0"])
def test_danet_only_knobs_refused_with_jax_messages(knob):
    name, value = knob.split("=")
    kw = {name: json.loads(value)}
    with pytest.raises(ValueError) as want:
        jax_build_model("deeplabv3", backbone="resnet18", **kw)
    with pytest.raises(ValueError) as got:
        build_model("deeplabv3", backbone="resnet18", **kw)
    assert str(got.value) == str(want.value)
    # the accepted defaults, JAX's legacy spelling of pam_impl included
    with torch.device("meta"):
        build_model("deeplabv3", backbone="resnet18", pam_impl="einsum",
                    **{name: None} if name in ("pam_block_size",
                                               "moe_hidden") else {})


def test_unknown_and_ring_pam_impl():
    x = np.zeros((1, 4, 4, 16), np.float32)
    with pytest.raises(ValueError) as want:
        JaxPositionAttention(channels=16, norm=None, impl="cuda").init(
            jax.random.PRNGKey(0), jnp.asarray(x))
    module = PositionAttentionModule(16, "cuda")
    with pytest.raises(ValueError) as got:
        module(torch.zeros(1, 16, 4, 4))
    assert str(got.value) == str(want.value)
    module.impl = "ring"
    with pytest.raises(NotImplementedError, match="model.pam_impl=ring"):
        module(torch.zeros(1, 16, 4, 4))


# -- routing and the MoE FFN ------------------------------------------------

def _stacked(d=16, e=4, h=24, seed=0, scale=0.5):
    r = np.random.default_rng(seed)
    return {"w_gate": (scale * r.normal(size=(d, e))).astype(np.float32),
            "w1": (r.normal(size=(e, d, h)) / np.sqrt(d)).astype(np.float32),
            "b1": (0.1 * r.normal(size=(e, h))).astype(np.float32),
            "w2": (r.normal(size=(e, h, d)) / np.sqrt(h)).astype(np.float32),
            "b2": (0.1 * r.normal(size=(e, d))).astype(np.float32)}


def _tokens(n=96, d=16, seed=1):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _dense(route: moe.Routing, n_experts: int, capacity: int):
    """The port's routing written out as JAX's (N, E, C) tensors."""
    k, n = route.expert.shape
    dispatch = np.zeros((n, n_experts, capacity), np.float32)
    combine = np.zeros_like(dispatch)
    for r in range(k):
        for t in range(n):
            if route.keep[r, t]:
                e, s = int(route.expert[r, t]), int(route.slot[r, t])
                dispatch[t, e, s] += 1.0
                combine[t, e, s] += float(route.gate[r, t])
    return dispatch, combine


CASES = [(1, 1.25), (1, 0.5), (2, 1.25), (2, 0.5)]


@pytest.mark.parametrize("k, factor", CASES)
def test_router_matches_jax(k, factor):
    x, p = _tokens(), _stacked()
    n, e = x.shape[0], p["w_gate"].shape[1]
    _assert_margin(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(p["w_gate"])),
                   k)
    cap = jmoe.expert_capacity(n, e, factor)
    assert moe.expert_capacity(n, e, factor) == cap
    d_want, c_want, aux_want = jmoe.router(
        jnp.asarray(x), jnp.asarray(p["w_gate"]), k=k, capacity=cap)
    route = moe.router(_t(x), _t(p["w_gate"]), k=k, capacity=cap)
    dispatch, combine = _dense(route, e, cap)
    np.testing.assert_array_equal(dispatch, np.asarray(d_want))
    assert np.abs(combine - np.asarray(c_want)).max() <= 1e-6
    assert abs(float(route.aux) - float(aux_want)) <= 1e-6
    if factor < 1:
        assert not route.keep.all()  # tokens drop
    # the dense transcription routes the same
    d_dense, c_dense, aux_dense = moe.router_dense(
        _t(x), _t(p["w_gate"]), k=k, capacity=cap)
    np.testing.assert_array_equal(d_dense.numpy(), dispatch)
    assert np.abs(c_dense.numpy() - combine).max() <= 1e-6
    assert abs(float(aux_dense) - float(aux_want)) <= 1e-6


def test_second_choice_slots_follow_every_first_choice():
    """k = 2's second round starts after ALL the first round's claims of
    an expert, dropped ones included (JAX's ``prior_alloc``)."""
    x, p = _tokens(), _stacked()
    route = moe.router(_t(x), _t(p["w_gate"]), k=2, capacity=4)
    first = np.bincount(route.expert[0].numpy(), minlength=4)
    for e in range(4):
        second = route.slot[1][route.expert[1] == e].numpy()
        assert np.array_equal(np.sort(second),
                              first[e] + np.arange(len(second)))
    assert (route.expert[0] != route.expert[1]).all()


@pytest.mark.parametrize("fn", ["moe_ffn", "moe_ffn_dense"])
@pytest.mark.parametrize("k, factor", CASES)
def test_moe_ffn_and_grads_match_jax(fn, k, factor):
    x, p = _tokens(), _stacked()
    _assert_margin(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(p["w_gate"])),
                   k)
    ct = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)

    def jloss(stacked, xx):
        y, aux = jmoe.moe_ffn(stacked, xx, k=k, capacity_factor=factor)
        return jnp.sum(y * ct) + 0.37 * aux, (y, aux)

    (_, (y_want, aux_want)), (g_p, g_x) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    params = {n: _t(a).requires_grad_() for n, a in p.items()}
    xt = _t(x).requires_grad_()
    y, aux = getattr(moe, fn)(params, xt, k=k, capacity_factor=factor)
    ((y * _t(ct)).sum() + 0.37 * aux).backward()
    _close(y.detach(), y_want, 1e-5)
    assert abs(float(aux) - float(aux_want)) <= 1e-6
    _close(xt.grad, g_x, 1e-5)
    for name in moe.PARAM_NAMES:
        _close(params[name].grad, g_p[name], 1e-5)


def test_moe_mlp_matches_jax_and_flax_init():
    r = np.random.default_rng(3)
    x = r.normal(size=(2, 40, 16)).astype(np.float32)
    p = _stacked()
    jm = jmoe.MoEMlp(n_experts=4, hidden=24, k=2, capacity_factor=1.25)
    want, sown = jm.apply({"params": p}, jnp.asarray(x), mutable=["losses"])
    _assert_margin(jax.nn.softmax(
        jnp.asarray(x).reshape(80, 16) @ jnp.asarray(p["w_gate"])), 2)
    m = moe.MoEMlp(16, 4, 24, k=2)
    with torch.no_grad():
        for name in moe.PARAM_NAMES:
            getattr(m, name).copy_(_t(p[name]))
        got, aux = m(_t(x))
    _close(got, want, 1e-5)
    (aux_want,) = jax.tree.leaves(sown["losses"])
    assert abs(float(aux) - float(aux_want)) <= 1e-6

    # init: flax's lecun_normal counts the expert axis into the fan-in;
    # a sample std of n draws is within 5 of its standard errors,
    # 1 / sqrt(2 n) relative
    e, d, h = 4, 256, 64
    ref = jmoe.MoEMlp(n_experts=e, hidden=h).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, d)))["params"]
    fresh = moe.MoEMlp(d, e, h, generator=torch.Generator().manual_seed(0))
    for name, fan_in in (("w_gate", d), ("w1", e * d), ("w2", e * h)):
        w = getattr(fresh, name)
        err = 5 / np.sqrt(2 * w.numel())
        got_std = float(w.std())
        want_std = float(np.asarray(ref[name]).std())
        assert abs(got_std / want_std - 1) < 2 ** 0.5 * err, name
        assert abs(got_std / np.sqrt(1 / fan_in) - 1) < err, name
        # truncated at two standard deviations of the untruncated normal
        assert float(getattr(fresh, name).abs().max()) \
            <= 2 * np.sqrt(1 / fan_in) / 0.87962566103423978
    for name in ("b1", "b2"):
        assert not getattr(fresh, name).any()
        assert not np.asarray(ref[name]).any()


def test_k_above_experts_raises_jax_message():
    x, p = _tokens(), _stacked()
    with pytest.raises(ValueError) as want:
        jmoe.router(jnp.asarray(x), jnp.asarray(p["w_gate"]), k=5, capacity=8)
    for fn in (moe.router, moe.router_dense):
        with pytest.raises(ValueError) as got:
            fn(_t(x), _t(p["w_gate"]), k=5, capacity=8)
        assert str(got.value) == str(want.value)


# -- the MoE DANet -------------------------------------------------------------

RES = 32


@pytest.fixture(scope="module")
def moe_danet():
    """JAX's DANet-R18 with ``moe_experts=2`` and its variables, every leaf
    drawn from numpy (the position branch's gate small, so that its
    scores pick no near-tie; the MoE's gate at 0.3)."""
    model = jax_build_model("danet", nclass=1, backbone="resnet18",
                            output_stride=8, attention_impl="xla",
                            moe_experts=2)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, RES, RES, 4)), train=False))
    # init also returns the aux loss the MoE sows
    variables = randomize({k: shapes[k] for k in ("params", "batch_stats")},
                          seed=4)
    head = variables["params"]["head"]
    head["pam"]["gamma"] = np.float32(3e-3)
    head["moe"]["w_gate"] = (np.random.default_rng(8).normal(
        size=head["moe"]["w_gate"].shape) * 0.3).astype(np.float32)
    return model, variables


def _port(variables, **kw):
    model = build_model("danet", nclass=1, backbone="resnet18",
                        output_stride=8, attention_impl="xla",
                        moe_experts=2, **kw)
    return load_jax_params(model, variables["params"],
                           variables["batch_stats"])


def _watch_margins(model, k=1):
    """Assert :data:`MARGIN` on every forward's routing."""
    def hook(module, args):
        tokens = args[0].detach().reshape(-1, args[0].shape[-1])
        _assert_margin(torch.softmax(tokens @ module.w_gate.detach(), -1), k)
    return model.head.moe.register_forward_pre_hook(hook)


def _crops(b=2, seed=2):
    return np.random.default_rng(seed).uniform(
        0, 255, (b, RES, RES, 4)).astype(np.float32)


def test_weights_carry_both_ways_bit_for_bit(moe_danet):
    _, variables = moe_danet
    state = jax_to_state_dict(variables["params"], variables["batch_stats"])
    assert {k for k in state if ".moe." in k} == {
        f"head.moe.{n}" for n in moe.PARAM_NAMES}
    params, stats = state_dict_to_jax(_port(variables).state_dict())
    for got_tree, want_tree in ((params, variables["params"]),
                                (stats, variables["batch_stats"])):
        got = jax.tree_util.tree_leaves_with_path(got_tree)
        want = jax.tree_util.tree_leaves_with_path(want_tree)
        assert [p for p, _ in got] == [p for p, _ in want]
        for (_, g), (_, w) in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))


def test_moe_danet_logits_match_jax(moe_danet):
    model, variables = moe_danet
    x = _crops()
    want = model.apply(variables, jnp.asarray(x), train=False)
    port = _port(variables).eval()
    handle = _watch_margins(port)
    with torch.no_grad():
        got = port(_t(x).permute(0, 3, 1, 2))
    handle.remove()
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.permute(0, 2, 3, 1).numpy() - w).max() \
            <= 1e-4 * max(1.0, float(np.abs(w).max()))


def test_moe_decode_is_the_full_forward():
    torch.manual_seed(0)
    model = build_model("danet", backbone="resnet18", guidance_inject="head",
                        moe_experts=2, moe_k=2).eval()
    x = torch.rand(2, 4, RES, RES) * 255
    with torch.no_grad():
        full, aux = model(x, with_aux=True)
        feats = model(x[:, :3], stage="encode")
        dec, dec_aux = model((feats, x[:, 3:]), stage="decode",
                             out_size=(RES, RES), with_aux=True)
    assert all(torch.equal(a, b) for a, b in zip(full, dec))
    assert torch.equal(aux, dec_aux) and aux > 0


def _batch(seed):
    r = np.random.default_rng(seed)
    return {"concat": r.uniform(0, 255, (2, RES, RES, 4)).astype(np.float32),
            "crop_gt": (r.random((2, RES, RES, 1)) < 0.3).astype(np.float32)}


def test_train_loss_with_aux_matches_jax(moe_danet):
    model, variables = moe_danet
    batch = _batch(6)
    with fnn.intercept_methods(_no_dropout):
        want, _ = _loss_and_updates(
            model, variables["params"], variables["batch_stats"],
            jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0), None,
            True, "multi_sigmoid", aux_loss_weight=0.01)
    port = _port(variables, dropout_rate=0.0)
    with torch.no_grad():
        _, aux = port.train()(_t(batch["concat"]).permute(0, 3, 1, 2),
                              with_aux=True)
    opt, sched = optim.make_optimizer(config.OptimConfig(lr=0.0), port, 1)
    state = create_train_state(port, opt, sched, 0, torch.device("cpu"))
    handle = _watch_margins(port)
    got = make_train_step(aux_loss_weight=0.01)(state, batch)
    handle.remove()
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    # the aux term is there, far above the tolerance
    assert 0.01 * float(aux) > 1e-3 * abs(float(want))
    assert port.head.moe.w_gate.grad.abs().max() > 0


def test_bf16_remat_accum_runs_the_moe_in_float32():
    torch.manual_seed(0)
    model = build_model("danet", backbone="resnet18", dtype="bfloat16",
                        remat=True, moe_experts=2, moe_k=2)
    seen = []
    model.head.moe.register_forward_hook(
        lambda m, args, out: seen.append((args[0].dtype, out[0].dtype,
                                          out[1].dtype)))
    opt, sched = optim.make_optimizer(config.OptimConfig(lr=1e-3), model, 1)
    state = create_train_state(model, opt, sched, 0, torch.device("cpu"))
    step = make_train_step(accum_steps=2, aux_loss_weight=0.01,
                           precision=precision_policy("bfloat16"))
    loss = step(state, _batch(9))
    assert np.isfinite(float(loss))
    assert seen == [(torch.float32,) * 3] * 2
    assert all(p.dtype == torch.float32 for p in model.head.moe.parameters())
    assert model.head.moe.w_gate.grad.abs().max() > 0
    with torch.no_grad():
        out = model.eval()(torch.rand(1, 4, RES, RES) * 255)
    assert all(o.dtype == torch.bfloat16 for o in out)


# -- the trainer ---------------------------------------------------------------

TINY = ["data.fake=true", "model.backbone=resnet18", "data.crop_size=[32,32]",
        "data.relax=10", "data.area_thres=0", "data.train_batch=4",
        "data.val_batch=8", "data.num_workers=0", "log_every_steps=2",
        "checkpoint.keep_latest=1",
        "model.moe_experts=2", "model.moe_k=2", "model.pam_impl=einsum",
        "model.pam_block_size=24"]


def test_moe_fit_resumes_bitwise_and_serves(tmp_path):
    def fit(work, *extra):
        cfg = config.apply_overrides(config.Config(), TINY + [
            f"work_dir={work}", *extra])
        trainer = Trainer(cfg, device="cpu")
        history = trainer.fit()
        trainer.close()
        return trainer, history

    first, history = fit(tmp_path / "a", "epochs=1")
    assert first.state.step == 2
    assert all(np.isfinite(history["train_loss"]))
    assert first.model.head.moe.w1.shape == (2, 128, 128)
    resumed, _ = fit(tmp_path / "a", "epochs=2", "resume=auto")
    assert resumed.state.step == 4
    straight, _ = fit(tmp_path / "b", "epochs=2")
    for (name, a), b in zip(resumed.model.state_dict().items(),
                            straight.model.state_dict().values()):
        assert torch.equal(a, b), name

    pred = Predictor.from_run(resumed.run_dir, device="cpu")
    assert pred.model.head.moe is not None
    assert pred.model.head.pam.block_size == 24
    x = torch.rand(2, 4, RES, RES) * 255
    with torch.no_grad():
        want = resumed.model.eval()(x)
        got = pred.model(x)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    image = np.random.default_rng(0).integers(
        0, 256, (80, 96, 3)).astype(np.uint8)
    points = np.array([[20, 40], [70, 40], [45, 15], [45, 65]], float)
    mask = pred.predict(image, points)
    assert mask.shape == (80, 96) and np.isfinite(mask).all()


def test_moe_at_world_size_two_is_refused(tmp_path, monkeypatch):
    monkeypatch.setattr(mesh, "data_axis_size", lambda: 2)
    cfg = config.apply_overrides(config.Config(), TINY + [
        f"work_dir={tmp_path}"])
    with pytest.raises(NotImplementedError,
                       match="model.moe_experts=2 at world size 2"):
        Trainer(cfg, device="cpu")


def test_ring_is_refused_by_name(tmp_path):
    cfg = config.apply_overrides(config.Config(), TINY + [
        "model.pam_impl=ring", f"work_dir={tmp_path}"])
    with pytest.raises(NotImplementedError, match="model.pam_impl='ring'"):
        Trainer(cfg, device="cpu")
