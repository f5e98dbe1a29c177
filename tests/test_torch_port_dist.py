"""The port's data parallelism against the JAX package's, on the CPU.

The tests that need a group share two spawned gloo processes
(``torch_port_dist_worker.RankPool``, rendezvous through a ``FileStore``
under the module's temporary directory), which run each test's body on
both ranks at once; JAX runs on the first two of conftest's eight CPU devices
(``make_mesh(data=2, devices=...)``, ``shard_batch``).

* Three train steps of DANet-R18 at 64², global batch 4 (2 per rank),
  lr 1e-2, from the same weights (``load_jax_params``), at W = 2 against
  JAX's two-device step: ``dp`` and ``dp_zero1`` against the GSPMD step
  (and ZeRO-1's sharded optimizer state), ``buckets`` (the port's
  ``train.reduce_buckets=3``) against the bucketed ``shard_map`` step
  with cross-replica BatchNorm; ``accum_steps`` 1 and 2, each rank's rows
  laid out as each JAX step splits the global batch.  Losses within 1e-4
  relative per step, every parameter and BatchNorm statistic within 1e-4
  x max(1, max |leaf|), the two ranks' states bitwise equal.  JAX's
  dropout is the identity (``flax.linen.intercept_methods``); the port's
  rate is 0.
* Cross-replica BatchNorm's forward and backward against flax
  ``BatchNorm`` over the concatenated batch (1e-5 relative).
* The global class balance against JAX's ``multi_output_loss`` on the
  global batch (1e-6 relative).
* Loader shards against JAX's ``DataLoader(num_shards=2, shard_index=r)``
  order, and at ``accum_steps=2`` each rank's rows against its slices of
  JAX's global micro-batches; the worker loader's shards.
* The W = 2 evaluation against single-process JAX ``evaluate`` over the
  same wrap-padded order.
* ``reduce_decision``, the plan blocks and ``pad_to_multiple`` against
  JAX's; ``mesh.data`` against the live world.
* A ``dp_zero1`` checkpoint restored under ``dp`` and the other way
  round; the stop consensus (SIGTERM to one rank); the CLI's launcher
  spawning two ranks, and ending the other when one dies.
"""

import itertools
import json
import multiprocessing
import os
import signal
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from jax.sharding import NamedSharding

from distributedpytorch_tpu.data import fake as jax_fake
from distributedpytorch_tpu.data import pipeline as jax_pipeline
from distributedpytorch_tpu.data import voc as jax_voc
from distributedpytorch_tpu.data.grain_pipeline import GrainDataLoader as JaxGrainLoader
from distributedpytorch_tpu.models import build_model as jax_build_model
from distributedpytorch_tpu.ops import losses as jax_losses
from distributedpytorch_tpu.parallel import TrainState as JaxTrainState
from distributedpytorch_tpu.parallel import consensus as jax_consensus
from distributedpytorch_tpu.parallel import make_eval_step as jax_make_eval_step
from distributedpytorch_tpu.parallel import make_train_step as jax_make_train_step
from distributedpytorch_tpu.parallel import mesh as jax_mesh
from distributedpytorch_tpu.parallel import plan as jax_plan
from distributedpytorch_tpu.parallel.step import bucket_grad_leaves as jax_buckets
from distributedpytorch_tpu.train import config as jax_config
from distributedpytorch_tpu.train import optim as jax_optim
from distributedpytorch_tpu.train.evaluate import evaluate as jax_evaluate
from distributedpytorch_tpu_torch.data import pipeline
from distributedpytorch_tpu_torch.data.grain_pipeline import GrainDataLoader
from distributedpytorch_tpu_torch.models import build_model
from distributedpytorch_tpu_torch.parallel import consensus, mesh, plan
from distributedpytorch_tpu_torch.parallel.step import bucket_grad_leaves
from distributedpytorch_tpu_torch.train import config
from distributedpytorch_tpu_torch.utils.weights import (
    load_jax_params,
    state_dict_to_jax,
)
from test_torch_port_model import randomize
from test_torch_port_train import _no_dropout
from torch_port_dist_worker import RankPool

B, HW, LR = 4, 64, 1e-2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = RankPool(tmp_path_factory.mktemp("group"))
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def r18(tmp_path_factory):
    """Random DANet-R18 weights, as a flax tree and as the port's
    ``state_dict`` saved for the ranks."""
    model = jax_build_model("danet", nclass=1, backbone="resnet18",
                            output_stride=8, attention_impl="xla")
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 4)), train=False))
    variables = randomize(shapes, seed=8)
    port = build_model("danet", backbone="resnet18", dropout_rate=0.0)
    load_jax_params(port, variables["params"], variables["batch_stats"])
    path = tmp_path_factory.mktemp("r18") / "init.pt"
    torch.save(port.state_dict(), path)
    return variables, str(path)


def _mesh():
    return jax_mesh.make_mesh(data=2, devices=jax.devices()[:2])


def _rank_rows(rank: int, strategy: str, accum: int) -> np.ndarray:
    """Rank ``rank``'s rows of a global batch of B: its slices of the dp
    step's global micro-batches, or its own contiguous half for the
    bucketed step (which splits them locally)."""
    halves = [np.arange(0, B // 2), np.arange(B // 2, B)]
    if strategy == "buckets":
        return halves[rank]
    return pipeline.micro_batch_rows(halves, rank, accum)


def _jax_step(variables, strategy, accum, mesh):
    jmodel = jax_build_model(
        "danet", nclass=1, backbone="resnet18", output_stride=8,
        attention_impl="xla",
        bn_cross_replica_axis="data" if strategy == "buckets" else None)
    tx, _ = jax_optim.make_optimizer(jax_config.OptimConfig(lr=LR), 10)
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=jax.tree.map(jnp.asarray,
                                                    variables["batch_stats"]),
                           opt_state=tx.init(params), rng=jax.random.PRNGKey(1))
    if strategy == "dp_zero1":
        p = jax_plan.resolve_plan("dp_zero1", n_devices=2)
        specs = p.state_specs(jstate, mesh)
        jstate = jax.device_put(jstate, jax.tree.map(
            lambda s: NamedSharding(mesh, s), specs,
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
        step = p.make_train_step(jmodel, tx, mesh=mesh, state=jstate,
                                 accum_steps=accum, donate=False)
    else:
        jstate = jax.device_put(jstate, jax_mesh.replicated_sharding(mesh))
        step = jax_make_train_step(
            jmodel, tx, accum_steps=accum, mesh=mesh, donate=False,
            reduce_buckets=3 if strategy == "buckets" else 0)
    return jstate, step


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("strategy", ["dp", "dp_zero1", "buckets"])
def test_two_rank_trajectory_matches_jax(ranks, r18, strategy, accum):
    variables, init_path = r18
    r = np.random.default_rng(6)
    batches = [{"concat": r.uniform(0, 255, (B, HW, HW, 4)).astype(np.float32),
                "crop_gt": (r.random((B, HW, HW, 1)) < 0.3).astype(np.float32)}
               for _ in range(3)]
    rows = [_rank_rows(k, strategy, accum) for k in range(2)]
    ranks.start(
        "trajectory", init_path, strategy, accum,
        [[{k: v[rows[rank]] for k, v in b.items()} for b in batches]
         for rank in range(2)], LR)

    mesh = _mesh()
    jstate, jstep = _jax_step(variables, strategy, accum, mesh)
    jlosses = []
    for batch in batches:
        with fnn.intercept_methods(_no_dropout):
            jstate, jloss = jstep(jstate, jax_mesh.shard_batch(mesh, batch))
        jlosses.append(float(jloss))
    got = ranks.results()

    for a, b in zip(got[0]["state"].values(), got[1]["state"].values()):
        assert torch.equal(a, b)
    assert got[0]["losses"] == got[1]["losses"]
    worst = max(abs(g - w) / abs(w) for g, w in zip(got[0]["losses"], jlosses))
    assert worst <= 1e-4, (got[0]["losses"], jlosses)
    got_params, got_stats = state_dict_to_jax(got[0]["state"])
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
    print(f"{strategy} accum {accum}: worst loss rel {worst:.2e}, worst leaf "
          f"{leaf_worst:.2e} of max(1, |leaf|)")


def test_two_rank_semantic_step_matches_jax(ranks, tmp_path):
    """DeepLabV3-R18 under ``dp`` with the softmax loss: rank 0's rows are
    mostly void and rank 1's hardly, so a mean of per-rank means would
    differ from JAX's one global mean over the valid pixels."""
    jmodel = jax_build_model("deeplabv3", nclass=5, backbone="resnet18",
                             aux_head=True)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)), train=False))
    variables = randomize(shapes, seed=10)
    port = build_model("deeplabv3", nclass=5, backbone="resnet18", aux_head=True,
                       in_channels=3, dropout_rate=0.0)
    load_jax_params(port, variables["params"], variables["batch_stats"])
    init_path = str(tmp_path / "deeplab.pt")
    torch.save(port.state_dict(), init_path)
    r = np.random.default_rng(13)
    batches = []
    for _ in range(2):
        gt = r.integers(0, 5, (B, HW, HW, 1)).astype(np.float32)
        gt[:B // 2][r.random((B // 2, HW, HW, 1)) < 0.7] = 255.0
        gt[B // 2:][r.random((B // 2, HW, HW, 1)) < 0.05] = 255.0
        batches.append({"concat": r.uniform(0, 255, (B, HW, HW, 3)).astype(np.float32),
                        "crop_gt": gt})
    halves = [[{k: v[:B // 2] for k, v in b.items()} for b in batches],
              [{k: v[B // 2:] for k, v in b.items()} for b in batches]]
    ranks.start("semantic_trajectory", init_path, halves, LR)

    mesh = _mesh()
    tx, _ = jax_optim.make_optimizer(jax_config.OptimConfig(lr=LR), 10)
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = jax.device_put(
        JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                      batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                      opt_state=tx.init(params), rng=jax.random.PRNGKey(1)),
        jax_mesh.replicated_sharding(mesh))
    jstep = jax_make_train_step(jmodel, tx, loss_weights=(1.0, 0.4), mesh=mesh,
                                donate=False, loss_type="multi_softmax")
    jlosses = []
    for batch in batches:
        with fnn.intercept_methods(_no_dropout):
            jstate, jloss = jstep(jstate, jax_mesh.shard_batch(mesh, batch))
        jlosses.append(float(jloss))
    got = ranks.results()

    for a, b in zip(got[0]["state"].values(), got[1]["state"].values()):
        assert torch.equal(a, b)
    assert got[0]["losses"] == got[1]["losses"]
    worst = max(abs(g - w) / abs(w) for g, w in zip(got[0]["losses"], jlosses))
    assert worst <= 1e-4, (got[0]["losses"], jlosses)
    got_params, got_stats = state_dict_to_jax(got[0]["state"])
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
    print(f"semantic dp: worst loss rel {worst:.2e}, worst leaf "
          f"{leaf_worst:.2e} of max(1, |leaf|)")


def _halves(a):
    return [a[:len(a) // 2], a[len(a) // 2:]]


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max()) / max(1e-30, float(np.abs(ref).max()))


def test_cross_replica_batch_norm_matches_flax(ranks):
    r = np.random.default_rng(9)
    x = (r.normal(size=(4, 5, 6, 3)) * 2 + 0.7).astype(np.float32)  # NCHW
    dy = r.normal(size=x.shape).astype(np.float32)
    w = r.uniform(0.5, 1.5, 5).astype(np.float32)
    b = r.normal(size=5).astype(np.float32)
    ranks.start("batch_norm", _halves(x), _halves(dy), w, b)

    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    stats0 = {"mean": jnp.zeros(5), "var": jnp.ones(5)}

    def f(xn, scale, bias):
        y, mutated = bn.apply({"params": {"scale": scale, "bias": bias},
                               "batch_stats": stats0}, xn,
                              mutable=["batch_stats"])
        return y, mutated["batch_stats"]

    nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
    y, vjp = jax.vjp(lambda xn, s, c: f(xn, s, c)[0], nhwc, jnp.asarray(w),
                     jnp.asarray(b))
    stats = f(nhwc, jnp.asarray(w), jnp.asarray(b))[1]
    dx, dw, db = vjp(jnp.asarray(dy.transpose(0, 2, 3, 1)))
    got = ranks.results()
    y_got = np.concatenate([g["y"] for g in got]).transpose(0, 2, 3, 1)
    dx_got = np.concatenate([g["dx"] for g in got]).transpose(0, 2, 3, 1)
    assert rel_err(y_got, y) <= 1e-5
    assert rel_err(dx_got, dx) <= 1e-5
    assert rel_err(got[0]["dw"] + got[1]["dw"], dw) <= 1e-5
    assert rel_err(got[0]["db"] + got[1]["db"], db) <= 1e-5
    # flax moved its running statistics 0.1 of the way to the batch's
    for g in got:
        assert rel_err(0.1 * g["mean"], stats["mean"]) <= 1e-5
        assert rel_err(0.9 + 0.1 * g["var"], stats["var"]) <= 1e-6


def test_global_class_balance_matches_jax(ranks):
    r = np.random.default_rng(4)
    outs = [(r.normal(size=(4, 1, 16, 20)) * 3).astype(np.float32)
            for _ in range(3)]
    gt = np.zeros((4, 1, 16, 20), np.float32)
    gt[:1] = (r.random((1, 1, 16, 20)) < 0.6)  # positives mostly on rank 0
    gt[3:] = (r.random((1, 1, 16, 20)) < 0.05)
    void = (r.random(gt.shape) < 0.1).astype(np.float32)
    ranks.start("balanced_loss", [_halves(o) for o in outs], _halves(gt),
                _halves(void))

    def nhwc(a):
        return jnp.asarray(a.transpose(0, 2, 3, 1))

    def loss(*o):
        return jax_losses.multi_output_loss(tuple(o), nhwc(gt), void=nhwc(void))

    ref, grads = jax.value_and_grad(loss, argnums=(0, 1, 2))(*map(nhwc, outs))
    got = ranks.results()
    assert rel_err([g["total"] for g in got], [ref, ref]) <= 1e-6
    assert rel_err(got[0]["share"] + got[1]["share"], ref) <= 1e-6
    for i, want in enumerate(grads):
        mine = np.concatenate([g["grads"][i] for g in got]).transpose(0, 2, 3, 1)
        assert rel_err(mine, want) <= 1e-6
    # a balance taken per rank would be another loss
    local = sum(float(jax_losses.multi_output_loss(
        tuple(nhwc(o[h]) for o in outs), nhwc(gt[h]), void=nhwc(void[h])))
        for h in (slice(0, 2), slice(2, 4))) / 2
    assert abs(local - float(ref)) > 1e-3 * abs(float(ref))


class _Indices:
    """A dataset of ``n`` records whose sample is its index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, index, rng=None):
        return {"index": np.int64(index)}


@pytest.mark.parametrize("n", [11, 12])
def test_loader_shards_match_jax(n):
    ds = _Indices(n)
    for rank in range(2):
        kw = dict(shuffle=True, drop_last=True, seed=3, num_workers=0)
        port = pipeline.DataLoader(ds, 2, num_shards=2, shard_index=rank, **kw)
        ref = jax_pipeline.DataLoader(ds, 2, num_shards=2, shard_index=rank,
                                      **kw)
        for epoch in (0, 1):
            port.set_epoch(epoch)
            ref.set_epoch(epoch)
            np.testing.assert_array_equal(port.epoch_indices(),
                                          ref._epoch_indices())
            assert len(port) == len(ref) == -(-n // 2) // 2
            got = [b["index"] for b in port]
            want = [b["index"] for b in ref]
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    # eval: no drop, every sample in some shard (wrap-padded)
    val = [pipeline.DataLoader(ds, 1, num_workers=0, num_shards=2,
                               shard_index=k).epoch_indices() for k in (0, 1)]
    assert set(np.concatenate(val)) == set(range(n))
    assert len(val[0]) == len(val[1])


def test_micro_batch_rows_are_jax_global_micro_batches():
    """At accum_steps 2 each rank's rows of global batch k are its slices
    of the JAX step's two global micro-batches: the global batch (the
    JAX shards' batch k in process order) cut in two, each half sharded
    over the two devices."""
    ds, accum = _Indices(23), 2
    kw = dict(shuffle=True, drop_last=True, seed=5, num_workers=0)
    refs = [jax_pipeline.DataLoader(ds, 4, num_shards=2, shard_index=k, **kw)
            for k in (0, 1)]
    ports = [pipeline.DataLoader(ds, 4, num_shards=2, shard_index=k,
                                 micro_batches=accum, **kw) for k in (0, 1)]
    workers = [GrainDataLoader(ds, 4, num_shards=2, shard_index=k,
                               micro_batches=accum, shuffle=True,
                               drop_last=True, seed=5) for k in (0, 1)]
    for batch in range(len(refs[0])):
        glob = np.concatenate([r.batch_sample_indices(batch) for r in refs])
        micro = glob.reshape(accum, -1)
        for rank in (0, 1):
            want = np.concatenate([m.reshape(2, -1)[rank] for m in micro])
            np.testing.assert_array_equal(
                ports[rank].batch_indices()[batch], want)
    # the worker loader: the same layout over its own shards
    for batch in range(len(workers[0])):
        glob = np.concatenate([w._shard_plan(k)[batch][1]
                               for k, w in enumerate(workers)])
        for rank in (0, 1):
            want = np.concatenate([m.reshape(2, -1)[rank]
                                   for m in glob.reshape(accum, -1)])
            np.testing.assert_array_equal(
                workers[rank].batch_plan()[batch][1], want)


@pytest.mark.parametrize("n", [11, 12])
@pytest.mark.parametrize("num_workers", [0, 2])
def test_worker_loader_shards(n, num_workers):
    """A contiguous shard of n // 2 records of the epoch's order, the
    remainder dropped (grain's ShardOptions(drop_remainder=True)); at an
    even n the threaded loader's shard.  Its length is the JAX loader's."""
    ds = _Indices(n)
    shards = []
    for rank in range(2):
        w = GrainDataLoader(ds, 2, shuffle=True, drop_last=True, seed=3,
                            num_workers=num_workers, num_shards=2,
                            shard_index=rank)
        w.set_epoch(1)
        shards.append(w.epoch_indices())
        assert len(w) == len(JaxGrainLoader(
            ds, 2, shuffle=True, drop_last=True, seed=3,
            num_workers=num_workers, num_shards=2, shard_index=rank))
        planned = np.concatenate([i for _, i in w.batch_plan()])
        assert set(planned) <= set(shards[-1]) and len(set(planned)) == \
            len(planned) == len(w) * 2
        if n % 2 == 0:
            t = pipeline.DataLoader(ds, 2, shuffle=True, drop_last=True, seed=3,
                                    num_shards=2, shard_index=rank)
            t.set_epoch(1)
            np.testing.assert_array_equal(shards[-1], t.epoch_indices())
    assert len(shards[0]) == len(shards[1]) == n // 2
    assert not set(shards[0]) & set(shards[1])


def test_two_rank_evaluate_matches_jax(ranks, r18, tmp_path):
    variables, init_path = r18
    root = str(tmp_path / "voc")
    jax_fake.make_fake_voc(root, n_images=5, size=(96, 128), n_val=2, seed=2)
    kw = dict(crop_size=(HW, HW), relax=10)
    ranks.start("evaluate_shard", init_path, root, (HW, HW), 10)
    jds = jax_voc.VOCInstanceSegmentation(
        root, split="val", preprocess=True,
        transform=jax_pipeline.build_eval_transform(**kw))
    assert len(jds) % 2  # the wrap-around pads shard 1
    order = itertools.chain(*[jax_pipeline.DataLoader(
        jds, 1, num_workers=0, num_shards=2, shard_index=k) for k in (0, 1)])
    jmodel = jax_build_model("danet", nclass=1, backbone="resnet18",
                             output_stride=8, attention_impl="xla")
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32),
                           params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=(), rng=jax.random.PRNGKey(0))
    ref = jax_evaluate(jax_make_eval_step(jmodel), jstate, order,
                       thresholds=(0.3, 0.5, 0.8), relax=10)
    got = ranks.results()
    assert got[0] == got[1]
    assert got[0]["n_samples"] == ref["n_samples"] == len(jds) + 1
    for t, want in ref["jaccard_per_threshold"].items():
        assert abs(got[0]["jaccard_per_threshold"][t] - want) <= 1e-4
    assert abs(got[0]["loss"] - ref["loss"]) <= 1e-4 * abs(ref["loss"])


def test_zero1_and_dp_checkpoints_restore_across(ranks, r18, tmp_path):
    """A ``dp_zero1`` checkpoint restores under ``dp`` and a ``dp`` one
    under ``dp_zero1``, with the same weights and momentum."""
    _, init_path = r18
    r = np.random.default_rng(2)
    batches = [[{"concat": r.uniform(0, 255, (2, HW, HW, 4)).astype(np.float32),
                 "crop_gt": (r.random((2, HW, HW, 1)) < 0.3).astype(np.float32)}
                for _ in range(2)] for _ in range(2)]
    got = ranks.run("zero_to_dp", init_path, str(tmp_path / "ckpt"), batches)
    shards = {}
    for g in got:
        assert g["dp_weights_equal"] and g["zero_weights_equal"]
        assert g["steps"] == (2, 2) and g["back_step"] == 2
        # both continue as one: the same loss from the same state
        assert g["loss_next"][0] == g["loss_next"][1]
        assert set(g["dp_restored"]) == set(got[0]["dp_restored"])
        for name, m in g["zero_local"].items():
            assert torch.equal(m, g["dp_restored"][name])
            shards[name] = m
        for name, m in g["zero_restored"].items():
            assert torch.equal(m, g["dp_after"][name])
    # each rank's ZeRO shard holds its own parameters' momentum, once
    assert set(shards) == set(got[0]["dp_restored"])
    assert sum(len(g["zero_local"]) for g in got) == len(shards)
    assert [set(g["zero_restored"]) for g in got] == \
        [set(g["zero_local"]) for g in got]


def test_stop_consensus_stops_every_rank_at_one_step(ranks):
    got = ranks.run("stop_consensus", 1, 3, 2)
    assert [g["stopped_at"] for g in got] == [4, 4]
    assert [g["own_flag"] for g in got] == [False, True]


def test_reduce_decision_matches_jax():
    cases = [([3, 1, 2], "max"), ([3, 1, 2], "min"), ([1, 2], "sum"),
             ([1, 2], "mean"), ([False, True], "any"), ([True, False], "all"),
             ([{"a": 1, "b": 2}, {"b": 2, "a": 1}], "same"),
             ([4, 5], lambda vs: vs[-1])]
    for values, reduce in cases:
        assert consensus.reduce_decision(values, reduce) == \
            jax_consensus.reduce_decision(values, reduce)
        assert consensus.replicated_decision(
            0, reduce, _gather=lambda _: values) == \
            jax_consensus.replicated_decision(0, reduce, _gather=lambda _: values)
    with pytest.raises(consensus.ConsensusError) as got:
        consensus.reduce_decision([1, 2], "same", label="x")
    with pytest.raises(jax_consensus.ConsensusError) as want:
        jax_consensus.reduce_decision([1, 2], "same", label="x")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown reduce"):
        consensus.reduce_decision([1], "median")
    assert consensus.replicated_decision(7, "max") == 7  # no group: itself


PLAN_CONFIGS = [[], ["mesh.shard_opt_state=true"], ["parallel.strategy=dp"],
                ["parallel.strategy=dp_zero1"],
                ["parallel.strategy=dp_zero1", "parallel.data=2"],
                ["mesh.data=2"]]


@pytest.mark.parametrize("overrides", PLAN_CONFIGS)
def test_plan_blocks_match_jax(overrides):
    port = plan.plan_from_config(
        config.apply_overrides(config.Config(), overrides), n_devices=2)
    ref = jax_plan.plan_from_config(
        jax_config.apply_overrides(jax_config.Config(), overrides), n_devices=2)
    strip = lambda b: {k: v for k, v in b.items() if k != "topology"}  # noqa: E731
    assert strip(port.block()) == strip(ref.block())
    assert port.describe() == ref.describe()
    assert plan.normalized_block(port.block(), 2) == {
        **jax_plan.normalized_block(ref.block(), 2), "topology": port.topology}
    assert plan.plan_record_block(port, 2) is None \
        if jax_plan.plan_record_block(ref) is None or \
        strip(ref.block())["data"] == 2 and ref.strategy == "dp" \
        else plan.plan_record_block(port, 2) == port.block()
    assert port.topology == "cpu:2/p1" and \
        plan.fingerprint_devices(port.topology) == 2
    zero = plan.resolve_plan("dp_zero1", n_devices=2).block()
    assert plan.plans_differ(zero, port.block(), 2) == jax_plan.plans_differ(
        jax_plan.resolve_plan("dp_zero1", n_devices=2).block(), ref.block(), 2)


@pytest.mark.parametrize("overrides,error", [
    (["parallel.strategy=dp_tp"], NotImplementedError),
    (["parallel.strategy=auto"], NotImplementedError),
    (["parallel.strategy=dp", "mesh.shard_opt_state=true"], plan.PlanError),
    (["parallel.strategy=dp", "parallel.data=3"], plan.PlanError),
    (["parallel.strategy=dp", "parallel.model=2"], plan.PlanError),
    (["parallel.strategy=ring"], plan.PlanError)])
def test_plans_the_port_refuses(overrides, error):
    with pytest.raises(error):
        plan.plan_from_config(
            config.apply_overrides(config.Config(), overrides), n_devices=2)
    assert "reduce_buckets" in str(plan.reduce_buckets_conflict("dp_tp")) and \
        str(plan.reduce_buckets_conflict("dp_tp")) == \
        str(jax_plan.reduce_buckets_conflict("dp_tp"))


def test_bucket_cap_follows_jax_buckets():
    r = np.random.default_rng(0)
    sizes = [int(s) for s in r.integers(1, 5000, 40)]
    leaves = [np.zeros(s, np.float32) for s in sizes]
    for n in (1, 3, 7):
        assert bucket_grad_leaves([4 * s for s in sizes], n) == \
            jax_buckets(leaves, n)


@pytest.mark.parametrize("n,multiple", [(3, 2), (4, 2), (5, 4), (1, 8)])
def test_pad_to_multiple_matches_jax(n, multiple):
    r = np.random.default_rng(n)
    batch = {"concat": r.normal(size=(n, 3, 2)).astype(np.float32),
             "crop_gt": r.random((n, 3)).astype(np.float32)}
    got, got_n = mesh.pad_to_multiple(batch, multiple)
    want, want_n = jax_mesh.pad_to_multiple(batch, multiple)
    assert got_n == want_n == n
    for k in batch:
        np.testing.assert_array_equal(got[k], want[k])


def test_mesh_without_a_group():
    """One process, no group: the data axis is 1 and every collective of
    the port is skipped; ``mesh.data`` must name the live world."""
    assert (mesh.data_axis_size(), mesh.process_index()) == (1, 0)
    assert not mesh.is_distributed()
    assert mesh.broadcast_object({"a": 1}) == {"a": 1}
    assert mesh.resolve_data_axis(None) == mesh.resolve_data_axis(1) == 1
    with pytest.raises(ValueError) as got:
        mesh.resolve_data_axis(2)
    with pytest.raises(ValueError) as want:
        jax_mesh.make_mesh(data=2, devices=jax.devices()[:1])
    assert str(got.value) == str(want.value)
    assert mesh.initialize_distributed(device="cpu") == torch.device("cpu")
    assert not mesh.is_distributed()


#: a tiny CPU run of the CLI (the fake fixture, ResNet-18 at 32²)
TINY_CLI = ["model.backbone=resnet18", "data.crop_size=[32,32]", "data.relax=10",
            "data.area_thres=0", "data.train_batch=2", "data.num_workers=0"]


def test_launcher_spawns_ranks_and_names_a_dead_one(monkeypatch, tmp_path,
                                                    capfd):
    """``spawn_ranks``, the CLI's launcher on a host with several cards,
    run here on the CPU over gloo: two ranks validate as one (rank 0
    alone writes the run and prints the metrics); then a rank killed at
    start ends the other, and the exit names it."""
    from distributedpytorch_tpu_torch.ops import cuda_attention
    from distributedpytorch_tpu_torch.parallel import launch

    monkeypatch.setattr(cuda_attention, "build", lambda: None)  # no card here
    ok = tmp_path / "ok"
    flags = ["--device", "cpu", "--fake-data"]
    assert launch.spawn_ranks(flags + ["--validate-only", *TINY_CLI,
                                       f"work_dir={ok}"], 2) == 0
    printed = [line for line in capfd.readouterr().out.splitlines()
               if line.startswith("{")]
    assert len(printed) == 1 and json.loads(printed[0])["n_samples"] == 8
    assert sorted(p.name for p in ok.iterdir()) == ["run_0"]

    def kill_rank_1():
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            ranks = [p for p in multiprocessing.active_children()
                     if p.name == "dptpu-rank-1"]
            if ranks:
                os.kill(ranks[0].pid, signal.SIGKILL)
                return
            time.sleep(0.02)

    killer = threading.Thread(target=kill_rank_1)
    killer.start()
    rc = launch.spawn_ranks(flags + TINY_CLI + ["epochs=100",
                                                f"work_dir={tmp_path / 'x'}"], 2)
    killer.join()
    assert rc == 1
    assert "rank 1 of 2" in capfd.readouterr().err
    assert not [p for p in multiprocessing.active_children()
                if p.name.startswith("dptpu-rank")]
