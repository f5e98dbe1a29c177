"""Rank bodies for ``test_torch_port_dist.py``.

:class:`RankPool` spawns ``world`` processes that form one gloo group
through a ``FileStore`` and then run the bodies below on request, each
body on every rank at once (a collective program).  The ranks import only
torch and the port (no JAX), and the group is formed once for the test
module: a rank's start, and its first forward's one-time setup, are paid
once rather than per test.
"""

from __future__ import annotations

import multiprocessing
import os
import signal
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from distributedpytorch_tpu_torch.data import pipeline
from distributedpytorch_tpu_torch.models import build_model
from distributedpytorch_tpu_torch.ops import losses
from distributedpytorch_tpu_torch.ops.sync_bn import (
    compute_dtype_batch_norm,
    cross_replica_batch_norm,
)
from distributedpytorch_tpu_torch.parallel.step import (
    create_train_state,
    make_eval_step,
    make_train_step,
    wrap_data_parallel,
)
from distributedpytorch_tpu_torch.parallel.zero import shard_optimizer
from distributedpytorch_tpu_torch.train import config
from distributedpytorch_tpu_torch.train.checkpoint import CheckpointManager
from distributedpytorch_tpu_torch.train.evaluate import evaluate
from distributedpytorch_tpu_torch.train.optim import make_optimizer
from distributedpytorch_tpu_torch.train.preemption import PreemptionGuard

#: seconds a body may take on the ranks before the test fails
TIMEOUT = 180


def _serve(rank: int, world: int, store: str, conn) -> None:
    """A rank: join the group, then run each ``(body, args)`` received,
    sending back ``{"ok": result}`` or ``{"error": traceback}``, until
    ``None``."""
    torch.set_num_threads(2)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        while (msg := conn.recv()) is not None:
            body, args = msg
            try:
                conn.send({"ok": globals()[body](rank, world, *args)})
            except BaseException:
                conn.send({"error": traceback.format_exc()})
    finally:
        dist.destroy_process_group()


class RankPool:
    """``world`` spawned gloo ranks serving bodies of this module."""

    def __init__(self, tmp: Path, world: int = 2):
        ctx = multiprocessing.get_context("spawn")
        self.conns, self.procs = [], []
        for rank in range(world):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_serve, daemon=True,
                            args=(rank, world, str(tmp / "store"), child))
            p.start()
            child.close()
            self.conns.append(parent)
            self.procs.append(p)

    def start(self, body: str, *args) -> "RankPool":
        """Run ``body(rank, world, *args)`` on every rank; read the results
        with :meth:`results`."""
        for conn in self.conns:
            conn.send((body, args))
        return self

    def results(self) -> list:
        out = []
        for rank, conn in enumerate(self.conns):
            if not conn.poll(TIMEOUT):
                self.close()
                raise TimeoutError(f"rank {rank} gave no result in {TIMEOUT} s")
            r = conn.recv()
            if "error" in r:
                raise RuntimeError(f"rank {rank} failed:\n{r['error']}")
            out.append(r["ok"])
        return out

    def run(self, body: str, *args) -> list:
        return self.start(body, *args).results()

    def close(self) -> None:
        for conn in self.conns:
            try:
                conn.send(None)
            except OSError:
                pass
        for p in self.procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()


# ----------------------------------------------------------------- bodies

def trajectory(rank, world, init_path, strategy, accum, batches, lr,
               optim=None):
    """Train steps of DANet-R18 under ``strategy`` (dp | dp_zero1 |
    buckets) from the weights in ``init_path``; ``batches[rank]`` are this
    rank's rows of each step; ``optim`` overrides fields of the
    ``OptimConfig``.  Returns the losses and the final state_dict."""
    model = build_model("danet", backbone="resnet18", dropout_rate=0.0,
                        bn_cross_replica=True)
    model.load_state_dict(torch.load(init_path))
    opt, sched = make_optimizer(config.OptimConfig(lr=lr, **(optim or {})),
                                model, 10)
    state = create_train_state(model, opt, sched, 0, torch.device("cpu"))
    if strategy == "dp_zero1":
        state.optimizer = shard_optimizer(opt)
    buckets = 3 if strategy == "buckets" else 0
    wrap_data_parallel(state, buckets)
    step = make_train_step(accum_steps=accum, global_balance=not buckets)
    lossv = [float(step(state, b)) for b in batches[rank]]
    return {"losses": lossv, "state": model.state_dict()}


def batch_norm(rank, world, xs, dys, weight, bias):
    """Cross-replica BatchNorm of this rank's rows ``xs[rank]``; its
    output and the gradients of ``sum(y * dys[rank])``."""
    x, dy = xs[rank], dys[rank]
    x = torch.from_numpy(x).requires_grad_()
    w = torch.from_numpy(weight).requires_grad_()
    b = torch.from_numpy(bias).requires_grad_()
    y, mean, var = cross_replica_batch_norm(x, w, b, 1e-5)
    (y * torch.from_numpy(dy)).sum().backward()
    return {"y": y.detach().numpy(), "mean": mean.numpy(), "var": var.numpy(),
            "dx": x.grad.numpy(), "dw": w.grad.numpy(), "db": b.grad.numpy()}


def batch_norm_bf16(rank, world, xs, dys, weight, bias):
    """:func:`batch_norm` with the statistics in bfloat16 over the group
    (``model.bn_fp32_stats=false``) on this rank's rows in bfloat16."""
    x = torch.from_numpy(xs[rank]).to(torch.bfloat16).requires_grad_()
    w = torch.from_numpy(weight).requires_grad_()
    b = torch.from_numpy(bias).requires_grad_()
    y, mean, var = compute_dtype_batch_norm(x, w, b, 1e-5, cross_replica=True)
    (y.float() * torch.from_numpy(dys[rank])).sum().backward()
    return {"y": y.detach().float().numpy(),
            "mean": mean.detach().float().numpy(),
            "var": var.detach().float().numpy(), "dx": x.grad.float().numpy(),
            "dw": w.grad.numpy(), "db": b.grad.numpy()}


def val_overlap_refused(rank, world, work):
    """The ``ValueError`` a ``Trainer`` with ``val_overlap`` raises at
    world size ``world``."""
    from distributedpytorch_tpu_torch.train.trainer import Trainer

    cfg = config.apply_overrides(config.Config(), [
        "data.fake=true", "model.backbone=resnet18", "data.crop_size=[32,32]",
        "val_overlap=true", f"work_dir={work}"])
    try:
        Trainer(cfg, device="cpu")
    except ValueError as e:
        return str(e)
    return None


def balanced_loss(rank, world, outputs, labels, void):
    """This rank's share (rows ``[rank]`` of each list) of the globally
    balanced multi-output loss, the global loss, and the share's
    gradients on its logits."""
    outs = [torch.from_numpy(o[rank]).requires_grad_() for o in outputs]
    labels = torch.from_numpy(labels[rank])
    void = torch.from_numpy(void[rank])
    counts = losses.balance_counts(labels, void)
    dist.all_reduce(counts)
    share = losses.multi_output_loss(outs, labels, void, counts=counts)
    share.backward()
    total = share.detach().clone()
    dist.all_reduce(total)
    return {"share": float(share), "total": float(total),
            "grads": [o.grad.numpy() for o in outs]}


def evaluate_shard(rank, world, init_path, root, crop, relax):
    """The validation protocol over this rank's shard of the VOC tree's
    val split, at one sample per rank and batch, summed over the ranks."""
    from distributedpytorch_tpu_torch.data import voc

    model = build_model("danet", backbone="resnet18")
    model.load_state_dict(torch.load(init_path))
    opt, sched = make_optimizer(config.OptimConfig(), model, 1)
    state = create_train_state(model, opt, sched, 0, torch.device("cpu"))
    dataset = voc.VOCInstanceSegmentation(
        root, split="val",
        transform=pipeline.build_eval_transform(crop_size=crop, relax=relax))
    loader = pipeline.DataLoader(dataset, 1, num_workers=0, num_shards=world,
                                 shard_index=rank)
    metrics = evaluate(make_eval_step(), state, loader, relax=relax)
    metrics.pop("seconds")
    metrics.pop("_first_batch")  # the panels' record, not a metric
    return metrics


def zero_to_dp(rank, world, init_path, ckpt_dir, batches):
    """One ``dp_zero1`` step, saved; a ``dp`` state restored from it; one
    more ``dp`` step, saved; a ``dp_zero1`` state restored from that.
    Returns what each holds."""
    def state_of(zero):
        torch.manual_seed(0)
        model = build_model("danet", backbone="resnet18", dropout_rate=0.0,
                            bn_cross_replica=True)
        model.load_state_dict(torch.load(init_path))
        opt, sched = make_optimizer(config.OptimConfig(lr=1e-2), model, 10)
        state = create_train_state(model, opt, sched, rank, torch.device("cpu"))
        if zero:
            state.optimizer = shard_optimizer(opt)
        return wrap_data_parallel(state)

    def momenta(state):
        names = {id(p): n for n, p in state.model.named_parameters()}
        opt = getattr(state.optimizer, "optim", state.optimizer)
        return {names[id(p)]: s["momentum_buffer"].clone()
                for p, s in opt.state.items()}

    def same_weights(a, b):
        return all(torch.equal(x, y) for x, y in zip(
            a.model.state_dict().values(), b.model.state_dict().values()))

    step = make_train_step()
    zero = state_of(True)
    step(zero, batches[rank][0])
    CheckpointManager(ckpt_dir).save(zero.step, zero, extra={"epoch": 0})
    dp = state_of(False)
    CheckpointManager(ckpt_dir).restore(dp)
    out = {"zero_local": momenta(zero), "dp_restored": momenta(dp),
           "dp_weights_equal": same_weights(zero, dp)}
    out["loss_next"] = [float(step(s, batches[rank][1])) for s in (zero, dp)]
    out["steps"] = (zero.step, dp.step)
    CheckpointManager(ckpt_dir).save(dp.step, dp, extra={"epoch": 0})
    back = state_of(True)
    CheckpointManager(ckpt_dir).restore(back)
    out.update(dp_after=momenta(dp), zero_restored=momenta(back),
               zero_weights_equal=same_weights(dp, back), back_step=back.step)
    return out


def stop_consensus(rank, world, signal_rank, signal_at, check_every):
    """A loop of 12 steps under a ``PreemptionGuard``; rank
    ``signal_rank`` sends itself SIGTERM at step ``signal_at``.  Returns
    the step every rank stopped at and whether its own flag was set."""
    with PreemptionGuard(check_every=check_every) as guard:
        for step in range(1, 13):
            if rank == signal_rank and step == signal_at:
                os.kill(os.getpid(), signal.SIGTERM)
            if guard.should_stop(step):
                return {"stopped_at": step, "own_flag": guard.triggered}
    return {"stopped_at": None, "own_flag": guard.triggered}


def semantic_trajectory(rank, world, init_path, batches, lr):
    """Train steps of DeepLabV3-R18 (aux head, 5 classes, dropout off)
    under ``dp`` with the softmax loss over the global count of valid
    pixels, from the weights in ``init_path``; ``batches[rank]`` are this
    rank's rows of each step.  Returns the losses and the final
    state_dict."""
    model = build_model("deeplabv3", nclass=5, backbone="resnet18",
                        aux_head=True, in_channels=3, dropout_rate=0.0,
                        bn_cross_replica=True)
    model.load_state_dict(torch.load(init_path))
    opt, sched = make_optimizer(config.OptimConfig(lr=lr), model, 10)
    state = create_train_state(model, opt, sched, 0, torch.device("cpu"))
    wrap_data_parallel(state)
    step = make_train_step(loss_weights=(1.0, 0.4), loss_type="multi_softmax")
    lossv = [float(step(state, b)) for b in batches[rank]]
    return {"losses": lossv, "state": model.state_dict()}
