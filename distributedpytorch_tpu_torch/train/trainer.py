"""The training loop, the counterpart of ``distributedpytorch_tpu/train/trainer.py``
for one device.

``Trainer(cfg)`` creates ``work_dir/run_<N>``, builds the data (VOC from
``data.root``, or the in-memory fake of 8 images at 96 x 128, 3 of them
val, with ``data.fake``), the model, the SGD optimizer and schedule, the
train and eval steps and the checkpoint manager, applies the precision
policy, and writes ``config.json``, ``hparams.json`` and the parameter
report.  ``fit`` trains every epoch, validates every ``eval_every``
epochs (saving the checkpoint, and the best one by the ``jaccard``
metric), saves a snapshot every ``checkpoint.snapshot_every`` epochs
otherwise, and writes ``fit_summary.json``.

``task`` picks the data, loss and validation: ``instance`` (one sample
per object, click guidance, the balanced sigmoid loss, threshold-swept
Jaccard; ``model.nclass=1``) or ``semantic`` (one sample per image,
class ids with void 255, the softmax loss over every output with
``model.loss_weights``, confusion-matrix mIoU with ``eval_full_res``,
``eval_tta_scales`` and ``eval_tta_flip``; its ``jaccard`` is the mIoU,
so the best checkpoint is chosen the same way).

``data.loader`` picks the train loader: ``threads`` (the threaded
``DataLoader``) or ``grain`` (worker processes,
``data/grain_pipeline.py``); validation always runs on the threaded one.
``data.fused_crop_resize`` and ``data.decode_cache`` reach the train
transform and both datasets.

``train.precision=bfloat16`` builds the model in bf16 compute with float32
master weights and hands the policy to the train and eval steps
(``train/precision.py``).  ``checkpoint.warm_start`` imports model weights
from a ``.pth`` (a JAX export, a port ``state_dict`` or a torchvision
ResNet); ``resume`` continues a run from its checkpoints (``auto``: the
newest earlier run under ``work_dir`` that has one).  A SIGTERM or SIGINT
during ``fit`` stops at the next check, saves the whole state once, marked
with the epoch and the number of its steps done, and returns; the resumed
run continues at that batch.

It runs on CUDA unless ``device`` says otherwise.  A knob this port does
not run yet, set away from its default, raises at construction
(``config.unported_knobs``).  Left out for now: the sentinel, the feed
governor, telemetry, overlapped validation, elastic membership.

Data parallelism: constructed in every process of a group
(``parallel/mesh.py``; ``python -m distributedpytorch_tpu_torch`` forms
it), the trainer resolves the plan (``parallel.strategy`` dp | dp_zero1,
``parallel/plan.py``), checks that the global ``data.train_batch``
divides over the ranks and their micro-batches, gives each rank a loader
of ``train_batch // W`` rows over its shard, builds the model with
cross-replica BatchNorm, wraps it in DDP (and the optimizer in ZeRO-1
under ``dp_zero1``), seeds each rank's dropout generator from ``(seed,
rank)`` and validates each rank's shard into one set of metrics.  Rank 0
alone writes the run's files, logs and prints; the stop after a signal to
any rank is a consensus, and its save records ``num_shards``, so a
resume under another world size replays the interrupted epoch.  The
plan's block goes to ``fit_summary.json`` and every checkpoint's meta.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from ..data.fake import make_fake_voc
from ..data.grain_pipeline import GrainDataLoader
from ..data.pipeline import (
    DataLoader,
    build_eval_transform,
    build_semantic_eval_transform,
    build_semantic_train_transform,
    build_train_transform,
)
from ..data.voc import VOCInstanceSegmentation, VOCSemanticSegmentation
from ..models import build_model
from ..ops import cuda_attention
from ..parallel import mesh
from ..parallel import plan as plan_lib
from ..parallel.consensus import replicated_decision
from ..parallel.step import (
    create_train_state,
    make_eval_step,
    make_train_step,
    wrap_data_parallel,
)
from ..parallel.zero import shard_optimizer
from ..predict import resolve_device
from . import config as config_lib
from ..utils import weights
from .checkpoint import (
    CheckpointManager,
    atomic_write_json,
    latest_checkpoint_dir,
    next_run_dir,
)
from .evaluate import (
    batch_debug_asserts,
    evaluate,
    evaluate_semantic,
    semantic_batch_debug_asserts,
)
from .logging import MultiWriter, make_writer
from .optim import make_optimizer
from .precision import apply_policy, precision_block
from .preemption import PreemptionGuard


def rank_seed(seed: int, rank: int) -> int:
    """The dropout generator's seed of ``rank``: ``seed`` itself on rank 0
    (the single-process run's), one drawn from ``(seed, rank)`` on the
    others, so the ranks draw different masks."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


class Trainer:
    """Build once, ``fit()`` to train, ``validate()`` to evaluate."""

    def __init__(self, cfg: config_lib.Config,
                 device: str | torch.device | None = None):
        unported = config_lib.unported_knobs(cfg)
        if unported:
            raise NotImplementedError(
                "not ported yet: " + ", ".join(unported))
        if cfg.task not in ("instance", "semantic"):
            raise ValueError(
                f"unknown task: {cfg.task!r} (instance | semantic)")
        if cfg.task == "instance" and cfg.model.nclass != 1:
            raise ValueError(
                f"task='instance' requires model.nclass=1 (binary sigmoid "
                f"head), got {cfg.model.nclass}; use task='semantic' for "
                "multi-class")
        if (cfg.eval_tta_scales or cfg.eval_tta_flip) \
                and cfg.task != "semantic":
            raise ValueError(
                "eval_tta_scales/eval_tta_flip apply to the semantic task "
                "only (the instance protocol is the reference's fixed "
                "threshold sweep)")
        if cfg.eval_full_res and cfg.task != "semantic":
            raise ValueError(
                "eval_full_res applies to the semantic task only (the "
                "instance protocol already scores at full resolution via "
                "crop2fullmask paste-back)")
        self.cfg = cfg
        self.device = resolve_device(device)
        #: the data axis: the processes of the group, this one's rank
        self.world, self.rank = mesh.data_axis_size(), mesh.process_index()
        self.is_main = self.rank == 0
        self.distributed = mesh.is_distributed()
        mesh.resolve_data_axis(cfg.mesh.data)
        self.plan = plan_lib.plan_from_config(cfg, n_devices=self.world)
        if cfg.train.reduce_buckets and \
                self.plan.strategy not in plan_lib.BUCKET_COMPATIBLE:
            raise plan_lib.reduce_buckets_conflict(self.plan.strategy)
        self.precision = apply_policy(cfg.train.precision)
        self.run_dir = mesh.broadcast_object(
            next_run_dir(cfg.work_dir) if self.is_main else None)
        self.writer = MultiWriter(*[make_writer(name, self.run_dir)
                                    for name in cfg.log_writers]) \
            if self.is_main else MultiWriter()

        d = cfg.data
        root = make_fake_voc(n_images=8, size=(96, 128), n_val=3,
                             seed=cfg.seed) if d.fake else d.root
        if cfg.task == "semantic":
            self.train_set = VOCSemanticSegmentation(
                root, split=d.train_split,
                transform=build_semantic_train_transform(
                    crop_size=tuple(d.crop_size), rots=tuple(d.rots),
                    scales=tuple(d.scales)),
                decode_cache=d.decode_cache)
            # one sample per image, read once per validation: no cache
            self.val_set = VOCSemanticSegmentation(
                root, split=d.val_split,
                transform=build_semantic_eval_transform(
                    crop_size=tuple(d.crop_size),
                    keep_fullres=cfg.eval_full_res))
        else:
            train_tf = build_train_transform(
                crop_size=tuple(d.crop_size), relax=d.relax,
                zero_pad=d.zero_pad, rots=tuple(d.rots),
                scales=tuple(d.scales), alpha=d.guidance_alpha,
                guidance=d.guidance, fused_crop_resize=d.fused_crop_resize)
            val_tf = build_eval_transform(
                crop_size=tuple(d.crop_size), relax=d.relax,
                zero_pad=d.zero_pad, alpha=d.guidance_alpha,
                guidance=d.guidance)
            self.train_set = VOCInstanceSegmentation(
                root, split=d.train_split, transform=train_tf,
                area_thres=d.area_thres, decode_cache=d.decode_cache)
            self.val_set = VOCInstanceSegmentation(
                root, split=d.val_split, transform=val_tf,
                area_thres=d.area_thres, decode_cache=d.decode_cache)
        # batch sizes are global: each rank loads its 1/W share of every
        # batch, which must divide over the ranks and the micro-batches
        tb, w, accum = d.train_batch, self.world, cfg.optim.accum_steps
        if tb % w:
            raise ValueError(f"global train batch {tb} not divisible by "
                             f"{w} processes")
        if tb % (w * accum):
            raise ValueError(
                f"global train batch {tb} not divisible by data axis "
                f"{w} x accum_steps {accum}")
        vb = max(1, -(-d.val_batch // w))  # per rank, ceil, >= 1
        if self.is_main and vb * w != d.val_batch:
            print(f"note: global val batch rounded {d.val_batch} -> "
                  f"{vb * w} ({vb}/rank x {w} ranks)", flush=True)
        shard = {"num_shards": w, "shard_index": self.rank,
                 # the dp step's global micro-batches; the bucketed step
                 # splits each rank's own rows
                 "micro_batches": 1 if cfg.train.reduce_buckets else accum}
        if d.loader == "grain":
            self.train_loader = GrainDataLoader(
                self.train_set, tb // w, shuffle=True, drop_last=True,
                seed=cfg.seed, num_workers=d.num_workers, prefetch=d.prefetch,
                **shard)
        elif d.loader == "threads":
            self.train_loader = DataLoader(
                self.train_set, tb // w, shuffle=True, drop_last=True,
                seed=cfg.seed, num_workers=d.num_workers, prefetch=d.prefetch,
                **shard)
        else:
            raise ValueError(f"unknown data.loader: {d.loader!r} "
                             "(threads | grain)")
        self.val_loader = DataLoader(
            self.val_set, vb, shuffle=False, drop_last=False,
            seed=cfg.seed, num_workers=d.num_workers, prefetch=d.prefetch,
            num_shards=w, shard_index=self.rank)
        # one rank raising alone would leave the others waiting at their
        # first collective: the emptiness decision is a consensus
        if replicated_decision(len(self.train_loader), reduce="min",
                               label="trainer/train_loader_len") == 0:
            raise ValueError(
                f"train loader is empty: {len(self.train_set)} samples "
                f"(~{len(self.train_set) // w} on this rank's shard), batch "
                f"{tb // w} per rank with drop_last — lower "
                "data.train_batch or enlarge the dataset")

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)  # the initial weights
            self.model = build_model(
                cfg.model.name, nclass=cfg.model.nclass,
                backbone=cfg.model.backbone,
                output_stride=cfg.model.output_stride,
                attention_impl=cfg.model.attention_impl,
                in_channels=cfg.model.in_channels,
                dtype=(self.precision.compute_dtype if self.precision
                       else cfg.model.dtype),
                pam_score_dtype=cfg.model.pam_score_dtype,
                remat=cfg.model.remat, aux_head=cfg.model.aux_head,
                encnet_codes=cfg.model.encnet_codes,
                ccnet_recurrence=cfg.model.ccnet_recurrence,
                bn_cross_replica=self.distributed)
        total_steps = len(self.train_loader) * cfg.epochs
        optimizer, self.schedule = make_optimizer(cfg.optim, self.model,
                                                  total_steps)
        self.state = create_train_state(self.model, optimizer, self.schedule,
                                        rank_seed(cfg.seed, self.rank),
                                        self.device)
        if self.distributed:
            if self.plan.shard_opt_state:  # on the device: ZeRO keeps it
                self.state.optimizer = shard_optimizer(optimizer)
            wrap_data_parallel(self.state, cfg.train.reduce_buckets)
        self.loss_type = ("multi_softmax" if cfg.task == "semantic"
                          else "multi_sigmoid")
        self.train_step = make_train_step(
            loss_weights=cfg.model.loss_weights,
            accum_steps=cfg.optim.accum_steps,
            loss_scale=cfg.optim.loss_scale,
            grad_clip_norm=cfg.optim.grad_clip_norm,
            precision=self.precision,
            global_balance=not cfg.train.reduce_buckets,
            loss_type=self.loss_type)
        self.eval_step = make_eval_step(loss_weights=cfg.model.loss_weights,
                                        precision=self.precision,
                                        loss_type=self.loss_type)
        self.ckpt = CheckpointManager(
            os.path.join(self.run_dir, "checkpoints"),
            keep_latest=cfg.checkpoint.keep_latest,
            best_metric_init=cfg.checkpoint.best_metric_init,
            digest=cfg.checkpoint.digest)
        self.start_epoch = 0
        #: batches of ``start_epoch`` a preempted run already trained
        self._resume_start_batch = 0
        #: steps the resume's restore skipped as unreadable
        self.resume_fallback_steps: list[int] = []
        #: the restored checkpoint's meta (empty when not resumed)
        self.resume_meta: dict = {}
        if cfg.checkpoint.warm_start:
            self._warm_start(cfg.checkpoint.warm_start,
                             cfg.checkpoint.warm_start_partial)
        if cfg.resume == "auto":
            src = mesh.broadcast_object(latest_checkpoint_dir(
                cfg.work_dir, exclude_run=self.run_dir)
                if self.is_main else None)
            if src is None:
                self._print(f"resume=auto: no prior checkpoints under "
                            f"{cfg.work_dir}; starting fresh")
            else:
                self._resume(src)
        elif cfg.resume:
            self._resume(cfg.resume)

        flat = config_lib.flatten(cfg)
        flat.update(n_params=self.n_params, device=str(self.device),
                    train_set=str(self.train_set), val_set=str(self.val_set),
                    world_size=self.world, resolved_plan=self.plan.describe())
        if self.is_main:
            with open(os.path.join(self.run_dir,
                                   f"{cfg.experiment_name}.txt"), "w") as f:
                f.writelines(f"{k}: {v}\n" for k, v in flat.items())
            config_lib.to_json(cfg, os.path.join(self.run_dir, "config.json"))
        self.writer.hparams(flat)

    def _print(self, msg: str) -> None:
        """Print on rank 0 only."""
        if self.is_main:
            print(msg, flush=True)

    @property
    def order_meta(self) -> dict:
        """What fixes the batch order a preemption save's batch offset
        indexes: ``num_shards`` (the world size), ``echo``,
        ``train_batch``, ``seed`` and the worker loader's worker count."""
        return {"num_shards": self.world, "echo": self.cfg.data.echo,
                "train_batch": self.cfg.data.train_batch,
                "seed": self.cfg.seed, "loader_workers": self.loader_workers}

    @property
    def loader_workers(self) -> int:
        """The worker count that shapes the train loader's batches: the
        worker-process loader's, 0 for the threaded one."""
        return self.train_loader.num_workers \
            if isinstance(self.train_loader, GrainDataLoader) else 0

    @property
    def n_params(self) -> int:
        return sum(p.numel() for p in self.model.parameters())

    def _warm_start(self, path: str, partial: bool) -> None:
        """Import model weights (parameters and BatchNorm statistics) from
        a torch ``.pth``; the step count, optimizer and generator stay
        fresh.  A torchvision ResNet is detected by its key names: its
        stem is widened to ``model.in_channels``, its keys renamed onto the
        backbone and the import made partial (the head is not in it), but
        the backbone must import whole, and a depth other than the
        model's raises.  An import that matches no key raises."""
        sd = weights.load_torch_file(path)
        rename = None
        if weights.is_torchvision_resnet(sd):
            backbone = self.cfg.model.backbone
            if not backbone.startswith("resnet"):
                raise ValueError(f"{path} looks like a torchvision ResNet "
                                 f"checkpoint but model.backbone={backbone!r}")
            depth = weights.torchvision_resnet_depth(sd)
            if depth != int(backbone[len("resnet"):]):
                raise ValueError(f"{path} is a torchvision resnet{depth} "
                                 f"checkpoint but model.backbone={backbone!r}")
            sd = weights.inflate_stem_channels(sd, self.cfg.model.in_channels)
            rename = weights.torchvision_resnet_rename(depth)
            partial = True
            self._print(f"warm start: torchvision ResNet naming detected in "
                        f"{path}; importing as pretrained backbone")
        imported, kept = weights.import_state_dict(
            self.model, sd, rename=rename, allow_missing=partial,
            allow_unused=partial)
        if rename is not None:
            missing = [k for k in kept if k.startswith("backbone.")]
            if missing:
                raise ValueError(
                    f"torchvision import left {len(missing)} backbone tensors "
                    f"at fresh init (e.g. {missing[0]}): tensor shapes in "
                    f"{path} do not match a plain resnet{depth}")
        if not imported:
            raise ValueError(f"warm start from {path} imported 0 of "
                             f"{len(kept)} tensors — checkpoint keys do not "
                             "match this model; check the architecture/naming")
        self._print(f"warm-started {len(imported)} tensors from {path} "
                    f"({len(kept)} kept from fresh init)")

    def _resume(self, source: str) -> None:
        """Restore the whole train state from the checkpoints in
        ``source`` and position the fit: the epoch after the saved one,
        or, for a save made on preemption, the interrupted epoch at the
        batch where it stopped — unless ``checkpoint.exact_resume`` is off
        or the batch order changed since (the world size, train batch,
        seed, echo, or the worker-process loader's worker count), when the
        epoch replays from its start.  A checkpoint of another plan (a
        ``dp_zero1`` save under ``dp``, another world size) restores all
        the same; the crossing is announced."""
        mgr = CheckpointManager(source)
        meta = mgr.restore(self.state)
        self.resume_meta = dict(meta)
        self.resume_fallback_steps = list(mgr.last_restore_fallback)
        self.start_epoch = int(meta.get("epoch", 0)) + 1
        self.ckpt.best_metric = float(meta.get("best_metric",
                                               self.ckpt.best_metric))
        if plan_lib.plans_differ(meta.get("plan"), self.plan.block(),
                                 self.world):
            self._print(f"plan crossing: checkpoint saved under "
                        f"{meta.get('plan')}, restored under "
                        f"{self.plan.block()}")
        interrupted = meta.get("interrupted_epoch")
        if interrupted is not None and self.cfg.checkpoint.exact_resume:
            stale = {k: (meta.get(k, v), v) for k, v in self.order_meta.items()
                     if int(meta.get(k, v)) != v}
            if stale:
                self._print(
                    "exact_resume: data-order config changed (" + ", ".join(
                        f"{k}: {a} -> {b}" for k, (a, b) in stale.items())
                    + ") — replaying the interrupted epoch instead")
            else:
                done = int(meta.get("epoch_steps_done", 0)) \
                    // max(1, self.cfg.data.echo)
                # a stop on the epoch's last step still owes the epoch-end
                # validation and checkpoint: replay the final batch
                done = min(done, len(self.train_loader) - 1)
                self.start_epoch = int(interrupted)
                self._resume_start_batch = done
        at = f"epoch {self.start_epoch}"
        if self._resume_start_batch:
            at += f" batch {self._resume_start_batch}"
        self._print(f"resumed from {source} step {self.state.step} at {at} "
                    f"(best={self.ckpt.best_metric:.4f})")

    def train_epoch(self, epoch: int, guard: PreemptionGuard | None = None,
                    start_batch: int = 0) -> float:
        """One epoch from batch ``start_batch`` of its order; returns the
        mean train loss of the batches trained.  Losses stay on the device
        and are read at the log cadence and at the epoch's end.  ``guard``
        is read every ``guard.check_every`` steps; when it says stop the
        epoch ends early and logs no epoch summary."""
        cfg = self.cfg
        self.train_loader.set_epoch(epoch, start_batch=start_batch)
        interrupted = False
        losses: list[torch.Tensor] = []
        data_s = 0.0
        t0 = time.perf_counter()
        batches = iter(self.train_loader)
        try:
            while True:
                t_data = time.perf_counter()
                batch = next(batches, None)
                data_s += time.perf_counter() - t_data
                if batch is None:
                    break
                if cfg.debug_asserts:
                    self._debug_asserts(batch)
                losses.append(self.train_step(self.state, batch))
                step = self.state.step
                if guard is not None and guard.should_stop(step):
                    interrupted = True
                    break
                if step % cfg.log_every_steps == 0:
                    self.writer.scalars({"train/loss": float(losses[-1]),
                                         "train/lr": self.schedule(step - 1),
                                         "train/epoch": epoch}, step)
        finally:
            batches.close()  # stops the loader's threads or workers
        loss_arr = torch.stack(losses).cpu().numpy()
        dt = time.perf_counter() - t0
        if not np.all(np.isfinite(loss_arr)):
            msg = (f"{int((~np.isfinite(loss_arr)).sum())}/{loss_arr.size} "
                   f"non-finite train losses in epoch {epoch}")
            if cfg.debug_asserts:
                raise FloatingPointError(msg)
            self._print(f"warning: {msg}")
        if interrupted:
            return float(loss_arr.mean())
        scalars = {"train/epoch_loss": float(loss_arr.mean()),
                   "train/step_losses": loss_arr.tolist(),
                   "train/imgs_per_sec": loss_arr.size * cfg.data.train_batch / dt,
                   "train/epoch_seconds": dt,
                   "train/data_wait_seconds": data_s,
                   "train/epoch": epoch}
        if start_batch:
            scalars["train/resumed_at_batch"] = start_batch
        if self.device.type == "cuda":
            scalars["train/peak_memory_gb"] = \
                torch.cuda.max_memory_allocated(self.device) / 2**30
        self.writer.scalars(scalars, self.state.step)
        return float(loss_arr.mean())

    def _debug_asserts(self, batch) -> None:
        if self.cfg.task == "semantic":
            semantic_batch_debug_asserts(batch, self.cfg.model.nclass)
        else:
            batch_debug_asserts(batch)

    def validate(self, epoch: int | None = None) -> dict:
        """The task's validation protocol on the current state; logs and
        returns its metrics."""
        cfg = self.cfg
        self.val_loader.set_epoch(0)
        if cfg.task == "semantic":
            metrics = evaluate_semantic(
                self.eval_step, self.state, self.val_loader,
                nclass=cfg.model.nclass, tta_scales=cfg.eval_tta_scales,
                tta_flip=cfg.eval_tta_flip, debug_asserts=cfg.debug_asserts,
                bf16_probs=cfg.eval_bf16_probs,
                device_fullres=(tuple(cfg.data.val_max_im_size)
                                if cfg.eval_device_fullres else None))
        else:
            metrics = evaluate(self.eval_step, self.state, self.val_loader,
                               thresholds=cfg.eval_thresholds,
                               relax=cfg.data.relax,
                               zero_pad=cfg.data.zero_pad,
                               debug_asserts=cfg.debug_asserts,
                               bf16_readback=cfg.eval_bf16_probs)
        if cfg.debug_asserts and not np.isfinite(metrics["loss"]):
            raise FloatingPointError(f"non-finite val loss {metrics['loss']} "
                                     f"at epoch {epoch}")
        flat = {"val/loss": metrics["loss"], "val/jaccard": metrics["jaccard"],
                "val/n_samples": metrics["n_samples"]}
        if "best_threshold" in metrics:
            flat["val/best_threshold"] = metrics["best_threshold"]
            flat.update({f"val/jaccard@{t}": v for t, v in
                         metrics["jaccard_per_threshold"].items()})
        if "miou" in metrics:
            flat["val/miou"] = metrics["miou"]
            flat["val/pixel_acc"] = metrics["pixel_acc"]
            flat["val/per_class_iou"] = metrics["per_class_iou"]
        if epoch is not None:
            flat["val/epoch"] = epoch
        self.writer.scalars(flat, self.state.step)
        return metrics

    def fit(self, guard: PreemptionGuard | None = None) -> dict:
        """Train from ``start_epoch`` to ``cfg.epochs``; returns
        ``{"train_loss": [...], "val": [...]}``, plus ``"preempted": True``
        when a stop was taken.  Unless ``checkpoint.save_on_preempt`` is
        off, SIGTERM/SIGINT are caught for the fit's duration (pass an
        entered ``guard`` of your own to stop it by ``trip()``): the loop
        stops at the next check (every ``checkpoint.preempt_check_every``
        steps, and at the epoch's end), saves the whole state once —
        marked with the interrupted epoch and its steps done — and
        returns.  The attention kernels' launch counts of the fit go to
        ``fit_summary.json``."""
        cfg = self.cfg
        history: dict = {"train_loss": [], "val": []}
        cuda_attention.reset_launches()
        start_step = self.state.step
        with contextlib.ExitStack() as stack:
            if guard is None and cfg.checkpoint.save_on_preempt:
                guard = stack.enter_context(PreemptionGuard(
                    check_every=cfg.checkpoint.preempt_check_every))
            epoch = self.start_epoch
            while epoch < cfg.epochs:
                t0 = time.perf_counter()
                sb, self._resume_start_batch = self._resume_start_batch, 0
                estep0 = self.state.step
                epoch_loss = self.train_epoch(epoch, guard=guard,
                                              start_batch=sb)
                step = self.state.step
                if guard is not None and guard.should_stop():
                    history["preempted"] = True
                    with guard.shield():
                        if self.ckpt.latest_step() != step:
                            self.ckpt.save(step, self.state, extra={
                                "epoch": epoch - 1,
                                "interrupted_epoch": epoch,
                                "epoch_steps_done": sb + (step - estep0),
                                **self.order_meta,
                                "plan": self.plan.block(),
                                "preempted": True})
                    self.writer.scalars({"preempted_at_epoch": epoch}, step)
                    break
                history["train_loss"].append(epoch_loss)
                if cfg.eval_every and (epoch + 1) % cfg.eval_every == 0:
                    metrics = self.validate(epoch)
                    history["val"].append(dict(metrics, epoch=epoch))
                    if self.ckpt.save(step, self.state,
                                      metric=metrics["jaccard"],
                                      extra={"epoch": epoch,
                                             "plan": self.plan.block()}):
                        self.writer.scalars({"val/new_best_jaccard":
                                             metrics["jaccard"],
                                             "val/epoch": epoch}, step)
                elif cfg.checkpoint.snapshot_every and \
                        (epoch + 1) % cfg.checkpoint.snapshot_every == 0:
                    self.ckpt.save(step, self.state, extra={
                        "epoch": epoch, "plan": self.plan.block()})
                self.writer.scalars({"epoch": epoch, "epoch_total_seconds":
                                     time.perf_counter() - t0}, step)
                epoch += 1
        preempted = bool(history.get("preempted"))
        # every rank's step, gathered: the ranks must stop together
        steps = replicated_decision(self.state.step, reduce=list,
                                    label="trainer/final_steps")
        if self.is_main:
            atomic_write_json(os.path.join(self.run_dir, "fit_summary.json"), {
                "completed": not preempted, "preempted": preempted,
                "start_step": start_step, "final_step": self.state.step,
                "start_epoch": self.start_epoch, "epochs": cfg.epochs,
                "epochs_recorded": len(history["train_loss"]),
                "resumed_from_step": self.resume_meta.get("step"),
                "device": str(self.device),
                "world_size": self.world,
                "final_step_by_rank": steps,
                "plan": self.plan.block(),
                "precision": precision_block(self.precision),
                "kernel_launches": dict(cuda_attention.launches)})
        self.writer.flush()
        return history

    def close(self) -> None:
        if isinstance(self.train_loader, GrainDataLoader):
            self.train_loader.close()
        self.writer.close()
