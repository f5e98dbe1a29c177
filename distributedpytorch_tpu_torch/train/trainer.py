"""The training loop, the counterpart of ``distributedpytorch_tpu/train/trainer.py``
for one device.

``Trainer(cfg)`` creates ``work_dir/run_<N>``, builds the data (VOC from
``data.root``, or the in-memory fake of 8 images at 96 x 128, 3 of them
val, with ``data.fake``), the model, the SGD optimizer and schedule, the
train and eval steps and the checkpoint manager, applies the precision
policy, and writes ``config.json``, ``hparams.json`` and the parameter
report.  ``fit`` trains every epoch, validates every ``eval_every``
epochs (saving the checkpoint, and the best one by Jaccard), saves a
snapshot every ``checkpoint.snapshot_every`` epochs otherwise, and writes
``fit_summary.json``.

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
governor, telemetry, overlapped validation, and everything multi-process
(the stop consensus, plan crossings).
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from ..data.fake import make_fake_voc
from ..data.pipeline import DataLoader, build_eval_transform, build_train_transform
from ..data.voc import VOCInstanceSegmentation
from ..models import build_model
from ..ops import cuda_attention
from ..parallel.step import create_train_state, make_eval_step, make_train_step
from ..predict import resolve_device
from . import config as config_lib
from ..utils import weights
from .checkpoint import (
    CheckpointManager,
    atomic_write_json,
    latest_checkpoint_dir,
    next_run_dir,
)
from .evaluate import batch_debug_asserts, evaluate
from .logging import MultiWriter, make_writer
from .optim import make_optimizer
from .precision import apply_policy, precision_block
from .preemption import PreemptionGuard


class Trainer:
    """Build once, ``fit()`` to train, ``validate()`` to evaluate."""

    def __init__(self, cfg: config_lib.Config,
                 device: str | torch.device | None = None):
        unported = config_lib.unported_knobs(cfg)
        if unported:
            raise NotImplementedError(
                "not ported yet: " + ", ".join(unported))
        if cfg.model.nclass != 1:
            raise ValueError(f"task='instance' requires model.nclass=1, got "
                             f"{cfg.model.nclass}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.precision = apply_policy(cfg.train.precision)
        self.run_dir = next_run_dir(cfg.work_dir)
        self.writer = MultiWriter(*[make_writer(name, self.run_dir)
                                    for name in cfg.log_writers])

        d = cfg.data
        root = make_fake_voc(n_images=8, size=(96, 128), n_val=3,
                             seed=cfg.seed) if d.fake else d.root
        train_tf = build_train_transform(
            crop_size=tuple(d.crop_size), relax=d.relax, zero_pad=d.zero_pad,
            rots=tuple(d.rots), scales=tuple(d.scales),
            alpha=d.guidance_alpha, guidance=d.guidance)
        val_tf = build_eval_transform(
            crop_size=tuple(d.crop_size), relax=d.relax, zero_pad=d.zero_pad,
            alpha=d.guidance_alpha, guidance=d.guidance)
        self.train_set = VOCInstanceSegmentation(
            root, split=d.train_split, transform=train_tf,
            area_thres=d.area_thres)
        self.val_set = VOCInstanceSegmentation(
            root, split=d.val_split, transform=val_tf, area_thres=d.area_thres)
        if d.train_batch % cfg.optim.accum_steps:
            raise ValueError(f"train batch {d.train_batch} not divisible by "
                             f"accum_steps {cfg.optim.accum_steps}")
        self.train_loader = DataLoader(
            self.train_set, d.train_batch, shuffle=True, drop_last=True,
            seed=cfg.seed, num_workers=d.num_workers, prefetch=d.prefetch)
        self.val_loader = DataLoader(
            self.val_set, d.val_batch, shuffle=False, drop_last=False,
            seed=cfg.seed, num_workers=d.num_workers, prefetch=d.prefetch)
        if len(self.train_loader) == 0:
            raise ValueError(
                f"train loader is empty: {len(self.train_set)} samples, "
                f"batch {d.train_batch} with drop_last — lower "
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
                remat=cfg.model.remat)
        total_steps = len(self.train_loader) * cfg.epochs
        optimizer, self.schedule = make_optimizer(cfg.optim, self.model,
                                                  total_steps)
        self.state = create_train_state(self.model, optimizer, self.schedule,
                                        cfg.seed, self.device)
        self.train_step = make_train_step(
            loss_weights=cfg.model.loss_weights,
            accum_steps=cfg.optim.accum_steps,
            loss_scale=cfg.optim.loss_scale,
            grad_clip_norm=cfg.optim.grad_clip_norm,
            precision=self.precision)
        self.eval_step = make_eval_step(loss_weights=cfg.model.loss_weights,
                                        precision=self.precision)
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
            src = latest_checkpoint_dir(cfg.work_dir, exclude_run=self.run_dir)
            if src is None:
                print(f"resume=auto: no prior checkpoints under "
                      f"{cfg.work_dir}; starting fresh", flush=True)
            else:
                self._resume(src)
        elif cfg.resume:
            self._resume(cfg.resume)

        flat = config_lib.flatten(cfg)
        flat.update(n_params=self.n_params, device=str(self.device),
                    train_set=str(self.train_set), val_set=str(self.val_set))
        with open(os.path.join(self.run_dir, f"{cfg.experiment_name}.txt"),
                  "w") as f:
            f.writelines(f"{k}: {v}\n" for k, v in flat.items())
        config_lib.to_json(cfg, os.path.join(self.run_dir, "config.json"))
        self.writer.hparams(flat)

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
            print(f"warm start: torchvision ResNet naming detected in {path}; "
                  "importing as pretrained backbone", flush=True)
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
        print(f"warm-started {len(imported)} tensors from {path} "
              f"({len(kept)} kept from fresh init)", flush=True)

    def _resume(self, source: str) -> None:
        """Restore the whole train state from the checkpoints in
        ``source`` and position the fit: the epoch after the saved one,
        or, for a save made on preemption, the interrupted epoch at the
        batch where it stopped — unless ``checkpoint.exact_resume`` is off
        or the batch order changed since (train batch, seed or echo),
        when the epoch replays from its start."""
        mgr = CheckpointManager(source)
        meta = mgr.restore(self.state)
        self.resume_meta = dict(meta)
        self.resume_fallback_steps = list(mgr.last_restore_fallback)
        self.start_epoch = int(meta.get("epoch", 0)) + 1
        self.ckpt.best_metric = float(meta.get("best_metric",
                                               self.ckpt.best_metric))
        interrupted = meta.get("interrupted_epoch")
        if interrupted is not None and self.cfg.checkpoint.exact_resume:
            now = {"echo": self.cfg.data.echo,
                   "train_batch": self.cfg.data.train_batch,
                   "seed": self.cfg.seed}
            stale = {k: (meta.get(k, v), v) for k, v in now.items()
                     if int(meta.get(k, v)) != v}
            if stale:
                print("exact_resume: data-order config changed (" + ", ".join(
                    f"{k}: {a} -> {b}" for k, (a, b) in stale.items())
                    + ") — replaying the interrupted epoch instead", flush=True)
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
        print(f"resumed from {source} step {self.state.step} at {at} "
              f"(best={self.ckpt.best_metric:.4f})", flush=True)

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
        while True:
            t_data = time.perf_counter()
            batch = next(batches, None)
            data_s += time.perf_counter() - t_data
            if batch is None:
                break
            if cfg.debug_asserts:
                batch_debug_asserts(batch)
            losses.append(self.train_step(self.state, batch))
            step = self.state.step
            if guard is not None and guard.should_stop(step):
                interrupted = True
                break
            if step % cfg.log_every_steps == 0:
                self.writer.scalars({"train/loss": float(losses[-1]),
                                     "train/lr": self.schedule(step - 1),
                                     "train/epoch": epoch}, step)
        batches.close()
        loss_arr = torch.stack(losses).cpu().numpy()
        dt = time.perf_counter() - t0
        if not np.all(np.isfinite(loss_arr)):
            msg = (f"{int((~np.isfinite(loss_arr)).sum())}/{loss_arr.size} "
                   f"non-finite train losses in epoch {epoch}")
            if cfg.debug_asserts:
                raise FloatingPointError(msg)
            print(f"warning: {msg}", flush=True)
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

    def validate(self, epoch: int | None = None) -> dict:
        """The validation protocol on the current state; logs and returns
        its metrics."""
        self.val_loader.set_epoch(0)
        metrics = evaluate(self.eval_step, self.state, self.val_loader,
                           thresholds=self.cfg.eval_thresholds,
                           relax=self.cfg.data.relax,
                           zero_pad=self.cfg.data.zero_pad,
                           debug_asserts=self.cfg.debug_asserts,
                           bf16_readback=self.cfg.eval_bf16_probs)
        if self.cfg.debug_asserts and not np.isfinite(metrics["loss"]):
            raise FloatingPointError(f"non-finite val loss {metrics['loss']} "
                                     f"at epoch {epoch}")
        flat = {"val/loss": metrics["loss"], "val/jaccard": metrics["jaccard"],
                "val/best_threshold": metrics["best_threshold"],
                "val/n_samples": metrics["n_samples"],
                **{f"val/jaccard@{t}": v for t, v in
                   metrics["jaccard_per_threshold"].items()}}
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
                                "echo": cfg.data.echo,
                                "train_batch": cfg.data.train_batch,
                                "seed": cfg.seed,
                                "preempted": True})
                    self.writer.scalars({"preempted_at_epoch": epoch}, step)
                    break
                history["train_loss"].append(epoch_loss)
                if cfg.eval_every and (epoch + 1) % cfg.eval_every == 0:
                    metrics = self.validate(epoch)
                    history["val"].append(dict(metrics, epoch=epoch))
                    if self.ckpt.save(step, self.state,
                                      metric=metrics["jaccard"],
                                      extra={"epoch": epoch}):
                        self.writer.scalars({"val/new_best_jaccard":
                                             metrics["jaccard"],
                                             "val/epoch": epoch}, step)
                elif cfg.checkpoint.snapshot_every and \
                        (epoch + 1) % cfg.checkpoint.snapshot_every == 0:
                    self.ckpt.save(step, self.state, extra={"epoch": epoch})
                self.writer.scalars({"epoch": epoch, "epoch_total_seconds":
                                     time.perf_counter() - t0}, step)
                epoch += 1
        preempted = bool(history.get("preempted"))
        atomic_write_json(os.path.join(self.run_dir, "fit_summary.json"), {
            "completed": not preempted, "preempted": preempted,
            "start_step": start_step, "final_step": self.state.step,
            "start_epoch": self.start_epoch, "epochs": cfg.epochs,
            "epochs_recorded": len(history["train_loss"]),
            "resumed_from_step": self.resume_meta.get("step"),
            "device": str(self.device),
            "precision": precision_block(self.precision),
            "kernel_launches": dict(cuda_attention.launches)})
        self.writer.flush()
        return history

    def close(self) -> None:
        self.writer.close()
