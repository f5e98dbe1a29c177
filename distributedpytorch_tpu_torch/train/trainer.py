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

It runs on CUDA unless ``device`` says otherwise.  A knob this port does
not run yet, set away from its default, raises at construction
(``config.unported_knobs``).  Left out for now: resume, warm start, the
sentinel, the feed governor, preemption handling, telemetry and
overlapped validation.
"""

from __future__ import annotations

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
from .checkpoint import CheckpointManager, atomic_write_json, next_run_dir
from .evaluate import batch_debug_asserts, evaluate
from .logging import MultiWriter, make_writer
from .optim import make_optimizer
from .precision import apply_policy


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
        apply_policy(cfg.train.precision)
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
                in_channels=cfg.model.in_channels)
        total_steps = len(self.train_loader) * cfg.epochs
        optimizer, self.schedule = make_optimizer(cfg.optim, self.model,
                                                  total_steps)
        self.state = create_train_state(self.model, optimizer, self.schedule,
                                        cfg.seed, self.device)
        self.train_step = make_train_step(
            loss_weights=cfg.model.loss_weights,
            accum_steps=cfg.optim.accum_steps,
            loss_scale=cfg.optim.loss_scale,
            grad_clip_norm=cfg.optim.grad_clip_norm)
        self.eval_step = make_eval_step(loss_weights=cfg.model.loss_weights)
        self.ckpt = CheckpointManager(
            os.path.join(self.run_dir, "checkpoints"),
            keep_latest=cfg.checkpoint.keep_latest,
            best_metric_init=cfg.checkpoint.best_metric_init,
            digest=cfg.checkpoint.digest)

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

    def train_epoch(self, epoch: int) -> float:
        """One epoch; returns its mean train loss.  Losses stay on the
        device and are read at the log cadence and at the epoch's end."""
        cfg = self.cfg
        self.train_loader.set_epoch(epoch)
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
            if step % cfg.log_every_steps == 0:
                self.writer.scalars({"train/loss": float(losses[-1]),
                                     "train/lr": self.schedule(step - 1),
                                     "train/epoch": epoch}, step)
        loss_arr = torch.stack(losses).cpu().numpy()
        dt = time.perf_counter() - t0
        if not np.all(np.isfinite(loss_arr)):
            msg = (f"{int((~np.isfinite(loss_arr)).sum())}/{loss_arr.size} "
                   f"non-finite train losses in epoch {epoch}")
            if cfg.debug_asserts:
                raise FloatingPointError(msg)
            print(f"warning: {msg}", flush=True)
        scalars = {"train/epoch_loss": float(loss_arr.mean()),
                   "train/step_losses": loss_arr.tolist(),
                   "train/imgs_per_sec": loss_arr.size * cfg.data.train_batch / dt,
                   "train/epoch_seconds": dt,
                   "train/data_wait_seconds": data_s,
                   "train/epoch": epoch}
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

    def fit(self) -> dict:
        """Train ``cfg.epochs`` epochs; returns ``{"train_loss": [...],
        "val": [...]}``.  The attention kernels' launch counts of the fit
        go to ``fit_summary.json``."""
        cfg = self.cfg
        history: dict = {"train_loss": [], "val": []}
        cuda_attention.reset_launches()
        for epoch in range(cfg.epochs):
            t0 = time.perf_counter()
            history["train_loss"].append(self.train_epoch(epoch))
            step = self.state.step
            if cfg.eval_every and (epoch + 1) % cfg.eval_every == 0:
                metrics = self.validate(epoch)
                history["val"].append(dict(metrics, epoch=epoch))
                if self.ckpt.save(step, self.state, metric=metrics["jaccard"],
                                  extra={"epoch": epoch}):
                    self.writer.scalars({"val/new_best_jaccard":
                                         metrics["jaccard"], "val/epoch": epoch},
                                        step)
            elif cfg.checkpoint.snapshot_every and \
                    (epoch + 1) % cfg.checkpoint.snapshot_every == 0:
                self.ckpt.save(step, self.state, extra={"epoch": epoch})
            self.writer.scalars({"epoch": epoch, "epoch_total_seconds":
                                 time.perf_counter() - t0}, step)
        atomic_write_json(os.path.join(self.run_dir, "fit_summary.json"), {
            "completed": True, "final_step": self.state.step,
            "epochs": cfg.epochs, "epochs_recorded": len(history["train_loss"]),
            "device": str(self.device),
            "kernel_launches": dict(cuda_attention.launches)})
        self.writer.flush()
        return history

    def close(self) -> None:
        self.writer.close()
