"""The training loop, the counterpart of ``distributedpytorch_tpu/train/trainer.py``
for one device.

``Trainer(cfg)`` creates ``work_dir/run_<N>``, builds the data (VOC from
``data.root``, or the in-memory fake of 8 images at 96 x 128, 3 of them
val, with ``data.fake``; SBD merged into the train set with
``data.sbd_root``), the model, the optimizer (SGD or AdamW) and
schedule, the train and eval steps and the checkpoint manager, applies the
precision policy, and writes ``config.json``, ``hparams.json`` and the parameter
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

Device-side data (the JAX trainer's wiring): the train batches reach the
step through ``parallel.mesh.prefetch_to_device`` with a window of
``max(data.device_prefetch, data.steps_per_dispatch)`` batches, read live
(so at least one placement is in flight, as in the JAX trainer).
``data.device_augment`` moves the flip (and with
``data.device_augment_geom`` the scale-rotate, on the fixed-size crop)
from the host stack into the train step, and
``data.device_guidance`` (instance task, any family of
``ops/guidance_device.FAMILIES``) the guidance channel: the host then
ships the bare image (``guidance='none'``).  One constructor,
:meth:`Trainer._build_device_stage`, builds that stage.
``data.prepared_cache`` puts both datasets behind the prepared-sample
cache (``data/prepared.py``); with ``data.val_prepared`` (its default)
validation reads its crops and full-resolution masks from there too, and
under ``data.device_guidance`` the eval step appends the val guidance
channel on the device.

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
(``config.unported_knobs``); so does ``model.moe_experts`` at a world
size above 1 (JAX routes the global batch's tokens).  With an MoE head
the train loss adds ``model.moe_aux_weight`` times the router's
load-balancing loss.  Left out for now: the sentinel (the fit
summary's ``recovery`` block is null), elastic membership, and the feed
governor's ``auto`` mode.

Telemetry (``telemetry``, on by default, as in the JAX trainer): the
flight recorder ``run_dir/events/<host>.<pid>.jsonl`` (``fit_start``,
the checkpoint saves and commits, preemption, governor decisions, fault
firings, ``fit_end`` with the goodput breakdown); the goodput accountant
(``telemetry/goodput.py``) books the batch fetch under ``input_wait``,
the first step under ``compile`` (on the card it pays the kernels' build,
cuDNN's algorithm search and CUDA's lazy start) and every later one, with
the loss reads at the log cadence and the epoch's end, under ``step``,
validation under ``eval`` (on its own thread when overlapped) and the
checkpoints under ``checkpoint``, with no synchronisation added; at the
fit's end the breakdown and the MFU (model FLOPs from
``telemetry.step_flops`` on a meta-device copy of the model, or
``6 x params x batch`` if that fails; counted once per model and batch
shape in a process) go to the writers (``goodput/*``, ``mfu``), the
registry and ``history``.  An MoE head's count is what the port runs: the
expert products over every capacity slot and none of the (N, E, C)
dispatch einsums that the JAX trainer's XLA count includes, so the two
MFUs differ there.  ``SIGUSR2`` arms a bounded
``torch.profiler`` capture under ``run_dir/trace_on_demand`` (refused,
and counted, while ``profile_epoch``'s profiler runs).  The feed governor
(``data.governor=observe``, ``data/governor.py``) reads the input-wait
share at the log cadence, writes its would-be decisions to
``run_dir/governor.jsonl`` and actuates nothing; its summary is
``history["feed"]``.  ``fit_summary.json`` always carries ``recovery``
and ``feed`` (null when off).  ``telemetry=false`` turns every hook off.
The chaos sites ``trainer/batch_fetch``, ``trainer/train_step`` and
``checkpoint/save`` fire under a plan armed from ``DPTPU_CHAOS_PLAN``.

Validation and observability: ``validate`` is the evaluation
(``_eval_metrics``, no side effects) plus its logging (``_log_val``: the
metrics, and the first batch's figure panels for the writers that take
figures, a failure to draw them swallowed).  ``val_overlap`` validates a
snapshot of the epoch-end state on a thread while the next epoch trains:
the model is deep-copied on the device, in eval mode, with the optimizer's
state and the dropout generator copied beside it, so the deferred
best-checkpoint save writes the epoch-end state; the thread enters the
device and inference mode itself and launches on the device's current
stream, the main thread's, so the overlap is on the host (the paste-back
and data loading beside the train steps) and the card runs the two in
turn.  An error on the thread surfaces at the train loop's next log
cadence; the bookkeeping (logs, history, checkpoint) runs on the main
thread at the join, after the next epoch; an unwinding fit joins and
drops it.  Single-rank only, as in the JAX package.  ``profile_epoch``
traces that epoch with ``torch.profiler`` into ``run_dir/profile`` on
rank 0 (``utils/profiling.trace``).  The writers get the flattened config
as hyperparameters.

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
import copy
import dataclasses
import functools
import os
import threading
import time

import numpy as np
import torch

from ..chaos import sites as chaos_sites
from ..data.combine import CombinedDataset
from ..data.fake import make_fake_voc
from ..data.governor import FeedActuators, FeedGovernor
from ..data.grain_pipeline import GrainDataLoader
from ..data.pipeline import (
    DataLoader,
    build_eval_transform,
    build_prepared_eval_post_transform,
    build_prepared_post_transform,
    build_prepared_semantic_eval_post_transform,
    build_prepared_semantic_post_transform,
    build_semantic_eval_transform,
    build_semantic_train_transform,
    build_train_transform,
)
from ..data.prepared import PreparedInstanceDataset, PreparedSemanticDataset
from ..data.sbd import SBDInstanceSegmentation, SBDSemanticSegmentation
from ..data.voc import VOCInstanceSegmentation, VOCSemanticSegmentation
from ..models import build_model
from ..ops import cuda_attention
from ..ops.augment import make_device_augment
from ..ops.guidance_device import FAMILIES as DEVICE_GUIDANCE_FAMILIES
from ..ops.guidance_device import make_device_guidance
from ..parallel import mesh
from ..parallel import plan as plan_lib
from ..parallel.consensus import replicated_decision
from ..parallel.step import (
    DEVICE_KEYS,
    create_train_state,
    make_eval_step,
    make_train_step,
    wrap_data_parallel,
)
from ..parallel.zero import shard_optimizer
from ..predict import resolve_device
from ..telemetry import TraceCapture, get_accountant, mfu_estimate, step_flops
from ..telemetry import events as events_lib
from ..telemetry import set_enabled as telemetry_set_enabled
from ..telemetry.goodput import FeedWindow
from . import config as config_lib
from ..utils import profiling, weights
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
from .logging import MultiWriter, make_val_panels, make_writer
from .optim import make_optimizer
from .precision import apply_policy, precision_block
from .preemption import PreemptionGuard


class _TrainerFeedActuators(FeedActuators):
    """The feed governor's knobs, bound to a live trainer.  Under
    ``observe`` (the only mode the port runs) the governor reads them and
    never calls a setter."""

    def __init__(self, trainer: "Trainer"):
        self._t = trainer

    def get_prefetch(self) -> tuple[int, int]:
        return self._t._host_prefetch, self._t._device_prefetch

    def set_prefetch(self, host: int, device: int) -> None:
        raise NotImplementedError("the port's governor observes only")

    def flip_available(self) -> tuple[bool, str]:
        return self._t._feed_flip_available()

    def flip_device_path(self) -> None:
        raise NotImplementedError("the port's governor observes only")

    def get_echo(self) -> int:
        return self._t._echo

    def base_echo(self) -> int:
        return self._t.cfg.data.echo

    def can_set_echo(self) -> tuple[bool, str]:
        if self._t.cfg.data.steps_per_dispatch > 1:
            return False, ("data.steps_per_dispatch > 1 packs distinct "
                           "batches per dispatch — mutually exclusive "
                           "with echo")
        return True, ""

    def set_echo(self, factor: int) -> None:
        raise NotImplementedError("the port's governor observes only")

    def pack_status(self) -> tuple[bool, str | None]:
        return self._t._pack_status()


def pack_command(root: str, out: str, dataset: str, kind: str, splits,
                 area_thres: int | None = None) -> str:
    """The ``dptpu-pack`` invocation that builds one pack, as the JAX
    package's ``data/packed.py`` words it (the governor's rung-0 text)."""
    parts = sorted([splits] if isinstance(splits, str) else list(splits))
    cmd = (f"dptpu-pack --root {root or '<data-root>'} --dataset {dataset} "
           f"--task {kind} --splits {','.join(parts)}")
    if kind == "instance" and area_thres is not None:
        cmd += f" --area-thres {int(area_thres)}"
    return cmd + f" --out {out or '<pack-dir>'}"


class _FrozenOptimizer:
    """An optimizer's ``state_dict`` copied at a snapshot: what a
    checkpoint of the snapshot saves."""

    def __init__(self, state: dict):
        self._state = state

    def state_dict(self) -> dict:
        return self._state


@functools.lru_cache(maxsize=16)
def _meta_step_flops(kwargs: tuple, shape: tuple) -> float:
    """``step_flops`` of ``build_model(**dict(kwargs))`` built on the meta
    device, on a meta batch of ``shape``: counted once per model and shape
    in a process (the count walks ~1 s of Python dispatch)."""
    with torch.device("meta"):
        model = build_model(**dict(kwargs))
    return step_flops(model.train(), torch.zeros(shape, device="meta"))


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
        if cfg.data.device_guidance:
            if cfg.task != "instance":
                raise ValueError("data.device_guidance applies to the "
                                 "instance task only (semantic has no "
                                 "guidance channel)")
            if cfg.data.guidance not in DEVICE_GUIDANCE_FAMILIES:
                raise ValueError(
                    f"data.device_guidance supports "
                    f"{DEVICE_GUIDANCE_FAMILIES}, not {cfg.data.guidance!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        #: the data axis: the processes of the group, this one's rank
        self.world, self.rank = mesh.data_axis_size(), mesh.process_index()
        self.is_main = self.rank == 0
        self.distributed = mesh.is_distributed()
        if cfg.model.moe_experts and self.world > 1:
            # JAX routes the global batch's tokens under its data mesh; a
            # rank here sees its own rows, so capacity and slot order would
            # differ without the token exchange of expert parallelism
            raise NotImplementedError(
                f"model.moe_experts={cfg.model.moe_experts} at world size "
                f"{self.world} is not ported: the MoE routes the global "
                "batch's tokens, which needs expert parallelism's token "
                "exchange")
        if cfg.val_overlap and self.world > 1:
            raise ValueError(
                "val_overlap is single-rank only: the val thread and "
                "the train loop would issue cross-host collectives in "
                "unsynchronized order (a distributed deadlock), so "
                "multi-host runs must validate serially")
        #: in-flight overlapped validation (val_overlap): set by
        #: _launch_overlapped_val, consumed by _join_overlapped_val
        self._pending_val = None
        mesh.resolve_data_axis(cfg.mesh.data)
        self.plan = plan_lib.plan_from_config(cfg, n_devices=self.world)
        if cfg.train.reduce_buckets and \
                self.plan.strategy not in plan_lib.BUCKET_COMPATIBLE:
            raise plan_lib.reduce_buckets_conflict(self.plan.strategy)
        self.precision = apply_policy(cfg.train.precision)
        self.run_dir = mesh.broadcast_object(
            next_run_dir(cfg.work_dir) if self.is_main else None)
        # flight recorder: every rank opens its own
        # run_dir/events/<host>.<pid>.jsonl; off = never configured, and
        # every emit() is one list check
        self._events = (events_lib.configure(self.run_dir)
                        if cfg.telemetry else None)
        if cfg.data.max_echo < 1:
            raise ValueError(
                f"data.max_echo must be >= 1, got {cfg.data.max_echo}")
        self.writer = MultiWriter(*[
            make_writer(name, self.run_dir,
                        experiment_name=cfg.experiment_name,
                        comet_project=cfg.comet_project or None,
                        comet_workspace=cfg.comet_workspace or None)
            for name in cfg.log_writers]) if self.is_main else MultiWriter()

        d = cfg.data
        root = make_fake_voc(n_images=8, size=(96, 128), n_val=3,
                             seed=cfg.seed) if d.fake else d.root
        self._build_datasets(root)
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
            self.model = build_model(**self._model_kwargs())
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
            loss_type=self.loss_type,
            augment=self._build_device_stage(cfg.data.device_augment,
                                             cfg.data.device_guidance),
            seed=cfg.seed,
            aux_loss_weight=(cfg.model.moe_aux_weight
                             if cfg.model.moe_experts else 0.0))
        # the prepared val wire ships the bare image: the eval step appends
        # the guidance channel with the val semantics (fixed points)
        self.eval_step = make_eval_step(
            loss_weights=cfg.model.loss_weights, precision=self.precision,
            loss_type=self.loss_type,
            preprocess=make_device_guidance(
                family=cfg.data.guidance, alpha=cfg.data.guidance_alpha,
                is_val=True) if self._val_device_guidance else None)
        self.ckpt = CheckpointManager(
            os.path.join(self.run_dir, "checkpoints"),
            keep_latest=cfg.checkpoint.keep_latest,
            best_metric_init=cfg.checkpoint.best_metric_init,
            digest=cfg.checkpoint.digest)
        # the live feed knobs the governor reads (observe: never moved)
        self._host_prefetch = cfg.data.prefetch
        self._device_prefetch = cfg.data.device_prefetch
        self._echo = cfg.data.echo
        self._feed_flipped = False
        # telemetry: the compile-vs-step split (the first train step books
        # under 'compile'), the MFU inputs and the on-demand trace
        self._step_compiled = False
        self._prod_steps = 0
        self._flops_per_step: float | None = None
        self._flops_source: str | None = None
        self._trace = TraceCapture(
            os.path.join(self.run_dir, "trace_on_demand")) \
            if (cfg.telemetry and self.is_main) else None
        # the feed governor, observing on rank 0 (its signal is the goodput
        # accountant's, so it needs telemetry); _feed_last is the previous
        # tick's goodput snapshot
        self._governor = FeedGovernor(
            cfg.data.governor, cfg.data.governor_target,
            _TrainerFeedActuators(self), max_echo=cfg.data.max_echo,
            window=FeedWindow(cfg.data.governor_window),
            jsonl_path=os.path.join(self.run_dir, "governor.jsonl"),
            telemetry=True) \
            if (cfg.data.governor != "off" and cfg.telemetry
                and self.is_main) else None
        self._feed_last: dict | None = None
        self.start_epoch = 0
        #: whether the resume crossed a plan (another strategy or world size)
        self.resume_plan_crossing = False
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

    def _build_datasets(self, root) -> None:
        """The train and val sets of the task, as the JAX trainer wires
        them: the host stacks without the stages the device owns, SBD's
        train and val merged into the train set with ``data.sbd_root``
        (VOC val's images excluded), behind the prepared-sample cache when
        ``data.prepared_cache`` is set (val too, with
        ``data.val_prepared``)."""
        cfg, d = self.cfg, self.cfg.data
        crop = tuple(d.crop_size)
        prepared = bool(d.prepared_cache)
        val_prep = prepared and d.val_prepared
        flip = not d.device_augment
        geom = not (d.device_augment and d.device_augment_geom)
        #: whether the eval step synthesises the val guidance channel
        self._val_device_guidance = val_prep and d.device_guidance
        if cfg.task == "semantic":
            sem_train_tf = None if prepared else build_semantic_train_transform(
                crop_size=crop, rots=tuple(d.rots), scales=tuple(d.scales),
                flip=flip, geom=geom)
            self.train_set = VOCSemanticSegmentation(
                root, split=d.train_split, transform=sem_train_tf,
                decode_cache=d.decode_cache)
            # one sample per image, read once per validation: no cache
            self.val_set = VOCSemanticSegmentation(
                root, split=d.val_split,
                transform=None if val_prep else build_semantic_eval_transform(
                    crop_size=crop, keep_fullres=cfg.eval_full_res))
            if val_prep:
                self.val_set = PreparedSemanticDataset(
                    self.val_set, d.prepared_cache, crop_size=crop,
                    keep_fullres=cfg.eval_full_res,
                    max_im_size=d.val_max_im_size,
                    post_transform=build_prepared_semantic_eval_post_transform())
            if d.sbd_root:
                sbd = SBDSemanticSegmentation(
                    d.sbd_root, split=["train", "val"], transform=sem_train_tf,
                    decode_cache=d.decode_cache)
                self.train_set = CombinedDataset([self.train_set, sbd],
                                                 excluded=[self.val_set])
            if prepared:
                self.train_set = PreparedSemanticDataset(
                    self.train_set, d.prepared_cache, crop_size=crop,
                    post_transform=build_prepared_semantic_post_transform(
                        rots=tuple(d.rots), scales=tuple(d.scales),
                        flip=flip, geom=geom))
            return
        # the device guidance: the host ships the bare image as 'concat'
        guidance = "none" if d.device_guidance else d.guidance
        train_tf = None if prepared else build_train_transform(
            crop_size=crop, relax=d.relax, zero_pad=d.zero_pad,
            rots=tuple(d.rots), scales=tuple(d.scales), alpha=d.guidance_alpha,
            guidance=guidance, flip=flip, geom=geom,
            fused_crop_resize=d.fused_crop_resize)
        val_tf = None if val_prep else build_eval_transform(
            crop_size=crop, relax=d.relax, zero_pad=d.zero_pad,
            alpha=d.guidance_alpha, guidance=d.guidance)
        self.train_set = VOCInstanceSegmentation(
            root, split=d.train_split, transform=train_tf,
            area_thres=d.area_thres, decode_cache=d.decode_cache)
        self.val_set = VOCInstanceSegmentation(
            root, split=d.val_split, transform=val_tf,
            area_thres=d.area_thres, decode_cache=d.decode_cache)
        crop_knobs = dict(crop_size=crop, relax=d.relax, zero_pad=d.zero_pad,
                          fused_crop_resize=d.fused_crop_resize)
        if val_prep:
            self.val_set = PreparedInstanceDataset(
                self.val_set, d.prepared_cache, eval_protocol=True,
                max_im_size=d.val_max_im_size,
                post_transform=build_prepared_eval_post_transform(
                    alpha=d.guidance_alpha, guidance=guidance),
                **crop_knobs)
        if d.sbd_root:
            # SBD train and val under the train stack, VOC val's images
            # excluded; after the val set (prepared or not), before the
            # train set's cache, which then stamps every part
            sbd = SBDInstanceSegmentation(
                d.sbd_root, split=["train", "val"], transform=train_tf,
                area_thres=d.area_thres, decode_cache=d.decode_cache)
            self.train_set = CombinedDataset([self.train_set, sbd],
                                             excluded=[self.val_set])
        if prepared:
            self.train_set = PreparedInstanceDataset(
                self.train_set, d.prepared_cache,
                post_transform=build_prepared_post_transform(
                    rots=tuple(d.rots), scales=tuple(d.scales),
                    alpha=d.guidance_alpha, guidance=guidance,
                    flip=flip, geom=geom),
                **crop_knobs)

    def _build_device_stage(self, device_augment: bool,
                            device_guidance: bool):
        """The train step's device stage (flip, scale-rotate with
        ``data.device_augment_geom``, guidance), or None when both are
        off: the one constructor for the config path and the governor's
        future flip to the device path."""
        if not (device_augment or device_guidance):
            return None
        cfg = self.cfg
        guidance_fn = make_device_guidance(
            family=cfg.data.guidance, alpha=cfg.data.guidance_alpha) \
            if device_guidance else None
        return make_device_augment(
            hflip=device_augment,
            scale_rotate=device_augment and cfg.data.device_augment_geom,
            rots=tuple(cfg.data.rots), scales=tuple(cfg.data.scales),
            semantic=cfg.task == "semantic", guidance_fn=guidance_fn)

    def _model_kwargs(self) -> dict:
        """``build_model``'s arguments for this config."""
        m = self.cfg.model
        return dict(
            name=m.name, nclass=m.nclass, backbone=m.backbone,
            output_stride=m.output_stride, attention_impl=m.attention_impl,
            in_channels=m.in_channels,
            dtype=(self.precision.compute_dtype if self.precision
                   else m.dtype),
            pam_score_dtype=m.pam_score_dtype, remat=m.remat,
            remat_policy=m.remat_policy or None, aux_head=m.aux_head,
            encnet_codes=m.encnet_codes,
            ccnet_recurrence=m.ccnet_recurrence,
            bn_cross_replica=self.distributed,
            bn_fp32_stats=m.bn_fp32_stats,
            guidance_inject=m.guidance_inject, pam_impl=m.pam_impl,
            pam_block_size=m.pam_block_size, moe_experts=m.moe_experts,
            moe_hidden=m.moe_hidden, moe_k=m.moe_k,
            moe_capacity_factor=m.moe_capacity_factor)

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
            # a head model's stem takes the RGB channels only
            stem = self.cfg.model.in_channels - (
                self.cfg.model.guidance_inject == "head")
            sd = weights.inflate_stem_channels(sd, stem)
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
        self.resume_plan_crossing = plan_lib.plans_differ(
            meta.get("plan"), self.plan.block(), self.world)
        if self.resume_plan_crossing:
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
                    start_batch: int = 0, abort_check=None) -> float:
        """One epoch from batch ``start_batch`` of its order; returns the
        mean train loss of the batches trained.  Losses stay on the device
        and are read at the log cadence and at the epoch's end.  ``guard``
        is read every ``guard.check_every`` steps; when it says stop the
        epoch ends early and logs no epoch summary.  ``abort_check`` runs
        at the log cadence (the overlapped validation's error poll)."""
        cfg = self.cfg
        self.train_loader.set_epoch(epoch, start_batch=start_batch)
        interrupted = False
        losses: list[torch.Tensor] = []
        data_s = 0.0
        t0 = time.perf_counter()
        # goodput: host perf_counter bookkeeping only, no sync added; the
        # device time the host waits for lands in the bucket it waits in
        acct = get_accountant()
        host = iter(self.train_loader)

        def checked(it):
            for b in it:  # the host batch, before it is placed
                if cfg.debug_asserts:
                    self._debug_asserts(b)
                yield b

        # up to the window's batches pulled and placed ahead on the device
        # (one worker thread, a side stream on a card); read live, so a
        # resized window applies mid-epoch
        batches = mesh.prefetch_to_device(
            checked(host), self.state.device,
            size=lambda: max(self._device_prefetch,
                             cfg.data.steps_per_dispatch),
            keys=DEVICE_KEYS)
        try:
            while True:
                t_data = time.perf_counter()
                # input wait: host time blocked on the loader and the
                # placement; an injected latency here is input stall, a
                # poisoned payload tears the batch the step is about to
                # consume
                with acct.account("input_wait"):
                    batch = next(batches, None)
                    if batch is not None:
                        batch = chaos_sites.fire("trainer/batch_fetch",
                                                 payload=batch)
                data_s += time.perf_counter() - t_data
                if batch is None:
                    break
                losses.append(self._dispatch(batch))
                step = self.state.step
                if guard is not None and guard.should_stop(step):
                    interrupted = True
                    break
                if step % cfg.log_every_steps == 0:
                    if abort_check is not None:
                        abort_check()
                    # the one regular sync: it pays the device time of the
                    # steps queued since the last read — productive time
                    with acct.account("step"):
                        loss_now = float(losses[-1])
                    if self._governor is not None:
                        self._feed_tick(epoch, step)
                    self.writer.scalars({"train/loss": loss_now,
                                         "train/lr": self.schedule(step - 1),
                                         "train/epoch": epoch}, step)
        finally:
            batches.close()  # drops the placements still queued
            host.close()  # stops the loader's threads or workers
        with acct.account("step"):  # the epoch's steps landing
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

    def _dispatch(self, batch) -> torch.Tensor:
        """One train step, goodput-attributed: the first books under
        'compile' (it pays the kernels' build, cuDNN's algorithm search and
        CUDA's lazy start), with the FLOP count beside it; the rest under
        'step'.  The on-demand trace ticks before the step, so an armed
        capture starts on the step it was requested for."""
        acct = get_accountant()
        if self._trace is not None:
            self._trace.tick(1)
        first = not self._step_compiled
        with acct.account("compile" if first else "step"):
            loss = self.train_step(self.state, batch)
        if first:
            self._step_compiled = True
            with acct.account("compile"):
                self._note_step_cost(batch)
        else:
            self._prod_steps += 1
        # chaos seam, between steps: sigterm is a preemption landing
        # mid-epoch, nan poisons the loss the loop observes
        return chaos_sites.fire("trainer/train_step", payload=loss)

    def _note_step_cost(self, batch) -> None:
        """One-shot model FLOPs per step for the MFU: ``step_flops`` on a
        meta-device copy of the model with the plain attention forms (the
        counter cannot see the kernels; the plain forms do the same
        products), at this rank's batch, times the ranks; on failure the
        JAX trainer's floor, 6 x params x the global batch.  The source is
        recorded so an estimate never passes for a count."""
        if self._flops_per_step is not None or not self.cfg.telemetry:
            return
        flops = None
        try:
            # a placed NCHW batch, or a host NHWC one that the step places;
            # its channels may be the host's 3, with the guidance channel
            # still to come on the device
            x = batch["concat"]
            n, h, w = (x.shape[0], *x.shape[2:]) if torch.is_tensor(x) \
                else x.shape[:3]
            c = self.cfg.model.in_channels
            kwargs = dict(self._model_kwargs(), remat=False,
                          remat_policy=None, dtype="float32",
                          bn_cross_replica=False)
            if self.cfg.model.name == "danet":
                kwargs.update(attention_impl="xla", pam_impl="")
            flops = _meta_step_flops(tuple(sorted(kwargs.items())),
                                     (n, c, h, w)) * self.world
        except Exception as e:  # a count failure must not kill the fit
            self._print(f"warning: FLOP count failed ({type(e).__name__}: "
                        f"{e}); MFU from the parameter estimate")
        if flops and flops > 0:
            self._flops_source = "flop_counter"
        else:
            flops = 6.0 * self.n_params * self.cfg.data.train_batch
            self._flops_source = "param_estimate"
        self._flops_per_step = flops

    def _report_goodput(self, history: dict) -> None:
        """Fit-end goodput breakdown and MFU estimate: into the writers
        (``goodput/*``, ``mfu``), the registry gauges (``/metrics`` when
        co-hosted) and ``history``."""
        if not self.cfg.telemetry:
            return
        rep = get_accountant().report()
        history["goodput"] = rep
        scalars = {f"goodput/{b}_s": round(v, 4)
                   for b, v in rep["buckets"].items()}
        scalars["goodput/total_s"] = round(rep["total_s"], 4)
        scalars["goodput/productive_frac"] = round(rep["goodput"], 4)
        if self._flops_per_step and self._prod_steps:
            step_time = rep["buckets"]["step"] / self._prod_steps
            if step_time > 0:
                kind = torch.cuda.get_device_name(self.device) \
                    if self.device.type == "cuda" else self.device.type
                est = mfu_estimate(self._flops_per_step / self.world,
                                   step_time, device_kind=kind)
                est["flops_source"] = self._flops_source
                history["mfu"] = est
                scalars["mfu"] = round(est["mfu"], 6)
                scalars["mfu/flops_per_step"] = self._flops_per_step
                scalars["mfu/peak_flops_per_device"] = \
                    est["peak_flops_per_device"]
        self.writer.scalars(scalars, self.state.step)

    def _feed_tick(self, epoch: int, step: int) -> None:
        """Log-cadence governor observation: the goodput snapshot's delta
        since the previous tick (step + compile busy, input wait) into the
        stall window.  Pure perf_counter bookkeeping."""
        snap = get_accountant().snapshot()
        last, self._feed_last = self._feed_last, snap
        if last is None:
            return
        busy = (snap["step"] - last["step"]) \
            + (snap["compile"] - last["compile"])
        wait = snap["input_wait"] - last["input_wait"]
        if busy + wait <= 0:
            return
        self._governor.tick(busy, wait, step=step, epoch=epoch)

    def _feed_flip_available(self) -> tuple[bool, str]:
        """The governor's rung-2 eligibility, answered for this config as
        the JAX trainer answers it (``_feed_flip_available``): the reason,
        or the recommendation naming the config keys."""
        cfg = self.cfg
        already = cfg.data.device_augment and (
            cfg.task == "semantic" or cfg.data.device_guidance
            or cfg.data.guidance == "none")
        if already or self._feed_flipped:
            return False, "on-device augmentation + guidance already active"
        if cfg.data.coalesce_wire:
            return False, (
                "coalesce_wire packed the wire layout from the current "
                "host pipeline — set data.device_augment/"
                "data.device_guidance in the config instead")
        if cfg.data.prepared_cache:
            return False, (
                "prepared cache owns the pipeline front — set "
                "data.device_augment/data.device_guidance (and consider "
                "data.uint8_transfer) in the config instead")
        if cfg.data.loader != "threads":
            return False, (
                "grain loader builds its pipeline up front — set "
                "data.device_augment/data.device_guidance in the config")
        if cfg.task == "instance" and cfg.data.guidance != "none" \
                and not cfg.data.device_guidance \
                and cfg.data.guidance not in DEVICE_GUIDANCE_FAMILIES:
            return False, (
                f"guidance family {cfg.data.guidance!r} has no device "
                f"implementation (supported: {DEVICE_GUIDANCE_FAMILIES}) — "
                "data.prepared_cache is the remaining lever")
        what = "flip augmentation"
        if cfg.task == "instance" and cfg.data.guidance != "none":
            what += " + guidance synthesis"
        return True, (f"move {what} on device "
                      "(data.device_augment=true"
                      + (", data.device_guidance=true"
                         if cfg.task == "instance"
                         and cfg.data.guidance != "none" else "") + ")")

    def _pack_status(self) -> tuple[bool, str | None]:
        """The governor's rung-0 input: whether the run feeds from a pack,
        and if not, the pack commands (worded as the JAX trainer words
        them; the fake fixture lives in memory, so its root is
        ``<data-root>``)."""
        d = self.cfg.data
        if d.source == "packed":
            return True, None
        root = "" if d.fake else d.root
        area = d.area_thres if self.cfg.task == "instance" else None
        cmds = [pack_command(root, d.pack_path, "voc", self.cfg.task,
                             [split], area)
                for split in (d.train_split, d.val_split)]
        return False, (
            "rung 0 — cheaper than tuning around the stall is deleting "
            "it: pre-decode the dataset once and train from the mmap "
            "(data.source=packed data.pack_path=<out>): `"
            + " && ".join(cmds) + "`")

    def _debug_asserts(self, batch) -> None:
        if self.cfg.task == "semantic":
            semantic_batch_debug_asserts(batch, self.cfg.model.nclass)
        else:
            batch_debug_asserts(batch)

    def _eval_metrics(self, state, epoch: int | None = None
                      ) -> tuple[dict, dict | None]:
        """The task's validation protocol on ``state``: its metrics and the
        first batch's record (None for the semantic task), with no writer
        or checkpoint side effects, so that it can run on the overlapped
        validation's thread."""
        # goodput: validation books under 'eval' (on the overlapped
        # validation's thread, its own per-thread stack)
        with get_accountant().account("eval"):
            return self._eval_metrics_inner(state, epoch)

    def _eval_metrics_inner(self, state, epoch: int | None
                            ) -> tuple[dict, dict | None]:
        cfg = self.cfg
        self.val_loader.set_epoch(0)
        if cfg.task == "semantic":
            metrics = evaluate_semantic(
                self.eval_step, state, self.val_loader,
                nclass=cfg.model.nclass, tta_scales=cfg.eval_tta_scales,
                tta_flip=cfg.eval_tta_flip, debug_asserts=cfg.debug_asserts,
                bf16_probs=cfg.eval_bf16_probs,
                device_fullres=(tuple(cfg.data.val_max_im_size)
                                if cfg.eval_device_fullres else None))
        else:
            metrics = evaluate(self.eval_step, state, self.val_loader,
                               thresholds=cfg.eval_thresholds,
                               relax=cfg.data.relax,
                               zero_pad=cfg.data.zero_pad,
                               debug_asserts=cfg.debug_asserts,
                               bf16_readback=cfg.eval_bf16_probs)
        first = metrics.pop("_first_batch", None)
        if cfg.debug_asserts and not np.isfinite(metrics["loss"]):
            raise FloatingPointError(f"non-finite val loss {metrics['loss']} "
                                     f"at epoch {epoch}")
        return metrics, first

    def validate(self, epoch: int | None = None, log_panels: bool = True,
                 state=None) -> dict:
        """The task's validation protocol on ``state`` (the current one by
        default); logs and returns its metrics."""
        state = self.state if state is None else state
        metrics, first = self._eval_metrics(state, epoch)
        self._log_val(metrics, first, epoch, state.step, log_panels=log_panels)
        return metrics

    def _log_val(self, metrics: dict, first: dict | None, epoch: int | None,
                 step: int, log_panels: bool = True) -> None:
        """The writer half of validation, on the main thread: the metrics,
        then the first batch's panels where a writer takes figures."""
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
        self.writer.scalars(flat, step)
        if log_panels and first is not None and self.writer.takes_figures:
            try:
                fig = make_val_panels(first)
                self.writer.figure("val_panels", fig, step)
                import matplotlib.pyplot as plt
                plt.close(fig)
            except Exception:
                pass  # visualization must never kill training

    def _snapshot(self):
        """The state at this epoch's end, as overlapped validation and its
        deferred save need it: the model deep-copied on its device and put
        in eval mode there (``optimizer.step`` updates the live parameters
        in place), the optimizer's ``state_dict`` and the dropout
        generator's state copied."""
        with torch.no_grad():
            model = copy.deepcopy(self.state.model).eval()
            optimizer = _FrozenOptimizer(
                copy.deepcopy(self.state.optimizer.state_dict()))
        generator = torch.Generator(device=self.device)
        generator.set_state(self.state.generator.get_state())
        return dataclasses.replace(self.state, model=model, optimizer=optimizer,
                                   generator=generator, ddp=None)

    def _launch_overlapped_val(self, epoch: int, step: int) -> None:
        """Start validating a snapshot of the current state on a thread
        (``val_overlap``); the next train epoch runs meanwhile.  Every
        writer and checkpoint side effect waits for
        :meth:`_join_overlapped_val` on the main thread."""
        state = self._snapshot()
        box: dict = {}
        device = torch.cuda.device(self.device) \
            if self.device.type == "cuda" else contextlib.nullcontext()

        def run() -> None:
            try:
                # the current device and the grad mode are per thread
                with device, torch.inference_mode():
                    box["result"] = self._eval_metrics(state, epoch)
            except BaseException as e:  # re-raised at the join
                box["error"] = e

        thread = threading.Thread(target=run, name=f"val-overlap-{epoch}",
                                  daemon=True)
        thread.start()
        self._pending_val = (epoch, step, state, thread, box)

    def _poll_overlapped_val_error(self) -> None:
        """Raise now if the overlapped validation already failed (run at
        the train loop's log cadence), not a whole epoch later."""
        pending = self._pending_val
        if pending is not None and "error" in pending[4]:
            self._join_overlapped_val(None)

    def _join_overlapped_val(self, history: dict | None,
                             finish: bool = True) -> None:
        """Wait for the overlapped validation, if one is running, and apply
        its bookkeeping (:meth:`_finish_val`); ``finish=False`` waits
        only."""
        pending = self._pending_val
        if pending is None:
            return
        self._pending_val = None
        epoch, step, state, thread, box = pending
        thread.join()
        if "error" in box:
            raise box["error"]
        if finish:
            metrics, first = box["result"]
            self._finish_val(metrics, first, epoch, step, state, history)

    def _discard_overlapped_val(self) -> None:
        """Join the overlapped validation and drop its result: for a fit
        that unwinds with an exception of its own, so that no thread
        outlives it."""
        pending = self._pending_val
        if pending is None:
            return
        self._pending_val = None
        pending[3].join()

    def _finish_val(self, metrics: dict, first: dict | None, epoch: int,
                    step: int, state, history: dict | None) -> None:
        """The epoch-end validation's bookkeeping, serial or overlapped:
        the logs, the history, and the checkpoint of ``state`` at ``step``
        (into the best slot on a better Jaccard)."""
        self._log_val(metrics, first, epoch, step)
        if history is not None:
            history["val"].append(dict(metrics, epoch=epoch))
        if self.ckpt.save(step, state, metric=metrics["jaccard"],
                          extra={"epoch": epoch, "plan": self.plan.block()}):
            self.writer.scalars({"val/new_best_jaccard": metrics["jaccard"],
                                 "val/epoch": epoch}, step)

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
        ``fit_summary.json``, beside the ``recovery`` (null: no sentinel
        yet) and ``feed`` (the governor's summary, null when off) blocks;
        with telemetry, ``history`` also carries ``goodput`` and ``mfu``."""
        cfg = self.cfg
        history: dict = {"train_loss": [], "val": []}
        if cfg.profile_epoch is not None and self.is_main and not \
                (self.start_epoch <= cfg.profile_epoch < cfg.epochs):
            print(f"warning: profile_epoch={cfg.profile_epoch} outside the "
                  f"epoch range [{self.start_epoch}, {cfg.epochs}) — no "
                  "trace will be written", flush=True)
        cuda_attention.reset_launches()
        start_step = self.state.step
        # the goodput books cover exactly this fit; set_enabled gates every
        # optional instrumentation path process-wide, so telemetry=false
        # is the zero-instrumentation baseline
        telemetry_set_enabled(cfg.telemetry)
        get_accountant().reset(enabled=cfg.telemetry)
        # the generation's opening anchor (an unpaired fit_start is the
        # crash evidence)
        events_lib.emit(
            "trainer", "fit_start", step=self.state.step,
            epoch=self.start_epoch,
            payload={"epochs": cfg.epochs,
                     "resumed": bool(self.resume_meta),
                     "plan_crossing": self.resume_plan_crossing})
        # an env-named fault plan (DPTPU_CHAOS_PLAN): one getenv when unset
        chaos_sites.maybe_arm_from_env()
        self._prod_steps = 0
        # the books were just zeroed: a fresh fit starts a fresh window
        self._feed_last = None
        with contextlib.ExitStack() as stack:
            if self._trace is not None:
                stack.callback(self._trace.close)
                stack.callback(self._trace.install_signal())
            if guard is None and cfg.checkpoint.save_on_preempt:
                guard = stack.enter_context(PreemptionGuard(
                    check_every=cfg.checkpoint.preempt_check_every))
            # an exception unwinding the fit must not leave the overlapped
            # validation's thread running; a clean end joins it below
            stack.callback(self._discard_overlapped_val)
            epoch = self.start_epoch
            while epoch < cfg.epochs:
                t0 = time.perf_counter()
                sb, self._resume_start_batch = self._resume_start_batch, 0
                estep0 = self.state.step
                if cfg.profile_epoch == epoch and self.is_main:
                    if self._trace is not None:
                        # one profiler at a time: an on-demand capture
                        # still open ends before profile_epoch's starts
                        self._trace.close()
                    trace = profiling.trace(
                        os.path.join(self.run_dir, "profile"))
                else:
                    trace = contextlib.nullcontext()
                with trace:
                    epoch_loss = self.train_epoch(
                        epoch, guard=guard, start_batch=sb,
                        abort_check=(self._poll_overlapped_val_error
                                     if cfg.val_overlap else None))
                # the previous epoch's overlapped validation ran beside this
                # epoch: land its logs and checkpoint first
                self._join_overlapped_val(history)
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
                if self._governor is not None:
                    # the epoch-boundary rungs, observed: before validation
                    # (which books its own bucket, outside the window)
                    self._governor.epoch_boundary(epoch=epoch, step=step)
                if cfg.eval_every and (epoch + 1) % cfg.eval_every == 0:
                    if cfg.val_overlap:
                        self._launch_overlapped_val(epoch, step)
                    else:
                        metrics, first = self._eval_metrics(self.state, epoch)
                        self._finish_val(metrics, first, epoch, step,
                                         self.state, history)
                elif cfg.checkpoint.snapshot_every and \
                        (epoch + 1) % cfg.checkpoint.snapshot_every == 0:
                    self.ckpt.save(step, self.state, extra={
                        "epoch": epoch, "plan": self.plan.block()})
                self.writer.scalars({"epoch": epoch, "epoch_total_seconds":
                                     time.perf_counter() - t0}, step)
                epoch += 1
            # the last epoch's overlapped validation has no epoch to hide
            # behind
            with guard.shield() if guard is not None \
                    else contextlib.nullcontext():
                self._join_overlapped_val(history)
                self.ckpt.wait()
            # after the last save has landed, so its wait is in the books
            self._report_goodput(history)
        history["recovery"] = None  # no sentinel yet: the key is there
        history["feed"] = (self._governor.summary_block()
                           if self._governor is not None else None)
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
                "kernel_launches": dict(cuda_attention.launches),
                "recovery": history["recovery"],
                "feed": history["feed"]})
        gp = history.get("goodput") or {}
        events_lib.emit(
            "trainer", "fit_end", step=self.state.step,
            payload={"preempted": preempted,
                     "epochs_recorded": len(history["train_loss"]),
                     "rollbacks": 0,
                     # the goodput breakdown rides the closing anchor
                     "goodput": {"total_s": gp.get("total_s"),
                                 "buckets": gp.get("buckets"),
                                 "productive_frac": gp.get("goodput")}})
        self.writer.flush()
        return history

    def close(self) -> None:
        if self._trace is not None:
            self._trace.close()
        if isinstance(self.train_loader, GrainDataLoader):
            self.train_loader.close()
        self.writer.close()
        # restores any outer event log as the current sink
        events_lib.release(self._events)
        self._events = None
