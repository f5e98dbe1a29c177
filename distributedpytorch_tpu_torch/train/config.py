"""Experiment configuration, the counterpart of
``distributedpytorch_tpu/train/config.py``.

The same nested dataclasses with the same fields and defaults, the same
JSON form and the same dotted-path CLI overrides, so one ``config.json``
loads in both packages (the tests hold the round trip to the JAX
package's).  Defaults are the reference's hyperparameter point: DANet-R101
at 512², train batch 16, SGD lr 5e-8 / momentum 0.9 / wd 5e-4, constant
LR, 100 epochs, eval every epoch at thresholds {0.3, 0.5, 0.8}.

The port runs part of what these knobs select.  :func:`unported_knobs`
names every knob set away from its default that the port does not run
yet; the ``Trainer`` raises on them instead of ignoring them.  A few knobs
are ported for some values only (:data:`PORTED_VALUES`): any other value
is refused the same way.  What each
knob means is documented at the JAX package's field of the same name.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


@dataclass
class DataConfig:
    source: str = "fs"
    pack_path: str = ""
    pack_quarantine: tuple[int, ...] = ()
    session_log: str = ""
    session_only: bool = False
    session_quarantine: tuple[int, ...] = ()
    root: str = ""
    sbd_root: str = ""
    fake: bool = False
    download: bool = False
    train_split: str = "train"
    val_split: str = "val"
    area_thres: int = 500
    crop_size: tuple[int, int] = (512, 512)
    relax: int = 50
    zero_pad: bool = True
    rots: tuple[float, float] = (-20.0, 20.0)
    scales: tuple[float, float] = (0.75, 1.25)
    guidance: str = "nellipse_gaussians"
    guidance_alpha: float = 0.6
    train_batch: int = 16
    val_batch: int = 1
    loader: str = "threads"
    num_workers: int = 2
    prefetch: int = 2
    device_prefetch: int = 2
    device_augment: bool = False
    device_augment_geom: bool = False
    device_guidance: bool = False
    fused_crop_resize: bool = False
    prepared_cache: str = ""
    uint8_transfer: bool = False
    packbits_masks: bool = False
    coalesce_wire: bool = False
    val_prepared: bool = True
    val_max_im_size: tuple[int, int] = (512, 512)
    decode_cache: int = 0
    steps_per_dispatch: int = 1
    echo: int = 1
    governor: str = "observe"
    governor_target: float = 0.1
    governor_window: int = 16
    max_echo: int = 4


@dataclass
class ModelConfig:
    name: str = "danet"
    nclass: int = 1
    backbone: str = "resnet101"
    output_stride: int | None = None
    in_channels: int = 4
    remat_policy: str = ""
    bn_fp32_stats: bool = True
    dtype: str = "float32"
    loss_weights: tuple[float, ...] | None = None
    pam_block_size: int | None = None
    attention_impl: str = "auto"
    pam_impl: str = ""
    pam_score_dtype: str | None = None
    quantization: str = ""
    remat: bool = False
    moe_experts: int = 0
    moe_hidden: int | None = None
    moe_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    aux_head: bool = False
    encnet_codes: int = 32
    ccnet_recurrence: int = 2
    guidance_inject: str = "stem"


@dataclass
class TrainConfig:
    precision: str = "float32"
    reduce_buckets: int = 0


@dataclass
class OptimConfig:
    name: str = "sgd"
    lr: float = 5e-8
    momentum: float = 0.9
    weight_decay: float = 5e-4
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    schedule: str = "constant"
    poly_power: float = 0.9
    warmup_steps: int = 0
    accum_steps: int = 1
    loss_scale: float = 1.0
    grad_clip_norm: float | None = None
    freeze: tuple[str, ...] = ()
    lr_mult: dict[str, float] | None = None


@dataclass
class ParallelConfig:
    strategy: str = ""
    data: int | None = None
    model: int = 0
    hbm_budget_gb: float = 0.0


@dataclass
class MeshConfig:
    data: int | None = None
    model: int = 1
    slices: int = 1
    process_is_granule: bool | None = None
    shard_params: bool = False
    shard_opt_state: bool = False


@dataclass
class CheckpointConfig:
    keep_latest: int = 3
    snapshot_every: int = 100
    best_metric_init: float = 0.0
    warm_start: str | None = None
    warm_start_partial: bool = False
    async_save: bool = True
    save_on_preempt: bool = True
    preempt_check_every: int = 32
    exact_resume: bool = True
    digest: bool = False


@dataclass
class SentinelConfig:
    enabled: bool = False
    ema_beta: float = 0.9
    suspect_factor: float = 3.0
    diverged_factor: float = 10.0
    warmup_steps: int = 8
    monitor_grads: bool = False
    grad_factor: float = 10.0
    update_ratio_max: float | None = None
    max_rollbacks: int = 2


@dataclass
class Config:
    task: str = "instance"
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    sentinel: SentinelConfig = field(default_factory=SentinelConfig)
    epochs: int = 100
    eval_every: int = 1
    val_overlap: bool = False
    eval_thresholds: tuple[float, ...] = (0.3, 0.5, 0.8)
    eval_tta_scales: tuple[float, ...] = ()
    eval_tta_flip: bool = False
    eval_full_res: bool = False
    eval_bf16_probs: bool = True
    eval_device_fullres: bool = True
    seed: int = 0
    work_dir: str = "runs"
    resume: str | None = None
    debug_asserts: bool = False
    log_every_steps: int = 50
    experiment_name: str = "experiment"
    log_writers: tuple[str, ...] = ("console", "jsonl")
    comet_project: str = ""
    comet_workspace: str = ""
    profile_epoch: int | None = None
    telemetry: bool = True



def _to_jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _to_jsonable(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple):
        return list(obj)
    return obj


def _from_dict(cls, d: dict):
    # f.type is a *string* under `from __future__ import annotations`;
    # resolve real types once so nested dataclasses recurse properly.
    import typing
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        ftype = hints.get(f.name, f.type)
        if isinstance(ftype, type) and dataclasses.is_dataclass(ftype) \
                and isinstance(v, dict):
            v = _from_dict(ftype, v)
        elif f.name in ("crop_size", "rots", "scales", "loss_weights",
                        "eval_thresholds", "eval_tta_scales",
                        "freeze", "val_max_im_size", "pack_quarantine",
                        "session_quarantine") and isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)


_SUBCONFIGS = {"data": DataConfig, "model": ModelConfig,
               "train": TrainConfig, "optim": OptimConfig,
               "parallel": ParallelConfig, "mesh": MeshConfig,
               "checkpoint": CheckpointConfig,
               "sentinel": SentinelConfig}


def to_json(cfg: Config, path: str | None = None) -> str:
    s = json.dumps(_to_jsonable(cfg), indent=2)
    if path:
        with open(path, "w") as f:
            f.write(s + "\n")
    return s


def from_json(source: str) -> Config:
    """Parse a JSON string or (if it names an existing file) a JSON file."""
    import os
    if os.path.exists(source):
        with open(source) as f:
            source = f.read()
    d = json.loads(source)
    kwargs = {}
    for k, v in d.items():
        if k in _SUBCONFIGS:
            kwargs[k] = _from_dict(_SUBCONFIGS[k], v)
        else:
            kwargs[k] = v
    base = Config()
    for f in dataclasses.fields(Config):
        if f.name not in kwargs:
            kwargs[f.name] = getattr(base, f.name)
        elif f.name in ("eval_thresholds", "eval_tta_scales",
                        "log_writers") \
                and isinstance(kwargs[f.name], list):
            kwargs[f.name] = tuple(kwargs[f.name])
    return Config(**kwargs)


def apply_overrides(cfg: Config, overrides: dict[str, Any] | list[str]) -> Config:
    """Dotted-path overrides: ``{"optim.lr": 1e-3}`` or ``["optim.lr=1e-3"]``.

    String values are JSON-decoded when possible so CLI args round-trip to
    numbers/bools/lists.
    """
    if isinstance(overrides, list):
        parsed = {}
        for item in overrides:
            k, _, v = item.partition("=")
            parsed[k.strip()] = v.strip()
        overrides = parsed
    cfg = dataclasses.replace(cfg)  # shallow copy of the root
    for path, value in overrides.items():
        if isinstance(value, str):
            try:
                value = json.loads(value)
            except (ValueError, TypeError):
                pass
        *parents, leaf = path.split(".")
        node = cfg
        trail = []
        for p in parents:
            trail.append((node, p))
            node = getattr(node, p)
        if not any(f.name == leaf for f in dataclasses.fields(node)):
            raise KeyError(f"unknown config field: {path}")
        if isinstance(getattr(node, leaf), tuple) and isinstance(value, list):
            value = tuple(value)
        new_leaf = dataclasses.replace(node, **{leaf: value})
        for parent, name in reversed(trail):
            new_leaf = dataclasses.replace(parent, **{name: new_leaf})
        cfg = new_leaf
    return cfg


def flatten(cfg: Config) -> dict[str, Any]:
    """Flat ``section.field -> value`` view — feeds the param report
    (the reference's ``generate_param_report``, train_pascal.py:169)."""
    out: dict[str, Any] = {}

    def walk(prefix: str, obj: Any):
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            for f in dataclasses.fields(obj):
                walk(f"{prefix}{f.name}.", getattr(obj, f.name))
        else:
            out[prefix[:-1]] = obj

    walk("", cfg)
    return out


#: knobs the port does not run yet: any of them away from its default is
#: refused by the Trainer (see :func:`unported_knobs`)
UNPORTED = (
    "data.source", "data.pack_path", "data.pack_quarantine",
    "data.session_log", "data.session_only", "data.session_quarantine",
    "data.sbd_root", "data.download", "data.device_prefetch",
    "data.device_augment", "data.device_augment_geom",
    "data.device_guidance", "data.prepared_cache",
    "data.uint8_transfer", "data.packbits_masks", "data.coalesce_wire",
    "data.steps_per_dispatch", "data.echo",
    "data.governor", "data.governor_target", "data.governor_window",
    "data.max_echo",
    "model.remat_policy", "model.bn_fp32_stats",
    "model.pam_block_size", "model.pam_impl", "model.quantization",
    "model.moe_experts", "model.guidance_inject",
    "optim.name",
    "parallel.model", "parallel.hbm_budget_gb",
    "mesh.model", "mesh.slices", "mesh.process_is_granule",
    "mesh.shard_params",
    "sentinel.enabled", "sentinel.monitor_grads",
    "val_overlap", "profile_epoch",
)

#: knobs the port runs for these values only; others are refused
PORTED_VALUES = {
    # pspnet, encnet and ccnet are not ported
    "model.name": ("danet", "deeplabv3", "deeplabv3plus", "fcn"),
    "model.dtype": ("float32", "bfloat16"),
    "model.pam_score_dtype": (None, "float32", "bfloat16"),
    # the data-only rungs; dp_tp, dp_tp_zero1 and auto are not ported
    "parallel.strategy": ("", "dp", "dp_zero1"),
}


def unported_knobs(cfg: Config) -> list[str]:
    """``knob=value`` for every :data:`UNPORTED` knob that ``cfg`` sets
    away from its default, and every :data:`PORTED_VALUES` knob set to a
    value outside its list."""
    got, default = flatten(cfg), flatten(Config())
    return [f"{k}={got[k]!r}" for k in UNPORTED if got[k] != default[k]] + \
        [f"{k}={got[k]!r}" for k, ok in PORTED_VALUES.items()
         if got[k] not in ok]
