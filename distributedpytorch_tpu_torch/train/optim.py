"""Optimizer and LR schedules, the counterpart of
``distributedpytorch_tpu/train/optim.py``.

The JAX package composes optax transforms; here the same update is
``torch.optim.SGD`` (``optim.name=sgd``), which already has torch
semantics (weight decay added to the gradient before momentum, momentum
buffer equal to the gradient on the first step), or ``torch.optim.AdamW``
(``adamw``, with ``adam_b1``, ``adam_b2``, ``adam_eps``), whose rule is
optax's ``adamw``: ``p <- p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``,
the decay decoupled from the gradient and scaled by the lr.  The schedule
is applied by the train step: before each update every param group's lr
is set to ``schedule(step) * lr_mult``, where ``step`` counts the updates
made so far (optax's count).  The multiplier therefore scales the whole
update, decay included, as optax's ``scale(mult)`` after the group's
``adamw`` does.

Parameter groups follow the JAX labeler: a dotted-name prefix in
``freeze`` freezes a subtree (``requires_grad`` off: no update, no decay,
no momentum, no share of the clip norm), a prefix in ``lr_mult`` scales
the lr of its subtree (the longest matching prefix wins), and a prefix that
matches no parameter raises.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

from .config import OptimConfig

Schedule = Callable[[int], float]


def make_schedule(cfg: OptimConfig, total_steps: int) -> Schedule:
    """``step -> lr``: constant | poly | cosine after an optional linear
    warmup from 0 (optax's ``join_schedules`` of ``linear_schedule`` and the
    decay, which restarts its count at the boundary)."""
    lr, warm = cfg.lr, cfg.warmup_steps
    decay_steps = max(total_steps - warm, 1)
    if cfg.schedule == "constant":
        def decay(step: int) -> float:
            return lr
    elif cfg.schedule == "poly":
        def decay(step: int) -> float:
            frac = 1.0 - min(max(step, 0), decay_steps) / decay_steps
            return lr * frac ** cfg.poly_power
    elif cfg.schedule == "cosine":
        def decay(step: int) -> float:
            count = min(max(step, 0), decay_steps)
            return lr * 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
    else:
        raise ValueError(f"unknown schedule: {cfg.schedule!r} "
                         "(constant | poly | cosine)")
    if warm <= 0:
        return decay

    def schedule(step: int) -> float:
        if step < warm:
            return lr * min(max(step, 0), warm) / warm
        return decay(step - warm)

    return schedule


def _matches(name: str, prefix: str) -> bool:
    return name == prefix or name.startswith(prefix + ".")


def make_param_labeler(freeze: tuple[str, ...],
                       lr_mult: dict[str, float] | None
                       ) -> Callable[[nn.Module], dict[str, str]]:
    """``model -> {param name: label}``: ``frozen`` when a ``freeze``
    prefix matches, else ``mult:<prefix>`` for the longest matching
    ``lr_mult`` prefix, else ``base``.  Raises if a prefix matches no
    parameter."""

    def labeler(model: nn.Module) -> dict[str, str]:
        matched: set[str] = set()
        labels = {}
        for name, _ in model.named_parameters():
            frozen = False
            for p in freeze:
                if _matches(name, p):
                    matched.add(p)
                    frozen = True
            best = ""
            for p in lr_mult or {}:
                if _matches(name, p):
                    matched.add(p)
                    if len(p) > len(best):
                        best = p
            labels[name] = "frozen" if frozen else \
                (f"mult:{best}" if best else "base")
        missing = (set(freeze) | set(lr_mult or {})) - matched
        if missing:
            raise ValueError(f"param-group prefixes matched no parameter: "
                             f"{sorted(missing)}")
        return labels

    return labeler


def make_optimizer(cfg: OptimConfig, model: nn.Module, total_steps: int
                   ) -> tuple[torch.optim.Optimizer, Schedule]:
    """``(optimizer, schedule)`` over ``model``'s parameters: SGD or
    AdamW by ``cfg.name``.  Frozen parameters get ``requires_grad`` off
    and join no group; each other group's ``lr_mult`` is the factor the
    train step applies to the scheduled lr."""
    if cfg.name not in ("sgd", "adamw"):
        raise ValueError(f"unknown optimizer: {cfg.name!r} (sgd | adamw)")
    labels = make_param_labeler(tuple(cfg.freeze), cfg.lr_mult)(model)
    mults = {"base": 1.0, **{f"mult:{p}": float(m)
                             for p, m in (cfg.lr_mult or {}).items()}}
    groups: dict[str, list[nn.Parameter]] = {}
    for name, param in model.named_parameters():
        if labels[name] == "frozen":
            param.requires_grad_(False)
        else:
            groups.setdefault(labels[name], []).append(param)
    param_groups = [{"params": params, "lr_mult": mults[label]}
                    for label, params in groups.items()]
    if cfg.name == "sgd":
        optimizer = torch.optim.SGD(param_groups, lr=cfg.lr,
                                    momentum=cfg.momentum,
                                    weight_decay=cfg.weight_decay)
    else:
        optimizer = torch.optim.AdamW(param_groups, lr=cfg.lr,
                                      betas=(cfg.adam_b1, cfg.adam_b2),
                                      eps=cfg.adam_eps,
                                      weight_decay=cfg.weight_decay)
    return optimizer, make_schedule(cfg, total_steps)


def apply_update(optimizer: torch.optim.Optimizer, schedule: Schedule,
                 step: int, grad_clip_norm: float | None = None) -> None:
    """One update from the gradients in place: clip their global norm if
    ``grad_clip_norm``, set the groups' lr for update number ``step`` and
    step the optimizer."""
    if grad_clip_norm:
        clip_grad_norm([p for g in optimizer.param_groups for p in g["params"]],
                       grad_clip_norm)
    set_lr(optimizer, schedule(step))
    optimizer.step()


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Every group's lr for the next update: ``lr`` times its multiplier."""
    for group in optimizer.param_groups:
        group["lr"] = lr * group["lr_mult"]


def clip_grad_norm(params: list[nn.Parameter], max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm``: scale every gradient by
    ``max_norm / ‖g‖`` when the global norm ``‖g‖`` exceeds ``max_norm``
    (no epsilon); returns ``‖g‖``."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm > max_norm, max_norm / norm,
                        torch.ones_like(norm))
    for g in grads:
        g.mul_(scale)
    return norm
