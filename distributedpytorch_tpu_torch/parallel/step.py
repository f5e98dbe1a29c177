"""The train and eval steps on one device, the counterpart of
``distributedpytorch_tpu/parallel/step.py`` without the mesh.

A host batch — the loader's dict of HWC float32 numpy arrays — becomes
NCHW torch tensors on the device once, here (:func:`device_batch`).  A
train step is forward, the multi-output balanced BCE, backward and one SGD
update; with ``accum_steps > 1`` the batch is split into that many
micro-batches in order, BatchNorm's running statistics move once per
micro-batch, the loss is the mean of the micro-batch losses and the
gradients are averaged, as the JAX step's scan does.  ``loss_scale``
multiplies the loss before the backward and divides the gradients after.
The returned loss is a device scalar: reading it synchronises, so callers
read it when they log.

``precision`` (a ``train.precision.Policy``, ``None`` for float32) draws
the two dtype boundaries of the mixed regime, as the JAX step does: the
input is cast to the compute dtype before the model and the outputs to
the loss dtype after it.  The model itself must be built in the compute
dtype; its parameters are float32, so their gradients, the clip norm and
the SGD momentum are float32 with nothing here to cast.

Mesh sharding, the uint8/packbits/coalesced wires, multi-step dispatch and
bucketed reduces are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from ..ops.losses import multi_output_loss
from ..train.optim import Schedule, apply_update
from ..train.precision import Policy

#: the batch keys the step consumes
INPUT_KEY = "concat"
TARGET_KEY = "crop_gt"
VOID_KEY = "crop_void"


@dataclasses.dataclass
class TrainState:
    """Everything that evolves in training: the model (parameters and
    BatchNorm statistics), the optimizer (momentum), the number of updates
    made, and the generator that draws the dropout masks."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    generator: torch.Generator
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def create_train_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                       schedule: Schedule, seed: int,
                       device: torch.device) -> TrainState:
    """Move ``model`` to ``device`` (the optimizer keeps its parameters:
    ``Module.to`` moves them in place) and seed the dropout generator on
    that device."""
    model.to(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    return TrainState(model, optimizer, schedule, generator)


def _nchw(arr, device: torch.device) -> torch.Tensor:
    """(B, H, W[, C]) numpy -> (B, C, H, W) float32 on ``device``."""
    t = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    if t.dim() == 3:
        t = t[..., None]
    return t.to(device, non_blocking=True).permute(0, 3, 1, 2).contiguous()


def device_batch(batch: Mapping, device: torch.device) -> dict[str, torch.Tensor]:
    """The step's keys of a host batch as NCHW float32 tensors on
    ``device``: ``concat`` (B, 4, H, W), ``crop_gt`` and ``crop_void`` (B, 1,
    H, W)."""
    return {k: _nchw(batch[k], device)
            for k in (INPUT_KEY, TARGET_KEY, VOID_KEY) if k in batch}


def _forward(model: nn.Module, inputs: torch.Tensor,
             precision: Policy | None,
             generator: torch.Generator | None = None
             ) -> tuple[torch.Tensor, ...]:
    """The model's outputs on ``inputs`` across the policy's boundaries:
    inputs in the compute dtype, outputs in the loss dtype."""
    if precision is None:
        return model(inputs, generator)
    return precision.cast_to_loss(
        model(precision.cast_to_compute(inputs), generator))


def _compute_loss(outputs: Sequence[torch.Tensor], batch: Mapping,
                  weights: Sequence[float] | None) -> torch.Tensor:
    """``multi_sigmoid``: the weighted balanced BCE of every output against
    the one target."""
    if weights is not None and len(weights) != len(outputs):
        raise ValueError(
            f"model.loss_weights has {len(weights)} entries but the model "
            f"emits {len(outputs)} outputs — give every output a weight")
    return multi_output_loss(outputs, batch[TARGET_KEY], batch.get(VOID_KEY),
                             weights=weights)


def make_train_step(loss_weights: Sequence[float] | None = None,
                    accum_steps: int = 1, loss_scale: float = 1.0,
                    grad_clip_norm: float | None = None,
                    precision: Policy | None = None
                    ) -> Callable[[TrainState, Mapping], torch.Tensor]:
    """``(state, host batch) -> loss``: one optimizer update of ``state``
    in place; ``grad_clip_norm`` clips the trainable gradients' global norm
    (optax's ``clip_by_global_norm``) before the update."""

    def step(state: TrainState, batch: Mapping) -> torch.Tensor:
        model = state.model.train()
        data = device_batch(batch, state.device)
        b = data[INPUT_KEY].shape[0]
        if b % accum_steps:
            raise ValueError(f"batch {b} not divisible by accum_steps "
                             f"{accum_steps}")
        micro = b // accum_steps
        state.optimizer.zero_grad(set_to_none=True)
        losses = []
        for i in range(accum_steps):
            part = {k: v[i * micro:(i + 1) * micro] for k, v in data.items()}
            outputs = _forward(model, part[INPUT_KEY], precision,
                               state.generator)
            loss = _compute_loss(outputs, part, loss_weights)
            (loss * loss_scale).backward()
            losses.append(loss.detach())
        if loss_scale != 1.0 or accum_steps != 1:
            for group in state.optimizer.param_groups:
                for p in group["params"]:
                    if p.grad is not None:
                        p.grad.div_(loss_scale * accum_steps)
        apply_update(state.optimizer, state.schedule, state.step,
                     grad_clip_norm)
        state.step += 1
        return torch.stack(losses).mean()

    return step


def make_eval_step(loss_weights: Sequence[float] | None = None,
                   precision: Policy | None = None
                   ) -> Callable[[TrainState, Mapping],
                                 tuple[tuple[torch.Tensor, ...], torch.Tensor]]:
    """``(state, host batch) -> (logits, loss)`` in eval mode: the model's
    three NCHW logit maps and the loss, as device tensors.  Under
    ``precision`` the forward runs in the compute dtype, the loss on the
    outputs upcast to the loss dtype."""

    def step(state: TrainState, batch: Mapping):
        model = state.model.eval()
        data = device_batch(batch, state.device)
        with torch.inference_mode():
            outputs = _forward(model, data[INPUT_KEY], precision)
            return outputs, _compute_loss(outputs, data, loss_weights)

    return step
