"""The train and eval steps, the counterpart of
``distributedpytorch_tpu/parallel/step.py``: on one device, or one
process per card under ``DistributedDataParallel``.

A host batch — the loader's dict of HWC float32 numpy arrays — becomes
NCHW torch tensors on the device once, here (:func:`device_batch`); a
batch already placed by the device prefetcher (``parallel/mesh.py``,
``prefetch_to_device``) passes through.  A train step is forward, the
loss, backward and one optimizer update.  ``augment``
(``ops/augment.py``, ``make_device_augment``; the device flip,
scale-rotate and guidance) runs after the batch is placed and before the
forward, on a ``torch.Generator`` of the step's own seed
(:func:`step_generator`: the run's seed, the step count and the rank), so
a resumed fit draws what the straight one drew with nothing added to the
checkpoint, and each rank draws its own.  ``make_eval_step(preprocess=)``
runs its stage (the val guidance) before the forward.  The
loss is ``loss_type``'s: ``multi_sigmoid``, the instance task's multi-output
balanced BCE, or ``multi_softmax``, the semantic task's per-output
softmax cross-entropy with ignore index 255 against the class ids in
``crop_gt`` (auxiliary outputs weighted 0.4 unless ``loss_weights``
says otherwise); with ``accum_steps > 1`` the batch is split into that many
micro-batches in order, BatchNorm's running statistics move once per
micro-batch, the loss is the mean of the micro-batch losses and the
gradients are averaged, as the JAX step's scan does.  ``loss_scale``
multiplies the loss before the backward and divides the gradients after.
``aux_loss_weight`` adds that multiple of the model's auxiliary loss (DANet's
MoE load-balancing term, which the forward returns under ``with_aux=True``)
to each micro-batch's train loss, under autograd; the eval loss has none,
as in the JAX step.
The returned loss is a device scalar: reading it synchronises, so callers
read it when they log.

``precision`` (a ``train.precision.Policy``, ``None`` for float32) draws
the two dtype boundaries of the mixed regime, as the JAX step does: the
input is cast to the compute dtype before the model and the outputs to
the loss dtype after it.  The model itself must be built in the compute
dtype; its parameters are float32, so their gradients, the clip norm and
the optimizer state are float32 with nothing here to cast.

Data parallelism (:func:`wrap_data_parallel`, ``TrainState.ddp``): each
rank holds its rows of the global batch; the model's BatchNorms take the
group's statistics (``ops/sync_bn.py``) and DDP averages the gradients.
With ``global_balance`` (the ``dp``/``dp_zero1`` step, one GSPMD program
over the global batch in the JAX package) the class balance and the
normaliser are the global micro-batch's: a rank backpropagates W times
its share of the global loss, so DDP's mean is the global loss's
gradient, and the loss returned is the global one; the softmax loss is
normalised the same way, by the global micro-batch's count of valid
pixels, so ranks that hold different numbers of void pixels still
compute one global mean.  Without it (the
bucketed ``shard_map`` step, ``train.reduce_buckets > 0``) each rank's
loss is its own rows', the gradient is that of their mean over the ranks
and so is the loss returned.  Micro-batches under accumulation are the
rank's rows in order; DDP reduces on the last one only (``no_sync``).
How the rows are laid out over the ranks is the loader's business
(``data/pipeline.py``).  ``train.reduce_buckets`` sets DDP's bucket size
from the JAX package's byte-balanced buckets (:func:`bucket_cap_mb`).

The uint8/packbits/coalesced wires and multi-step dispatch are not ported
yet.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
from typing import Callable, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from ..ops.losses import (
    balance_counts,
    multi_output_loss,
    multi_softmax_loss,
    valid_count,
)
from .mesh import to_nchw
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
    made, and the generator that draws the dropout masks; under data
    parallelism ``ddp``, the DDP module around ``model`` that the train
    step runs."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    generator: torch.Generator
    step: int = 0
    ddp: DistributedDataParallel | None = None

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


def bucket_grad_leaves(sizes: Sequence[int], n_buckets: int) -> list[list[int]]:
    """Partition gradient-leaf indices into ``n_buckets`` byte-balanced
    buckets in reverse order (a copy of the JAX function's rule, over the
    leaves' byte ``sizes``): the last leaves, whose gradients the backward
    produces first, fill bucket 0."""
    if n_buckets < 1:
        raise ValueError(f"reduce_buckets must be >= 1 (got {n_buckets})")
    order = list(range(len(sizes)))[::-1]
    total = sum(int(sizes[i]) for i in order)
    n_buckets = min(n_buckets, len(order)) or 1
    per = max(1, total // n_buckets)
    buckets: list[list[int]] = []
    cur: list[int] = []
    acc = 0
    for i in order:
        cur.append(i)
        acc += int(sizes[i])
        if acc >= per and len(buckets) < n_buckets - 1:
            buckets.append(cur)
            cur, acc = [], 0
    if cur:
        buckets.append(cur)
    return buckets


def bucket_cap_mb(model: nn.Module, n_buckets: int) -> float:
    """DDP's ``bucket_cap_mb`` for ``train.reduce_buckets = n_buckets``:
    the largest of the JAX package's byte-balanced buckets over the
    trainable parameters, in MiB, so DDP (which also cuts in reverse
    parameter order) closes about as many buckets."""
    sizes = [p.numel() * p.element_size() for p in model.parameters()
             if p.requires_grad]
    buckets = bucket_grad_leaves(sizes, n_buckets)
    return max(sum(sizes[i] for i in b) for b in buckets) / 2**20


#: DDP's switch for the forward's buffer broadcast (renamed in torch 2.13)
_NO_BUFFER_SYNC = "forward_sync_buffers" if "forward_sync_buffers" in \
    inspect.signature(DistributedDataParallel).parameters else "broadcast_buffers"


def wrap_data_parallel(state: TrainState, reduce_buckets: int = 0,
                       group=None) -> TrainState:
    """Put ``state.model`` under ``DistributedDataParallel`` over
    ``group`` (the default group): parameters broadcast from rank 0, the
    gradients averaged over the ranks.  BatchNorm's buffers are not
    broadcast (the cross-replica layers keep them equal).
    ``reduce_buckets > 0`` sizes the buckets from the JAX package's
    (:func:`bucket_cap_mb`); 0 keeps DDP's default."""
    device = state.device
    kwargs = {_NO_BUFFER_SYNC: False}
    if reduce_buckets:
        kwargs["bucket_cap_mb"] = bucket_cap_mb(state.model, reduce_buckets)
    state.ddp = DistributedDataParallel(
        state.model, device_ids=[device] if device.type == "cuda" else None,
        process_group=group, **kwargs)
    return state


#: the batch keys placed on the device
DEVICE_KEYS = (INPUT_KEY, TARGET_KEY, VOID_KEY)


def device_batch(batch: Mapping, device: torch.device) -> dict[str, torch.Tensor]:
    """The step's keys of a host batch as NCHW float32 tensors on
    ``device``: ``concat`` (B, C, H, W), ``crop_gt`` and ``crop_void`` (B,
    1, H, W); tensors (a placed batch) pass through."""
    return {k: to_nchw(batch[k], device) for k in DEVICE_KEYS if k in batch}


def step_generator(seed: int, step: int, rank: int,
                   device: torch.device) -> torch.Generator:
    """The device stage's generator of one train step, seeded from
    ``(seed, step, rank)`` alone."""
    state = np.random.SeedSequence([seed, step, rank]).generate_state(
        1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def _forward(model: nn.Module, inputs: torch.Tensor,
             precision: Policy | None,
             generator: torch.Generator | None = None,
             with_aux: bool = False):
    """The model's outputs on ``inputs`` across the policy's boundaries:
    inputs in the compute dtype, outputs in the loss dtype; with
    ``with_aux``, the pair of them and the model's auxiliary loss."""
    if precision is not None:
        inputs = precision.cast_to_compute(inputs)
    if with_aux:
        outputs, aux = model(inputs, generator, with_aux=True)
    else:
        outputs, aux = model(inputs, generator), None
    if precision is not None:
        outputs = precision.cast_to_loss(outputs)
    return outputs if aux is None else (outputs, aux)


def _labels(batch: Mapping) -> torch.Tensor:
    """The semantic task's (B, H, W) class ids from ``crop_gt``."""
    return batch[TARGET_KEY][:, 0]


def loss_counts(batch: Mapping, loss_type: str) -> torch.Tensor:
    """What the loss of ``batch`` counts, to be summed over the ranks:
    (positives, valid pixels) for ``multi_sigmoid``, valid pixels for
    ``multi_softmax``."""
    if loss_type == "multi_softmax":
        return valid_count(_labels(batch))
    return balance_counts(batch[TARGET_KEY], batch.get(VOID_KEY))


def _compute_loss(outputs: Sequence[torch.Tensor], batch: Mapping,
                  weights: Sequence[float] | None,
                  counts: torch.Tensor | None = None,
                  loss_type: str = "multi_sigmoid") -> torch.Tensor:
    """``loss_type``'s loss of the outputs: ``multi_sigmoid``, the weighted
    balanced BCE of every output against the one target; or
    ``multi_softmax``, the weighted softmax cross-entropy against the
    class ids; balanced and normalised by ``counts``
    (:func:`loss_counts`) when given."""
    if weights is not None and len(weights) != len(outputs):
        raise ValueError(
            f"model.loss_weights has {len(weights)} entries but the model "
            f"emits {len(outputs)} outputs — give every output a weight")
    if loss_type == "multi_sigmoid":
        return multi_output_loss(outputs, batch[TARGET_KEY],
                                 batch.get(VOID_KEY), weights=weights,
                                 counts=counts)
    if loss_type == "multi_softmax":
        return multi_softmax_loss(outputs, _labels(batch), weights=weights,
                                  n_valid=counts)
    raise ValueError(f"unknown loss_type: {loss_type!r}")


def make_train_step(loss_weights: Sequence[float] | None = None,
                    accum_steps: int = 1, loss_scale: float = 1.0,
                    grad_clip_norm: float | None = None,
                    precision: Policy | None = None,
                    global_balance: bool = True,
                    loss_type: str = "multi_sigmoid",
                    augment: Callable | None = None, seed: int = 0,
                    aux_loss_weight: float = 0.0
                    ) -> Callable[[TrainState, Mapping], torch.Tensor]:
    """``(state, host batch) -> loss``: one optimizer update of ``state``
    in place; ``grad_clip_norm`` clips the trainable gradients' global norm
    (optax's ``clip_by_global_norm``) before the update.  Under
    ``state.ddp`` the batch is this rank's rows, and ``global_balance``
    picks the global loss (see the module docstring).  ``augment`` is a
    ``(device batch, generator) -> device batch`` stage, run on
    :func:`step_generator` of ``seed``.  ``aux_loss_weight`` weights the
    model's auxiliary loss into the train loss (0: none is asked for)."""

    def step(state: TrainState, batch: Mapping) -> torch.Tensor:
        ddp = state.ddp
        model = state.model.train() if ddp is None else ddp.train()
        data = device_batch(batch, state.device)
        if augment is not None:
            rank = 0 if ddp is None else dist.get_rank(ddp.process_group)
            data = augment(data, step_generator(seed, state.step, rank,
                                                state.device))
        b = data[INPUT_KEY].shape[0]
        if b % accum_steps:
            raise ValueError(f"batch {b} not divisible by accum_steps "
                             f"{accum_steps}")
        micro = b // accum_steps
        world = 1 if ddp is None else dist.get_world_size(ddp.process_group)
        state.optimizer.zero_grad(set_to_none=True)
        losses = []
        for i in range(accum_steps):
            part = {k: v[i * micro:(i + 1) * micro] for k, v in data.items()}
            counts = None
            if ddp is not None and global_balance:
                counts = loss_counts(part, loss_type)
                dist.all_reduce(counts, group=ddp.process_group)
            last = ddp is None or i == accum_steps - 1
            with contextlib.nullcontext() if last else ddp.no_sync():
                outputs = _forward(model, part[INPUT_KEY], precision,
                                   state.generator,
                                   with_aux=bool(aux_loss_weight))
                if aux_loss_weight:
                    outputs, aux = outputs
                loss = _compute_loss(outputs, part, loss_weights, counts,
                                     loss_type)
                if aux_loss_weight:
                    loss = loss + aux_loss_weight * aux
                scale = loss_scale * (world if counts is not None else 1)
                (loss * scale).backward()
            losses.append(loss.detach())
        if loss_scale != 1.0 or accum_steps != 1:
            for group in state.optimizer.param_groups:
                for p in group["params"]:
                    if p.grad is not None:
                        p.grad.div_(loss_scale * accum_steps)
        apply_update(state.optimizer, state.schedule, state.step,
                     grad_clip_norm)
        state.step += 1
        loss = torch.stack(losses).mean()
        if ddp is not None:
            dist.all_reduce(loss, group=ddp.process_group)
            if not global_balance:
                loss = loss / world
        return loss

    return step


def make_eval_step(loss_weights: Sequence[float] | None = None,
                   precision: Policy | None = None,
                   loss_type: str = "multi_sigmoid",
                   preprocess: Callable[[Mapping], Mapping] | None = None
                   ) -> Callable[[TrainState, Mapping],
                                 tuple[tuple[torch.Tensor, ...], torch.Tensor]]:
    """``(state, host batch) -> (logits, loss)`` in eval mode: the model's
    NCHW logit maps and ``loss_type``'s loss, as device tensors.  Under
    ``precision`` the forward runs in the compute dtype, the loss on the
    outputs upcast to the loss dtype.  ``preprocess`` (a deterministic
    ``device batch -> device batch`` stage) runs before the forward."""

    def step(state: TrainState, batch: Mapping):
        model = state.model.eval()
        data = device_batch(batch, state.device)
        with torch.inference_mode():
            if preprocess is not None:
                data = preprocess(data)
            outputs = _forward(model, data[INPUT_KEY], precision)
            return outputs, _compute_loss(outputs, data, loss_weights,
                                          loss_type=loss_type)

    return step
