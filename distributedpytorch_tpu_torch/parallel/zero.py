"""ZeRO-1 optimizer-state sharding over the ranks, the counterpart of
``distributedpytorch_tpu/parallel/zero.py`` (``dp_zero1``).

The JAX package partitions each large optimizer leaf over the ``data``
axis and lets GSPMD all-gather the update.  Here the SGD or AdamW that
``train/optim.py`` builds is re-wrapped in
``torch.distributed.optim.ZeroRedundancyOptimizer``: each rank keeps the
state (momentum; AdamW's moments) of its share of the parameters, updates
that share, and broadcasts it to the other ranks after the step.  The
parameter groups (``lr_mult``, frozen parameters left out) and the
optimizer's hyperparameters carry over unchanged, so the update is the
replicated one: the same numbers in another layout.  A checkpoint gathers
the shards on rank 0 (``consolidate_state_dict``) into the plain
``state_dict`` form, so a checkpoint written under one strategy restores
under the other.
"""

from __future__ import annotations

import inspect

import torch
from torch.distributed.optim import ZeroRedundancyOptimizer


def shard_optimizer(optimizer: torch.optim.Optimizer) -> ZeroRedundancyOptimizer:
    """``optimizer``'s groups and hyperparameters, its state sharded over
    the default process group.  ``optimizer`` must be fresh (no state) and
    its parameters already on their device: ZeRO takes that device for
    its own collectives (NCCL refuses CPU tensors)."""
    if optimizer.state:
        raise ValueError("shard_optimizer takes a fresh optimizer: its state "
                         "would be dropped")
    groups = [dict(g) for g in optimizer.param_groups]
    cls = type(optimizer)
    # only what the constructor takes: AdamW's defaults also hold the
    # ``decoupled_weight_decay`` that its class fixes
    accepted = inspect.signature(cls.__init__).parameters
    return ZeroRedundancyOptimizer(
        groups, optimizer_class=cls,
        **{k: v for k, v in optimizer.defaults.items() if k in accepted})


def is_sharded(optimizer: torch.optim.Optimizer) -> bool:
    return isinstance(optimizer, ZeroRedundancyOptimizer)
