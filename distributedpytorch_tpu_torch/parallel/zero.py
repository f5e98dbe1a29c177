"""ZeRO-1 optimizer-state sharding over the ranks, the counterpart of
``distributedpytorch_tpu/parallel/zero.py`` (``dp_zero1``).

The JAX package partitions each large optimizer leaf over the ``data``
axis and lets GSPMD all-gather the update.  Here the SGD that
``train/optim.py`` builds is re-wrapped in
``torch.distributed.optim.ZeroRedundancyOptimizer``: each rank keeps the
momentum of its share of the parameters, updates that share, and
broadcasts it to the other ranks after the step.  The parameter groups
(``lr_mult``, frozen parameters left out) and the SGD hyperparameters
carry over unchanged, so the update is the replicated one: the same
numbers in another layout.  A checkpoint gathers the shards on rank 0
(``consolidate_state_dict``) into the plain SGD ``state_dict`` form, so a
checkpoint written under one strategy restores under the other.
"""

from __future__ import annotations

import torch
from torch.distributed.optim import ZeroRedundancyOptimizer


def shard_optimizer(optimizer: torch.optim.SGD) -> ZeroRedundancyOptimizer:
    """``optimizer``'s groups and hyperparameters, its state sharded over
    the default process group.  ``optimizer`` must be fresh (no state) and
    its parameters already on their device: ZeRO takes that device for
    its own collectives (NCCL refuses CPU tensors)."""
    if optimizer.state:
        raise ValueError("shard_optimizer takes a fresh optimizer: its state "
                         "would be dropped")
    groups = [dict(g) for g in optimizer.param_groups]
    return ZeroRedundancyOptimizer(groups, optimizer_class=type(optimizer),
                                   **optimizer.defaults)


def is_sharded(optimizer: torch.optim.Optimizer) -> bool:
    return isinstance(optimizer, ZeroRedundancyOptimizer)
