"""The process group and the data axis, the counterpart of
``distributedpytorch_tpu/parallel/mesh.py`` for data parallelism.

The JAX package builds one ``Mesh`` over every device and lets GSPMD
insert the collectives; one process drives all of a host's devices.  The
port runs one process per card (DDP's layout): the ``data`` axis is the
``torch.distributed`` world, of size :func:`data_axis_size`, and rank r
drives ``cuda:<local rank>``.  With no group formed the world is one
process and every collective of the port is skipped, so a single-process
run is the plain path of the earlier slices.

:func:`initialize_distributed` joins the group that ``torchrun``'s
environment describes (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``/``MASTER_PORT``) or the one its arguments name; at one
process it does nothing, as the JAX function does.  NCCL is the backend
for CUDA and gloo for the CPU; gloo also carries CUDA tensors, which lets
two ranks share one card (NCCL refuses that).
"""

from __future__ import annotations

import math
import os
from typing import Mapping

import numpy as np
import torch
import torch.distributed as dist

#: the canonical axis name, as in the JAX package
DATA_AXIS = "data"

#: the environment ``torchrun`` gives each worker
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def launched_by_torchrun(env: Mapping[str, str] | None = None) -> bool:
    """Whether ``env`` (default: this process's) carries a torchrun
    worker's rendezvous variables."""
    env = os.environ if env is None else env
    return all(k in env for k in TORCHRUN_ENV)


def initialize_distributed(init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None,
                           local_rank: int | None = None,
                           backend: str | None = None,
                           device: str = "cuda") -> torch.device:
    """Join the process group and return this rank's device.

    Without arguments the group is the one torchrun's environment
    describes (``env://``); ``init_method``/``world_size``/``rank`` name
    another (``tcp://localhost:<port>``, ``file://<path>``).  A world of
    one process, or no torchrun environment and no arguments, forms no
    group.  For ``device="cuda"`` the rank's card is ``cuda:<local rank
    modulo the visible cards>``, made current before any CUDA work (NCCL
    refuses two ranks on one card; gloo does not); the backend defaults to
    NCCL there and to gloo on the CPU."""
    env = os.environ
    if init_method is None and launched_by_torchrun():
        init_method = "env://"
        world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
        rank = int(env["RANK"]) if rank is None else rank
        if local_rank is None:
            local_rank = int(env["LOCAL_RANK"])
    world_size = 1 if world_size is None else int(world_size)
    rank = 0 if rank is None else int(rank)
    local_rank = rank if local_rank is None else int(local_rank)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "to run on the CPU explicitly")
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if init_method is None or dist.is_initialized():
        return dev
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kwargs)
    return dev


def destroy_distributed() -> None:
    """Leave the process group, if one was formed."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_distributed() -> bool:
    """Whether a process group is formed (of any size, one included)."""
    return dist.is_available() and dist.is_initialized()


def data_axis_size() -> int:
    """The size of the ``data`` axis: the processes of the group, 1
    without one."""
    return dist.get_world_size() if is_distributed() else 1


def process_index() -> int:
    """This process's rank on the ``data`` axis (0 without a group)."""
    return dist.get_rank() if is_distributed() else 0


def local_world_size() -> int:
    """The processes of the group on this host (torchrun's
    ``LOCAL_WORLD_SIZE``; the whole group where it is not set)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", data_axis_size()))


def resolve_data_axis(data: int | None) -> int:
    """``mesh.data`` against the live world: ``None`` means every process
    (one per visible card); a set value must equal it, or raises with the
    JAX ``make_mesh`` message."""
    n = data_axis_size()
    if data is not None and int(data) != n:
        raise ValueError(f"mesh {int(data)}x1 != {n} devices")
    return n


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank (``obj`` itself without a group)."""
    if not is_distributed() or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier() -> None:
    """Wait for every rank (a no-op without a group)."""
    if is_distributed() and dist.get_world_size() > 1:
        dist.barrier()


def pad_to_multiple(batch: Mapping[str, np.ndarray], multiple: int
                    ) -> tuple[dict, int]:
    """Pad the batch dim up to ``multiple`` by repeating the last sample;
    returns (padded batch, original size)."""
    first = next(iter(batch.values()))
    n = first.shape[0]
    target = math.ceil(n / multiple) * multiple
    if target == n:
        return dict(batch), n
    pad = target - n
    return {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)], axis=0)
            for k, v in batch.items()}, n
