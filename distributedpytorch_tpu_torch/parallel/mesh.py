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

:func:`prefetch_to_device` places a window of host batches on the card
ahead of the step that consumes them (``data.device_prefetch``), the
counterpart of the JAX function of the same name: one worker thread
pulls the host batches and copies them from pinned memory on a side CUDA
stream, so the loader's wait and the copy overlap the step running on
the consumer's stream.
"""

from __future__ import annotations

import collections
import math
import os
import threading
from typing import Callable, Iterable, Iterator, Mapping

import numpy as np
import torch
import torch.distributed as dist

from ..chaos import sites as chaos_sites

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


def to_nchw(arr, device: torch.device) -> torch.Tensor:
    """A host (B, H, W[, C]) array -> a (B, C, H, W) float32 tensor on
    ``device`` (other ranks as they are); a tensor passes through as
    already laid out, moved to ``device`` if it is elsewhere."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device)
    t = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    return _layout(t.to(device, non_blocking=True))


def _layout(t: torch.Tensor) -> torch.Tensor:
    if t.dim() == 3:
        t = t[..., None]
    return t.permute(0, 3, 1, 2).contiguous() if t.dim() == 4 else t


#: the placement's side stream of each card
_STREAMS: dict = {}


class _Placer:
    """Places host batches on ``device``: on a card, each array is copied
    into pinned memory and to the card with ``non_blocking`` on a side
    stream (the NCHW transpose runs there too), and an event is recorded
    behind the copies; :meth:`ready` makes the consumer's current stream
    wait on that event and records the tensors' use on it, so the step
    never reads a half-copied batch and the caching allocator does not
    hand their memory to the side stream before the step is done."""

    def __init__(self, device: torch.device, keys):
        self.device = torch.device(device)
        self.keys = keys
        self.stream = None
        if self.device.type == "cuda":
            # one side stream per card for the process: the caching
            # allocator reuses a stream's freed blocks only on that stream,
            # so a stream per prefetcher (per epoch) would allocate its
            # batches afresh every epoch and keep the old ones cached
            if self.device not in _STREAMS:
                _STREAMS[self.device] = torch.cuda.Stream(device=self.device)
            self.stream = _STREAMS[self.device]

    def place(self, batch: Mapping):
        if self.keys is not None:
            batch = {k: v for k, v in batch.items() if k in self.keys}
        # chaos seam: latency here is a slow copy, an error a failed one,
        # a poisoned payload a torn host batch before placement
        batch = chaos_sites.fire("device/put", payload=batch)
        if self.stream is None:
            return {k: to_nchw(v, self.device) for k, v in batch.items()}, None
        out = {}
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            for k, v in batch.items():
                host = torch.from_numpy(np.ascontiguousarray(v, np.float32))
                out[k] = _layout(host.pin_memory().to(self.device,
                                                      non_blocking=True))
            event = torch.cuda.Event()
            event.record(self.stream)
        return out, event

    def ready(self, placed) -> dict:
        out, event = placed
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for t in out.values():
                t.record_stream(consumer)
        return out


#: the worker's end-of-batches marker
_END = object()


def prefetch_to_device(batches: Iterable[Mapping], device: torch.device,
                       size: int | Callable[[], int] = 2,
                       keys: tuple[str, ...] | None = None
                       ) -> Iterator[dict]:
    """Iterate ``batches`` (host dicts of HWC numpy arrays) as dicts of
    NCHW float32 tensors on ``device``, with up to ``size`` of them placed
    ahead of the consumer.

    ``keys`` keeps only the device-bound arrays (metadata and ragged lists
    cannot be placed).  ``size=0`` places each batch when it is asked for.
    ``size`` may be a zero-argument callable, read again whenever the
    window is full, so a window resized mid-epoch applies at once (never
    below 1).  One worker thread (``device-put``) pulls the host batches
    and places them, in order, while the consumer steps; it pulls the next
    one only while fewer than the window's batches wait placed, so the
    consumer waits only on an empty window (an epoch's first batch, or a
    loader or placement slower than the step).  The JAX function pulls on
    the consumer's thread and yields only once the window is full, which
    makes the first step of an epoch wait for the window's loader batches
    too.  The ``device/put`` chaos site fires on the worker before each
    placement; whatever the worker raises (the loader's errors included)
    surfaces in the consumer at that batch's turn.  An abandoned iterator
    drops the placed batches and stops the worker before its next pull."""
    placer = _Placer(device, keys)
    if not callable(size) and size <= 0:  # synchronous placement
        for batch in batches:
            yield placer.ready(placer.place(batch))
        return
    bound = (lambda: max(1, int(size()))) if callable(size) \
        else (lambda: max(1, size))
    placed: collections.deque = collections.deque()
    cond = threading.Condition()
    stop = threading.Event()

    def fill():
        try:
            for batch in batches:
                item = placer.place(batch)
                with cond:
                    placed.append(item)
                    cond.notify_all()
                    while len(placed) >= bound() and not stop.is_set():
                        cond.wait(0.05)  # a grown window applies within this
                if stop.is_set():
                    return
        except BaseException as e:  # raised in the consumer, in order
            with cond:
                placed.append(e)
        finally:
            with cond:
                placed.append(_END)
                cond.notify_all()

    worker = threading.Thread(target=fill, name="device-put", daemon=True)
    worker.start()
    try:
        while True:
            with cond:
                while not placed:
                    cond.wait()
                item = placed.popleft()
                cond.notify_all()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield placer.ready(item)
    finally:
        # an abandoned iterator: the worker ends after the batch in hand
        stop.set()
        with cond:
            cond.notify_all()
        worker.join()
        placed.clear()
