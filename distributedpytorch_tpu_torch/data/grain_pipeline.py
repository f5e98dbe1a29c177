"""The worker-process train loader (``data.loader=grain``), the counterpart
of ``distributedpytorch_tpu/data/grain_pipeline.py``.

The JAX package builds this loader on the ``grain`` package.  The card's
machine has no ``grain``, so the port builds the same surface
(:class:`GrainDataLoader`: ``set_epoch``, ``__len__``, ``__iter__``, the
dict batches of :func:`.pipeline.collate`) on the standard library's
``multiprocessing`` alone.  What it keeps of the JAX loader:

* every sample's RNG is ``default_rng((seed, epoch, index))``, so a
  sample's contents are bit-identical to the threaded
  :class:`.pipeline.DataLoader`'s at any worker count;
* with ``num_workers`` N > 0 each worker takes every Nth record of the
  epoch's order and batches its own slice (``drop_last`` drops one
  remainder per worker), and the batches come out round-robin over the
  workers — worker 0's first, worker 1's first, ..., worker 0's second —
  passing over a worker whose slice is spent: grain's composition and
  order.  ``num_workers=0`` batches the whole order in-process, as
  ``DataLoader`` does;
* ``__len__`` sums the per-worker batch counts;
* with ``num_shards`` W > 1 each rank takes a contiguous shard of
  ``len // W`` records of the epoch's order, the remainder dropped, as
  grain's ``ShardOptions(..., drop_remainder=True)`` does in the JAX
  loader; ``micro_batches`` lays its batches out over the ranks as the
  threaded loader does (:func:`.pipeline.micro_batch_rows`).

The record order is the port's own ``(seed, epoch)`` permutation, the
threaded loader's (grain's ``IndexSampler`` order is grain's own, and the
JAX package documents that its two loaders' orders differ).
``set_epoch(epoch, start_batch)`` positions the loader exactly, and the
skipped batches are not loaded.  The trainer validates on the threaded
loader, as the JAX trainer does.

Processes: each iteration starts its workers with the ``spawn`` start
method (a fresh interpreter: the parent, which may hold a CUDA context, is
never forked) and stops them when it ends or is closed, killing any still
running, so no worker outlives it; :meth:`GrainDataLoader.close` and
interpreter exit stop any left.  At most one worker per CPU of the
process's affinity, shared among the ranks on the host (the affinity
divided by the local world size), so ranks do not oversubscribe it.  A worker imports numpy and the port's data modules,
never torch, and ignores SIGINT and SIGTERM (the parent owns preemption).
A worker's exception is raised from the iterator; a worker that dies
raises there, naming it and its exit code or signal.

Transport: each worker sends its batches over its own socket pair, pickled
with protocol 5, the arrays as out-of-band buffers read straight into the
parent's memory — no shared memory, so the size of ``/dev/shm`` does not
matter.  A parent thread reads them in order; at most ``prefetch`` batches
wait there, plus one being sent by each worker.
"""

from __future__ import annotations

import atexit
import multiprocessing
import os
import pickle
import queue
import signal
import struct
import threading
import traceback
import weakref
from typing import Iterator

import numpy as np

from .. import native_ops
from .pipeline import collate, micro_batch_rows, sample_rng

_SIZE = struct.Struct("<Q")


def _write_all(fd: int, data) -> None:
    view = memoryview(data).cast("B")
    while view:
        view = view[os.write(fd, view):]


def _read_into(fd: int, buf: bytearray) -> None:
    view = memoryview(buf)
    while view:
        n = os.readv(fd, [view])
        if n == 0:
            raise EOFError("the other end closed")
        view = view[n:]


def _send(fd: int, obj) -> None:
    """Pickle ``obj`` (protocol 5, arrays out of band) onto ``fd``."""
    buffers: list = []
    head = pickle.dumps(obj, protocol=5, buffer_callback=buffers.append)
    raws = [b.raw() for b in buffers]
    sizes = [len(head)] + [r.nbytes for r in raws]
    _write_all(fd, _SIZE.pack(len(sizes)) + struct.pack(f"<{len(sizes)}Q", *sizes))
    for part in (head, *raws):
        _write_all(fd, part)


def _recv(fd: int):
    """The next object :func:`_send` wrote to the other end of ``fd``."""
    count = bytearray(_SIZE.size)
    _read_into(fd, count)
    sizes = bytearray(_SIZE.size * _SIZE.unpack(count)[0])
    _read_into(fd, sizes)
    parts = []
    for (size,) in _SIZE.iter_unpack(sizes):
        parts.append(bytearray(size))
        _read_into(fd, parts[-1])
    return pickle.loads(parts[0], buffers=parts[1:])


def _load(dataset, seed: int, epoch: int, index: int) -> dict:
    """Record ``index`` with its ``(seed, epoch, index)`` RNG, as the
    threaded loader loads it."""
    return dataset.__getitem__(int(index), rng=sample_rng(seed, epoch, index))


class _WorkerError:
    """A worker's exception and its formatted traceback."""

    def __init__(self, exc: BaseException, tb: str):
        self.exc, self.tb = exc, tb


class _RemoteTraceback(Exception):
    def __str__(self) -> str:
        return self.args[0]


def _worker(conn) -> None:
    """A worker's main: read (dataset, seed, epoch, batches), send each
    batch's collated samples, exit."""
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    fd = conn.fileno()
    try:
        dataset, seed, epoch, batches = _recv(fd)
        for idxs in batches:
            _send(fd, collate([_load(dataset, seed, epoch, i) for i in idxs]))
    except (BrokenPipeError, ConnectionResetError, EOFError):
        return  # the loader went away
    except BaseException as e:  # raised from the parent's iterator
        tb = traceback.format_exc()
        try:
            pickle.dumps(e)
        except Exception:
            e = RuntimeError(repr(e))
        try:
            _send(fd, _WorkerError(e, tb))
        except OSError:
            pass


_DONE = object()


class _Died:
    def __init__(self, worker: int):
        self.worker = worker


class _Workers:
    """One iteration's worker processes and the thread that reads their
    batches, in the plan's order, into a bounded queue."""

    def __init__(self, loader: "GrainDataLoader",
                 plan: list[tuple[int, np.ndarray]]):
        self.loader = loader
        self.plan = plan
        self.out: queue.Queue = queue.Queue(maxsize=loader.prefetch)
        self.stop = threading.Event()
        self.finished = False
        self.procs: dict = {}
        self.conns: dict = {}
        self.reader: threading.Thread | None = None

    def start(self) -> None:
        per: dict[int, list] = {}
        for w, idxs in self.plan:
            per.setdefault(w, []).append(idxs)
        ctx = multiprocessing.get_context("spawn")
        for w in sorted(per):
            parent, child = ctx.Pipe(duplex=True)
            self.conns[w] = parent
            proc = ctx.Process(target=_worker, args=(child,), daemon=True,
                               name=f"dptpu-data-worker-{w}")
            try:
                proc.start()
            finally:
                child.close()
            self.procs[w] = proc
        ld = self.loader
        jobs = {w: (ld.dataset, ld.seed, ld._epoch, per[w]) for w in per}
        self.reader = threading.Thread(target=self._read, args=(jobs,),
                                       daemon=True)
        self.reader.start()

    def _put(self, item) -> bool:
        while not self.stop.is_set():
            try:
                self.out.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def _read(self, jobs: dict) -> None:
        w = None
        try:
            for w, job in jobs.items():
                _send(self.conns[w].fileno(), job)
            for w, _ in self.plan:
                msg = _recv(self.conns[w].fileno())
                if isinstance(msg, _WorkerError):
                    msg.exc.__cause__ = _RemoteTraceback(
                        f"\n\nin data loader worker {w}:\n{msg.tb}")
                    self._put(msg.exc)
                    return
                if not self._put(msg):
                    return
            self._put(_DONE)
        except (EOFError, OSError):
            if not self.stop.is_set():
                self._put(_Died(w))
        except BaseException as e:  # e.g. a dataset that does not pickle
            self._put(e)

    def batches(self) -> Iterator[dict]:
        while (item := self.out.get()) is not _DONE:
            if isinstance(item, _Died):
                raise self._death(item.worker)
            if isinstance(item, BaseException):
                raise item
            yield item
        self.finished = True

    def _death(self, w: int) -> RuntimeError:
        proc = self.procs[w]
        proc.join(timeout=10)
        code = proc.exitcode
        if code is None:
            how = "closed its connection but is still running"
        elif code < 0:
            how = f"was killed by signal {signal.Signals(-code).name}"
        else:
            how = f"exited with code {code}"
        return RuntimeError(f"data loader worker {w} (pid {proc.pid}) {how} "
                            "before it sent all of its batches")

    def shutdown(self) -> None:
        """Stop the reader and every worker: a worker still running after
        its last batch was read gets a few seconds to exit, one that owes
        batches is killed at once."""
        self.stop.set()
        for proc in self.procs.values():
            proc.join(timeout=5 if self.finished else 0)
            if proc.is_alive():
                proc.kill()
            proc.join()
            proc.close()
        if self.reader is not None:
            self.reader.join()
        for conn in self.conns.values():
            conn.close()
        self.procs, self.conns = {}, {}


#: every live iteration's workers, stopped at interpreter exit (before
#: multiprocessing's own exit handler, which would wait on them)
_LIVE: "weakref.WeakSet[_Workers]" = weakref.WeakSet()


@atexit.register
def _stop_all() -> None:
    for workers in list(_LIVE):
        workers.shutdown()


def cpu_count() -> int:
    """CPUs this process may run on (its affinity), at least 1."""
    try:
        return max(1, len(os.sched_getaffinity(0)))
    except AttributeError:  # no affinity on this platform
        return max(1, os.cpu_count() or 1)


class GrainDataLoader:
    """Worker-process counterpart of :class:`.pipeline.DataLoader`, with
    the same ``set_epoch`` / ``__len__`` / ``__iter__`` surface and dict
    batches (see the module docstring for batch composition).

    ``num_workers`` is capped at the process's CPU affinity over the
    ranks on its host (:attr:`num_workers` is the count used); 0 loads
    in-process.  ``prefetch`` bounds the batches that wait in the
    parent.  ``num_shards``/``shard_index``/``micro_batches``: see the
    module docstring."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, num_workers: int = 0,
                 prefetch: int = 2, num_shards: int = 1, shard_index: int = 0,
                 micro_batches: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        # imported here: a worker imports this module, and must not torch
        from ..parallel.mesh import local_world_size

        self.num_workers = min(max(0, num_workers),
                               max(1, cpu_count() // local_world_size()))
        self.prefetch = max(1, prefetch)
        self.num_shards = max(1, num_shards)
        self.shard_index = shard_index
        self.micro_batches = max(1, micro_batches)
        if self.micro_batches > 1 and self.num_shards > 1 and not drop_last:
            raise ValueError("micro_batches over shards needs drop_last")
        self._epoch = 0
        self._start_batch = 0

    def set_epoch(self, epoch: int, start_batch: int = 0) -> None:
        """Position the loader at ``epoch``; ``start_batch`` skips that many
        batches of the epoch's fixed order (without loading them), so a
        resumed run continues where a preempted one stopped.  ``len``
        still counts the whole epoch."""
        self._epoch = int(epoch)
        self._start_batch = int(start_batch)

    def epoch_indices(self, shard_index: int | None = None) -> np.ndarray:
        """The dataset indices of the current epoch in order: the
        ``(seed, epoch)`` permutation (``arange`` without ``shuffle``), or
        this loader's shard of it (shard ``shard_index`` if given)."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self._epoch)).shuffle(order)
        if self.num_shards > 1:
            per = len(order) // self.num_shards
            r = self.shard_index if shard_index is None else shard_index
            order = order[r * per:(r + 1) * per]
        return order

    def _shard_plan(self, shard_index: int) -> list[tuple[int, np.ndarray]]:
        order = self.epoch_indices(shard_index)
        w, b = self.num_workers, self.batch_size
        per = []
        for part in ([order[i::w] for i in range(w)] if w else [order]):
            n = len(part) // b if self.drop_last else -(-len(part) // b)
            per.append([part[i * b:(i + 1) * b] for i in range(n)])
        plan = []
        for k in range(max((len(p) for p in per), default=0)):
            plan += [(w, p[k]) for w, p in enumerate(per) if k < len(p)]
        return plan

    def batch_plan(self) -> list[tuple[int, np.ndarray]]:
        """The whole epoch's batches in yield order, as (worker, indices)."""
        plan = self._shard_plan(self.shard_index)
        if self.micro_batches == 1 or self.num_shards == 1:
            return plan
        plans = [plan if s == self.shard_index else self._shard_plan(s)
                 for s in range(self.num_shards)]
        return [(w, micro_batch_rows([p[k][1] for p in plans],
                                     self.shard_index, self.micro_batches))
                for k, (w, _) in enumerate(plan)]

    def __len__(self) -> int:
        n, w, b = len(self.dataset), self.num_workers, self.batch_size
        if self.num_shards > 1:  # the remainder dropped
            n //= self.num_shards
        counts = [n // w + (1 if i < n % w else 0) for i in range(w)] if w \
            else [n]
        if self.drop_last:
            return sum(c // b for c in counts)
        return sum(-(-c // b) for c in counts)

    def __iter__(self) -> Iterator[dict]:
        plan = self.batch_plan()[self._start_batch:]
        if not self.num_workers:
            for _, idxs in plan:
                yield collate([_load(self.dataset, self.seed, self._epoch, i)
                               for i in idxs])
            return
        if not plan:
            return
        if native_ops.enabled():
            native_ops.load()  # build once here, not in every worker
        workers = _Workers(self, plan)
        _LIVE.add(workers)
        try:
            workers.start()
            yield from workers.batches()
        finally:
            workers.shutdown()

    def close(self) -> None:
        """Stop the workers of any iteration still open."""
        for workers in list(_LIVE):
            if workers.loader is self:
                workers.shutdown()
