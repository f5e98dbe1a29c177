"""The CLI's own launcher for one host: one rank per visible card.

``python -m distributedpytorch_tpu_torch`` without torchrun's environment,
on a host with more than one visible card, calls :func:`spawn_ranks`: the
kernels are built once here, then every rank is started with the ``spawn``
start method (never a fork) and the environment torchrun would give it,
its rendezvous a TCP store on localhost.  A rank that dies ends the
others, and the exit code names it.  (The entry point lives here, not in
the package's ``__main__``, because ``spawn`` cannot import a function
from a package's ``__main__`` module.)
"""

from __future__ import annotations

import os
import signal
import socket
import sys


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_entry(argv: list[str], env: dict[str, str]) -> None:
    """A spawned rank: torchrun's environment, then the CLI."""
    from ..__main__ import main

    os.environ.update(env)
    sys.exit(main(argv))


def spawn_ranks(argv: list[str], n: int) -> int:
    """Run ``argv`` as ``n`` ranks on this host, one per card; returns 0
    when every rank does, else 1 naming the first rank that died."""
    import multiprocessing
    from multiprocessing.connection import wait

    from .. import native_ops
    from ..ops import cuda_attention

    cuda_attention.build()  # once, before any rank starts
    if native_ops.enabled():
        native_ops.load()
    ctx = multiprocessing.get_context("spawn")
    base = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()),
            "WORLD_SIZE": str(n), "LOCAL_WORLD_SIZE": str(n)}
    procs = []
    for rank in range(n):
        env = dict(base, RANK=str(rank), LOCAL_RANK=str(rank))
        proc = ctx.Process(target=_rank_entry, args=(argv, env),
                           name=f"dptpu-rank-{rank}")
        proc.start()
        procs.append(proc)

    def forward(signum, frame):
        for p in procs:
            if p.is_alive():
                os.kill(p.pid, signum)

    # SIGTERM goes to the parent alone: pass it on.  A terminal's Ctrl-C
    # already reaches every rank, so the parent only outlives it.
    prev = {signal.SIGTERM: signal.signal(signal.SIGTERM, forward),
            signal.SIGINT: signal.signal(signal.SIGINT, signal.SIG_IGN)}
    dead = None
    try:
        live = list(procs)
        while live:
            for sentinel in wait([p.sentinel for p in live]):
                p = next(q for q in live if q.sentinel == sentinel)
                live.remove(p)
                p.join()
                if p.exitcode != 0 and dead is None:
                    # the others would wait for it in their next
                    # collective (a SIGTERM only asks them to stop there)
                    dead = p
                    for q in live:
                        q.kill()
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        for s, h in prev.items():
            signal.signal(s, h)
    if dead is not None:
        rank = procs.index(dead)
        print(f"rank {rank} of {n} (pid {dead.pid}) died with exit code "
              f"{dead.exitcode}; the other ranks were ended", file=sys.stderr,
              flush=True)
        return 1
    return 0
