"""Power-of-two micro-batch bucketing for the inference service.

A copy of ``distributedpytorch_tpu/serve/batching.py``: every drained batch
is padded up to the next power-of-two bucket (1/2/4/.../max_batch) with
zero lanes, so the forward only ever sees ``log2(max_batch) + 1`` batch
shapes.  Eval-mode BatchNorm and per-sample attention make each output lane
a function of its own input lane, so the zero lanes are inert and are
sliced off.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def bucket_sizes(max_batch: int) -> tuple[int, ...]:
    """The ascending power-of-two bucket ladder up to ``max_batch``, which
    must itself be a power of two."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    if max_batch & (max_batch - 1):
        raise ValueError(
            f"max_batch must be a power of two, got {max_batch} "
            "(the bucket ladder doubles; a ragged top bucket would "
            "over- or under-shoot it)")
    sizes = []
    b = 1
    while b <= max_batch:
        sizes.append(b)
        b *= 2
    return tuple(sizes)


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket holding ``n`` requests."""
    if n < 1:
        raise ValueError(f"need at least one request, got {n}")
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(
        f"{n} requests exceed the top bucket {buckets[-1]} — the batcher "
        "must split the drain, not grow the program")


def pad_to_bucket(stack: np.ndarray, bucket: int) -> np.ndarray:
    """(n, H, W, C) request stack -> (bucket, H, W, C), zero-filled lanes."""
    n = stack.shape[0]
    if n > bucket:
        raise ValueError(f"{n} requests do not fit bucket {bucket}")
    if n == bucket:
        return stack
    padded = np.zeros((bucket, *stack.shape[1:]), stack.dtype)
    padded[:n] = stack
    return padded


def unpad(results: np.ndarray, n: int) -> np.ndarray:
    """Keep only the ``n`` real results."""
    return results[:n]
