"""Batched click-to-mask serving of the port: the bounded-queue
micro-batcher (``service``), its bucket ladder (``batching``), the
session feature cache (``sessions``), hot swap with canary generations
(``swap``), the wire format and client (``client``) and the HTTP front
(``__main__``)."""

from .swap import PredictorPool, SwapInProgressError

__all__ = ["PredictorPool", "SwapInProgressError"]
