"""Batched click-to-mask serving of the port: the bounded-queue
micro-batcher (``service``), its bucket ladder (``batching``), the
session feature cache (``sessions``), hot swap with canary generations
(``swap``), int8 weight quantization of the served model (``quantize``),
the AOT program cache (``aot``), the wire format and client (``client``)
and the HTTP front (``__main__``)."""

from .aot import AotCache, AotCacheError, AotCacheMiss
from .quantize import (
    QTensor,
    QuantizedPredictor,
    QuantPolicy,
    quant_policy,
    quantization_block,
    quantize_predictor,
)
from .swap import PredictorPool, SwapInProgressError

__all__ = [
    "AotCache",
    "AotCacheError",
    "AotCacheMiss",
    "PredictorPool",
    "QTensor",
    "QuantPolicy",
    "QuantizedPredictor",
    "SwapInProgressError",
    "quant_policy",
    "quantization_block",
    "quantize_predictor",
]
