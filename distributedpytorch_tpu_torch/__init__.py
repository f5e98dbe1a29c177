"""distributedpytorch_tpu_torch — the PyTorch and CUDA port of
``distributedpytorch_tpu``, for an NVIDIA H100.

Serving slice: click-to-mask inference through DANet on a dilated ResNet
(``predict.Predictor``, ``serve.InferenceService``, the HTTP front in
``python -m distributedpytorch_tpu_torch.serve``), with DANet's three
attention kernels hand-written in CUDA for ``sm_90a`` (``csrc/``).

Importing the package is cheap: submodules load on first attribute access,
and no kernel is built until a CUDA tensor reaches one.  The port imports
neither JAX nor the JAX package.
"""

from __future__ import annotations

import importlib

_LAZY = {
    "Predictor": "predict",
    "prepare_input": "predict",
    "build_model": "models",
    "InferenceService": "serve.service",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    if name in _LAZY:
        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
