"""Model zoo of the port: DANet on a dilated ResNet.

``build_model`` mirrors ``distributedpytorch_tpu.models.build_model`` for
``name="danet"``; the JAX package's other families are not ported yet and
raise.
"""

from __future__ import annotations

import torch

from ..train.precision import torch_dtype
from .danet import DANet, DANetHead
from .resnet import ResNet

_BACKBONE_DEPTH = {"resnet18": 18, "resnet34": 34, "resnet50": 50,
                   "resnet101": 101, "resnet152": 152}


def build_model(name: str = "danet", nclass: int = 1,
                backbone: str = "resnet101", output_stride: int | None = None,
                attention_impl: str = "auto", in_channels: int = 4,
                dropout_rate: float = 0.1,
                dtype: str | torch.dtype | None = "float32",
                pam_score_dtype: str | torch.dtype | None = None,
                remat: bool = False) -> DANet:
    """Construct a segmentation model by name (``danet`` only).

    ``attention_impl`` is the one knob for both attention branches:
    ``auto`` (CUDA kernels on a CUDA tensor, plain forms on the CPU),
    ``xla`` (plain forms everywhere) or ``flash`` (kernels).
    ``dropout_rate`` is the head's train-mode dropout (flax's 0.1).
    ``dtype`` is the compute dtype (parameters stay float32),
    ``pam_score_dtype`` the dtype the plain position branch rounds its
    scores to, ``remat`` recomputes the backbone's blocks in the
    backward."""
    if name != "danet":
        raise ValueError(f"model {name!r} is not ported (danet only)")
    if backbone not in _BACKBONE_DEPTH:
        raise ValueError(f"unknown backbone {backbone!r} "
                         f"({' | '.join(_BACKBONE_DEPTH)})")
    return DANet(nclass=nclass, backbone_depth=_BACKBONE_DEPTH[backbone],
                 output_stride=output_stride or 8, in_channels=in_channels,
                 attention_impl=attention_impl, dropout_rate=dropout_rate,
                 dtype=None if dtype is None else torch_dtype(dtype),
                 pam_score_dtype=None if pam_score_dtype is None
                 else torch_dtype(pam_score_dtype),
                 remat=remat)


__all__ = ["DANet", "DANetHead", "ResNet", "build_model"]
