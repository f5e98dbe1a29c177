"""Model zoo of the port: DANet on a dilated ResNet.

``build_model`` mirrors ``distributedpytorch_tpu.models.build_model`` for
``name="danet"``; the JAX package's other families are not ported yet and
raise.
"""

from __future__ import annotations

import torch

from ..train.precision import torch_dtype
from .danet import DANet, DANetHead
from .resnet import ResNet, set_cross_replica

_BACKBONE_DEPTH = {"resnet18": 18, "resnet34": 34, "resnet50": 50,
                   "resnet101": 101, "resnet152": 152}


def build_model(name: str = "danet", nclass: int = 1,
                backbone: str = "resnet101", output_stride: int | None = None,
                attention_impl: str = "auto", in_channels: int = 4,
                dropout_rate: float = 0.1,
                dtype: str | torch.dtype | None = "float32",
                pam_score_dtype: str | torch.dtype | None = None,
                remat: bool = False, aux_head: bool = False,
                encnet_codes: int = 32, ccnet_recurrence: int = 2,
                bn_cross_replica: bool = False) -> DANet:
    """Construct a segmentation model by name (``danet`` only).

    ``attention_impl`` is the one knob for both attention branches:
    ``auto`` (CUDA kernels on a CUDA tensor, plain forms on the CPU),
    ``xla`` (plain forms everywhere) or ``flash`` (kernels).
    ``dropout_rate`` is the head's train-mode dropout (flax's 0.1).
    ``dtype`` is the compute dtype (parameters stay float32),
    ``pam_score_dtype`` the dtype the plain position branch rounds its
    scores to, ``remat`` recomputes the backbone's blocks in the
    backward.  ``bn_cross_replica`` makes every BatchNorm take its
    train-mode statistics over the process group (the JAX
    ``bn_cross_replica_axis``; ``ops/sync_bn.py``).
    ``aux_head``, ``encnet_codes`` and ``ccnet_recurrence``
    belong to other families and raise away from their defaults, as in the
    JAX package."""
    if name != "danet":
        raise ValueError(f"model {name!r} is not ported (danet only)")
    if encnet_codes != 32:
        raise ValueError(
            f"encnet_codes is EncNet-only; model {name!r} does not "
            "support it")
    if ccnet_recurrence != 2:
        raise ValueError(
            f"ccnet_recurrence is CCNet-only; model {name!r} does not "
            "support it")
    if aux_head:
        raise ValueError("aux_head is a DeepLabV3/FCN/PSPNet option; DANet's "
                         "three heads already provide multi-output "
                         "supervision")
    if backbone not in _BACKBONE_DEPTH:
        raise ValueError(f"unknown backbone {backbone!r} "
                         f"({' | '.join(_BACKBONE_DEPTH)})")
    model = DANet(nclass=nclass, backbone_depth=_BACKBONE_DEPTH[backbone],
                  output_stride=output_stride or 8, in_channels=in_channels,
                  attention_impl=attention_impl, dropout_rate=dropout_rate,
                  dtype=None if dtype is None else torch_dtype(dtype),
                  pam_score_dtype=None if pam_score_dtype is None
                  else torch_dtype(pam_score_dtype),
                  remat=remat)
    set_cross_replica(model, bn_cross_replica)
    return model


__all__ = ["DANet", "DANetHead", "ResNet", "build_model"]
