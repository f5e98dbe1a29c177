"""Model zoo of the port: DANet, DeepLabV3, DeepLabV3+ and FCN on a
dilated ResNet.

``build_model`` mirrors ``distributedpytorch_tpu.models.build_model`` for
``danet``, ``deeplabv3``, ``deeplabv3plus`` and ``fcn``; the JAX
package's ``pspnet``, ``encnet`` and ``ccnet`` are not ported yet and
raise.
"""

from __future__ import annotations

import torch
from torch import nn

from ..train.precision import torch_dtype
from .danet import DANet, DANetHead
from .deeplab import ASPP, FCN, DeepLabV3, FCNHead, set_dropout
from .resnet import ResNet, set_cross_replica, set_fp32_stats

_BACKBONE_DEPTH = {"resnet18": 18, "resnet34": 34, "resnet50": 50,
                   "resnet101": 101, "resnet152": 152}
#: the families of the port, and those of the JAX package still to port
PORTED_MODELS = ("danet", "deeplabv3", "deeplabv3plus", "fcn")
UNPORTED_MODELS = ("pspnet", "encnet", "ccnet")


def build_model(name: str = "danet", nclass: int = 1,
                backbone: str = "resnet101", output_stride: int | None = None,
                attention_impl: str = "auto", in_channels: int = 4,
                dropout_rate: float | None = None,
                dtype: str | torch.dtype | None = "float32",
                pam_score_dtype: str | torch.dtype | None = None,
                remat: bool = False, remat_policy: str | None = None,
                aux_head: bool = False,
                encnet_codes: int = 32, ccnet_recurrence: int = 2,
                bn_cross_replica: bool = False,
                bn_fp32_stats: bool = True,
                guidance_inject: str = "stem", pam_impl: str = "",
                pam_block_size: int | None = None, moe_experts: int = 0,
                moe_hidden: int | None = None, moe_k: int = 1,
                moe_capacity_factor: float = 1.25) -> nn.Module:
    """Construct a segmentation model by name: ``danet``, ``deeplabv3``,
    ``deeplabv3plus`` or ``fcn``, each at the JAX package's default
    output stride (8 for DANet and FCN, 16 for DeepLab) unless given.

    ``attention_impl`` is DANet's one knob for both attention branches:
    ``auto`` (CUDA kernels on a CUDA tensor, plain forms on the CPU),
    ``xla`` (plain forms everywhere) or ``flash`` (kernels).  A non-empty
    ``pam_impl`` (``auto`` | ``einsum`` | ``flash``; ``ring`` is not
    ported) overrides it for the position branch only, and
    ``pam_block_size`` picks the blocked position form (see
    ``models/danet.py``).  ``moe_experts > 0`` adds the head's MoE FFN
    of ``moe_hidden`` (the fused channels when None) units per expert,
    top-``moe_k`` routing at ``moe_capacity_factor`` (``parallel/moe.py``).
    ``dropout_rate`` is DANet's head dropout (flax's 0.1 when ``None``);
    the DeepLab family's rates are fixed (ASPP 0.5, FCN heads 0.1), and
    ``dropout_rate=0.0`` turns them off for parity runs.
    ``dtype`` is the compute dtype (parameters stay float32),
    ``pam_score_dtype`` the dtype DANet's plain position branch rounds its
    scores to, ``remat`` recomputes the backbone's blocks in the
    backward, keeping what ``remat_policy`` (a zero-argument
    ``jax.checkpoint_policies`` name, looked up only with ``remat``) saves.
    ``bn_cross_replica`` makes every BatchNorm take its
    train-mode statistics over the process group (the JAX
    ``bn_cross_replica_axis``; ``ops/sync_bn.py``), ``bn_fp32_stats=False``
    in the compute dtype rather than float32 (flax's
    ``force_float32_reductions``).  ``aux_head`` adds
    the FCN head on ``c3`` to DeepLab and FCN; ``aux_head``,
    ``encnet_codes`` and ``ccnet_recurrence`` raise away from their
    defaults on a family that lacks them, DANet's knobs on the others,
    as in the JAX package.  ``guidance_inject`` is DANet's: ``stem`` (the
    backbone takes the whole concat) or ``head`` (the backbone takes the
    RGB channels, the guidance joins at the head; the model then runs
    ``stage="encode"`` and ``stage="decode"`` apart).

    The model keeps these arguments as ``build_args`` (dtypes by name):
    the architecture an AOT package of it is built for
    (``serve/aot.cache_fingerprint``)."""
    build_args = {k: v if v is None or isinstance(v, (str, int, float))
                  else str(v).removeprefix("torch.")
                  for k, v in locals().items()}
    if name in UNPORTED_MODELS:
        raise ValueError(f"model {name!r} is not ported "
                         f"({' | '.join(PORTED_MODELS)})")
    if name not in PORTED_MODELS:
        raise ValueError(
            f"unknown model: {name!r} (danet | deeplabv3 | deeplabv3plus | "
            "fcn | pspnet | encnet | ccnet)")
    if name != "danet":
        # the JAX package's order and accepted defaults (pam_impl: the
        # inherit sentinel and the spelled-out legacy default)
        for knob, value, defaults in (
                ("pam_block_size", pam_block_size, (None,)),
                ("pam_impl", pam_impl, ("", "einsum")),
                ("attention_impl", attention_impl, ("auto",)),
                ("pam_score_dtype", pam_score_dtype, (None,)),
                ("moe_experts", moe_experts, (0,)),
                ("moe_hidden", moe_hidden, (None,)),
                ("moe_k", moe_k, (1,)),
                ("moe_capacity_factor", moe_capacity_factor, (1.25,)),
                ("guidance_inject", guidance_inject, ("stem",))):
            if value not in defaults:
                raise ValueError(f"{knob} is DANet-only; model {name!r} "
                                 "does not support it")
    if encnet_codes != 32:
        raise ValueError(
            f"encnet_codes is EncNet-only; model {name!r} does not "
            "support it")
    if ccnet_recurrence != 2:
        raise ValueError(
            f"ccnet_recurrence is CCNet-only; model {name!r} does not "
            "support it")
    if backbone not in _BACKBONE_DEPTH:
        raise ValueError(f"unknown backbone {backbone!r} "
                         f"({' | '.join(_BACKBONE_DEPTH)})")
    depth = _BACKBONE_DEPTH[backbone]
    dtype = None if dtype is None else torch_dtype(dtype)
    if name == "danet":
        if aux_head:
            raise ValueError("aux_head is a DeepLabV3/FCN/PSPNet option; "
                             "DANet's three heads already provide "
                             "multi-output supervision")
        model = DANet(nclass=nclass, backbone_depth=depth,
                      output_stride=output_stride or 8,
                      in_channels=in_channels,
                      attention_impl=attention_impl,
                      dropout_rate=0.1 if dropout_rate is None
                      else dropout_rate,
                      dtype=dtype,
                      pam_score_dtype=None if pam_score_dtype is None
                      else torch_dtype(pam_score_dtype),
                      remat=remat, remat_policy=remat_policy,
                      guidance_inject=guidance_inject, pam_impl=pam_impl,
                      pam_block_size=pam_block_size,
                      moe_experts=moe_experts, moe_hidden=moe_hidden,
                      moe_k=moe_k, moe_capacity_factor=moe_capacity_factor)
    else:
        if dropout_rate not in (None, 0.0):
            raise ValueError(
                f"model {name!r} has fixed dropout rates (ASPP 0.5, FCN "
                f"heads 0.1); dropout_rate takes None or 0.0, got "
                f"{dropout_rate}")
        if name == "fcn":
            model = FCN(nclass=nclass, backbone_depth=depth,
                        output_stride=output_stride or 8, aux_head=aux_head,
                        in_channels=in_channels, dtype=dtype, remat=remat,
                        remat_policy=remat_policy)
        else:
            model = DeepLabV3(nclass=nclass, backbone_depth=depth,
                              output_stride=output_stride or 16,
                              aux_head=aux_head,
                              decoder=name == "deeplabv3plus",
                              in_channels=in_channels, dtype=dtype,
                              remat=remat, remat_policy=remat_policy)
        set_dropout(model, dropout_rate is None)
    set_cross_replica(model, bn_cross_replica)
    set_fp32_stats(model, bn_fp32_stats)
    model.build_args = build_args
    return model

__all__ = ["ASPP", "DANet", "DANetHead", "DeepLabV3", "FCN", "FCNHead",
           "ResNet", "build_model"]
