"""DeepLabV3, DeepLabV3+ and FCN (NCHW), the counterpart of
``distributedpytorch_tpu/models/deeplab.py``.

A dilated ResNet feeds a context head: ASPP (four parallel branches and
an image-pool branch, concatenated and projected) for DeepLabV3, ASPP and
a decoder that fuses the stride-4 ``c1`` features for DeepLabV3+, a plain
3x3 head for FCN.  ``aux_head`` adds an FCN head on ``c3``.  ``forward``
returns the tuple of logits, primary first, each bilinearly upsampled to
the input size by target size with half-pixel centres (``align_corners
=False``, as ``jax.image.resize``; every resize of these models is an
upsample, so its antialiasing never applies).

Submodules carry the flax names — ``aspp.b0_conv``, ``decoder.low_proj``,
``classifier`` — and the auto-numbered ``Conv_0``/``BatchNorm_0``/
``Conv_1`` of the unnamed layers inside ``FCNHead``, so a JAX tree loads
strictly (``utils/weights.py``).

Dropout (ASPP 0.5 after the projection, FCN heads 0.1 before their
classifier) follows flax's ``nn.Dropout`` with masks drawn from the
``generator`` passed to ``forward``; ``dropout_rate`` on each module is 0
for parity runs.  ``dtype`` is the compute dtype on float32 parameters,
as for DANet (``resnet.set_compute_dtype``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .danet import dropout
from .resnet import Conv2d, ResNet, conv, flax_init_, norm, set_compute_dtype


def _resize_bilinear(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Bilinear resize to ``size`` (H, W), half-pixel centres, by size, in
    float32 and returned in ``x``'s dtype.  For a bf16 ``x`` this is the
    JAX resize up to one bf16 rounding (JAX rounds after each of its two
    separable passes, this once), and it keeps the backward off torch's
    bf16 upsample gradient, whose atomic adds took 68 ms of a 155 ms bf16
    config-4 step on the H100 against 17 ms in float32."""
    return F.interpolate(x.float(), size=tuple(size), mode="bilinear",
                         align_corners=False).to(x.dtype)


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: a 1x1 branch, one dilated 3x3
    branch per rate and an image-pool branch (global mean -> 1x1 ->
    broadcast), each conv-BN-ReLU, concatenated, projected by a 1x1
    conv-BN-ReLU and dropped out."""

    def __init__(self, in_channels: int, channels: int, rates: Sequence[int],
                 dropout_rate: float = 0.5):
        super().__init__()
        self.rates = tuple(rates)
        self.dropout_rate = dropout_rate
        self._branch("b0", conv(in_channels, channels, 1), channels)
        for i, r in enumerate(self.rates):
            self._branch(f"b{i + 1}", conv(in_channels, channels, 3,
                                           dilation=r), channels)
        self._branch("pool", conv(in_channels, channels, 1), channels)
        self._branch("project", conv(channels * (len(self.rates) + 2),
                                     channels, 1), channels)

    def _branch(self, name: str, layer: nn.Module, channels: int) -> None:
        self.add_module(f"{name}_conv", layer)
        self.add_module(f"{name}_bn", norm(channels))

    def _run(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.relu(getattr(self, f"{name}_bn")(getattr(self, f"{name}_conv")(x)))

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        outs = [self._run(f"b{i}", x) for i in range(len(self.rates) + 1)]
        pooled = self._run("pool", x.mean(dim=(2, 3), keepdim=True))
        outs.append(pooled.expand(-1, -1, *x.shape[2:]))
        y = self._run("project", torch.cat(outs, dim=1))
        return dropout(y, self.dropout_rate, self.training, generator)


class FCNHead(nn.Module):
    """3x3 conv-BN-ReLU to a quarter of the channels, dropout, 1x1
    classifier (with bias): FCN's head and the auxiliary head."""

    def __init__(self, in_channels: int, nclass: int,
                 dropout_rate: float = 0.1):
        super().__init__()
        inter = max(in_channels // 4, 1)
        self.dropout_rate = dropout_rate
        self.Conv_0 = conv(in_channels, inter, 3)
        self.BatchNorm_0 = norm(inter)
        self.Conv_1 = Conv2d(inter, nclass, 1)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = dropout(y, self.dropout_rate, self.training, generator)
        return self.Conv_1(y)


class DecoderV3Plus(nn.Module):
    """DeepLabV3+'s decoder: the ASPP features upsampled to ``c1``'s size
    and concatenated with ``c1`` projected to ``low_channels`` (1x1
    conv-BN-ReLU), refined by two 3x3 conv-BN-ReLU."""

    def __init__(self, in_channels: int, low_in: int, channels: int,
                 low_channels: int = 48):
        super().__init__()
        self.low_proj = conv(low_in, low_channels, 1)
        self.low_bn = norm(low_channels)
        cin = in_channels + low_channels
        for i in range(2):
            self.add_module(f"refine{i}_conv", conv(cin, channels, 3))
            self.add_module(f"refine{i}_bn", norm(channels))
            cin = channels

    def forward(self, y: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
        low = F.relu(self.low_bn(self.low_proj(low)))
        y = torch.cat([_resize_bilinear(y, low.shape[2:]), low], dim=1)
        for i in range(2):
            y = F.relu(getattr(self, f"refine{i}_bn")(
                getattr(self, f"refine{i}_conv")(y)))
        return y


class _Segmenter(nn.Module):
    """What the families share: the backbone, the compute dtype, the
    auxiliary head on ``c3`` and the upsample of every output."""

    def _init_backbone(self, nclass: int, backbone_depth: int,
                       output_stride: int, in_channels: int, aux_head: bool,
                       remat: bool, remat_policy: str | None,
                       multi_grid=None) -> None:
        self.nclass = nclass
        self.output_stride = output_stride
        self.backbone = ResNet(depth=backbone_depth,
                               output_stride=output_stride,
                               in_channels=in_channels, remat=remat,
                               multi_grid=multi_grid,
                               remat_policy=remat_policy)
        self.compute_dtype = None
        c4 = self.backbone.out_channels
        # c3 has half of c4's channels, c1 an eighth (a quarter of c2's)
        self._c3, self._c1 = c4 // 2, c4 // 8
        self.aux = FCNHead(self._c3, nclass) if aux_head else None

    def set_compute_dtype(self, dtype: torch.dtype | None) -> None:
        """Compute in ``dtype`` with the parameters left as they are
        (float32 master weights); ``None`` or float32 computes in the
        parameters' own dtype."""
        set_compute_dtype(self, dtype)
        self.compute_dtype = None if dtype in (None, torch.float32) else dtype

    def _head(self, feats: dict, generator) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None
                ) -> tuple[torch.Tensor, ...]:
        size = x.shape[-2:]
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        feats = self.backbone(x)
        outs = [_resize_bilinear(self._head(feats, generator), size)]
        if self.aux is not None:
            outs.append(_resize_bilinear(self.aux(feats["c3"], generator),
                                         size))
        return tuple(outs)


class DeepLabV3(_Segmenter):
    """Dilated ResNet (stage 4 multi-grid ``(1, 2, 4)``) + ASPP (rates 6,
    12, 18 at output stride 16, doubled otherwise) + 1x1 classifier;
    ``decoder`` makes it DeepLabV3+.  ``forward(x)`` -> ``(logits,)`` or
    ``(logits, aux_logits)`` at the input size."""

    def __init__(self, nclass: int = 21, backbone_depth: int = 50,
                 output_stride: int = 16, aspp_channels: int = 256,
                 aux_head: bool = False, decoder: bool = False,
                 in_channels: int = 3, dtype: torch.dtype | None = None,
                 remat: bool = False, remat_policy: str | None = None):
        super().__init__()
        self._init_backbone(nclass, backbone_depth, output_stride,
                            in_channels, aux_head, remat, remat_policy,
                            multi_grid=(1, 2, 4))
        rates = (6, 12, 18) if output_stride == 16 else (12, 24, 36)
        self.aspp = ASPP(self.backbone.out_channels, aspp_channels, rates)
        self.decoder = DecoderV3Plus(aspp_channels, self._c1, aspp_channels) \
            if decoder else None
        self.classifier = Conv2d(aspp_channels, nclass, 1)
        flax_init_(self)
        self.set_compute_dtype(dtype)

    def _head(self, feats: dict, generator) -> torch.Tensor:
        y = self.aspp(feats["c4"], generator)
        if self.decoder is not None:
            y = self.decoder(y, feats["c1"])
        return self.classifier(y)


class FCN(_Segmenter):
    """Dilated ResNet + FCN head on ``c4`` (torchvision's ``fcn_resnet``
    structure).  ``forward(x)`` -> ``(logits,)`` or ``(logits,
    aux_logits)`` at the input size."""

    def __init__(self, nclass: int = 21, backbone_depth: int = 50,
                 output_stride: int = 8, aux_head: bool = False,
                 in_channels: int = 3, dtype: torch.dtype | None = None,
                 remat: bool = False, remat_policy: str | None = None):
        super().__init__()
        self._init_backbone(nclass, backbone_depth, output_stride,
                            in_channels, aux_head, remat, remat_policy)
        self.head = FCNHead(self.backbone.out_channels, nclass)
        flax_init_(self)
        self.set_compute_dtype(dtype)

    def _head(self, feats: dict, generator) -> torch.Tensor:
        return self.head(feats["c4"], generator)


def set_dropout(model: nn.Module, on: bool) -> None:
    """Dropout of every ASPP and FCN head at flax's rates (ASPP 0.5, the
    heads 0.1), or off (rate 0) for parity runs."""
    for module in model.modules():
        if isinstance(module, ASPP):
            module.dropout_rate = 0.5 if on else 0.0
        elif isinstance(module, FCNHead):
            module.dropout_rate = 0.1 if on else 0.0
