"""DANet, the dual-attention segmentation network (NCHW), the counterpart
of ``distributedpytorch_tpu/models/danet.py`` with ``guidance_inject="stem"``
and ``stage="full"``.

A dilated ResNet feeds two attention branches over its stage-4 features:
position attention (self-attention over the H/8 x W/8 tokens) and channel
attention (Gram matrix over channels).  ``forward`` returns the fused,
position and channel logits, bilinearly upsampled to the input size with
half-pixel centres (``align_corners=False``, as ``jax.image.resize``).

``impl`` keeps the JAX knob names.  ``flash`` runs the hand-written CUDA
kernels (``ops/cuda_attention.py``), ``einsum`` the plain PyTorch forms,
and ``auto`` — the default — picks the kernels for a CUDA tensor and the
plain forms on the CPU, whatever the dtype.  The kernels are autograd
functions whose backward recomputes through the plain forms, so a train
step differentiates through them.

In train mode the head drops out (rate 0.1, before each classifier) with
masks drawn from the ``generator`` passed to ``forward`` — the train
state's, never the global RNG.  JAX's masks come from its own PRNG and
cannot be reproduced bit for bit; parity runs use rate 0.

``dtype`` is flax's compute dtype: ``bfloat16`` keeps every parameter
float32 and computes each conv in bf16 (``resnet.set_compute_dtype``);
the input is cast to it at the model's entry, the residual gates follow
the activations' dtype, and the logits come out in it.  The kernels take
bf16 tokens on their bf16 paths.  The final upsample interpolates in the
compute dtype, as ``jax.image.resize`` does (its bilinear weights are cast
to the input's dtype); torch accumulates each output in float32 and rounds
once, where JAX rounds after each of its two separable contractions, so
the two differ by at most a bf16 rounding of the intermediate.
``pam_score_dtype`` rounds the position branch's N x N scores on the plain
path (the kernels never hold them), and ``remat`` recomputes the
backbone's blocks in the backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import cuda_attention
from ..ops.attention import channel_attention, position_attention
from .resnet import Conv2d, ResNet, conv, flax_init_, norm, set_compute_dtype

#: build_model's one knob for both branches -> the branch impl
ATTENTION_IMPLS = {"auto": "auto", "xla": "einsum", "flash": "flash"}


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> contiguous (B, H*W, C), the JAX token layout."""
    return x.flatten(2).transpose(1, 2).contiguous()


def _untokens(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], h, w)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - rate`` and scale
    the kept values by ``1 / (1 - rate)``; the identity in eval mode."""
    if not training or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _resolve(impl: str, x: torch.Tensor) -> str:
    if impl not in ("auto", "einsum", "flash"):
        raise ValueError(f"unknown attention impl: {impl!r} "
                         "(auto | einsum | flash)")
    if impl == "auto":
        return "flash" if x.is_cuda else "einsum"
    return impl


class PositionAttentionModule(nn.Module):
    """Spatial self-attention with a learned residual gate ``gamma``."""

    def __init__(self, channels: int, impl: str = "auto",
                 score_dtype: torch.dtype | None = None):
        super().__init__()
        self.query = Conv2d(channels, channels // 8, 1)
        self.key = Conv2d(channels, channels // 8, 1)
        self.value = Conv2d(channels, channels, 1)
        self.gamma = nn.Parameter(torch.zeros(()))
        self.impl = impl
        self.score_dtype = score_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, _, h, w = x.shape
        q, k, v = (_tokens(f(x)) for f in (self.query, self.key, self.value))
        impl = _resolve(self.impl, x)
        if impl == "flash":
            out = cuda_attention.flash_position_attention(q, k, v)
        else:
            out = position_attention(q, k, v, score_dtype=self.score_dtype)
        return self.gamma.to(x.dtype) * _untokens(out, h, w) + x


class ChannelAttentionModule(nn.Module):
    """Channel Gram-matrix attention with a learned residual gate."""

    def __init__(self, impl: str = "auto"):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(()))
        self.impl = impl

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, _, h, w = x.shape
        tokens = _tokens(x)
        impl = _resolve(self.impl, x)
        if impl == "flash":
            out = cuda_attention.flash_channel_attention(tokens)
        else:
            out = channel_attention(tokens)
        return self.gamma.to(x.dtype) * _untokens(out, h, w) + x


class DANetHead(nn.Module):
    """conv-in -> {PAM, CAM} -> conv-out -> three 1x1 classifiers; returns
    ``(fused, pam, cam)`` logits at feature resolution."""

    def __init__(self, in_channels: int, nclass: int, impl: str = "auto",
                 dropout_rate: float = 0.1,
                 pam_score_dtype: torch.dtype | None = None):
        super().__init__()
        inter = max(in_channels // 4, 1)
        for branch in ("pam", "cam"):
            self.add_module(f"{branch}_in_conv", conv(in_channels, inter, 3))
            self.add_module(f"{branch}_in_bn", norm(inter))
            self.add_module(f"{branch}_out_conv", conv(inter, inter, 3))
            self.add_module(f"{branch}_out_bn", norm(inter))
        self.pam = PositionAttentionModule(inter, impl, pam_score_dtype)
        self.cam = ChannelAttentionModule(impl)
        self.dropout_rate = dropout_rate
        self.fused_cls = Conv2d(inter, nclass, 1)
        self.pam_cls = Conv2d(inter, nclass, 1)
        self.cam_cls = Conv2d(inter, nclass, 1)

    def _conv_bn_relu(self, x: torch.Tensor, name: str) -> torch.Tensor:
        conv_, bn = getattr(self, f"{name}_conv"), getattr(self, f"{name}_bn")
        return F.relu(bn(conv_(x)))

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None
                ) -> tuple[torch.Tensor, ...]:
        pa = self._conv_bn_relu(x, "pam_in")
        pa = self._conv_bn_relu(self.pam(pa), "pam_out")
        ca = self._conv_bn_relu(x, "cam_in")
        ca = self._conv_bn_relu(self.cam(ca), "cam_out")
        fused = pa + ca

        def drop(y):
            return dropout(y, self.dropout_rate, self.training, generator)

        return (self.fused_cls(drop(fused)), self.pam_cls(drop(pa)),
                self.cam_cls(drop(ca)))


class DANet(nn.Module):
    """Backbone + dual-attention head.  ``forward(x)`` with ``x`` the
    (B, C, H, W) RGB + guidance crop -> ``(fused, pam, cam)`` logits, each
    (B, nclass, H, W) in the compute dtype; in train mode ``generator``
    draws the dropout masks."""

    def __init__(self, nclass: int = 1, backbone_depth: int = 101,
                 output_stride: int = 8, in_channels: int = 4,
                 attention_impl: str = "auto", dropout_rate: float = 0.1,
                 dtype: torch.dtype | None = None,
                 pam_score_dtype: torch.dtype | None = None,
                 remat: bool = False):
        super().__init__()
        self.nclass = nclass
        self.backbone = ResNet(depth=backbone_depth,
                               output_stride=output_stride,
                               in_channels=in_channels, remat=remat)
        self.head = DANetHead(self.backbone.out_channels, nclass,
                              dropout_rate=dropout_rate,
                              pam_score_dtype=pam_score_dtype)
        flax_init_(self)
        self.set_attention_impl(attention_impl)
        self.set_compute_dtype(dtype)

    def set_compute_dtype(self, dtype: torch.dtype | None) -> None:
        """Compute in ``dtype`` with the parameters left as they are
        (float32 master weights); ``None`` or float32 computes in the
        parameters' own dtype."""
        set_compute_dtype(self, dtype)
        self.compute_dtype = None if dtype in (None, torch.float32) else dtype

    def set_attention_impl(self, attention_impl: str) -> None:
        """Switch both branches: ``auto`` | ``xla`` (plain forms) |
        ``flash`` (CUDA kernels).  The impls are parameter-free."""
        try:
            impl = ATTENTION_IMPLS[attention_impl]
        except KeyError:
            raise ValueError(f"unknown attention_impl: {attention_impl!r} "
                             f"({' | '.join(ATTENTION_IMPLS)})") from None
        self.head.pam.impl = impl
        self.head.cam.impl = impl

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None
                ) -> tuple[torch.Tensor, ...]:
        size = x.shape[-2:]
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        outs = self.head(self.backbone(x)["c4"], generator)
        return tuple(F.interpolate(o, size=size, mode="bilinear",
                                   align_corners=False) for o in outs)
