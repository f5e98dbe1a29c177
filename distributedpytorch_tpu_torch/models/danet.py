"""DANet, the dual-attention segmentation network (NCHW), the counterpart
of ``distributedpytorch_tpu/models/danet.py``: both guidance injections
(``stem`` and ``head``) and the ``head`` model's three stages (``full``,
``encode`` and ``decode``).

A dilated ResNet feeds two attention branches over its stage-4 features:
position attention (self-attention over the H/8 x W/8 tokens) and channel
attention (Gram matrix over channels).  ``forward`` returns the fused,
position and channel logits, bilinearly upsampled to the input size with
half-pixel centres (``align_corners=False``, as ``jax.image.resize``).

``impl`` keeps the JAX knob names.  ``flash`` runs the hand-written CUDA
kernels (``ops/cuda_attention.py``), ``einsum`` the plain PyTorch forms,
and ``auto`` — the default — picks the kernels for a CUDA tensor and the
plain forms on the CPU, whatever the dtype (JAX's ``auto`` crossover,
``AUTO_FLASH_MIN_TOKENS``, was measured on a TPU and is not carried
over).  The kernels are autograd functions whose backward recomputes
through the plain forms, so a train step differentiates through them.
The position branch has its own ``pam_impl`` (``model.pam_impl``, which
overrides ``attention_impl`` there) and ``pam_block_size``: ``einsum``
with a block size runs the blocked online-softmax form, without one the
full form; ``flash`` runs the kernel, whose tiles are its own (JAX hands
the block size to the Pallas kernel as its VMEM tiles), and the block
size sets only the key block of the plain form its backward recomputes
through (256 when unset).  ``ring`` (sequence parallelism) is not ported
and raises ``NotImplementedError``.

``moe_experts > 0`` puts the mixture-of-experts FFN (``parallel/moe.py``)
on the fused features, between the two branches and the fused
classifier, in float32 whatever the compute dtype; ``forward(...,
with_aux=True)`` also returns its load-balancing loss (0 without an MoE),
which the train step weights into the loss.

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

``guidance_inject`` picks where the click guidance (the input's last
channel) enters.  ``stem``: the backbone takes the whole RGB + guidance
concat.  ``head``: the backbone takes the RGB channels only (its stem conv
has ``in_channels - 1`` inputs, as flax infers from ``x[..., :-1]``), and
the guidance, resized to the stage-4 grid, goes through a zero-init,
bias-free 1x1 ``guidance_proj`` (1 -> C) added to the stage-4 features
before the head.  The backbone's output is then a function of the image
alone: ``stage="encode"`` computes it once per session, ``stage="decode"``
runs the head on it with each click's guidance (``serve/sessions.py``).
The guidance's downsample antialiases, as ``jax.image.resize`` does when
it shrinks: on random [0, 1] maps at 512 -> 64, torch's
``antialias=False`` is 0.43 off it, ``antialias=True`` within 2e-7.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import cuda_attention
from ..ops.attention import (
    blocked_position_attention,
    channel_attention,
    position_attention,
)
from ..parallel.moe import MoEMlp
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
    """Spatial self-attention with a learned residual gate ``gamma``.

    ``impl``: ``auto`` | ``einsum`` | ``flash`` | ``ring`` (not ported);
    ``block_size``: the blocked form's key block under ``einsum`` (None:
    the full form), the backward's under ``flash``.  ``score_dtype``
    acts on the full form only, as in JAX."""

    def __init__(self, channels: int, impl: str = "auto",
                 score_dtype: torch.dtype | None = None,
                 block_size: int | None = None):
        super().__init__()
        self.query = Conv2d(channels, channels // 8, 1)
        self.key = Conv2d(channels, channels // 8, 1)
        self.value = Conv2d(channels, channels, 1)
        self.gamma = nn.Parameter(torch.zeros(()))
        self.impl = impl
        self.score_dtype = score_dtype
        self.block_size = block_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, _, h, w = x.shape
        if self.impl == "ring":
            raise NotImplementedError(
                "model.pam_impl=ring is not ported: sequence-parallel "
                "position attention needs the sequence-parallel mesh")
        if self.impl not in ("auto", "einsum", "flash"):
            raise ValueError(f"unknown attention impl: {self.impl!r} "
                             "(auto | einsum | flash | ring)")
        q, k, v = (_tokens(f(x)) for f in (self.query, self.key, self.value))
        impl = _resolve(self.impl, x)
        if impl == "flash":
            out = cuda_attention.flash_position_attention(
                q, k, v, block_k=self.block_size or 256)
        elif self.block_size is None:
            out = position_attention(q, k, v, score_dtype=self.score_dtype)
        else:
            out = blocked_position_attention(q, k, v, self.block_size)
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
    """conv-in -> {PAM, CAM} -> conv-out -> [MoE on the fused sum] -> three
    1x1 classifiers; returns ``((fused, pam, cam) logits at feature
    resolution, the MoE's auxiliary loss or None)``."""

    def __init__(self, in_channels: int, nclass: int, impl: str = "auto",
                 dropout_rate: float = 0.1,
                 pam_score_dtype: torch.dtype | None = None,
                 pam_block_size: int | None = None, moe_experts: int = 0,
                 moe_hidden: int | None = None, moe_k: int = 1,
                 moe_capacity_factor: float = 1.25):
        super().__init__()
        inter = max(in_channels // 4, 1)
        for branch in ("pam", "cam"):
            self.add_module(f"{branch}_in_conv", conv(in_channels, inter, 3))
            self.add_module(f"{branch}_in_bn", norm(inter))
            self.add_module(f"{branch}_out_conv", conv(inter, inter, 3))
            self.add_module(f"{branch}_out_bn", norm(inter))
        self.pam = PositionAttentionModule(inter, impl, pam_score_dtype,
                                           pam_block_size)
        self.cam = ChannelAttentionModule(impl)
        self.moe = MoEMlp(inter, moe_experts, moe_hidden or inter, moe_k,
                          moe_capacity_factor) if moe_experts > 0 else None
        self.dropout_rate = dropout_rate
        self.fused_cls = Conv2d(inter, nclass, 1)
        self.pam_cls = Conv2d(inter, nclass, 1)
        self.cam_cls = Conv2d(inter, nclass, 1)

    def _conv_bn_relu(self, x: torch.Tensor, name: str) -> torch.Tensor:
        conv_, bn = getattr(self, f"{name}_conv"), getattr(self, f"{name}_bn")
        return F.relu(bn(conv_(x)))

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None
                ) -> tuple[tuple[torch.Tensor, ...], torch.Tensor | None]:
        pa = self._conv_bn_relu(x, "pam_in")
        pa = self._conv_bn_relu(self.pam(pa), "pam_out")
        ca = self._conv_bn_relu(x, "cam_in")
        ca = self._conv_bn_relu(self.cam(ca), "cam_out")
        fused = pa + ca
        aux = None
        if self.moe is not None:
            # the whole batch's tokens, row-major, in float32 (float64 for
            # a float64 model), back in the compute dtype after
            _, _, h, w = fused.shape
            acc = torch.promote_types(fused.dtype, torch.float32)
            tokens, aux = self.moe(_tokens(fused.to(acc)))
            fused = _untokens(tokens, h, w).to(
                fused.dtype, memory_format=torch.contiguous_format)

        def drop(y):
            return dropout(y, self.dropout_rate, self.training, generator)

        return (self.fused_cls(drop(fused)), self.pam_cls(drop(pa)),
                self.cam_cls(drop(ca))), aux


def resize_guidance(g: torch.Tensor, size) -> torch.Tensor:
    """The guidance (B, 1, H, W) bilinearly resized to ``size`` as
    ``jax.image.resize`` resizes it: half-pixel centres, antialiased when
    it shrinks.  It interpolates in float32 (torch has no bf16 antialiased
    resize on the CPU) and returns ``g``'s dtype: in bf16 within one
    rounding of JAX's bf16 arithmetic."""
    return F.interpolate(g.float(), size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=True).to(g.dtype)


class DANet(nn.Module):
    """Backbone + dual-attention head.  ``forward(x)`` with ``x`` the
    (B, C, H, W) RGB + guidance crop -> ``(fused, pam, cam)`` logits, each
    (B, nclass, H, W) in the compute dtype; in train mode ``generator``
    draws the dropout masks.

    A ``guidance_inject="head"`` model also runs its stages apart:
    ``stage="encode"`` takes the (B, C - 1, H, W) RGB crop and returns the
    stage-4 features (B, C_feat, H / os, W / os); ``stage="decode"`` takes
    ``x = (features, guidance)`` with the guidance (B, 1, H, W) in crop
    space and returns the logits at ``out_size``.  ``decode(encode(rgb),
    g)`` is the full forward of the concat, op for op."""

    def __init__(self, nclass: int = 1, backbone_depth: int = 101,
                 output_stride: int = 8, in_channels: int = 4,
                 attention_impl: str = "auto", dropout_rate: float = 0.1,
                 dtype: torch.dtype | None = None,
                 pam_score_dtype: torch.dtype | None = None,
                 remat: bool = False, remat_policy: str | None = None,
                 guidance_inject: str = "stem", pam_impl: str = "",
                 pam_block_size: int | None = None, moe_experts: int = 0,
                 moe_hidden: int | None = None, moe_k: int = 1,
                 moe_capacity_factor: float = 1.25):
        super().__init__()
        if guidance_inject not in ("stem", "head"):
            raise ValueError(f"unknown guidance_inject: "
                             f"{guidance_inject!r} (stem | head)")
        self.nclass = nclass
        self.guidance_inject = guidance_inject
        head = guidance_inject == "head"
        self.backbone = ResNet(depth=backbone_depth,
                               output_stride=output_stride,
                               in_channels=in_channels - 1 if head
                               else in_channels, remat=remat,
                               remat_policy=remat_policy)
        if head:
            c = self.backbone.out_channels
            self.guidance_proj = Conv2d(1, c, 1, bias=False)
        self.head = DANetHead(self.backbone.out_channels, nclass,
                              dropout_rate=dropout_rate,
                              pam_score_dtype=pam_score_dtype,
                              pam_block_size=pam_block_size,
                              moe_experts=moe_experts, moe_hidden=moe_hidden,
                              moe_k=moe_k,
                              moe_capacity_factor=moe_capacity_factor)
        flax_init_(self)
        if head:
            with torch.no_grad():
                self.guidance_proj.weight.zero_()
        if self.head.moe is not None:
            # its own generator, seeded by one draw of the global one: a
            # model built twice under one seed is the same model
            seed = int(torch.randint(2**62, (), device="cpu"))
            self.head.moe.reset_parameters(
                torch.Generator().manual_seed(seed))
        self.set_attention_impl(attention_impl)
        if pam_impl:
            self.head.pam.impl = pam_impl
        self.set_compute_dtype(dtype)

    def set_compute_dtype(self, dtype: torch.dtype | None) -> None:
        """Compute in ``dtype`` with the parameters left as they are
        (float32 master weights); ``None`` or float32 computes in the
        parameters' own dtype."""
        set_compute_dtype(self, dtype)
        self.compute_dtype = None if dtype in (None, torch.float32) else dtype

    def set_attention_impl(self, attention_impl: str) -> None:
        """Switch both branches: ``auto`` | ``xla`` (plain forms) |
        ``flash`` (CUDA kernels), a ``pam_impl`` override included.  The
        impls are parameter-free."""
        try:
            impl = ATTENTION_IMPLS[attention_impl]
        except KeyError:
            raise ValueError(f"unknown attention_impl: {attention_impl!r} "
                             f"({' | '.join(ATTENTION_IMPLS)})") from None
        self.head.pam.impl = impl
        self.head.cam.impl = impl

    def _cast(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.compute_dtype is None else x.to(self.compute_dtype)

    def _encode(self, x: torch.Tensor) -> torch.Tensor:
        """The backbone's stage-4 features: the session-invariant stage."""
        return self.backbone(x)["c4"]

    def _decode(self, feats: torch.Tensor, guidance: torch.Tensor | None,
                out_size, generator: torch.Generator | None
                ) -> tuple[tuple[torch.Tensor, ...], torch.Tensor | None]:
        """The head on the (guidance-conditioned) stage-4 features, its
        logits upsampled to ``out_size``, and the MoE's aux loss."""
        if guidance is not None:
            feats = feats + self.guidance_proj(
                resize_guidance(guidance, feats.shape[-2:]))
        outs, aux = self.head(feats, generator)
        return tuple(F.interpolate(o, size=tuple(out_size), mode="bilinear",
                                   align_corners=False) for o in outs), aux

    def forward(self, x, generator: torch.Generator | None = None,
                stage: str = "full", out_size=None, with_aux: bool = False):
        """The logits of ``stage`` (the features for ``encode``); with
        ``with_aux``, the logits and the MoE's load-balancing loss, a
        scalar (0 without an MoE)."""
        if stage == "full":
            size = out_size or x.shape[-2:]
            x = self._cast(x)
            if self.guidance_inject == "stem":
                outs, aux = self._decode(self._encode(x), None, size,
                                         generator)
            else:
                # the same concat as the stem model takes: the backbone
                # sees the RGB channels, the guidance re-enters at the head
                outs, aux = self._decode(self._encode(x[:, :-1]), x[:, -1:],
                                         size, generator)
        elif self.guidance_inject != "head":
            raise ValueError(
                f"stage={stage!r} needs guidance_inject='head' — the stem "
                "architecture folds the guidance into the backbone, so "
                "its encoding cannot be reused across clicks")
        elif stage == "encode":
            return self._encode(self._cast(x))
        elif stage == "decode":
            if out_size is None:
                raise ValueError("stage='decode' needs out_size (the "
                                 "logit-map resolution)")
            feats, guidance = x
            outs, aux = self._decode(feats, self._cast(guidance), out_size,
                                     generator)
        else:
            raise ValueError(f"unknown stage: {stage!r} "
                             "(full | encode | decode)")
        if not with_aux:
            return outs
        return outs, torch.zeros((), device=outs[0].device) if aux is None \
            else aux
