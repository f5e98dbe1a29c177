"""Dilated ResNet backbones (NCHW), the counterpart of
``distributedpytorch_tpu/models/resnet.py``.

Submodules carry flax's auto-numbered names (``Conv_0``, ``BatchNorm_0``,
``BottleneckBlock_7``, ...), so a JAX parameter tree maps onto this
module's ``state_dict`` one leaf to one key (``utils/weights.py``).

flax's ``padding="SAME"`` is not torch's ``padding=k//2``: on a stride-2
layer with an even input it pads one pixel more on the bottom and right
than on the top and left.  :func:`same_pad` computes flax's split, and the
layers pad explicitly where the split is uneven (the 7x7 stem, stride-2
3x3s and the max-pool, which pads with -inf).

Mixed precision follows flax's ``dtype``/``param_dtype``: parameters stay
float32, and a layer with a ``compute_dtype`` (set by
:func:`set_compute_dtype`) casts its input and its weights to that dtype
at use — explicit casts, the same on the CPU and the card, where
``torch.autocast``'s op lists differ between the two.  BatchNorm takes
its bf16 input with float32 statistics and affine parameters (flax's
``force_float32_reductions``: mean and variance in float32, the input
normalised in float32) and returns the compute dtype.

``remat=True`` recomputes each residual block in the backward
(``torch.utils.checkpoint``, non-reentrant), flax's per-block ``nn.remat``.

:func:`set_cross_replica` makes every BatchNorm take its train-mode
statistics over the ranks of the process group (``ops/sync_bn.py``, flax's
``axis_name``), as data-parallel training needs; without a group formed
the layer stays the one-process layer, bit for bit.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.sync_bn import cross_replica_batch_norm

#: block counts per stage
RESNET_DEPTHS = {
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}
#: depths that use the 3-conv bottleneck block (4x channel expansion)
BOTTLENECK_DEPTHS = (50, 101, 152)


def same_pad(size: int, kernel: int, stride: int, dilation: int = 1
             ) -> tuple[int, int]:
    """flax/XLA ``SAME`` padding of one spatial axis: (before, after)."""
    eff = (kernel - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + eff - size, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype`` (flax ``nn.Conv``'s
    ``dtype``): the input, weight and bias are cast to it at use and the
    output is in it.  ``None`` computes in the parameters' own dtype."""

    compute_dtype: torch.dtype | None = None

    def _operands(self, x: torch.Tensor):
        dtype = self.compute_dtype
        if dtype is None:
            return x, self.weight, self.bias
        return (x.to(dtype), self.weight.to(dtype),
                None if self.bias is None else self.bias.to(dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, weight, bias = self._operands(x)
        return self._conv_forward(x, weight, bias)


class SameConv2d(Conv2d):
    """:class:`Conv2d` with flax's ``SAME`` padding (asymmetric when
    needed)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, weight, bias = self._operands(x)
        (kh, kw), (sh, sw), (dh, dw) = self.kernel_size, self.stride, self.dilation
        top, bottom = same_pad(x.shape[-2], kh, sh, dh)
        left, right = same_pad(x.shape[-1], kw, sw, dw)
        if top == bottom and left == right:
            return F.conv2d(x, weight, bias, self.stride, (top, left),
                            self.dilation)
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, weight, bias, self.stride, 0, self.dilation)


def conv(cin: int, cout: int, kernel: int, stride: int = 1, dilation: int = 1,
         bias: bool = False) -> Conv2d:
    """flax ``nn.Conv`` (default ``SAME`` padding) as a torch layer; a 1x1
    conv never pads, so it is a plain :class:`Conv2d`."""
    if kernel == 1:
        return Conv2d(cin, cout, 1, stride=stride, bias=bias)
    return SameConv2d(cin, cout, kernel, stride=stride, dilation=dilation,
                      bias=bias)


_remat = threading.local()


def recomputing() -> bool:
    """True inside a remat block's recompute in the backward."""
    return getattr(_remat, "depth", 0) > 0


@contextlib.contextmanager
def _recompute_scope():
    _remat.depth = getattr(_remat, "depth", 0) + 1
    try:
        yield
    finally:
        _remat.depth -= 1


def _remat_contexts():
    """``checkpoint``'s (forward, recompute) contexts: the recompute is
    marked, so that BatchNorm moves its running statistics once."""
    return contextlib.nullcontext(), _recompute_scope()


def remat_block(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``block(x)`` whose activations are recomputed in the backward
    instead of kept (non-reentrant ``torch.utils.checkpoint``)."""
    return checkpoint(block, x, use_reentrant=False,
                      context_fn=_remat_contexts)


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """``BatchNorm2d`` that keeps its running statistics the flax way.

    In train mode both normalise with the biased batch variance, but torch
    moves ``running_var`` towards the *unbiased* one while flax moves it
    towards the biased one: ``ra = 0.9 ra + 0.1 var``.  The forward is
    torch's (cuDNN on the card); the running variance is then corrected to
    flax's update, ``(n - 1) / n`` times torch's step.  The keys stay
    ``running_mean``/``running_var``, so JAX trees load strictly.

    A bf16 input is normalised with float32 statistics and parameters
    (torch's mixed-dtype batch norm: float32 mean and variance of the
    bf16 values, float32 arithmetic, rounded once on output) and the
    result is in ``compute_dtype`` (the input's dtype when ``None``).
    Inside a remat recompute the running statistics are left alone: the
    forward that is being recomputed already moved them.

    With ``cross_replica`` set and a process group formed, the train-mode
    statistics are the whole group's batch
    (:func:`~..ops.sync_bn.cross_replica_batch_norm`) and the running
    statistics move towards them, identically on every rank."""

    compute_dtype: torch.dtype | None = None
    cross_replica: bool = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype or x.dtype
        if not self.training:
            return super().forward(x).to(dtype)
        if self.cross_replica and dist.is_available() and dist.is_initialized():
            return self._cross_replica_forward(x, dtype)
        n = x.numel() // x.shape[1]
        if n == 1:
            return self._single_value_forward(x, dtype)
        # torch updates copies (its backward may keep the buffers it was
        # given), which are then written back with flax's variance step
        mean, var = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True,
                         self.momentum, self.eps)
        if recomputing():
            return y.to(dtype)
        with torch.no_grad():
            kept = self.running_var * (1.0 - self.momentum)
            # torch added momentum * var * n / (n - 1)
            self.running_var.copy_((var - kept) * ((n - 1) / n) + kept)
            self.running_mean.copy_(mean)
            self.num_batches_tracked.add_(1)
        return y.to(dtype)

    def _single_value_forward(self, x: torch.Tensor,
                              dtype: torch.dtype) -> torch.Tensor:
        """Train mode over one value per channel (the ASPP image-pool
        branch at batch 1), which torch's batch norm refuses: flax's
        arithmetic, variance 0, so the output is the bias."""
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = (xf - mean[:, None, None]).square().mean(dim=(0, 2, 3))
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * scale[:, None, None] \
            + self.bias[:, None, None]
        if not recomputing():
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
                self.running_var.mul_(1.0 - m).add_(var, alpha=m)
                self.num_batches_tracked.add_(1)
        return y.to(dtype)

    def _cross_replica_forward(self, x: torch.Tensor,
                               dtype: torch.dtype) -> torch.Tensor:
        y, mean, var = cross_replica_batch_norm(x, self.weight, self.bias,
                                                self.eps, out_dtype=dtype)
        if not recomputing():
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
                self.running_var.mul_(1.0 - m).add_(var, alpha=m)
                self.num_batches_tracked.add_(1)
        return y


def norm(channels: int) -> nn.BatchNorm2d:
    """flax ``BatchNorm(momentum=0.9, epsilon=1e-5)`` as a torch layer."""
    return FlaxBatchNorm2d(channels, eps=1e-5, momentum=0.1)


def set_compute_dtype(model: nn.Module, dtype: torch.dtype | None) -> None:
    """Make every conv and BatchNorm of ``model`` compute in ``dtype``,
    its parameters unchanged; ``None`` or float32 computes in the
    parameters' own dtype."""
    dtype = None if dtype in (None, torch.float32) else dtype
    for module in model.modules():
        if isinstance(module, (Conv2d, FlaxBatchNorm2d)):
            module.compute_dtype = dtype


def set_cross_replica(model: nn.Module, on: bool = True) -> None:
    """Make every BatchNorm of ``model`` take its train-mode statistics
    over the process group (flax's ``bn_cross_replica_axis``), or not."""
    for module in model.modules():
        if isinstance(module, FlaxBatchNorm2d):
            module.cross_replica = on


def flax_init_(model: nn.Module) -> nn.Module:
    """Re-initialise ``model`` as flax initialises the JAX modules: conv
    kernels lecun-normal (a normal of variance 1 / fan_in truncated at two
    standard deviations), conv biases 0, BatchNorm scale 1 and bias 0 —
    but 0 for the last BatchNorm of each residual block, so every block
    starts as its shortcut.  Draws from torch's global generator."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, nn.Conv2d):
                # 0.8796 is the std of a unit normal truncated at +-2
                std = (1.0 / module.weight[0].numel()) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(module.weight, 0.0, std, -2 * std, 2 * std)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, nn.BatchNorm2d):
                module.weight.fill_(1.0)
                module.bias.zero_()
        for module in model.modules():
            if isinstance(module, (BasicBlock, BottleneckBlock)):
                module.last_norm.weight.zero_()
    return model


def max_pool_same(x: torch.Tensor, kernel: int = 3, stride: int = 2) -> torch.Tensor:
    """flax ``nn.max_pool(..., padding="SAME")``: -inf padding, flax's split."""
    top, bottom = same_pad(x.shape[-2], kernel, stride)
    left, right = same_pad(x.shape[-1], kernel, stride)
    x = F.pad(x, (left, right, top, bottom), value=-torch.inf)
    return F.max_pool2d(x, kernel, stride)


class BasicBlock(nn.Module):
    """Two 3x3 convs + identity shortcut (ResNet-18/34)."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.Conv_0 = conv(cin, filters, 3, stride, dilation)
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = conv(filters, filters, 3, 1, dilation)
        self.BatchNorm_1 = norm(filters)
        self.project = cin != filters or stride != 1
        if self.project:
            self.Conv_2 = conv(cin, filters, 1, stride)
            self.BatchNorm_2 = norm(filters)

    @property
    def last_norm(self) -> nn.BatchNorm2d:
        return self.BatchNorm_1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        residual = self.BatchNorm_2(self.Conv_2(x)) if self.project else x
        return F.relu(y + residual)


class BottleneckBlock(nn.Module):
    """1x1 reduce -> 3x3 (carries stride and dilation) -> 1x1 expand x4."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        out = filters * self.expansion
        self.Conv_0 = conv(cin, filters, 1)
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = conv(filters, filters, 3, stride, dilation)
        self.BatchNorm_1 = norm(filters)
        self.Conv_2 = conv(filters, out, 1)
        self.BatchNorm_2 = norm(out)
        self.project = cin != out or stride != 1
        if self.project:
            self.Conv_3 = conv(cin, out, 1, stride)
            self.BatchNorm_3 = norm(out)

    @property
    def last_norm(self) -> nn.BatchNorm2d:
        return self.BatchNorm_2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = self.BatchNorm_3(self.Conv_3(x)) if self.project else x
        return F.relu(y + residual)


def _stage_plan(output_stride: int) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(strides, dilations) of stages 1-4 for the target output stride."""
    if output_stride == 32:
        return (1, 2, 2, 2), (1, 1, 1, 1)
    if output_stride == 16:
        return (1, 2, 2, 1), (1, 1, 1, 2)
    if output_stride == 8:
        return (1, 2, 1, 1), (1, 1, 2, 4)
    raise ValueError(f"output_stride must be 8, 16 or 32, got {output_stride}")


class ResNet(nn.Module):
    """Dilated ResNet feature extractor with a single 7x7 stem.

    ``forward(x)`` (B, in_channels, H, W) -> dict of stage outputs
    ``{'c1', 'c2', 'c3', 'c4'}``; ``c4`` is at H / output_stride.  With
    ``remat`` a training forward keeps only each residual block's input
    and recomputes the block in the backward.  ``multi_grid`` multiplies
    the dilation of stage 4's blocks in turn, its last entry repeating
    (DeepLabV3's ``(1, 2, 4)``)."""

    def __init__(self, depth: int = 50, output_stride: int = 16,
                 in_channels: int = 4, width: int = 64, remat: bool = False,
                 multi_grid: tuple[int, ...] | None = None):
        super().__init__()
        self.remat = remat
        if depth not in RESNET_DEPTHS:
            raise ValueError(f"unsupported ResNet depth {depth} "
                             f"({sorted(RESNET_DEPTHS)})")
        block_cls = BottleneckBlock if depth in BOTTLENECK_DEPTHS else BasicBlock
        strides, dilations = _stage_plan(output_stride)
        self.Conv_0 = conv(in_channels, width, 7, 2)
        self.BatchNorm_0 = norm(width)
        self.stage_ends: list[int] = []
        cin, filters, idx = width, width, 0
        for stage, n_blocks in enumerate(RESNET_DEPTHS[depth]):
            for i in range(n_blocks):
                dilation = dilations[stage]
                if stage == 3 and multi_grid is not None:
                    dilation *= multi_grid[min(i, len(multi_grid) - 1)]
                block = block_cls(cin, filters,
                                  stride=strides[stage] if i == 0 else 1,
                                  dilation=dilation)
                self.add_module(f"{block_cls.__name__}_{idx}", block)
                cin = filters * block_cls.expansion
                idx += 1
            self.stage_ends.append(idx)
            filters *= 2
        self.out_channels = cin

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        x = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        x = max_pool_same(x)
        blocks = [m for name, m in self.named_children() if "Block_" in name]
        remat = self.remat and self.training and torch.is_grad_enabled()
        feats, start = {}, 0
        for stage, end in enumerate(self.stage_ends):
            for block in blocks[start:end]:
                x = remat_block(block, x) if remat else block(x)
            feats[f"c{stage + 1}"] = x
            start = end
        return feats
