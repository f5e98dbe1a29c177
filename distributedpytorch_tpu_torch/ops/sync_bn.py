"""Cross-replica BatchNorm, the counterpart of flax ``BatchNorm`` with
``axis_name`` (``bn_cross_replica_axis``) and of the global batch
statistics that GSPMD gives the JAX package's data-parallel step.

Under data parallelism the JAX step's BatchNorm normalises with the
statistics of the whole global (micro-)batch.  Per-rank statistics would
compute another function, so every BatchNorm of a model trained by more
than one process reduces its statistics over the ranks:

* forward: one ``all_reduce`` of (Σx, Σx², count) per channel in float32,
  giving flax's ``mean`` and ``mean(x²) − mean²`` (clipped at 0);
* backward: one ``all_reduce`` of (Σdy, Σdy·x̂), so that each rank's input
  gradient is the gradient of every rank's loss through the shared
  statistics; the scale and bias gradients stay local sums, which DDP
  reduces with the other parameters.

It is plain ``torch.distributed`` code, so one implementation serves gloo
(the CPU tests) and NCCL (the card); ``torch.nn.SyncBatchNorm`` refuses
CPU tensors.  Nothing here is a kernel: the JAX package left BatchNorm to
XLA.  The arithmetic is float32 whatever the input's dtype (a bfloat16
input is normalised with float32 statistics and rounded once on output,
as the single-process layer does).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _reduce_dims(x: torch.Tensor) -> list[int]:
    return [0] + list(range(2, x.dim()))


def _channel_shape(x: torch.Tensor) -> list[int]:
    return [1, x.shape[1]] + [1] * (x.dim() - 2)


def global_moments(x: torch.Tensor, group=None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(mean, var, count)`` of ``x`` per channel (dim 1) over every rank
    of ``group``, float32: one ``all_reduce`` of the sums, no gradient."""
    with torch.no_grad():
        xf = x.float()
        dims = _reduce_dims(x)
        c = x.shape[1]
        count = x.numel() // c
        sums = torch.cat([xf.sum(dims), (xf * xf).sum(dims),
                          xf.new_full((1,), float(count))])
        dist.all_reduce(sums, group=group)
        n = sums[2 * c]
        mean = sums[:c] / n
        var = (sums[c:2 * c] / n - mean * mean).clamp_min(0.0)
        return mean, var, n


class _Normalize(torch.autograd.Function):
    """``(x − mean) · invstd · weight + bias`` with the statistics of the
    global batch; the backward completes the statistics' share of the
    input gradient with one ``all_reduce``."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, invstd, count, group, out_dtype):
        shape = _channel_shape(x)
        y = (x.float() - mean.view(shape)) * (invstd * weight.float()).view(shape) \
            + bias.float().view(shape)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.count, ctx.group = count, group
        return y.to(out_dtype)

    @staticmethod
    def backward(ctx, grad):
        x, weight, mean, invstd = ctx.saved_tensors
        shape, dims = _channel_shape(x), _reduce_dims(x)
        dy = grad.float()
        xhat = (x.float() - mean.view(shape)) * invstd.view(shape)
        sdy = dy.sum(dims)
        sdyx = (dy * xhat).sum(dims)
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        gw = sdyx.clone() if need_w else None
        gb = sdy.clone() if need_b else None
        gx = None
        if need_x:
            c = x.shape[1]
            sums = torch.cat([sdy, sdyx])
            dist.all_reduce(sums, group=ctx.group)
            n = ctx.count
            gx = (dy - (sums[:c] / n).view(shape)
                  - xhat * (sums[c:] / n).view(shape)) \
                * (invstd * weight.float()).view(shape)
            gx = gx.to(x.dtype)
        return (gx, None if gw is None else gw.to(weight.dtype),
                None if gb is None else gb.to(weight.dtype),
                None, None, None, None, None)


def cross_replica_batch_norm(x: torch.Tensor, weight: torch.Tensor,
                             bias: torch.Tensor, eps: float,
                             out_dtype: torch.dtype | None = None, group=None
                             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train-mode BatchNorm of ``x`` (N, C, ...) with the statistics of the
    batch over every rank of ``group``; returns ``(y, mean, var)``, the
    biased global variance, for the running statistics.  ``y`` is in
    ``out_dtype`` (``x``'s dtype when None)."""
    mean, var, n = global_moments(x, group)
    invstd = torch.rsqrt(var + eps)
    y = _Normalize.apply(x, weight, bias, mean, invstd, n, group,
                         out_dtype or x.dtype)
    return y, mean, var
