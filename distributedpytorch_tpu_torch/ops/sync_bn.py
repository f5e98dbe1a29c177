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

:func:`compute_dtype_batch_norm` is the other arithmetic, flax's
``force_float32_reductions=False`` (``model.bn_fp32_stats=false``): the
batch mean and mean of squares in the input's dtype, on one process or
averaged over the group, in plain differentiable torch ops.
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


class _GroupMean(torch.autograd.Function):
    """The mean of ``t`` over the ranks of ``group``, summed in float32 and
    returned in ``t``'s dtype; its gradient is the group's mean of the
    incoming gradients, the same convention as :class:`_Normalize`'s
    backward (each rank's input feeds every rank's loss)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _mean_over(t, group)

    @staticmethod
    def backward(ctx, grad):
        return _mean_over(grad, ctx.group), None


def _mean_over(t: torch.Tensor, group) -> torch.Tensor:
    total = t.float().clone()
    dist.all_reduce(total, group=group)
    return (total / dist.get_world_size(group)).to(t.dtype)


def compute_dtype_batch_norm(x: torch.Tensor, weight: torch.Tensor,
                             bias: torch.Tensor, eps: float,
                             out_dtype: torch.dtype | None = None,
                             cross_replica: bool = False, group=None
                             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train-mode BatchNorm of ``x`` (N, C, ...) with its statistics in
    ``x``'s dtype, as flax's ``BatchNorm(force_float32_reductions=False)``
    computes them: ``mean = E[x]`` and ``E[x²]`` (``x²`` rounded to the
    dtype; each mean accumulated in float32 by torch and rounded once),
    ``var = max(0, E[x²] − mean²)`` in the dtype, then ``(x − mean) ·
    (rsqrt(var + eps) · weight) + bias`` promoted to the float32
    parameters and rounded to ``out_dtype`` (``x``'s when None).  With
    ``cross_replica`` the two means are averaged over the ranks of
    ``group`` (flax's ``pmean``), which assumes equal shares per rank, as
    flax does.  Returns ``(y, mean, var)`` in ``x``'s dtype; the gradient
    flows through every op, the group mean included."""
    dims = _reduce_dims(x)
    mean, mean_sq = x.mean(dims), (x * x).mean(dims)
    if cross_replica:
        mean, mean_sq = _GroupMean.apply(torch.stack([mean, mean_sq]), group)
    var = (mean_sq - mean * mean).clamp_min(0.0)
    shape = _channel_shape(x)
    scale = torch.rsqrt(var + eps) * weight
    y = (x - mean.view(shape)) * scale.view(shape) + bias.view(shape)
    return y.to(out_dtype or x.dtype), mean, var
