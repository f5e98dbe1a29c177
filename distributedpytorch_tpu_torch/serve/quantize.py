"""Post-training int8 weight quantization of the serve forward: the
counterpart of ``distributedpytorch_tpu/serve/quantize.py``.

One float32 weight set of DANet-R101 is ~254 MiB of device memory, and a
hot swap holds two of them while a canary runs (``serve/swap.py``).
Weight-only int8 stores the conv weights in a quarter of that:

* **Which weights.**  Every conv weight (the port's
  :class:`~distributedpytorch_tpu_torch.models.resnet.Conv2d`; the JAX
  package quantizes every ``kernel`` leaf with >= 2 dims, flax's Conv and
  Dense weights, and each maps onto one of these).  Biases, BatchNorm,
  the residual gates and the MoE's ``w_gate``/``w1``/``b1``/``w2``/``b2``
  stay float32.
* **How.**  Per output channel, symmetric: ``amax`` over every axis but
  the output channel's (dims 1..3 of torch's ``(cout, cin, kh, kw)``;
  every axis but the last of flax's ``(kh, kw, cin, cout)``), ``scale =
  amax / 127`` in float32 (1.0 for an all-zero channel, such as a head
  model's zero-initialised ``guidance_proj``), ``q = clip(rint(w /
  scale), -127, 127)`` as int8.  It runs on the host in numpy with the
  JAX package's arithmetic, so ``q`` and ``scale`` are bitwise its own.
* **Use.**  A quantized ``Conv2d`` holds ``weight_q`` (int8) and
  ``weight_scale`` (float32, ``(cout, 1, 1, 1)``) buffers and no float
  weight, and dequantizes at use: ``weight_q * weight_scale`` in float32,
  then cast to the compute dtype.  That is plain PyTorch, one elementwise
  launch before each conv, and a float copy of the weight lives only
  while its conv runs.  The attention kernels act on activations and run
  as they do in float32.

:func:`quantize_predictor` builds the int8 module beside the given
predictor's: that predictor's model is left as it was, since a float32
generation may go on serving while an int8 canary runs.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch
from torch import nn

from ..models.resnet import Conv2d
from ..predict import Predictor


class QTensor:
    """One quantized weight: int8 values ``q`` and their per-output-channel
    float32 ``scale`` (numpy arrays or tensors, in one layout)."""

    __slots__ = ("q", "scale")

    def __init__(self, q, scale):
        self.q = q
        self.scale = scale

    @property
    def shape(self):
        return tuple(self.q.shape)

    @property
    def ndim(self) -> int:
        return self.q.ndim

    @property
    def dtype(self):
        """The dequantized dtype."""
        return self.scale.dtype

    def dequantize(self):
        """``q * scale`` in the scale's dtype."""
        if torch.is_tensor(self.q):
            return self.q.to(self.scale.dtype) * self.scale
        return self.q.astype(self.scale.dtype) * self.scale

    def __repr__(self):
        return (f"QTensor(int8{list(self.q.shape)}, "
                f"scale{list(self.scale.shape)})")


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """One weight-quantization regime: what quantized weights store as, the
    scale sharing (per output channel), and the zero-point-free form."""

    weight_dtype: str = "int8"
    granularity: str = "per_channel"
    symmetric: bool = True

    #: the symmetric int8 range [-127, 127]: +max and -max map to the same
    #: magnitude
    QMAX = 127

    def block(self) -> dict:
        """The record's ``quantization`` block."""
        return {
            "weight_dtype": self.weight_dtype,
            "granularity": self.granularity,
            "symmetric": self.symmetric,
        }


def quant_policy(name: str | None) -> QuantPolicy | None:
    """``model.quantization`` -> policy: ``''``, ``None`` and ``'none'``
    give None (the unquantized forward), ``'int8'`` per-channel symmetric
    weight-only int8; anything else raises ``ValueError``."""
    if not name or name == "none":
        return None
    if name == "int8":
        return QuantPolicy()
    raise ValueError(f"unknown model.quantization: {name!r} (int8 | none)")


def quantization_block(policy: QuantPolicy | None) -> dict | None:
    """The policy's block, or None when unquantized."""
    return None if policy is None else policy.block()


def quantize_leaf(w: np.ndarray, policy: QuantPolicy | None = None) -> QTensor:
    """Per-output-channel symmetric int8 of a weight in torch's layout
    (output channels first): numpy ``q`` of ``w``'s shape and float32
    ``scale`` of shape ``(cout, 1, ...)``."""
    policy = policy or QuantPolicy()
    w = np.asarray(w)
    axes = tuple(range(1, w.ndim))
    amax = np.abs(w).max(axis=axes, keepdims=True).astype(np.float32)
    # an all-zero channel quantizes to q = 0 under any scale; 1.0 keeps
    # the arithmetic finite
    scale = np.where(amax > 0, amax / policy.QMAX, 1.0).astype(np.float32)
    q = np.clip(np.rint(w / scale), -policy.QMAX, policy.QMAX) \
        .astype(np.int8)
    return QTensor(q, scale)


def _float_weights(model: nn.Module) -> list[tuple[str, Conv2d]]:
    """(name, layer) of every layer whose float ``weight`` has >= 2 dims;
    such a weight on a layer that cannot dequantize at use raises."""
    out = []
    for name, module in model.named_modules():
        weight = module._parameters.get("weight")
        if weight is None or weight.ndim < 2:
            continue
        if not isinstance(module, Conv2d):
            raise TypeError(f"{name or type(module).__name__}: a "
                            f"{type(module).__name__} cannot dequantize its "
                            "weight at use (only the port's Conv2d can)")
        out.append((name, module))
    return out


def quantize_model(model: nn.Module,
                   policy: QuantPolicy | None = None) -> nn.Module:
    """A copy of ``model`` whose conv weights are int8 + scales (the
    counterpart of the JAX package's ``quantize_params``): every other
    parameter and buffer is copied as it is, on its device, and ``model``
    is left untouched.  The float weights being replaced are not copied."""
    policy = policy or QuantPolicy()
    # the copy takes the very weights it is about to drop, not copies
    memo = {id(module.weight): module.weight
            for _, module in _float_weights(model)}
    qmodel = copy.deepcopy(model, memo)
    for _, module in _float_weights(qmodel):
        weight = module.weight.detach()
        leaf = quantize_leaf(weight.cpu().numpy(), policy)
        module.quantize_(torch.from_numpy(leaf.q).to(weight.device),
                         torch.from_numpy(leaf.scale).to(weight.device))
    return qmodel


def quantized_weights(model: nn.Module) -> dict[str, QTensor]:
    """``layer.weight`` -> the layer's :class:`QTensor` (tensors), for
    every quantized layer of ``model``."""
    return {f"{name}.weight": QTensor(m.weight_q, m.weight_scale)
            for name, m in model.named_modules()
            if isinstance(m, Conv2d) and m.quantized}


def quantize_report(model: nn.Module) -> dict:
    """Byte accounting of a (possibly quantized) model's weights, as the
    JAX package's over its ``params`` tree: each quantized layer one
    quantized leaf (int8 values and float32 scales), each parameter one
    float leaf (BatchNorm's running statistics are not parameters)."""
    qs = quantized_weights(model)
    params = list(model.parameters())
    return {
        "quantized_leaves": len(qs),
        "float_leaves": len(params),
        "quantized_bytes": int(sum(
            t.q.numel() * t.q.element_size()
            + t.scale.numel() * t.scale.element_size() for t in qs.values())),
        "float_bytes": int(sum(p.numel() * p.element_size() for p in params)),
    }


class QuantizedPredictor(Predictor):
    """A :class:`~distributedpytorch_tpu_torch.predict.Predictor` on a
    quantized model (:func:`quantize_model`): the same API, stages,
    sessions and swaps, since each quantized layer dequantizes at use.
    ``quant_policy`` names the regime (the server's boot line)."""

    def __init__(self, model: nn.Module, *,
                 quant_policy: QuantPolicy | None = None, **kwargs):
        self.quant_policy = quant_policy or QuantPolicy()
        super().__init__(model, **kwargs)


def quantize_predictor(predictor: Predictor,
                       policy: QuantPolicy | None = None
                       ) -> QuantizedPredictor:
    """An int8 predictor beside ``predictor``: its serving settings
    (resolution, relax, zero padding, alpha, guidance, input channels,
    device, compute dtype, input mean and std) carried over, so it can
    canary into the service ``predictor`` serves, on a quantized copy of
    its model.  ``predictor`` and its model are left as they were; the
    new model holds no float conv weight."""
    policy = policy or QuantPolicy()
    kwargs = {attr: getattr(predictor, attr)
              for attr in ("resolution", "relax", "zero_pad", "alpha",
                           "guidance", "in_channels", "device", "dtype",
                           "mean", "std")}
    return QuantizedPredictor(quantize_model(predictor.model, policy),
                              quant_policy=policy, **kwargs)
