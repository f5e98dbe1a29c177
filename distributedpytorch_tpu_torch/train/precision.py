"""The precision policy, the counterpart of
``distributedpytorch_tpu/train/precision.py``.

``train.precision`` names one of two regimes:

* ``float32`` (the default, and ``None`` or ``""``): float32 end to end.
  There is no policy object (:func:`precision_policy` returns ``None``),
  so every consumer's ``policy is None`` branch is the plain float32 path.
* ``bfloat16``: bf16 compute with float32 master weights — the
  :class:`Policy`.  The model is built with ``dtype=bfloat16`` (each conv
  casts its input and its float32 weight to bf16 at use, as flax's
  ``dtype``/``param_dtype`` do), so parameters, their gradients and the
  SGD momentum stay float32; the train step casts the inputs down at the
  model and the outputs up to the loss dtype after it.

Under both regimes :func:`apply_policy` turns PyTorch's TF32 shortcuts off
for matrix products and cuDNN convolutions (TF32 keeps 10 mantissa bits
where float32 keeps 23, and PyTorch leaves cuDNN's on by default), so the
float32 islands of the bf16 regime — the loss, BatchNorm's statistics and
the optimizer — stay float32-exact.  The attention kernels are
float32-exact on float32 inputs on their own (3xTF32) and take bf16 inputs
natively.

The JAX policy's ``ja002_allow`` has no counterpart here: it feeds the
JAX package's IR audit (jaxaudit's dtype-flow check), whose port is
analysis-layer work that has not been done.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

POLICIES = ("float32", "bfloat16")


def torch_dtype(name: str | torch.dtype) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16``; a ``torch.dtype`` as is."""
    if isinstance(name, torch.dtype):
        return name
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"not a floating dtype: {name!r}")
    return dtype


def _map_floating(x: Any, dtype: torch.dtype) -> Any:
    """Cast every floating tensor in ``x`` (a tensor, or a dict, list or
    tuple of them) to ``dtype``; anything else as is."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype) if x.is_floating_point() else x
    if isinstance(x, dict):
        return {k: _map_floating(v, dtype) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_map_floating(v, dtype) for v in x)
    return x


@dataclasses.dataclass(frozen=True)
class Policy:
    """One mixed-precision regime: ``compute_dtype`` is what the model
    computes in, ``param_dtype`` what the parameters, their gradients and
    the optimizer state live in (always float32 here: bf16 master weights
    would lose most of an lr 5e-8 update), ``loss_dtype`` what the loss
    accumulates in."""

    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    loss_dtype: str = "float32"

    def cast_to_compute(self, x: Any) -> Any:
        """The floating tensors of ``x`` in the compute dtype: the train
        step's cast of the inputs at the model boundary."""
        return _map_floating(x, torch_dtype(self.compute_dtype))

    def cast_to_loss(self, outputs: Any) -> Any:
        """The model's outputs in the loss dtype: the declared boundary
        between bf16 compute and float32 loss arithmetic."""
        return _map_floating(outputs, torch_dtype(self.loss_dtype))

    def block(self) -> dict:
        """The record block, keys as the JAX package's."""
        return {"compute_dtype": self.compute_dtype,
                "param_dtype": self.param_dtype,
                "loss_dtype": self.loss_dtype}


def precision_policy(name: str | None) -> Policy | None:
    """``train.precision`` -> the policy: ``None`` for float32 (also for
    ``None`` and ``""``), :class:`Policy` for ``bfloat16``."""
    if not name or name == "float32":
        return None
    if name == "bfloat16":
        return Policy()
    raise ValueError(
        f"unknown train.precision: {name!r} ({' | '.join(POLICIES)})")


def precision_block(policy: Policy | None) -> dict | None:
    """The policy's record block, or ``None`` under float32."""
    return None if policy is None else policy.block()


def apply_policy(name: str | None = "float32") -> Policy | None:
    """Set the process's matmul and convolution precision for ``name``
    (TF32 off under both regimes) and return its policy."""
    policy = precision_policy(name)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return policy
