"""The precision policy, the counterpart of
``distributedpytorch_tpu/train/precision.py``.

``float32`` — the port's only policy so far, and the default of both the
trainer and serving — means float32 end to end: PyTorch's TF32 shortcuts
for matrix products and cuDNN convolutions are turned off, since TF32
keeps 10 mantissa bits where float32 keeps 23 (PyTorch leaves cuDNN's on
by default).  The attention kernels are float32-exact on their own
(3xTF32).  ``bfloat16`` (bf16 compute, float32 master weights) is not
ported yet.
"""

from __future__ import annotations

import torch

POLICIES = ("float32", "bfloat16")


def apply_policy(name: str | None = "float32") -> None:
    """Set the process's matmul and convolution precision for ``name``
    (``None`` or ``""`` is ``float32``, as in the JAX package)."""
    name = name or "float32"
    if name == "bfloat16":
        raise NotImplementedError(
            "train.precision=bfloat16 is not ported yet (float32 only)")
    if name != "float32":
        raise ValueError(f"unknown precision {name!r} ({' | '.join(POLICIES)})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
