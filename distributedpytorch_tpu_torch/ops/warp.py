"""The device half of the full-resolution semantic evaluation, the
counterpart of ``distributedpytorch_tpu/ops/warp.py``'s
``_linear_weight_matrix``, ``resize_bilinear_ragged`` and
``fullres_argmax``.

Each sample's class probabilities are resized to that sample's own native
size inside a fixed canvas as two matmuls with per-sample weight
matrices — ``W[o, i]``, the tent weight of input row ``i`` for output row
``o``, with cv2's ``INTER_LINEAR`` centres ``src = (o + 0.5) · in / out −
0.5`` clamped to the input (edge replicate, no antialias) — then argmaxed
on the device, so only a uint8 class map is read back.  Plain PyTorch on
the device (the JAX package's form was XLA, not a Pallas kernel).
Tensors are NCHW.  These three functions are the whole JAX module; the
device augmentation's warps (flip, crop, scale-rotate) are
:mod:`.augment`'s.
"""

from __future__ import annotations

import torch


def _linear_weight_matrix(out_size: torch.Tensor, n_out: int,
                          in_size: int) -> torch.Tensor:
    """(B, n_out, in_size) float32 bilinear weights of each sample's
    target size ``out_size`` (B,); rows at or beyond a sample's size are
    zero."""
    out_size = out_size.to(torch.float32)[:, None]
    device = out_size.device
    o = torch.arange(n_out, dtype=torch.float32, device=device)[None]
    src = (o + 0.5) * (float(in_size) / out_size) - 0.5
    src = src.clamp(0.0, float(in_size - 1))
    lo = torch.floor(src)
    frac = src - lo
    i = torch.arange(in_size, dtype=torch.float32, device=device)
    is_lo = (i == lo[..., None]).to(torch.float32)
    is_hi = (i == lo[..., None] + 1.0).to(torch.float32)
    w = is_lo * (1.0 - frac[..., None]) + is_hi * frac[..., None]
    return torch.where((o < out_size)[..., None], w, torch.zeros_like(w))


def resize_bilinear_ragged(x: torch.Tensor, out_hw: torch.Tensor,
                           max_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of each sample of ``x`` (B, C, H, W) to its own
    ``out_hw[b] = (h_b, w_b)`` inside a (B, C, max_h, max_w) float32
    canvas, zero beyond each sample's size."""
    max_h, max_w = int(max_hw[0]), int(max_hw[1])
    out_hw = out_hw.to(x.device)
    wh = _linear_weight_matrix(out_hw[:, 0], max_h, x.shape[2])
    ww = _linear_weight_matrix(out_hw[:, 1], max_w, x.shape[3])
    y = torch.einsum("boh,bchw->bcow", wh, x.to(torch.float32))
    return torch.einsum("bpw,bcow->bcop", ww, y)


def fullres_argmax(probs: torch.Tensor, out_hw: torch.Tensor,
                   max_hw: tuple[int, int]) -> torch.Tensor:
    """Class probabilities (B, C, H, W) resized to each sample's native
    size and argmaxed: (B, max_h, max_w) uint8 class ids.  Callers score
    ``[:h_b, :w_b]`` of each sample only (beyond it is the argmax of
    zeros)."""
    if probs.shape[1] > 256:
        raise ValueError(
            f"{probs.shape[1]} classes do not fit the uint8 class-map "
            "wire; use resize_bilinear_ragged + argmax directly")
    full = resize_bilinear_ragged(probs, out_hw, max_hw)
    return full.argmax(dim=1).to(torch.uint8)
