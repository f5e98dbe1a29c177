"""Plain PyTorch forms of DANet's two attention branches.

Counterpart of ``distributedpytorch_tpu/ops/attention.py``, with its
layouts: spatial features are (B, N, C) token-major, N = H*W.  These are the
forms the CUDA kernels in :mod:`.cuda_attention` are held to, and what the
wrappers run for a tensor on the CPU.

Numerics follow the JAX functions: position-attention energies are
unscaled (DANet), channel attention softmaxes ``rowmax - E``, and every
product accumulates in float32 whatever the input dtype (JAX's
``preferred_element_type=float32``) — in float64 for float64 inputs, so
that gradients can be checked numerically.
"""

from __future__ import annotations

import torch


def _acc(x: torch.Tensor) -> torch.Tensor:
    """``x`` in its accumulation dtype: float32, or float64 if wider."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def position_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float | None = None) -> torch.Tensor:
    """Full position attention: ``q``/``k`` (B, N, Ck), ``v`` (B, N, Cv)
    -> (B, N, Cv) in ``v.dtype``.  Scores are float32 and unscaled unless
    ``scale`` is given; the attention weights are cast to ``v.dtype`` before
    the value product, as in the JAX form."""
    scores = torch.matmul(_acc(q), _acc(k).transpose(1, 2))
    if scale is not None:
        scores = scores * scale
    attn = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(_acc(attn), _acc(v)).to(v.dtype)


def blocked_position_attention(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, block_size: int = 1024,
                               scale: float | None = None) -> torch.Tensor:
    """:func:`position_attention` with an online softmax over key blocks —
    the (max, sum, acc) recurrence, O(N * block) memory.  Keys past N are
    never read (the JAX form pads and masks them to -inf)."""
    b, n, _ = q.shape
    cv = v.shape[-1]
    qf = _acc(q) if scale is None else _acc(q) * scale
    m = torch.full((b, n), -torch.inf, dtype=qf.dtype, device=q.device)
    s = torch.zeros((b, n), dtype=qf.dtype, device=q.device)
    acc = torch.zeros((b, n, cv), dtype=qf.dtype, device=q.device)
    for k0 in range(0, n, block_size):
        kb = _acc(k[:, k0:k0 + block_size])
        vb = _acc(v[:, k0:k0 + block_size])
        scores = torch.matmul(qf, kb.transpose(1, 2))
        m_new = torch.maximum(m, scores.amax(dim=-1))
        correction = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        s = s * correction + p.sum(dim=-1)
        acc = acc * correction[..., None] + torch.matmul(p, vb)
        m = m_new
    return (acc / s[..., None]).to(v.dtype)


def channel_energy(x: torch.Tensor) -> torch.Tensor:
    """(B, N, C) -> the (B, C, C) float32 channel-attention map: the Gram
    matrix XᵀX, ``rowmax - E``, then a softmax over each row."""
    xf = _acc(x)
    energy = torch.matmul(xf.transpose(1, 2), xf)
    energy = energy.amax(dim=-1, keepdim=True) - energy
    return torch.softmax(energy, dim=-1)


def channel_apply(attn: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Apply a (B, C, C) map back over channels: ``out[n, i] = sum_j
    attn[i, j] * x[n, j]`` in float32, cast to ``x.dtype``."""
    return torch.matmul(_acc(x), attn.transpose(1, 2)).to(x.dtype)


def channel_attention(x: torch.Tensor) -> torch.Tensor:
    """Channel (Gram-matrix) attention: (B, N, C) -> (B, N, C)."""
    return channel_apply(channel_energy(x), x)
