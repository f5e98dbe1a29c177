"""DANet attention on the hand-written Hopper kernels (``csrc/attention.cu``).

Counterpart of ``distributedpytorch_tpu/ops/pallas_attention.py``, with its
public names and shapes:

* :func:`flash_position_attention` — ``q``/``k`` (B, N, Ck), ``v``
  (B, N, Cv) -> (B, N, Cv), one kernel (``pam_forward``) on the tensor
  cores: float32-exact 3xTF32 for float32 inputs, one bfloat16 pass for
  bfloat16 ones;
* :func:`flash_channel_attention` — (B, N, C) -> (B, N, C), the composition
  of :func:`cam_energy` (Gram + ``rowmax - E`` softmax, two launches that
  together port the TPU's one energy kernel) and :func:`cam_apply`, both
  on the tensor cores in float32-exact 3xTF32.

Each wrapper launches its kernel for a CUDA tensor — or raises — and runs
the plain form of :mod:`.attention` only for a tensor on the CPU.  It counts
its launches in :data:`launches` (one per call that reached the kernel), so
a run can show that its main path went through the kernels.  Inputs are
float32 or bfloat16 and must be contiguous; outputs are allocated here with
``torch.empty`` on the caller's current stream, and nothing synchronises.

The two attention functions are ``torch.autograd.Function``s, the
counterparts of the JAX ``custom_vjp``s: the forward is the kernels (the
plain form on the CPU) and saves its inputs; the backward recomputes
through the plain forms — :func:`.attention.blocked_position_attention`
with the same key block, :func:`.attention.channel_attention` — and
returns their vector-Jacobian products.  There is no backward kernel, as
there is no backward Pallas kernel.  An output therefore carries a
``grad_fn`` whenever an input requires grad.  On bfloat16 inputs the
forward takes the kernels' bf16 paths and the backward recomputes in the
inputs' dtype, as the JAX ``custom_vjp`` does: the plain forms accumulate
in float32 (the position form keeps p in float32 and upcasts v, where the
forward kernel rounds p to bf16 before P·V), and the gradients come back
in bf16.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .attention import (
    blocked_position_attention,
    channel_apply,
    channel_attention,
    channel_energy,
)

#: launches per kernel wrapper since the last :func:`reset_launches`
launches: dict[str, int] = {"position_attention": 0, "cam_energy": 0,
                            "cam_apply": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "dptpu_pam_forward": (_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I,
                          _I, _P),
    "dptpu_cam_gram": (_P, _P, _I, _I, _I, _I, _I, _P),
    "dptpu_cam_softmax": (_P, _P, _I, _I, _I, _P),
    "dptpu_cam_apply": (_P, _P, _P, _I, _I, _I, _I, _P),
}
#: the largest Ck whose Q planes and K stages fit one block's shared memory
#: beside the value stages (227 KB per block on Hopper)
MAX_CK = 128
#: the Gram kernel's output tile, and the most slices of N it sums
_GRAM_TILE = 128
_GRAM_MAX_SPLITS = 16
#: the shortest slice of N worth a block of its own
_GRAM_MIN_SLICE = 256


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


_typed_lib: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _typed_lib
    if _typed_lib is None:
        lib = _build.library("attention")
        for fn, argtypes in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _typed_lib = lib
    return _typed_lib


def build() -> None:
    """Compile and load the kernels now (they otherwise build at first use)."""
    _lib()


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (take the plain form); False
    when all lie on one CUDA device (launch the kernel); raises otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: {sorted(map(str, devices))}")
    (device,) = devices
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}: CUDA or CPU tensors only")
    for t in tensors:
        if t.dtype not in _DTYPES:
            raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    return False


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel failed to launch: CUDA error {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


#: the profiler range around every backward recompute
RECOMPUTE_RANGE = "attention_backward_recompute"


def _vjp(fn, inputs: tuple[torch.Tensor, ...], grad: torch.Tensor,
         needs: tuple[bool, ...]) -> tuple[torch.Tensor | None, ...]:
    """The gradients of ``fn(*inputs)`` against ``grad`` for the inputs
    that ``needs`` marks (None for the others), by recomputing ``fn``
    inside the profiler range :data:`RECOMPUTE_RANGE`."""
    with torch.enable_grad(), torch.profiler.record_function(RECOMPUTE_RANGE):
        leaves = [x.detach().requires_grad_(need)
                  for x, need in zip(inputs, needs)]
        wanted = [x for x in leaves if x.requires_grad]
        grads = iter(torch.autograd.grad(fn(*leaves), wanted, grad)
                     if wanted else ())
    return tuple(next(grads) if need else None for need in needs)


class _PositionAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, block_k, scale):
        ctx.save_for_backward(q, k, v)
        ctx.block_k, ctx.scale = block_k, scale
        return _pam_forward(q, k, v, block_k, scale)

    @staticmethod
    def backward(ctx, grad):
        def plain(q, k, v):
            return blocked_position_attention(q, k, v, block_size=ctx.block_k,
                                              scale=ctx.scale)

        return _vjp(plain, ctx.saved_tensors, grad,
                    ctx.needs_input_grad[:3]) + (None, None)


class _ChannelAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return cam_apply(cam_energy(x), x)

    @staticmethod
    def backward(ctx, grad):
        return _vjp(channel_attention, ctx.saved_tensors, grad,
                    ctx.needs_input_grad)


def flash_position_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, block_q: int = 256,
                             block_k: int = 256,
                             scale: float | None = None) -> torch.Tensor:
    """Position attention, (B, N, Ck)·(B, N, Ck)ᵀ -> softmax -> ·(B, N, Cv).

    Energies are unscaled unless ``scale`` is given; the output takes
    ``v.dtype``.  ``block_q``/``block_k`` are the TPU kernel's VMEM tiling:
    the Hopper kernel has its own fixed tiles, and ``block_k`` sets the key
    block of the plain online-softmax form that the CPU forward and every
    backward run."""
    del block_q
    return _PositionAttention.apply(q, k, v, block_k, scale)


def _pam_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 block_k: int, scale: float | None) -> torch.Tensor:
    """The position kernel's launch (the plain form for CPU tensors)."""
    if q.dim() != 3 or k.shape != q.shape or v.dim() != 3 \
            or v.shape[:2] != q.shape[:2]:
        raise ValueError(f"expected q, k (B, N, Ck) and v (B, N, Cv); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if _on_cpu(q, k, v):
        return blocked_position_attention(q, k, v, block_size=block_k,
                                          scale=scale)
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    b, n, ck = q.shape
    cv = v.shape[-1]
    if not 1 <= ck <= MAX_CK:
        raise ValueError(f"Ck={ck} outside the kernel's 1..{MAX_CK}")
    out = torch.empty((b, n, cv), dtype=v.dtype, device=v.device)
    if n == 0 or b == 0:
        return out
    err = _lib().dptpu_pam_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n, ck, cv,
        0.0 if scale is None else float(scale), int(scale is not None),
        _DTYPES[v.dtype], _stream(v))
    _check(err, "position-attention")
    launches["position_attention"] += 1
    return out


@functools.lru_cache(maxsize=256)
def gram_splits(batch: int, channels: int, tokens: int, sms: int) -> int:
    """How many slices of N the Gram kernel sums separately.

    Its blocks (one per tile on and above the diagonal of E, per batch
    entry, per slice) are spread over the card's ``sms`` SMs, two resident
    on an SM at most, and an SM works through its blocks' tokens at one
    rate however many it holds.  So take the split that gives the busiest
    SM the fewest tokens, the fewest slices among equals (each slice costs
    a C x C partial in device memory); at most 16, and no slice shorter
    than 256 tokens.  Cached per shape: it runs on every call."""
    side = -(-channels // _GRAM_TILE)
    blocks = side * (side + 1) // 2 * batch
    if blocks == 0:
        return 1
    most = max(1, min(_GRAM_MAX_SPLITS, 2 * sms // blocks,
                      tokens // _GRAM_MIN_SLICE))

    def busiest(splits: int) -> int:
        return -(-blocks * splits // sms) * -(-tokens // splits)

    return min(range(1, most + 1), key=busiest)


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_gram(x: torch.Tensor, partial: torch.Tensor) -> None:
    """The energy kernel's first launch: ``partial`` (B, S, C, C) <- the
    Gram matrices of S slices of N."""
    b, n, c = x.shape
    _check(_lib().dptpu_cam_gram(x.data_ptr(), partial.data_ptr(), b, n, c,
                                 partial.shape[1], _DTYPES[x.dtype], _stream(x)),
           "channel-energy Gram")


def _launch_softmax(partial: torch.Tensor, attn: torch.Tensor) -> None:
    """The energy kernel's second launch: ``attn`` <- the row softmax of
    ``rowmax - E``, E the partials summed in slice order.  ``attn`` may be
    ``partial`` itself when there is one slice."""
    b, splits, c, _ = partial.shape
    _check(_lib().dptpu_cam_softmax(partial.data_ptr(), attn.data_ptr(), b * c,
                                    c, splits, _stream(attn)),
           "channel-energy softmax")


def _gram_buffers(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The (B, S, C, C) partials and the (B, C, C) map for ``x``; one
    buffer when S = 1."""
    b, n, c = x.shape
    splits = gram_splits(b, c, n, _sm_count(x.device))
    attn = torch.empty((b, c, c), dtype=torch.float32, device=x.device)
    if splits == 1:
        return attn.view(b, 1, c, c), attn
    return torch.empty((b, splits, c, c), dtype=torch.float32,
                       device=x.device), attn


def cam_energy(x: torch.Tensor) -> torch.Tensor:
    """(B, N, C) -> the (B, C, C) float32 channel-attention map."""
    if x.dim() != 3:
        raise ValueError(f"expected x (B, N, C), got {tuple(x.shape)}")
    if _on_cpu(x):
        return channel_energy(x)
    partial, attn = _gram_buffers(x)
    if attn.numel() == 0:
        return attn
    _launch_gram(x, partial)
    _launch_softmax(partial, attn)
    launches["cam_energy"] += 1
    return attn


def cam_apply(attn: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``out[n, i] = sum_j attn[i, j] * x[n, j]``: (B, C, C) float32 map and
    (B, N, C) tokens -> (B, N, C) in ``x.dtype``."""
    if x.dim() != 3 or attn.shape != (x.shape[0], x.shape[2], x.shape[2]):
        raise ValueError(f"expected attn (B, C, C) and x (B, N, C); got "
                         f"{tuple(attn.shape)}, {tuple(x.shape)}")
    if _on_cpu(attn, x):
        return channel_apply(attn, x)
    if attn.dtype != torch.float32:
        raise TypeError(f"the attention map must be float32, got {attn.dtype}")
    b, n, c = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    err = _lib().dptpu_cam_apply(attn.data_ptr(), x.data_ptr(), out.data_ptr(),
                                 b, n, c, _DTYPES[x.dtype], _stream(x))
    _check(err, "channel-apply")
    launches["cam_apply"] += 1
    return out


def flash_channel_attention(x: torch.Tensor,
                            block_n: int = 256) -> torch.Tensor:
    """Channel attention, (B, N, C) -> (B, N, C): :func:`cam_energy` then
    :func:`cam_apply`, differentiable through the plain form.  ``block_n``
    is the TPU kernel's row tiling and has no effect here."""
    del block_n
    return _ChannelAttention.apply(x)
