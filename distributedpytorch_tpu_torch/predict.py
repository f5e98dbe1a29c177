"""Inference: click-to-mask (an image and 4 extreme-point clicks in, a
full-resolution probability mask out) and whole-image class maps.

Counterpart of ``distributedpytorch_tpu/predict.py`` (``prepare_input``,
``Predictor``, ``SemanticPredictor`` and ``predict_cli``).  The host path is the same numpy: relax-padded bbox ->
zero-padded crop -> cubic resize to the model resolution -> guidance
channel -> RGB + guidance concat in [0, 255]; the forward is the sigmoid of
DANet's fused head in float32; the paste-back is ``crop2fullmask`` with the
relax border shaved.

The forward runs on CUDA unless the caller passes ``device="cpu"``; with no
card and no explicit CPU request the constructor raises rather than
quietly running on the CPU.  A ``Predictor`` turns TF32 off
(``train/precision.py``); its ``dtype`` is the compute dtype of the
forward — ``bfloat16`` computes in bf16 on float32 parameters, as the JAX
package's ``dtype`` does, and never casts the module's weights.
``Predictor.from_run`` serves the weights of a run the port's ``Trainer``
wrote, in the run's precision: a ``train.precision=bfloat16`` run serves
in bf16.  ``mean``/``std`` normalise the input channel-wise before the
forward, as the JAX predictor's ``_apply_with_normalize`` does.

A DANet built with ``guidance_inject="head"`` splits into two stages
(``supports_sessions``): :meth:`Predictor.encode` (the RGB crop -> the
backbone's features, kept on the device in the compute dtype) and
:meth:`Predictor.decode` (features + guidance -> probabilities).  Its
``forward_prepared`` is ``decode(encode(rgb), guidance)``, so a stateless
click and a session's warm click (cached features, new guidance from
:meth:`Predictor.prepare_guidance`) run the same two forwards.

A warm boot (``serve/aot.py``) installs compiled programs of exact shapes
(:meth:`Predictor.install_aot`): ``forward_prepared``, ``encode`` and
``decode_device`` run the installed program at its shape and the eager
forward at every other.

``SemanticPredictor`` serves a ``task=semantic`` run: the image resized
to the training crop (cubic, clamped), the argmax of the primary logits
resized back nearest (``resize``), or crop-sized windows at native
resolution whose softmax probabilities are summed where they overlap
(``slide``).  ``predict_cli`` is the CLI's ``--predict``: it serves the
run with the predictor of its task and writes a PNG.
"""

from __future__ import annotations

import math
import os
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from . import imaging
from .data import guidance as guidance_lib
from .train.precision import apply_policy, precision_policy, torch_dtype
from .utils.helpers import crop2fullmask, crop_from_bbox, get_bbox, overlay_mask


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: CUDA unless asked otherwise.

    ``None`` means CUDA and raises where there is none; a CUDA device that
    is not there raises too.  Only an explicit CPU device runs on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    return device


def prepare_input(
    image: np.ndarray,
    points: np.ndarray,
    relax: int = 50,
    zero_pad: bool = True,
    resolution: tuple[int, int] = (512, 512),
    alpha: float = 0.6,
    guidance: str = "nellipse_gaussians",
) -> tuple[np.ndarray, tuple[int, int, int, int]]:
    """Image + clicks -> (network input (H, W, 4) float32, crop bbox).

    ``image`` is (H, W, 3) RGB in [0, 255]; ``points`` is (4, 2) xy in
    full-image coordinates.  The bbox is what :meth:`Predictor.paste_back`
    needs to put the prediction back."""
    image = np.asarray(image, np.float32)
    if image.ndim != 3 or image.shape[-1] != 3:
        raise ValueError(f"expected (H, W, 3) RGB image, got {image.shape}")
    points = np.asarray(points, np.float64)
    if points.shape != (4, 2):
        raise ValueError(f"expected 4 xy extreme points, got {points.shape}")
    h, w = image.shape[:2]
    if (points[:, 0].max() >= w or points[:, 1].max() >= h
            or points.min() < 0):
        raise ValueError(f"points {points.tolist()} outside image {w}x{h}")

    shape_stub = np.broadcast_to(np.uint8(0), (h, w))
    bbox = get_bbox(shape_stub, points=points, pad=relax, zero_pad=zero_pad)
    crop = crop_from_bbox(image, bbox, zero_pad=zero_pad)
    res_h, res_w = resolution
    crop = imaging.resize(crop, (res_h, res_w), imaging.CUBIC)
    heat = guidance_lib.crop_point_guidance(
        points, bbox, (res_h, res_w), alpha=alpha, family=guidance)
    concat = np.concatenate(
        [np.clip(crop, 0.0, 255.0), heat[..., None]], axis=-1)
    return concat.astype(np.float32), bbox


def _randomize_(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter and BatchNorm statistic of a DANet from
    ``generator``, the residual gates, the zero-init last-BN scales and a
    head model's zero-init ``guidance_proj`` included (at 0 they would
    cut the attention branches, or the clicks, out of the logits).  Scales
    keep the activations of a 101-layer net finite."""
    with torch.no_grad():
        for name, module in model.named_modules():
            if isinstance(module, torch.nn.Conv2d):
                fan_in = module.weight[0].numel()
                # the classifiers get logits of order 1, not 0.1; the
                # guidance projection sees [0, 255] maps, not unit ones
                gain = 100.0 if name.endswith("_cls") else \
                    2.0 / 255.0 ** 2 if name == "guidance_proj" else 2.0
                module.weight.normal_(0.0, (gain / fan_in) ** 0.5,
                                      generator=generator)
                if module.bias is not None:
                    module.bias.normal_(0.0, 0.1, generator=generator)
            elif isinstance(module, torch.nn.BatchNorm2d):
                module.weight.uniform_(0.2, 0.6, generator=generator)
                module.bias.normal_(0.0, 0.1, generator=generator)
                module.running_mean.normal_(0.0, 0.1, generator=generator)
                module.running_var.uniform_(0.5, 2.0, generator=generator)
        for name, param in model.named_parameters():
            if name.endswith("gamma"):
                param.uniform_(0.5, 1.0, generator=generator)


def load_run_config(run_dir: str):
    """The ``Config`` a run of the port's ``Trainer`` wrote."""
    from .train.config import from_json

    return from_json(os.path.join(run_dir, "config.json"))


def load_run_model(run_dir: str, cfg, step: int | None = None
                   ) -> tuple[torch.nn.Module, torch.dtype | str]:
    """The model of a run, built from its ``cfg`` with a committed
    checkpoint's weights loaded strictly (``step`` from the latest slot,
    by default the best checkpoint, or the latest where there is no best
    yet), and its compute dtype (``train.precision``, else
    ``model.dtype``)."""
    from .models import build_model
    from .train.checkpoint import CheckpointManager

    mgr = CheckpointManager(os.path.join(run_dir, "checkpoints"))
    best = step is None and bool(mgr.committed_steps(best=True))
    payload, _ = mgr.load(step, best=best)
    policy = precision_policy(cfg.train.precision)
    dtype = policy.compute_dtype if policy else cfg.model.dtype
    model = build_model(cfg.model.name, nclass=cfg.model.nclass,
                        backbone=cfg.model.backbone,
                        output_stride=cfg.model.output_stride,
                        attention_impl=cfg.model.attention_impl,
                        in_channels=cfg.model.in_channels, dtype=dtype,
                        pam_score_dtype=cfg.model.pam_score_dtype,
                        aux_head=cfg.model.aux_head,
                        encnet_codes=cfg.model.encnet_codes,
                        ccnet_recurrence=cfg.model.ccnet_recurrence,
                        guidance_inject=cfg.model.guidance_inject,
                        # a ring-trained run serves with the plain form
                        # (JAX's predict does the same); the moe_* knobs
                        # shape the parameters
                        pam_impl="einsum" if cfg.model.pam_impl == "ring"
                        else cfg.model.pam_impl,
                        pam_block_size=cfg.model.pam_block_size,
                        moe_experts=cfg.model.moe_experts,
                        moe_hidden=cfg.model.moe_hidden,
                        moe_k=cfg.model.moe_k,
                        moe_capacity_factor=cfg.model.moe_capacity_factor)
    model.load_state_dict(payload["model"], strict=True)
    return model, dtype


def _split_channel_stats(vals, n_channels: int):
    """Split per-channel normalisation stats into (rgb, guidance) parts.

    Each stage of a split predictor normalises its own part of the input;
    slicing here keeps that bitwise what normalising the concat and then
    splitting gives.  A single value applies to both parts; per-channel
    stats must cover every channel, or the guidance would silently reuse
    an RGB constant."""
    if vals is None:
        return None, None
    vals = tuple(vals)
    if len(vals) == 1:
        return vals, vals
    if len(vals) != n_channels:
        raise ValueError(
            f"normalization stats have {len(vals)} entries for "
            f"{n_channels} input channels — pass 1 (broadcast) or "
            f"{n_channels} (per-channel incl. guidance)")
    return vals[:-1], vals[-1:]


def _normalize(x: torch.Tensor, mean, std) -> torch.Tensor:
    """Channel-wise ``(x - mean) / std`` of an NCHW float32 batch; nothing
    when neither is given, ``(0,)`` / ``(255,)`` for the one left out (the
    JAX predictor's defaults)."""
    if mean is None and std is None:
        return x
    from .ops.augment import normalize

    return normalize({"concat": x}, mean or (0.0,),
                     std or (255.0,))["concat"]


class FeatureStruct(NamedTuple):
    """Shape, dtype and bytes of one batch of encoded features: what a
    session's cache entry holds, and what the store's budget charges."""
    shape: tuple[int, ...]
    dtype: torch.dtype
    nbytes: int


class Predictor:
    """Reusable click-to-mask inference on one DANet.

    >>> p = Predictor.fresh(512, "resnet101", seed=0)   # random weights
    >>> prob = p.predict(image, points)                 # (H, W) in [0, 1]
    """

    #: the weight-quantization regime (``serve/quantize.QuantPolicy``);
    #: None on a float predictor
    quant_policy = None

    def __init__(self, model: torch.nn.Module,
                 resolution: tuple[int, int] = (512, 512),
                 relax: int = 50, zero_pad: bool = True, alpha: float = 0.6,
                 guidance: str = "nellipse_gaussians", in_channels: int = 4,
                 device: str | torch.device | None = None,
                 dtype: torch.dtype = torch.float32,
                 mean: Sequence[float] | None = None,
                 std: Sequence[float] | None = None):
        if guidance not in guidance_lib.POINT_GUIDANCE:
            raise ValueError(f"guidance {guidance!r} is not derivable from "
                             "clicks alone "
                             f"({' | '.join(guidance_lib.POINT_GUIDANCE)})")
        self.device = resolve_device(device)
        apply_policy("float32")
        self.dtype = torch_dtype(dtype)
        self.model = model.to(device=self.device).eval()
        self.model.set_compute_dtype(self.dtype)
        self.resolution = tuple(resolution)
        self.relax = relax
        self.zero_pad = zero_pad
        self.alpha = alpha
        self.guidance = guidance
        self.in_channels = in_channels
        self.mean, self.std = mean, std
        #: a guidance_inject="head" DANet runs encode and decode apart
        self.supports_sessions = \
            getattr(model, "guidance_inject", "stem") == "head"
        if self.supports_sessions:
            rgb_mean, g_mean = _split_channel_stats(mean, in_channels)
            rgb_std, g_std = _split_channel_stats(std, in_channels)
            self._rgb_stats = (rgb_mean, rgb_std)
            self._guidance_stats = (g_mean, g_std)
        self._feature_shape: tuple[int, ...] | None = None
        #: per-shape AOT programs (serve/aot.py): empty unless a warm boot
        #: installed some
        self._aot: dict = {}

    @classmethod
    def fresh(cls, size: int = 512, backbone: str = "resnet101",
              seed: int = 0, device: str | torch.device | None = None,
              dtype: torch.dtype = torch.float32,
              guidance_inject: str = "stem", **kwargs) -> "Predictor":
        """A predictor on DANet(nclass=1, ``backbone``, output stride 8,
        ``guidance_inject``) at ``size``², every weight drawn from
        ``torch.Generator`` seeded with ``seed`` — no checkpoint needed;
        ``dtype`` is the compute dtype (the weights are float32)."""
        from .models import build_model

        device = resolve_device(device)
        model = build_model("danet", nclass=1, backbone=backbone,
                            output_stride=8, dtype=dtype,
                            guidance_inject=guidance_inject)
        _randomize_(model, torch.Generator().manual_seed(seed))
        return cls(model, resolution=(size, size), device=device, dtype=dtype,
                   **kwargs)

    @classmethod
    def from_run(cls, run_dir: str, step: int | None = None,
                 device: str | torch.device | None = None,
                 **kwargs) -> "Predictor":
        """Serve a training run of the port's ``Trainer``: its
        ``config.json`` and a committed checkpoint — ``step`` from the
        latest slot, or by default the best checkpoint (the latest when
        there is no best yet), as the JAX package's ``from_run`` does.
        Crop size, relax, zero padding, alpha, guidance and the compute
        dtype (``train.precision``, else ``model.dtype``) come from the
        run's config unless given."""
        cfg = load_run_config(run_dir)
        if cfg.task != "instance":
            raise ValueError(
                f"Predictor is the click-guided instance path; this run was "
                f"trained with task={cfg.task!r} (use SemanticPredictor)")
        if cfg.data.guidance not in guidance_lib.POINT_GUIDANCE:
            # before the weights are read, with the JAX package's message
            raise ValueError(
                f"this run's guidance family ({cfg.data.guidance!r}) is not "
                "derivable from clicks alone (confidence maps need the gt "
                "mask; 'none' has no channel) — click-based prediction does "
                "not apply to it")
        model, dtype = load_run_model(run_dir, cfg, step)
        kwargs.setdefault("dtype", dtype)
        kwargs.setdefault("resolution", tuple(cfg.data.crop_size))
        kwargs.setdefault("relax", cfg.data.relax)
        kwargs.setdefault("zero_pad", cfg.data.zero_pad)
        kwargs.setdefault("alpha", cfg.data.guidance_alpha)
        kwargs.setdefault("guidance", cfg.data.guidance)
        kwargs.setdefault("in_channels", cfg.model.in_channels)
        return cls(model, device=device, **kwargs)

    def prepare(self, image: np.ndarray,
                points: Any) -> tuple[np.ndarray, tuple[int, int, int, int]]:
        """:func:`prepare_input` with this predictor's settings (host-only,
        safe to call from many threads)."""
        return prepare_input(image, points, relax=self.relax,
                             zero_pad=self.zero_pad,
                             resolution=self.resolution,
                             alpha=self.alpha, guidance=self.guidance)

    def install_aot(self, key: tuple, program) -> None:
        """Install a compiled program for one shape.

        ``key``: ``("forward", (B, H, W, C))`` for a whole-forward
        predictor, ``("encode", bucket)`` / ``("decode", bucket)`` for a
        split one: the keys ``serve.aot.AotCache`` hands the warm boot.
        Calls at exactly that shape then run ``program`` (a loaded
        AOTInductor package); every other shape keeps the eager path."""
        kind = key[0]
        valid = ({"encode", "decode"} if self.supports_sessions
                 else {"forward"})
        if kind not in valid:
            raise ValueError(
                f"install_aot: key kind {kind!r} does not match this "
                f"predictor's programs ({sorted(valid)})")
        self._aot[key] = program

    @property
    def aot_programs(self) -> list:
        """Keys of the installed AOT programs."""
        return sorted(self._aot, key=str)

    def _nhwc(self, x) -> torch.Tensor:
        """(B, H, W, C) or (H, W, C) numpy or tensor -> a (B, H, W, C)
        float32 tensor on this predictor's device."""
        t = x if torch.is_tensor(x) else \
            torch.from_numpy(np.ascontiguousarray(x, np.float32))
        if t.ndim == 3:
            t = t[None]
        return t.to(self.device, torch.float32)

    def forward_prepared(self, concat: np.ndarray) -> np.ndarray:
        """(B, H, W, C) prepared crops -> (B, H, W) float32 probabilities of
        the fused head.  A single (H, W, C) crop is treated as B = 1.  A
        split predictor runs ``decode(encode(rgb), guidance)``."""
        if self.supports_sessions:
            concat = np.asarray(concat, np.float32)
            if concat.ndim == 3:
                concat = concat[None]
            return self.decode(self.encode(concat[..., :-1]),
                               concat[..., -1:])
        x = self._nhwc(concat)
        program = self._aot.get(("forward", tuple(x.shape))) \
            if self._aot else None
        if program is not None:
            with torch.inference_mode():
                return program(x).cpu().numpy()
        x = _normalize(x.permute(0, 3, 1, 2), self.mean, self.std)
        with torch.inference_mode():
            logits = self.model(x.to(self.dtype).contiguous())[0]
            probs = torch.sigmoid(logits.float())[:, 0]
        return probs.cpu().numpy()

    def _need_sessions(self, what: str) -> None:
        if not self.supports_sessions:
            raise ValueError(f"{what}: this predictor has no encode stage "
                             "(guidance_inject='stem')")

    def encode(self, rgb) -> torch.Tensor:
        """(B, H, W, C - 1) RGB crops (numpy or tensor, [0, 255]) -> the
        backbone's features (B, C_feat, H / os, W / os), in the compute
        dtype, on the device: a session's cache entry."""
        self._need_sessions("encode")
        x = self._nhwc(rgb)
        program = self._aot.get(("encode", x.shape[0])) if self._aot else None
        if program is not None:
            with torch.inference_mode():
                return program(x)
        x = _normalize(x.permute(0, 3, 1, 2), *self._rgb_stats)
        with torch.inference_mode():
            return self.model(x.to(self.dtype).contiguous(), stage="encode")

    def decode_device(self, features: torch.Tensor,
                      guidance) -> torch.Tensor:
        """Encoded ``features`` + (B, H, W, 1) guidance -> (B, H, W) float32
        probabilities of the fused head, left on the device."""
        self._need_sessions("decode")
        g = self._nhwc(guidance)
        program = self._aot.get(("decode", features.shape[0])) \
            if self._aot else None
        if program is not None:
            with torch.inference_mode():
                return program(features, g)
        g = _normalize(g.permute(0, 3, 1, 2), *self._guidance_stats)
        with torch.inference_mode():
            logits = self.model((features, g.to(self.dtype).contiguous()),
                                stage="decode", out_size=self.resolution)[0]
            return torch.sigmoid(logits.float())[:, 0]

    def decode(self, features: torch.Tensor, guidance) -> np.ndarray:
        """:meth:`decode_device`, read back: (B, H, W) float32 numpy."""
        return self.decode_device(features, guidance).cpu().numpy()

    def feature_struct(self, batch: int = 1) -> FeatureStruct:
        """Shape, dtype and bytes of ``batch`` encoded crops, found once by
        running the encode stage on the ``meta`` device (no dispatch)."""
        self._need_sessions("feature_struct")
        if self._feature_shape is None:
            h, w = self.resolution
            meta = {k: torch.empty_like(v, device="meta") for k, v in
                    [*self.model.named_parameters(),
                     *self.model.named_buffers()]}
            x = torch.empty((1, self.in_channels - 1, h, w), device="meta",
                            dtype=self.dtype)
            with torch.inference_mode():
                out = torch.func.functional_call(self.model, meta, (x,),
                                                 {"stage": "encode"})
            self._feature_shape = tuple(out.shape[1:])
        shape = (batch, *self._feature_shape)
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return FeatureStruct(shape, self.dtype, math.prod(shape) * itemsize)

    def prepare_guidance(self, points: Any,
                         bbox: tuple[int, int, int, int]) -> np.ndarray:
        """A warm click's guidance: new clicks in an existing crop.

        A session's first click fixed ``bbox`` (and the cached features of
        that crop); a later click re-synthesises only the guidance in the
        same crop's coordinates, by :func:`prepare_input`'s point rule
        with the bbox held.  Returns (H, W, 1) float32 at
        ``resolution``."""
        points = np.asarray(points, np.float64)
        if points.shape != (4, 2):
            raise ValueError(f"expected 4 xy extreme points, got "
                             f"{points.shape}")
        heat = guidance_lib.crop_point_guidance(
            points, bbox, self.resolution, alpha=self.alpha,
            family=self.guidance)
        return heat.astype(np.float32)[..., None]

    def paste_back(self, prob: np.ndarray, bbox: tuple[int, int, int, int],
                   shape_hw: tuple[int, int]) -> np.ndarray:
        """One crop-space probability map -> full-image coordinates, relax
        border shaved, clipped to [0, 1]."""
        return np.clip(crop2fullmask(prob, bbox, shape_hw,
                                     zero_pad=self.zero_pad,
                                     relax=self.relax), 0.0, 1.0)

    def predict(self, image: np.ndarray, points: Any) -> np.ndarray:
        """(H, W, 3) image + (4, 2) xy clicks -> (H, W) float32 mask."""
        return self.predict_batch(image, [points])[0]

    def predict_batch(self, image: np.ndarray,
                      points_list: Sequence[Any]) -> list[np.ndarray]:
        """Segment N objects of one image in one batched forward."""
        if len(points_list) == 0:
            return []
        prepared = [self.prepare(image, pts) for pts in points_list]
        probs = self.forward_prepared(np.stack([c for c, _ in prepared]))
        return [self.paste_back(probs[i], bbox, image.shape[:2])
                for i, (_, bbox) in enumerate(prepared)]


class SemanticPredictor:
    """Whole-image multi-class inference for ``task=semantic`` runs, the
    semantic validation stack's protocol.

    >>> p = SemanticPredictor.from_run("runs/run_0")
    >>> classes = p.predict(image)       # (H, W) uint8 class ids

    Runs on CUDA unless ``device="cpu"``; ``dtype`` is the compute dtype
    of the forward on float32 parameters; ``mean``/``std`` normalise the
    input channel-wise before the forward, as :class:`Predictor`'s do."""

    def __init__(self, model: torch.nn.Module,
                 resolution: tuple[int, int] = (513, 513),
                 device: str | torch.device | None = None,
                 dtype: torch.dtype = torch.float32,
                 mean: Sequence[float] | None = None,
                 std: Sequence[float] | None = None):
        self.device = resolve_device(device)
        apply_policy("float32")
        self.dtype = torch_dtype(dtype)
        self.model = model.to(device=self.device).eval()
        self.model.set_compute_dtype(self.dtype)
        self.resolution = tuple(resolution)
        self.mean, self.std = mean, std

    @classmethod
    def from_run(cls, run_dir: str, step: int | None = None,
                 device: str | torch.device | None = None,
                 **kwargs) -> "SemanticPredictor":
        """Serve a ``task=semantic`` run of the port's ``Trainer`` (the
        checkpoint as :meth:`Predictor.from_run` picks it) at its crop
        size and precision unless given."""
        cfg = load_run_config(run_dir)
        if cfg.task != "semantic":
            raise ValueError(
                f"SemanticPredictor is the whole-image multi-class path; "
                f"this run was trained with task={cfg.task!r} (use "
                f"Predictor for click-guided instance runs)")
        model, dtype = load_run_model(run_dir, cfg, step)
        kwargs.setdefault("dtype", dtype)
        kwargs.setdefault("resolution", tuple(cfg.data.crop_size))
        return cls(model, device=device, **kwargs)

    def _logits(self, x: np.ndarray) -> torch.Tensor:
        """The primary logits of (B, H, W, 3) images, NCHW float32."""
        t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        t = t.to(self.device).permute(0, 3, 1, 2).contiguous()
        t = _normalize(t, self.mean, self.std)
        with torch.inference_mode():
            return self.model(t.to(self.dtype))[0].float()

    def forward_classes(self, x: np.ndarray) -> np.ndarray:
        """(B, H, W) int class ids of (B, H, W, 3) crops: the argmax runs on
        the device, only the map is read back."""
        return self._logits(x).argmax(dim=1).cpu().numpy()

    def forward_probs(self, x: np.ndarray) -> np.ndarray:
        """(B, H, W, C) float32 softmax probabilities of (B, H, W, 3)
        crops."""
        return torch.softmax(self._logits(x), dim=1).permute(
            0, 2, 3, 1).cpu().numpy()

    def predict(self, image: np.ndarray, mode: str = "resize",
                overlap: float = 0.5) -> np.ndarray:
        """(H, W, 3) RGB in [0, 255] -> (H, W) class ids, uint8 where the
        class count fits (int32 otherwise).

        ``resize``: the whole image resized to the training crop (cubic,
        clamped), one forward, the class map resized back nearest.
        ``slide``: crop-sized windows at native resolution with stride
        ``(1 - overlap)`` of the crop (the last window flush with the
        edge; an image smaller than the crop is zero-padded), the softmax
        probabilities summed where windows overlap, argmax once."""
        image = np.asarray(image, np.float32)
        if image.ndim != 3 or image.shape[-1] != 3:
            raise ValueError(f"expected (H, W, 3) RGB image, got "
                             f"{image.shape}")
        dtype = np.uint8 if self.model.nclass <= 256 else np.int32
        if mode == "resize":
            resized = imaging.resize(np.clip(image, 0.0, 255.0),
                                     self.resolution, imaging.CUBIC)
            classes = self.forward_classes(resized[None])[0]
            full = imaging.resize(classes.astype(np.float32),
                                  image.shape[:2], imaging.NEAREST)
            return full.astype(dtype)
        if mode != "slide":
            raise ValueError(f"unknown mode {mode!r} (resize | slide)")
        if not 0.0 <= overlap < 1.0:
            raise ValueError(f"overlap must be in [0, 1), got {overlap}")
        ch, cw = self.resolution
        h, w = image.shape[:2]
        hp, wp = max(h, ch), max(w, cw)
        padded = np.zeros((hp, wp, 3), np.float32)
        padded[:h, :w] = np.clip(image, 0.0, 255.0)

        def starts(full: int, crop: int, stride: int) -> list[int]:
            s = list(range(0, full - crop + 1, stride))
            if s[-1] != full - crop:
                s.append(full - crop)
            return s

        sh = max(1, int(ch * (1.0 - overlap)))
        sw = max(1, int(cw * (1.0 - overlap)))
        probs = np.zeros((hp, wp, self.model.nclass), np.float32)
        for y in starts(hp, ch, sh):
            for x in starts(wp, cw, sw):
                win = padded[y:y + ch, x:x + cw]
                probs[y:y + ch, x:x + cw] += self.forward_probs(win[None])[0]
        # the per-pixel window count scales every class alike: the sum's
        # argmax is the mean's
        return np.argmax(probs, axis=-1)[:h, :w].astype(dtype)


def parse_points(spec: str) -> np.ndarray:
    """The CLI's clicks: ``"x1,y1 x2,y2 x3,y3 x4,y4"`` (or ;-separated)."""
    parts = spec.replace(";", " ").split()
    try:
        pts = np.array([[float(v) for v in p.split(",")] for p in parts])
    except ValueError as e:
        raise ValueError(f"bad --points {spec!r}: {e}") from e
    if pts.shape != (4, 2):
        raise ValueError(
            f"--points needs exactly 4 x,y pairs, got shape {pts.shape}")
    return pts


def predict_cli(run_dir: str, image_path: str, points_spec: str | None,
                out_path: str, threshold: float | None = None,
                overlay_path: str | None = None, slide: bool = False,
                device: str | torch.device | None = None) -> dict:
    """The CLI's ``--predict``, by the run's task: an instance run takes
    the 4 clicks (``points_spec``) and writes a binary mask PNG
    (``threshold`` 0.5 by default); a semantic run takes the whole image
    and writes a class-id PNG.  Clicks or a threshold for a semantic run,
    or ``slide`` for an instance run, raise.  ``overlay_path`` also writes
    the mask (the non-background classes) over the image.  Returns a
    summary."""
    from PIL import Image

    cfg = load_run_config(run_dir)
    with Image.open(image_path) as im:
        image = np.asarray(im.convert("RGB"))

    def write_overlay(mask: np.ndarray) -> None:
        if overlay_path:
            over = overlay_mask(image.astype(np.float32) / 255.0,
                                mask.astype(np.float32))
            Image.fromarray((np.clip(over, 0, 1) * 255).astype(np.uint8)
                            ).save(overlay_path)

    if cfg.task == "semantic":
        if points_spec or threshold is not None:
            raise ValueError(
                "this run is task='semantic' (whole-image class map): "
                "--points/--threshold do not apply")
        mode = "slide" if slide else "resize"
        classes = SemanticPredictor.from_run(run_dir, device=device).predict(
            image, mode=mode)
        Image.fromarray(classes).save(out_path)
        write_overlay(classes > 0)
        present = {int(c): int(n) for c, n in
                   zip(*np.unique(classes, return_counts=True))}
        return {"task": "semantic", "classes": present, "out": out_path,
                "mode": mode}
    if slide:
        raise ValueError("this run is task='instance' (click-guided crop "
                         "inference): --slide does not apply")
    if not points_spec:
        raise ValueError("this run is task='instance': --points (the 4 "
                         "extreme-point clicks) is required")
    threshold = 0.5 if threshold is None else threshold
    prob = Predictor.from_run(run_dir, device=device).predict(
        image, parse_points(points_spec))
    mask = prob > threshold
    Image.fromarray((mask * 255).astype(np.uint8)).save(out_path)
    write_overlay(mask)
    return {"task": "instance", "pixels": int(mask.sum()),
            "threshold": threshold, "max_prob": float(prob.max()),
            "out": out_path}
