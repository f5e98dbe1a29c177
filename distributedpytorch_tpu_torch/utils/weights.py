"""Carry parameter trees between the JAX package and the port's modules.

The trees are nested dicts of numpy arrays (``variables["params"]`` and
``variables["batch_stats"]`` of a flax model, e.g. after
``jax.device_get``).  The port's module names follow flax's, so each leaf
path maps to one ``state_dict`` key; the layouts differ as follows:

==================  ===========================  ==========================
flax leaf           port key                     conversion
==================  ===========================  ==========================
``Conv/kernel``     ``Conv.weight``              HWIO -> OIHW
``Conv/bias``       ``Conv.bias``                as is
``BN/scale``        ``BN.weight``                as is
``BN/bias``         ``BN.bias``                  as is
``BN/mean``         ``BN.running_mean``          (from batch_stats)
``BN/var``          ``BN.running_var``           (from batch_stats)
``gamma``           ``gamma``                    scalar, as is
``moe/w_gate`` ...  ``moe.w_gate`` ...           as is (``w_gate``, ``w1``,
                                                 ``b1``, ``w2``, ``b2``)
==================  ===========================  ==========================

A head-injected DANet's ``guidance_proj/kernel`` (HWIO (1, 1, 1, C)) is a
conv kernel like any other, and its stem kernel has 3 input channels.
Loading is ``strict=True``: a leaf with no key, or a key with no leaf,
raises.  (BatchNorm's ``num_batches_tracked`` counter has no flax
counterpart and keeps the module's value.)  :func:`state_dict_to_jax` is
the inverse: a port ``state_dict`` back to a (params, batch_stats) pair of
nested numpy dicts, bit for bit.

Warm start reads torch ``.pth`` files (:func:`load_torch_file`) and copies
them into a model in place (:func:`import_state_dict`).  The port's keys
are the ones the JAX package's ``params_to_torch_state_dict`` exports, so
a JAX export imports with no rename; a torchvision ResNet checkpoint is
bridged by :func:`torchvision_resnet_rename` and
:func:`inflate_stem_channels` — the port's copies of
``distributedpytorch_tpu/utils/torch_interop.py``'s helpers.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import numpy as np
import torch
from torch import nn

#: leaves carried under their own names: the gates and the MoE's stacks
_AS_IS = ("bias", "gamma", "w_gate", "w1", "b1", "w2", "b2")
_PARAM_NAMES = {"kernel": "weight", "scale": "weight",
                **{name: name for name in _AS_IS}}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping[str, Any], prefix: tuple[str, ...] = ()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, np.asarray(value)


def jax_to_state_dict(params: Mapping[str, Any],
                      batch_stats: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` entries for a flax (params, batch_stats)
    pair (without BatchNorm's ``num_batches_tracked``)."""
    out: dict[str, torch.Tensor] = {}
    for tree, names in ((params, _PARAM_NAMES), (batch_stats, _STAT_NAMES)):
        for path, value in _flatten(tree):
            leaf = path[-1]
            if leaf not in names:
                raise KeyError(f"no port counterpart for JAX leaf {'/'.join(path)}")
            if leaf == "kernel":
                if value.ndim != 4:
                    raise ValueError(f"{'/'.join(path)}: expected an HWIO conv "
                                     f"kernel, got shape {value.shape}")
                value = value.transpose(3, 2, 0, 1)
            key = ".".join(path[:-1] + (names[leaf],))
            out[key] = torch.from_numpy(np.ascontiguousarray(value, np.float32))
    return out


def load_jax_params(model: nn.Module, params: Mapping[str, Any],
                    batch_stats: Mapping[str, Any]) -> nn.Module:
    """Copy a flax (params, batch_stats) pair into ``model`` (strict) and
    return it."""
    state = jax_to_state_dict(params, batch_stats)
    for key, value in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            state[key] = value
    model.load_state_dict(state, strict=True)
    return model


def state_dict_to_jax(state: Mapping[str, torch.Tensor]
                      ) -> tuple[dict[str, Any], dict[str, Any]]:
    """The flax ``(params, batch_stats)`` trees of a port ``state_dict``:
    nested dicts of float32 numpy arrays, conv kernels back to HWIO.  A
    BatchNorm is a module with ``running_mean``; its ``weight`` becomes
    ``scale``."""
    norms = {k.rsplit(".", 1)[0] for k in state if k.endswith(".running_mean")}
    params: dict[str, Any] = {}
    stats: dict[str, Any] = {}
    for key, value in state.items():
        *path, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        arr = value.detach().cpu().numpy()
        is_norm = ".".join(path) in norms
        if leaf in ("running_mean", "running_var"):
            tree, name = stats, leaf.removeprefix("running_")
        elif leaf == "weight":
            tree, name = params, "scale" if is_norm else "kernel"
            if not is_norm:
                if arr.ndim != 4:
                    raise ValueError(f"{key}: expected an OIHW conv weight, "
                                     f"got shape {arr.shape}")
                arr = arr.transpose(2, 3, 1, 0)
        elif leaf in _AS_IS:
            tree, name = params, leaf
        else:
            raise KeyError(f"no JAX counterpart for port key {key}")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[name] = arr.copy()  # ascontiguousarray would make a 0-d gate 1-d
    return params, stats


def load_torch_file(path: str) -> dict[str, np.ndarray]:
    """``torch.load`` a ``.pth`` (CPU, weights only) into a numpy
    state_dict: a ``{"state_dict": ...}`` wrapper unwrapped, a ``module.``
    prefix (``nn.DataParallel``) stripped, ``num_batches_tracked``
    dropped."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]
    out = {}
    for key, value in raw.items():
        key = key.removeprefix("module.")
        if key.endswith("num_batches_tracked"):
            continue
        out[key] = value.detach().numpy() if hasattr(value, "detach") \
            else np.asarray(value)
    return out


def is_torchvision_resnet(state_dict: Mapping[str, Any]) -> bool:
    """Whether the keys follow torchvision's ResNet naming (``conv1``,
    ``layer1.0.conv1``, ...) rather than this package's; a deep stem in
    that naming (``conv1.0``, ...) counts, so its import refuses it by
    name."""
    keys = state_dict.keys()
    return (("conv1.weight" in keys or "conv1.0.weight" in keys)
            and any(k.startswith("layer1.0.conv") for k in keys)
            and not any("Block_" in k for k in keys))


def _refuse_deep_stem(keys) -> None:
    """Raise for a deep stem in torchvision-style naming: ``conv1`` as a
    sequence of three 3x3 convs and their BatchNorms (``conv1.0``,
    ``conv1.1``, ... ``conv1.6``).  The import maps the single 7x7 stem
    only; the port's ``ResNet(deep_stem=True)`` has no torchvision
    counterpart."""
    deep = sorted(k for k in keys
                  if k.startswith("conv1.") and k.split(".")[1].isdigit())
    if deep:
        raise ValueError(
            f"deep stem ({deep[0]}, ...: three 3x3 convs) in a torchvision-"
            "style checkpoint; the torchvision import maps only the single "
            "7x7 stem (conv1 / bn1)")


def torchvision_resnet_depth(state_dict: Mapping[str, Any]) -> int:
    """The depth of a torchvision ResNet state_dict, from its blocks per
    stage and block type; raises for any other layout."""
    from ..models.resnet import BOTTLENECK_DEPTHS, RESNET_DEPTHS

    counts = []
    for stage in (1, 2, 3, 4):
        n = 0
        while f"layer{stage}.{n}.conv1.weight" in state_dict:
            n += 1
        counts.append(n)
    bottleneck = any(".conv3." in k for k in state_dict)
    for depth, c in RESNET_DEPTHS.items():
        if tuple(c) == tuple(counts) and (depth in BOTTLENECK_DEPTHS) == bottleneck:
            return depth
    raise ValueError(f"unrecognized torchvision ResNet layout: stage counts "
                     f"{counts}, {'bottleneck' if bottleneck else 'basic'} blocks")


def torchvision_resnet_rename(depth: int, prefix: str = "backbone"
                              ) -> Callable[[str], str | None]:
    """Key rename from a torchvision ResNet-``depth`` onto the port's
    ``prefix`` submodule (``None`` drops a key: the classifier ``fc``)::

        conv1 / bn1                     Conv_0 / BatchNorm_0
        layer{s}.{i}.conv{k} / bn{k}    <Block>_{flat}.Conv_{k-1} / BatchNorm_{k-1}
        layer{s}.{i}.downsample.0 / 1   <Block>_{flat}.Conv_K / BatchNorm_K

    with ``flat`` the block's index over all stages and ``K`` the
    shortcut's slot (3 in a bottleneck block, 2 in a basic one).  A deep
    stem's key raises (:func:`_refuse_deep_stem`)."""
    from ..models.resnet import BOTTLENECK_DEPTHS, RESNET_DEPTHS

    counts = RESNET_DEPTHS[depth]
    bottleneck = depth in BOTTLENECK_DEPTHS
    block = "BottleneckBlock" if bottleneck else "BasicBlock"
    down_slot = 3 if bottleneck else 2
    stage_base = [sum(counts[:s]) for s in range(len(counts))]

    def rename(key: str) -> str | None:
        _refuse_deep_stem([key])
        parts = key.split(".")
        if parts[0] == "fc" or parts[-1] == "num_batches_tracked":
            return None
        if parts[0] == "conv1":
            return f"{prefix}.Conv_0.{parts[1]}"
        if parts[0] == "bn1":
            return f"{prefix}.BatchNorm_0.{parts[1]}"
        if parts[0].startswith("layer"):
            stage = int(parts[0][len("layer"):]) - 1
            mod = f"{prefix}.{block}_{stage_base[stage] + int(parts[1])}"
            if parts[2] == "downsample":
                kind = "Conv" if parts[3] == "0" else "BatchNorm"
                return f"{mod}.{kind}_{down_slot}.{parts[4]}"
            if parts[2].startswith("conv"):
                return f"{mod}.Conv_{int(parts[2][4:]) - 1}.{parts[3]}"
            if parts[2].startswith("bn"):
                return f"{mod}.BatchNorm_{int(parts[2][2:]) - 1}.{parts[3]}"
        return key

    return rename


def inflate_stem_channels(state_dict: Mapping[str, np.ndarray],
                          in_channels: int,
                          key: str = "conv1.weight") -> dict:
    """Zero-pad the stem conv's input channels (OIHW dim 1) up to
    ``in_channels``: an RGB backbone takes the guidance channel, which
    starts out contributing nothing.  A deep stem raises
    (:func:`_refuse_deep_stem`)."""
    _refuse_deep_stem(state_dict.keys())
    out = dict(state_dict)
    w = np.asarray(out[key])
    have = w.shape[1]
    if have > in_channels:
        raise ValueError(f"stem has {have} input channels; cannot shrink "
                         f"to {in_channels}")
    if have < in_channels:
        pad = np.zeros((w.shape[0], in_channels - have) + w.shape[2:], w.dtype)
        out[key] = np.concatenate([w, pad], axis=1)
    return out


def import_state_dict(model: nn.Module, state_dict: Mapping[str, Any],
                      rename: Callable[[str], str | None] | None = None,
                      allow_missing: bool = False,
                      allow_unused: bool = False
                      ) -> tuple[list[str], list[str]]:
    """Copy ``state_dict`` into ``model``'s parameters and BatchNorm
    statistics in place (an optimizer built on them keeps them); returns
    the keys imported and the keys kept at the model's values.

    ``rename`` maps a checkpoint key to the model's (``None`` drops it).
    ``allow_missing`` keeps a model key that the checkpoint lacks, or has
    in another shape; ``allow_unused`` ignores checkpoint keys that match
    nothing.  Both default to raising, as the JAX import does: a rename
    typo shows as a missing key and an unused one at once."""
    available = {}
    for key, value in state_dict.items():
        key = rename(key) if rename else key
        if key is not None:
            available[key] = np.asarray(value)
    target = {k: v for k, v in model.state_dict().items()
              if not k.endswith("num_batches_tracked")}
    new, kept = {}, []
    for key, like in target.items():
        if key not in available:
            if not allow_missing:
                raise KeyError(f"checkpoint missing {key!r}; pass "
                               "allow_missing=True for a partial warm start")
            kept.append(key)
            continue
        value = available[key]
        if tuple(value.shape) != tuple(like.shape):
            if not allow_missing:
                raise ValueError(f"shape mismatch at {key}: checkpoint "
                                 f"{tuple(value.shape)} vs model {tuple(like.shape)}")
            kept.append(key)
            continue
        new[key] = torch.from_numpy(np.array(value)).to(like.dtype)
    unused = sorted(set(available) - set(new))
    if unused and not allow_unused:
        raise KeyError(f"checkpoint keys unmatched by the model: {unused[:8]}"
                       f"{'...' if len(unused) > 8 else ''}")
    with torch.no_grad():
        for key, value in new.items():
            target[key].copy_(value)
    return sorted(new), kept
