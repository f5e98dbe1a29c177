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
==================  ===========================  ==========================

Loading is ``strict=True``: a leaf with no key, or a key with no leaf,
raises.  (BatchNorm's ``num_batches_tracked`` counter has no flax
counterpart and keeps the module's value.)  :func:`state_dict_to_jax` is
the inverse: a port ``state_dict`` back to a (params, batch_stats) pair of
nested numpy dicts, bit for bit.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

_PARAM_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias",
                "gamma": "gamma"}
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
        elif leaf in ("bias", "gamma"):
            tree, name = params, leaf
        else:
            raise KeyError(f"no JAX counterpart for port key {key}")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(arr)
    return params, stats
