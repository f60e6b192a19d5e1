"""Carry the JAX model's Flax parameters over to the port's ``state_dict``.

``params_from_flax(params)`` takes the Flax param tree as nested dicts of
numpy arrays and returns a flat ``state_dict`` of float32 tensors:

  * ``X/norm/{scale,bias}``      -> ``X.{weight,bias}``
  * ``X/conv/kernel`` (HWIO)     -> ``X.weight``: (3, 3, Cout, Cin) for the
    convs the fused GN+SiLU+conv3x3 kernel computes (a ResBlock's
    ``in_conv``/``out_conv`` and the top-level ``out_conv``), OIHW otherwise
  * ``X/conv/kernel`` (1, C, 3C) -> ``X.weight`` (3C, C) (attention qkv/proj)
  * ``X/dense/kernel`` (in, out) -> ``X.weight`` (out, in)
  * ``X/{conv,dense}/bias``      -> ``X.bias``
  * ``label_emb/embedding``      -> ``label_emb.weight``

Any Flax leaf it cannot map raises.  ``load_flax_params(model, params)``
also names every port key the tree leaves unset or sets but the model
lacks, and every shape that differs, before loading.

``inception_from_jax(params)`` builds the port's FID InceptionV3
(``evals.inception.FIDInceptionV3``) from the JAX package's Inception param
tree (nested dicts of arrays): each conv's HWIO ``w`` becomes OIHW, its
folded ``scale`` and ``shift`` and the ``fc`` head ([in, out]) stay as they
are.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["params_from_flax", "load_flax_params", "inception_from_jax"]

_FUSED_CONVS = ("in_conv", "out_conv")


def _flatten(tree: Mapping, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, np.array(value, dtype=np.float32)


def _is_fused(module_path) -> bool:
    """A ResBlock's in_conv/out_conv, or the model's own out_conv."""
    name = module_path[-1]
    if len(module_path) == 1:
        return name == "out_conv"
    return name in _FUSED_CONVS and module_path[-2].endswith("_res")


def _convert_leaf(path, value: np.ndarray):
    *module, layer, leaf = path
    module = tuple(module)
    key = ".".join(module)
    if layer == "norm" and leaf == "scale":
        return f"{key}.weight", value
    if layer in ("norm", "conv", "dense") and leaf == "bias":
        return f"{key}.bias", value
    if layer == "conv" and leaf == "kernel":
        if value.ndim == 3:  # 1-D 1x1 conv (1, in, out)
            return f"{key}.weight", value[0].T
        if value.ndim == 4:
            axes = (0, 1, 3, 2) if _is_fused(module) else (3, 2, 0, 1)
            return f"{key}.weight", value.transpose(axes)
    if layer == "dense" and leaf == "kernel":
        return f"{key}.weight", value.T
    if path == ("label_emb", "embedding"):
        return "label_emb.weight", value
    raise KeyError(f"no port counterpart for Flax parameter {'/'.join(path)} "
                   f"{tuple(value.shape)}")


def params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax param tree (nested dicts of arrays) -> the port's state_dict."""
    out = {}
    for path, value in _flatten(params):
        key, arr = _convert_leaf(path, value)
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def load_flax_params(model: torch.nn.Module, params: Mapping) -> torch.nn.Module:
    """Convert ``params`` and load them into ``model``; raise naming every
    missing or unused key and every shape mismatch."""
    state = params_from_flax(params)
    expected = model.state_dict()
    missing = sorted(set(expected) - set(state))
    unused = sorted(set(state) - set(expected))
    shapes = sorted(
        f"{k}: flax {tuple(state[k].shape)} vs port {tuple(expected[k].shape)}"
        for k in set(state) & set(expected)
        if state[k].shape != expected[k].shape
    )
    if missing or unused or shapes:
        raise ValueError(
            "Flax params do not match the port model:\n"
            f"  missing in the Flax tree: {missing}\n"
            f"  unused from the Flax tree: {unused}\n"
            f"  shape mismatches: {shapes}"
        )
    model.load_state_dict(state, strict=True)
    return model


def inception_from_jax(params: Mapping, device="cpu"):
    """The JAX Inception param tree -> the port's ``FIDInceptionV3`` on
    ``device``; a missing, left-over or misshapen leaf raises (strict
    ``load_state_dict``)."""
    from .evals.inception import FIDInceptionV3

    state = {}
    for path, value in _flatten(params):
        if path[-1] == "w" and value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        state[".".join(path)] = torch.from_numpy(np.ascontiguousarray(value))
    model = FIDInceptionV3(fc="fc" in params)
    model.load_state_dict(state, strict=True)
    return model.to(device)
