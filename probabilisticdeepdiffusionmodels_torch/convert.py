"""Carry the JAX model's Flax parameters over to the port's ``state_dict``.

``params_from_flax(params)`` takes the Flax param tree as nested dicts of
numpy arrays and returns a flat ``state_dict`` of float32 tensors:

  * ``X/norm/{scale,bias}``      -> ``X.{weight,bias}``
  * ``X/conv/kernel`` (HWIO)     -> ``X.weight``: (3, 3, Cout, Cin) for the
    2-D convs the fused GN+SiLU+conv3x3 kernel computes (a ResBlock's
    ``in_conv``/``out_conv`` and the UNet's own ``out_conv``), OIHW otherwise
  * ``X/conv/kernel`` (k..., Cin, Cout) of a 1-D or 3-D conv (every conv of
    those UNets, their ResBlocks' included) -> ``X.weight`` (Cout, Cin, k...)
  * ``X/conv/kernel`` (1, C, 3C) of an attention ``qkv``/``proj`` ->
    ``X.weight`` (3C, C)
  * ``X/dense/kernel`` (in, out) -> ``X.weight`` (out, in) (the UNet's and
    the dense model's ``Linear``s)
  * ``X/{conv,dense}/bias``      -> ``X.bias``
  * ``label_emb/embedding``      -> ``label_emb.weight``

A SuperResModel's tree is the UNet's under ``unet/``, and maps onto the
port's ``unet.`` submodule the same way.

Any Flax leaf it cannot map raises.  ``load_flax_params(model, params)``
also names every port key the tree leaves unset or sets but the model
lacks, and every shape that differs, before loading.  A model cut to its
tensor-parallel slices (``parallel.tp.shard_model``) takes this rank's
slice of each sharded weight (``tp_local``).

``inception_from_jax(params)`` builds the port's FID InceptionV3
(``evals.inception.FIDInceptionV3``) from the JAX package's Inception param
tree (nested dicts of arrays): each conv's HWIO ``w`` becomes OIHW, its
folded ``scale`` and ``shift`` and the ``fc`` head ([in, out]) stay as they
are.

``flax_layout(model)`` gives each port parameter's Flax shape and where
each Flax axis lives in the port's tensor, for the placement rules that
pick an axis by shape (``parallel.mesh``).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .parallel.tp import tp_slice

__all__ = ["params_from_flax", "load_flax_params", "inception_from_jax", "flax_layout",
           "tp_local"]

_FUSED_CONVS = ("in_conv", "out_conv")


def _flatten(tree: Mapping, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, np.array(value, dtype=np.float32)


def _is_fused(module_path) -> bool:
    """A ResBlock's in_conv/out_conv, or the UNet's own out_conv (a
    SuperResModel's UNet is ``unet``)."""
    if module_path[0] == "unet":
        module_path = module_path[1:]
    name = module_path[-1]
    if len(module_path) == 1:
        return name == "out_conv"
    return name in _FUSED_CONVS and module_path[-2].endswith("_res")


def _is_token_linear(module_path) -> bool:
    """An AttentionBlock's qkv or proj: a 1-wide conv in Flax, a Linear here."""
    return (len(module_path) >= 2 and module_path[-1] in ("qkv", "proj")
            and module_path[-2].endswith("_attn"))


def _convert_leaf(path, value: np.ndarray):
    *module, layer, leaf = path
    module = tuple(module)
    key = ".".join(module)
    if layer == "norm" and leaf == "scale":
        return f"{key}.weight", value
    if layer in ("norm", "conv", "dense") and leaf == "bias":
        return f"{key}.bias", value
    if layer == "conv" and leaf == "kernel":
        if _is_token_linear(module):  # (1, in, out)
            return f"{key}.weight", value[0].T
        if value.ndim == 4 and _is_fused(module):
            return f"{key}.weight", value.transpose(0, 1, 3, 2)
        if value.ndim in (3, 4, 5):  # (k..., in, out) -> (out, in, k...)
            nd = value.ndim
            return f"{key}.weight", value.transpose(nd - 1, nd - 2, *range(nd - 2))
    if layer == "dense" and leaf == "kernel":
        return f"{key}.weight", value.T
    if path[-2:] == ("label_emb", "embedding") and len(path) <= 3:
        return f"{key + '.' if key else ''}label_emb.weight", value
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
    state = tp_local(model, params_from_flax(params))
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


def tp_local(model: torch.nn.Module, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A whole (one-device) ``state_dict`` cut to what ``model`` holds: the
    weight of each layer marked tensor-parallel (``module.tp``) narrowed to
    this rank's slice of its output features; everything else as it is."""
    out = dict(state)
    for name, module in model.named_modules():
        shard = getattr(module, "tp", None)
        key = f"{name}.weight" if name else "weight"
        if shard is None or key not in out:
            continue
        out[key] = tp_slice(out[key], shard.index, shard.size, shard.dim).contiguous()
    return out


def inception_from_jax(params: Mapping, device=None):
    """The JAX Inception param tree -> the port's ``FIDInceptionV3`` on
    ``device`` (None: cuda, which raises without a card); a missing,
    left-over or misshapen leaf raises (strict ``load_state_dict``)."""
    from .evals.inception import FIDInceptionV3
    from .models import resolve_device

    device = resolve_device(device)

    state = {}
    for path, value in _flatten(params):
        if path[-1] == "w" and value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        state[".".join(path)] = torch.from_numpy(np.ascontiguousarray(value))
    model = FIDInceptionV3(fc="fc" in params)
    model.load_state_dict(state, strict=True)
    return model.to(device)


def flax_layout(model: torch.nn.Module) -> Dict[str, tuple]:
    """For each parameter of ``model``: (its Flax shape, and for each Flax
    axis the port's axis holding it, None for an axis the port drops).

    The inverse of ``params_from_flax``'s layout changes, read from the
    module that owns the parameter: a fused conv's (3, 3, Cout, Cin) is
    Flax's (3, 3, Cin, Cout), a plain conv's (Cout, Cin, k...) is (k...,
    Cin, Cout), an attention ``qkv``/``proj`` Linear (out, in) is the 1-wide
    conv (1, in, out), any other Linear (out, in) is the dense (in, out);
    every other parameter keeps its shape.  A rule that picks an axis by
    shape (``parallel.fsdp_sharding``, ``tp_sharding``) must read the Flax
    shape: on the port's, a square conv would split Cin where JAX splits
    Cout."""
    from .models.layers import Conv, FusedConv3x3, Linear

    out = {}
    for mod_name, mod in model.named_modules():
        path = tuple(mod_name.split(".")) if mod_name else ()
        for leaf, p in mod.named_parameters(recurse=False):
            key = f"{mod_name}.{leaf}" if mod_name else leaf
            shape = tuple(p.shape)
            axes = tuple(range(len(shape)))
            if leaf == "weight" and isinstance(mod, FusedConv3x3):
                shape, axes = (shape[0], shape[1], shape[3], shape[2]), (0, 1, 3, 2)
            elif leaf == "weight" and isinstance(mod, Conv):
                nd = len(shape)
                shape = (*shape[2:], shape[1], shape[0])
                axes = (*range(2, nd), 1, 0)
            elif leaf == "weight" and isinstance(mod, Linear):
                if _is_token_linear(path):
                    shape, axes = (1, shape[1], shape[0]), (None, 1, 0)
                else:
                    shape, axes = (shape[1], shape[0]), (1, 0)
            out[key] = (shape, axes)
    return out
