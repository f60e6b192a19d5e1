"""Tensor parallelism over a mesh's ``model`` axis (``param_sharding="tp"``).

JAX places the state by ``parallel.mesh.tp_sharding`` (every large >= 2-D
leaf split on its output-feature dim) and lets GSPMD propagate the channel
split through the network.  Here the fused kernels take plain tensors, so
the layout is built by hand with one uniform rule: **a layer whose weight is
sharded computes its slice of the output channels and all-gathers the
channels over the model axis**; its bias (never sharded: it is 1-D) is added
to the whole output after the gather.  Activations stay whole and equal on
every model rank; only the weights, their EMA copies and Adam's moments are
split, which is the memory tensor parallelism exists to save.

In autograd that is two functions:

  * :func:`to_model` — identity forward; backward, the all-reduce of the
    inputs' gradients over the model group (each rank's slice of the
    output reaches only part of each input's gradient);
  * :func:`gather_channels` — all-gather of the channel slices forward;
    backward, this rank's slice of the (whole, equal) gradient.

A replicated parameter sees the same whole activations and gradients on
every model rank, so its gradient needs no model-axis reduction; a sharded
one gets exactly its slice's.  The rule holds for any split: a FiLM
projection's scale and shift on different ranks, a ``qkv`` slice cutting a
head, are whole again after the gather.  (Head-local attention and a
row-parallel ``proj``, which save a gather, are not built.)

:func:`shard_model` cuts a module to the layout: each parameter the rule
splits is replaced by this rank's slice (a ``Linear``'s, a ``Conv``'s, a
``FusedConv3x3``'s or an ``Embedding``'s weight, on its output-feature
axis) and the layer is marked with a :class:`TPShard`, which its forward
reads.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from .mesh import MODEL_AXIS, mesh_axis, tp_sharding

__all__ = ["TPShard", "tp_slice", "to_model", "gather_channels", "shard_model",
           "sharded_dims", "out_axis"]


class TPShard:
    """A layer's place on the model axis: this rank's index, the axis size,
    its process group, and the weight's split axis.  Shared, not copied, by
    ``copy.deepcopy`` (the EMA model is a deep copy of the live one)."""

    def __init__(self, index: int, size: int, group, dim: int):
        self.index, self.size, self.group, self.dim = index, size, group, dim

    def __deepcopy__(self, memo):
        return self

    def __repr__(self):
        return f"TPShard({self.index}/{self.size}, dim={self.dim})"


def tp_slice(full: torch.Tensor, index: int, size: int, dim: int) -> torch.Tensor:
    """Rank ``index``'s block of a whole tensor whose axis ``dim`` is split
    over ``size`` model ranks (a view): channels [index k, (index+1) k)."""
    if full.shape[dim] % size:
        raise ValueError(f"dim {dim} of {tuple(full.shape)} is not divisible by the {size} "
                         f"ranks of the model axis")
    k = full.shape[dim] // size
    return full.narrow(dim, index * k, k)


class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        present = [g for g in grads if g is not None]
        if present:
            # one collective for every input's gradient
            flat = torch.cat([g.reshape(-1).float() for g in present])
            dist.all_reduce(flat, group=ctx.group)
            out, off = [], 0
            for g in grads:
                if g is None:
                    out.append(None)
                    continue
                out.append(flat[off:off + g.numel()].view(g.shape).to(g.dtype))
                off += g.numel()
            grads = out
        return (None, *grads)


def to_model(shard: TPShard, *xs: torch.Tensor):
    """The inputs of a sharded layer, unchanged; their gradients summed over
    the model group in the backward.  Returns a tuple."""
    if not (torch.is_grad_enabled() and any(x.requires_grad for x in xs)):
        return xs
    return _ToModel.apply(shard.group, *xs)


def _all_gather_last(y: torch.Tensor, shard: TPShard) -> torch.Tensor:
    y = y.contiguous()
    # gloo takes the output as the inputs concatenated on dim 0
    recv = torch.empty((shard.size * y.shape[0], *y.shape[1:]), dtype=y.dtype, device=y.device)
    dist.all_gather_into_tensor(recv, y, group=shard.group)
    recv = recv.view(shard.size, *y.shape)
    # (M, ..., k) -> (..., M, k) -> (..., M k): rank r's slice is channels [r k, (r+1) k)
    return recv.movedim(0, -2).reshape(*y.shape[:-1], shard.size * y.shape[-1])


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, y):
        ctx.shard, ctx.k = shard, y.shape[-1]
        return _all_gather_last(y, shard)

    @staticmethod
    def backward(ctx, grad):
        s, k = ctx.shard, ctx.k
        return None, grad.narrow(-1, s.index * k, k).contiguous()


def gather_channels(shard: TPShard, y: torch.Tensor) -> torch.Tensor:
    """Channels-last ``y`` [..., k], this rank's slice of the output
    channels, all-gathered into [..., M k] (rank order)."""
    if torch.is_grad_enabled() and y.requires_grad:
        return _GatherChannels.apply(shard, y)
    return _all_gather_last(y, shard)


def out_axis(module: torch.nn.Module) -> Optional[int]:
    """The axis of ``module.weight`` that holds its output features, for the
    layers that can be sharded (None for any other module)."""
    from ..models.layers import Conv, Embedding, FusedConv3x3, Linear

    if isinstance(module, FusedConv3x3):
        return 2
    if isinstance(module, (Conv, Linear)):
        return 0
    if isinstance(module, Embedding):
        return 1
    return None


def sharded_dims(mesh, model: torch.nn.Module) -> Dict[str, Optional[int]]:
    """{parameter name: the port axis ``tp_sharding`` splits over the model
    axis, or None}."""
    axis = mesh.mesh_dim_names.index(MODEL_AXIS)
    return {name: (p[axis].dim if p[axis].is_shard() else None)
            for name, p in tp_sharding(mesh, model).items()}


def shard_model(model: torch.nn.Module, mesh) -> Dict[str, Optional[int]]:
    """Cut ``model``'s parameters in place to this rank's ``tp_sharding``
    slices and mark each sharded layer (``module.tp``); returns
    ``sharded_dims``.  A model axis of one rank leaves the model whole."""
    if MODEL_AXIS not in (mesh.mesh_dim_names or ()):
        raise ValueError(f'tensor parallelism needs a mesh with a "{MODEL_AXIS}" axis '
                         f"(make_mesh_2d); got axes {mesh.mesh_dim_names}")
    index, size, group = mesh_axis(mesh, MODEL_AXIS)
    dims = sharded_dims(mesh, model)
    if size == 1:
        return {name: None for name in dims}
    for name, d in dims.items():
        if d is None:
            continue
        mod_name, _, leaf = name.rpartition(".")
        module = model.get_submodule(mod_name)
        if leaf != "weight" or out_axis(module) != d:
            raise ValueError(f"tp_sharding splits {name} on axis {d}, which no sharded layer "
                             f"computes ({type(module).__name__})")
        w = module.weight
        part = tp_slice(w.detach(), index, size, d).clone()
        module.weight = torch.nn.Parameter(part, requires_grad=w.requires_grad)
        module.tp = TPShard(index, size, group, d)
    return dims

