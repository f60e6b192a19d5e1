"""The device mesh, its placement rules, and the batch axis split over it.

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/parallel/mesh.py``.
JAX runs one program over a ``jax.sharding.Mesh`` and lets XLA insert the
collectives; here every rank of a ``torch.distributed`` group runs the same
program on its own device, and the code that shards says so:

  * :func:`make_mesh` / :func:`make_mesh_2d` return a
    ``torch.distributed.device_mesh.DeviceMesh`` over the group's ranks,
    axes ``data`` (and ``model``);
  * the placement rules (:func:`data_sharding`, :func:`replicated`,
    :func:`fsdp_sharding`, :func:`tp_sharding`, :func:`spatial_sharding`)
    return DTensor placements, one per mesh axis, where JAX returns a
    ``NamedSharding``; :func:`fsdp_sharding` and :func:`tp_sharding` take a
    module and give one per parameter, the axis picked on the parameter's
    Flax shape and mapped to the port's layout (``convert.flax_layout``), so
    both packages split the same logical axis;
  * :func:`shard_batch` takes this rank's contiguous 1/N of the leading
    axis, the block JAX's ``data_sharding`` puts on each device, and
    :func:`local_shard` this rank's block of any tensor under any
    placements (a ``tp_sharding`` leaf, a ``spatial_sharding`` image);
  * :func:`batch_shard` is the batch axis split: while one is active
    (``with batch_shard(mesh):``) the per-sample draws of the train steps,
    the samplers, the likelihood and the UNet's dropout (``randn``,
    ``rand``, ``randint``) are made at the GLOBAL batch shape from the
    generator and sliced to this rank's rows, so N ranks consume the
    generator exactly as one device does and each sees its rows of the
    one-device draw; :func:`batch_mean` is this rank's share of a mean over
    the global batch.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = ["DATA_AXIS", "MODEL_AXIS", "make_mesh", "make_mesh_2d", "data_sharding",
           "spatial_sharding", "replicated", "fsdp_sharding", "tp_sharding", "shard_batch",
           "local_shard", "mesh_axis", "axis_size", "batch_shard", "randn", "rand", "randint",
           "global_batch", "batch_mean"]

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _device_type(device) -> str:
    from ..models import resolve_device

    return resolve_device(device).type


def _world(what: str) -> int:
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(f"{what} needs a torch.distributed process group: join one with "
                           "parallel.initialize_runtime (a launch declared in the env) or run "
                           "under parallel.spawn")
    return dist.get_world_size()


def _mesh(shape: Tuple[int, ...], names: Tuple[str, ...], device, what: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    need = int(np.prod(shape))
    world = _world(what)
    if world < need:
        raise RuntimeError(f"{what}: only {world} rank(s) in the process group; start "
                           f"{need} (parallel.spawn, or a launcher)")
    if dist.get_rank() >= need:
        raise ValueError(f"{what}: rank {dist.get_rank()} is outside the mesh's {need} ranks")
    ranks = torch.arange(need).reshape(shape)
    return DeviceMesh(_device_type(device), ranks, mesh_dim_names=names)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = DATA_AXIS, device=None):
    """1-D data-parallel mesh over the group's first ``n_devices`` ranks
    (default: all), on ``device``'s type (None: cuda).  Raises if the group
    has fewer ranks: a silently smaller mesh would pass without sharding."""
    n = _world("make_mesh") if n_devices is None else int(n_devices)
    return _mesh((n,), (axis_name,), device, f"make_mesh({n_devices})")


def make_mesh_2d(n_data: int, n_model: int, axis_names: tuple = (DATA_AXIS, MODEL_AXIS),
                 device=None):
    """2-D (data x model) mesh, ranks row-major (a rank's model-axis
    neighbours are adjacent ranks), with a process group for each axis
    (``mesh.get_group("data")`` holds the ranks of this rank's model
    index, ``"model"`` those of its data index); ``mesh_axis`` gives this
    rank's coordinate on either.  Raises where the group has fewer than
    ``n_data * n_model`` ranks, as JAX's raises where the slice has fewer
    devices."""
    return _mesh((int(n_data), int(n_model)), tuple(axis_names), device,
                 f"make_mesh_2d({n_data}, {n_model})")


def mesh_axis(mesh, axis_name: str = DATA_AXIS) -> Tuple[int, int, object]:
    """(this rank's index on the axis, the axis size, its process group)."""
    return (mesh.get_local_rank(axis_name), mesh.size(mesh.mesh_dim_names.index(axis_name)),
            mesh.get_group(axis_name))


def axis_size(mesh, axis_name: str) -> int:
    """The size of the mesh's axis ``axis_name``; 1 where it has none (a
    1-D data mesh has no model axis)."""
    names = tuple(mesh.mesh_dim_names or ())
    return mesh.size(names.index(axis_name)) if axis_name in names else 1


# ------------------------------------------------------------ placement rules


def _placements(mesh, axis_name: str, dim: Optional[int]) -> tuple:
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(dim) if (name == axis_name and dim is not None) else Replicate()
                 for name in mesh.mesh_dim_names)


def data_sharding(mesh, ndim: int, axis_name: str = DATA_AXIS) -> tuple:
    """Shard the leading (batch) dim over the data axis, replicate the rest."""
    return _placements(mesh, axis_name, 0)


def spatial_sharding(mesh, axis_name: str = DATA_AXIS) -> tuple:
    """Shard NHWC images over the HEIGHT axis: each rank holds H/N rows
    (``generate_images(shard_mode="spatial")``, ``parallel.spatial``)."""
    return _placements(mesh, axis_name, 1)


def replicated(mesh) -> tuple:
    return _placements(mesh, DATA_AXIS, None)


def _fsdp_axis(shape, n: int, min_size: int) -> Optional[int]:
    """JAX's ``_fsdp_leaf`` on a Flax shape: the largest axis-divisible dim
    (ties resolve to the LAST max dim); None for small or indivisible leaves."""
    if not shape or int(np.prod(shape)) < min_size:
        return None
    best = None
    for i, d in enumerate(shape):
        if d % n == 0 and (best is None or d >= shape[best]):
            best = i
    return best


def _tp_axis(shape, n: int, min_size: int) -> Optional[int]:
    """JAX's ``_tp_leaf``: the last (output-feature) dim of a large >= 2-D
    leaf that the axis divides."""
    if len(shape) < 2 or int(np.prod(shape)) < min_size or shape[-1] % n:
        return None
    return len(shape) - 1


def _by_flax_shape(mesh, model: torch.nn.Module, axis_name: str, rule, min_size: int) -> Dict:
    from ..convert import flax_layout

    n = mesh.size(mesh.mesh_dim_names.index(axis_name))
    out = {}
    for name, (shape, axes) in flax_layout(model).items():
        flax_axis = rule(shape, n, min_size)
        out[name] = _placements(mesh, axis_name, None if flax_axis is None else axes[flax_axis])
    return out


def fsdp_sharding(mesh, model: torch.nn.Module, axis_name: str = DATA_AXIS,
                  min_size: int = 65536) -> Dict[str, tuple]:
    """The fully-sharded layout of ``model``'s parameters (and so of their
    EMA copies and Adam moments): {name: placements}; every leaf of at least
    ``min_size`` elements is split over the axis on its largest divisible
    dim, the rest replicated.  The dim is chosen on the Flax shape (JAX's
    rule) and named in the port's layout."""
    return _by_flax_shape(mesh, model, axis_name, _fsdp_axis, min_size)


def tp_sharding(mesh, model: torch.nn.Module, axis_name: str = MODEL_AXIS,
                min_size: int = 2048) -> Dict[str, tuple]:
    """The tensor-parallel layout: every large >= 2-D leaf split on its
    output-feature dim (the last Flax dim) over the model axis, the rest
    replicated (``param_sharding="tp"``; ``parallel.tp.shard_model`` cuts
    the modules to it)."""
    return _by_flax_shape(mesh, model, axis_name, _tp_axis, min_size)


def shard_batch(mesh, batch, axis_name: str = DATA_AXIS):
    """This rank's contiguous 1/N of the leading axis of every array in
    ``batch`` (a tensor, a numpy array, None, or a tuple / list / dict of
    them); a batch the axis does not divide raises."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v, axis_name) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(mesh, v, axis_name) for v in batch)
    if batch is None:
        return None
    index, n, _ = mesh_axis(mesh, axis_name)
    b = batch.shape[0]
    if b % n:
        raise ValueError(f"batch size {b} must be divisible by the mesh's {n} data-axis "
                         "devices")
    k = b // n
    return batch[index * k:(index + 1) * k]


def local_shard(mesh, full: torch.Tensor, placements: tuple) -> torch.Tensor:
    """This rank's block of ``full`` under ``placements`` (one per mesh
    axis, as the rules above return them): along each axis that shards a
    dim, this rank's contiguous 1/N of it (a view).  A dim the axis does
    not divide raises."""
    out = full
    for name, placement in zip(mesh.mesh_dim_names, placements):
        if not placement.is_shard():
            continue
        index, n, _ = mesh_axis(mesh, name)
        d = placement.dim
        if out.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(full.shape)} is not divisible by the "
                             f"{n} ranks of mesh axis {name!r}")
        k = out.shape[d] // n
        out = out.narrow(d, index * k, k)
    return out


# ------------------------------------------------------------ the batch axis split


class _Shard(NamedTuple):
    index: int
    count: int


_SHARD: contextvars.ContextVar = contextvars.ContextVar("pddm_batch_shard", default=None)


@contextlib.contextmanager
def batch_shard(mesh, axis_name: str = DATA_AXIS):
    """Within: per-sample draws are made at the global batch and sliced to
    this rank's rows; ``batch_mean`` is this rank's share.  ``mesh`` None
    (or a 1-rank axis) leaves both as on one device."""
    if mesh is None:
        yield
        return
    index, n, _ = mesh_axis(mesh, axis_name)
    token = _SHARD.set(_Shard(index, n) if n > 1 else None)
    try:
        yield
    finally:
        _SHARD.reset(token)


def _global(fn, shape, **kw) -> torch.Tensor:
    shard = _SHARD.get()
    shape = tuple(shape)
    if shard is None or not shape:
        return fn(shape, **kw)
    b = shape[0]
    full = fn((b * shard.count, *shape[1:]), **kw)
    return full[shard.index * b:(shard.index + 1) * b]


def randn(shape, *, generator=None, device=None, dtype=None) -> torch.Tensor:
    """``torch.randn`` of a per-sample draw [B, ...] (see :func:`batch_shard`)."""
    return _global(torch.randn, shape, generator=generator, device=device, dtype=dtype)


def rand(shape, *, generator=None, device=None, dtype=None) -> torch.Tensor:
    """``torch.rand`` of a per-sample draw [B, ...]."""
    return _global(torch.rand, shape, generator=generator, device=device, dtype=dtype)


def randint(low: int, high: int, shape, *, generator=None, device=None) -> torch.Tensor:
    """``torch.randint`` of a per-sample draw [B, ...]."""
    return _global(lambda s, **kw: torch.randint(low, high, s, **kw), shape,
                   generator=generator, device=device)


def global_batch(b: int) -> int:
    """The global batch size of a local batch of ``b``."""
    shard = _SHARD.get()
    return b if shard is None else b * shard.count


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of per-sample ``x`` [B] over the batch, or under a batch
    split this rank's share of the global mean (the shares sum to it)."""
    shard = _SHARD.get()
    return x.mean() if shard is None else x.sum() / (x.shape[0] * shard.count)
