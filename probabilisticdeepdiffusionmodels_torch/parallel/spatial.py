"""Spatial sharding of the UNet's forward (``shard_mode="spatial"``).

JAX puts sampled images on ``spatial_sharding`` (height over the data axis)
and lets XLA's SPMD partitioner insert the conv halo exchanges and the
attention gathers.  Here the layers do it by hand while a row split is
active (``with rows(mesh):``): the batch is whole on every rank and each
of the axis's N ranks holds H/N rows of every activation.

  * a 3-wide conv (plain or fused) runs on a slab of its rows and its
    neighbours' edge rows (:func:`halo`: one all-gather of every rank's
    edge rows, the same code over gloo and NCCL); a fused conv's kernel
    activates the halo rows and pads zeros only at the slab's own edge,
    which is the image's edge or a row that is dropped, so the kept rows
    are the unsharded conv's.  The stride-2 downsample (JAX's ``SAME``
    pads (0, 1)) takes only the row below;
  * GroupNorm and the fused conv fold whole-image statistics: the per-(sample,
    channel) E[x] and E[x^2] of each slab summed over the ranks in place
    (:func:`total`, one all-reduce of a (2, B, C) tensor) and folded inside
    the kernel that consumes them, which divides by the rank count as
    :func:`average` does;
  * attention gathers ``qkv`` along the token rows (:func:`gather_rows`),
    runs over every token and keeps this rank's queries: N times the
    compute, cheap at the 16x16 and 8x8 sites;
  * the upsample, the pools, the 1x1 convs and the elementwise ops are
    local.

:func:`sharded_forward` wraps a model: it cuts the input's rows, runs the
model under the split and all-gathers the output's rows, so a sampler
around it sees whole images.  Forward only (sampling), as in JAX.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, local_shard, mesh_axis, spatial_sharding

__all__ = ["Rows", "rows", "one_rank", "active", "halo", "average", "total", "gather_rows",
           "check_height", "sharded_forward"]


class Rows(NamedTuple):
    index: int   # this rank's place along the height
    count: int   # ranks the height is split over
    group: object


_ROWS: contextvars.ContextVar = contextvars.ContextVar("pddm_spatial_rows", default=None)


@contextlib.contextmanager
def rows(mesh, axis_name: str = DATA_AXIS):
    """Within: every activation holds this rank's 1/N of the height."""
    index, n, group = mesh_axis(mesh, axis_name)
    token = _ROWS.set(Rows(index, n, group) if n > 1 else None)
    try:
        yield
    finally:
        _ROWS.reset(token)


@contextlib.contextmanager
def one_rank():
    """Within: a row split over a world of one rank, in one process, with no
    process group: every layer takes its slab path on the whole image, the
    all-reduce the identity and the all-gather a copy.  What holds the slab
    path against the unsharded forward on one card or the CPU."""
    token = _ROWS.set(Rows(0, 1, None))
    try:
        yield
    finally:
        _ROWS.reset(token)


def active() -> Optional[Rows]:
    """The row split in force, or None."""
    return _ROWS.get()


def _gather(x: torch.Tensor, r: Rows) -> torch.Tensor:
    """[N, *x.shape]: every rank's ``x`` in rank order."""
    x = x.contiguous()
    # gloo takes the output as the inputs concatenated on dim 0
    if r.count == 1:
        return x.unsqueeze(0)
    out = torch.empty((r.count * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=r.group)
    return out.view(r.count, *x.shape)


def halo(x: torch.Tensor, above: int, below: int, r: Rows):
    """(slab, top, bottom): NHWC ``x`` (this rank's rows) with the last
    ``above`` rows of the rank above and the first ``below`` rows of the
    rank below (none at the image's edges); ``top`` and ``bottom`` are the
    rows added.  ``halo.sent_bytes`` counts the bytes this rank sends."""
    h = x.shape[1]
    if max(above, below) > h:
        raise ValueError(f"a halo of {max(above, below)} rows needs at least as many rows a "
                         f"rank, got {h}")
    send = torch.cat([x[:, :below], x[:, h - above:]], dim=1)
    halo.sent_bytes += send.numel() * send.element_size()
    edges = _gather(send, r)
    top = above if r.index > 0 else 0
    bottom = below if r.index < r.count - 1 else 0
    parts = []
    if top:
        parts.append(edges[r.index - 1][:, below:])
    parts.append(x)
    if bottom:
        parts.append(edges[r.index + 1][:, :below])
    return (torch.cat(parts, dim=1) if len(parts) > 1 else x), top, bottom


halo.sent_bytes = 0


def average(moments: torch.Tensor, r: Rows) -> torch.Tensor:
    """Per-rank statistics averaged over the ranks (each holds as many rows)."""
    out = moments.contiguous().clone()
    if r.count > 1:
        dist.all_reduce(out, group=r.group)
    return out / r.count


def total(moments: torch.Tensor, r: Rows) -> torch.Tensor:
    """Contiguous per-rank statistics summed over the ranks in place (one
    all-reduce) and returned: :func:`average` without its copy and its
    divide, which the kernel that folds them does (sum / count)."""
    if r.count > 1:
        dist.all_reduce(moments, group=r.group)
    return moments


def gather_rows(tokens: torch.Tensor, r: Rows) -> torch.Tensor:
    """[B, T, ...] of this rank's token rows -> [B, N T, ...], in image order."""
    parts = _gather(tokens, r)
    return parts.movedim(0, 1).reshape(tokens.shape[0], r.count * tokens.shape[1],
                                       *tokens.shape[2:])


def check_height(height: int, downsamples: int, n: int) -> None:
    """Raise where ``n`` ranks cannot split the height at every level of a
    UNet with ``downsamples`` stride-2 stages (each rank an even number of
    rows above the last)."""
    if height % (n * 2 ** downsamples):
        raise ValueError(f"shard_mode=\"spatial\": height {height} does not split over {n} "
                         f"ranks at every one of the UNet's {downsamples + 1} levels (it must "
                         f"be divisible by {n} * 2^{downsamples} = {n * 2 ** downsamples})")


def sharded_forward(model: Callable, mesh, axis_name: str = DATA_AXIS) -> Callable:
    """``model`` with its input cut to this rank's rows and its output
    gathered whole: ``fn(x, t, *args, **kw)`` on a whole NHWC batch returns
    what ``model`` returns, each rank running 1/N of the height."""
    n = mesh_axis(mesh, axis_name)[1]

    def fn(x, t, *args, **kw):
        if kw.get("return_cache") or kw.get("cache") is not None or kw.get("return_features"):
            raise ValueError('shard_mode="spatial" runs the plain forward: encoder reuse and '
                             "features need whole activations")
        local = local_shard(mesh, x, spatial_sharding(mesh, axis_name))
        with torch.no_grad(), rows(mesh, axis_name):
            out = model(local, t, *args, **kw)
            r = active()
            if r is None:
                return out
            return _gather(out, r).movedim(0, 1).reshape(
                out.shape[0], n * out.shape[1], *out.shape[2:])

    return fn
