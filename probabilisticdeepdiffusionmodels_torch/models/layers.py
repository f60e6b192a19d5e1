"""NN primitives for the UNet, channels last ((B, *spatial, C)).

PyTorch counterparts of ``probabilisticdeepdiffusionmodels_tpu/models/layers.py``:

  * parameters are float32 and are cast to the compute dtype where they are
    used (Flax's ``param_dtype=float32`` with ``dtype=bfloat16``);
  * convolutions (1-, 2- or 3-D) pad like JAX ``SAME`` on each axis (for a
    stride-2 3-wide conv on an even size that is (0, 1), not torch's (1, 1));
  * GroupNorm uses gcd(32, C) groups, computes in float32 and casts back;
  * init is torch's Conv/Linear default, U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    for weight and bias, with zero init where the JAX model zero-inits.

Under tensor parallelism (``parallel.tp``) a ``Conv``, ``FusedConv3x3``,
``Linear`` or ``Embedding`` whose weight holds this rank's slice of the
output features (``self.tp`` set) computes that slice, all-gathers the
channels over the model axis and adds its whole bias.  Under a spatial row
split (``parallel.spatial``) a 3-wide ``Conv`` runs on its rows and its
neighbours' halo rows, and ``GroupNorm32`` folds whole-image statistics.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.groupnorm import group_norm_silu, group_norm_silu_slab
from ..parallel import spatial
from ..parallel.tp import gather_channels, to_model

__all__ = [
    "Conv",
    "FusedConv3x3",
    "Linear",
    "Embedding",
    "GroupNorm32",
    "silu",
    "avg_pool_nd",
    "nearest_upsample_nd",
    "bilinear_resize",
]


def _uniform_(p: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]):
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        p.uniform_(-bound, bound, generator=generator)


def _same_pads(size: int, k: int, stride: int):
    """(low, high) padding of JAX ``SAME`` along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


_CONVS = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


class Conv(nn.Module):
    """k-wide convolution over the ``dims`` spatial axes of channels-last
    input, with JAX ``SAME`` padding (k > 1) or ``VALID`` (k = 1).
    ``weight`` is (Cout, Cin, k, ...), torch's layout."""

    tp = None  # parallel.tp.TPShard where the weight is this rank's slice

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, zero_init: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, dims: int = 2):
        super().__init__()
        self.kernel_size, self.stride, self.dtype, self.dims = kernel_size, stride, dtype, dims
        k = kernel_size
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, *(k,) * dims))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        if not zero_init:
            _uniform_(self.weight, in_ch * k ** dims, generator)
            _uniform_(self.bias, in_ch * k ** dims, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        w, bias = self.weight.to(self.dtype), self.bias.to(self.dtype)
        if self.tp is None:
            return self._conv(x, w, bias)
        (x,) = to_model(self.tp, x)
        return gather_channels(self.tp, self._conv(x, w, None)) + bias

    def _conv(self, x, w, bias):
        k, s, d = self.kernel_size, self.stride, self.dims
        padding = 0
        rows = spatial.active() if k > 1 else None
        if rows is not None:
            if d != 2:
                raise ValueError("a spatial row split runs 2-D convs only")
            # the global SAME pads along the height: the neighbours' rows
            # where there are any, zeros at the image's edges
            lo, hi = _same_pads(x.shape[1] * rows.count, k, s)
            x, top, bottom = spatial.halo(x, lo, hi, rows)
            x = F.pad(x, [0, 0, *_same_pads(x.shape[2], k, s), lo - top, hi - bottom])
        elif k > 1:
            pads = [_same_pads(n, k, s) for n in x.shape[1:-1]]
            if all(lo == hi for lo, hi in pads):
                padding = tuple(lo for lo, _ in pads)
            else:  # asymmetric SAME padding, applied channels last
                x = F.pad(x, [0, 0] + [p for pair in reversed(pads) for p in pair])
        y = _CONVS[d](x.movedim(-1, 1), w, bias, stride=s, padding=padding)
        return y.movedim(1, -1).contiguous()


class FusedConv3x3(nn.Module):
    """Weight and bias of a 3x3 conv that ``ops.gn_conv.gn_silu_conv3x3``
    computes; ``weight`` is (3, 3, Cout, Cin), the kernel's layout.
    ``conv`` is the same conv alone, for the ResBlock's dropout path."""

    tp = None  # parallel.tp.TPShard where the weight is this rank's Cout slice

    def __init__(self, in_ch: int, out_ch: int, zero_init: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(3, 3, out_ch, in_ch))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        if not zero_init:
            _uniform_(self.weight, in_ch * 9, generator)
            _uniform_(self.bias, in_ch * 9, generator)

    def conv(self, y: torch.Tensor) -> torch.Tensor:
        """3x3 SAME conv of NHWC ``y`` in its dtype."""
        w, bias = self.weight.to(y.dtype).permute(2, 3, 0, 1), self.bias.to(y.dtype)
        if self.tp is None:
            out = F.conv2d(y.permute(0, 3, 1, 2), w, bias, padding=1)
            return out.permute(0, 2, 3, 1).contiguous()
        (y,) = to_model(self.tp, y)
        out = F.conv2d(y.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
        return gather_channels(self.tp, out) + bias


class Linear(nn.Module):
    """Dense layer in ``dtype`` with torch-default init; ``weight`` is (out, in)."""

    tp = None  # parallel.tp.TPShard where the weight is this rank's slice of the rows

    def __init__(self, in_features: int, out_features: int,
                 zero_init: bool = False, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        if not zero_init:
            _uniform_(self.weight, in_features, generator)
            _uniform_(self.bias, in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, bias = x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype)
        if self.tp is None:
            return F.linear(x, w, bias)
        (x,) = to_model(self.tp, x)
        return gather_channels(self.tp, F.linear(x, w)) + bias


class Embedding(nn.Embedding):
    """``nn.Embedding`` (the class-label table), whose rows may be cut to
    this rank's slice of the features under tensor parallelism."""

    tp = None

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        out = super().forward(y)
        return out if self.tp is None else gather_channels(self.tp, out)


class GroupNorm32(nn.Module):
    """GroupNorm with gcd(32, C) groups over channels-last input, float32
    statistics, output in the input dtype.  ``forward`` runs
    ``ops.groupnorm.group_norm_silu`` (the CUDA kernel on the card), with
    the SiLU where ``silu``; 2-D ResBlocks instead fold ``weight``/``bias``
    into the fused conv."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.groups = math.gcd(num_groups, channels)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
        rows = spatial.active()
        if rows is not None:
            return group_norm_silu_slab(x.contiguous(), self.weight, self.bias, self.groups,
                                        self.eps, silu, lambda m: spatial.total(m, rows),
                                        rows.count)
        return group_norm_silu(x.contiguous(), self.weight, self.bias,
                               self.groups, self.eps, silu=silu)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x)."""
    return x * torch.sigmoid(x)


_POOLS = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def avg_pool_nd(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Stride-``window`` average pool over every spatial axis of
    channels-last (B, *spatial, C) input."""
    y = _POOLS[x.dim() - 2](x.movedim(-1, 1), window, window)
    return y.movedim(1, -1).contiguous()


def nearest_upsample_nd(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample over every spatial axis of
    channels-last (B, *spatial, C) input."""
    b, *spatial, c = x.shape
    for i in range(len(spatial)):  # a size-1 axis after each spatial axis
        x = x.unsqueeze(2 + 2 * i)
    pairs = [n for s in spatial for n in (s, 2)]
    return x.expand(b, *pairs, c).reshape(b, *(2 * s for s in spatial), c)


def bilinear_resize(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """NHWC ``x`` resized to (height, width) in float32, as
    ``jax.image.resize(..., "bilinear")``: half-pixel centres, the kernel
    renormalised where it leaves the image (``F.interpolate`` without
    ``align_corners`` clamps there, which gives the same weights when
    growing), and an antialiasing kernel on an axis that shrinks."""
    h, w = x.shape[1], x.shape[2]
    y = F.interpolate(x.float().permute(0, 3, 1, 2), size=(height, width), mode="bilinear",
                      align_corners=False, antialias=height < h or width < w)
    return y.permute(0, 2, 3, 1).contiguous()
