"""GroupNorm (+ optional SiLU): plain torch version and the CUDA kernel.

Semantics of ``group_norm_silu_xla`` / ``group_norm_silu_pallas`` in
``probabilisticdeepdiffusionmodels_tpu/ops/groupnorm_pallas.py``: statistics
in float32 over (spatial, channels-of-group), eps inside the rsqrt, affine,
optional SiLU, output in the input dtype.

Kernel (``csrc/groupnorm.cu``) — replaces ``group_norm_silu_pallas`` /
``_gn_kernel``.  On the H100 it is bound by bytes: it reads x once for the
statistics and writes the output once, with a handful of flops per element.
One block per (sample, group) accumulates the float32 sum and sum of
squares in one pass (as the Pallas kernel does), reduces them across the
block, then normalizes, applies the affine and the SiLU on a second pass
whose reads hit the cache, and stores in the input dtype.  It is written in
CUDA C++ like the other two kernels, so the port builds from one toolchain.

Backward: no Pallas kernel has a backward kernel, so this op has none
either.  As ``_gns_bwd`` in ``groupnorm_pallas.py`` does, the gradient is
that of the plain version, recomputed from the saved inputs
(``autograd.kernel_op``).
"""

from __future__ import annotations

import torch

from . import _build
from .autograd import kernel_op

__all__ = ["group_norm_silu", "group_norm_silu_plain"]

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def group_norm_silu_plain(x: torch.Tensor, gamma: torch.Tensor,
                          beta: torch.Tensor, num_groups: int = 32,
                          eps: float = 1e-5, silu: bool = True) -> torch.Tensor:
    """x: (B, *spatial, C), channels last; two-pass float32 statistics."""
    b, c = x.shape[0], x.shape[-1]
    g = num_groups
    xf = x.float().reshape(b, -1, g, c // g)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = y * gamma.float() + beta.float()
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def group_norm_silu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    num_groups: int = 32, eps: float = 1e-5,
                    silu: bool = True) -> torch.Tensor:
    """x: (B, *spatial, C), channels last; gamma/beta: (C,).  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises.
    Differentiable in x, gamma and beta."""
    if x.device.type == "cpu":
        return group_norm_silu_plain(x, gamma, beta, num_groups, eps, silu)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_silu: unsupported device {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"group_norm_silu kernel takes float32/bfloat16, got {x.dtype}")
    if x.dim() < 2 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (B, *spatial, C) tensor")
    b, c = x.shape[0], x.shape[-1]
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"gamma/beta must be ({c},)")
    # the casts stay outside the Function (gradients reach float32 parameters)
    gamma = gamma.to(device=x.device, dtype=torch.float32).contiguous()
    beta = beta.to(device=x.device, dtype=torch.float32).contiguous()
    return kernel_op(
        lambda x, gamma, beta: _launch(x, gamma, beta, num_groups, eps, silu),
        lambda x, gamma, beta: group_norm_silu_plain(x, gamma, beta, num_groups, eps, silu),
        x, gamma, beta)


def _launch(x, gamma, beta, num_groups, eps, silu):
    b, c = x.shape[0], x.shape[-1]
    out = torch.empty_like(x)
    _build.launch("pddm_group_norm_silu", x.data_ptr(), gamma.data_ptr(),
                  beta.data_ptr(), out.data_ptr(), b, x.numel() // (b * c), c,
                  num_groups, float(eps), int(silu), int(x.dtype == torch.bfloat16))
    group_norm_silu.launches += 1
    return out


group_norm_silu.launches = 0
