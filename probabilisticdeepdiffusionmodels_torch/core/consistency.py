"""Consistency models: the map of any point of a probability-flow ODE
trajectory to its end (Song et al., arXiv:2303.01469; iCT, arXiv:2310.14189).

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/core/consistency.py``.
The boundary condition f(x, sigma_min) = x is built into the
parameterization:

    f(x, sigma) = c_skip x + c_out F(c_in x, c_noise)
    c_skip = sd^2 / ((sigma - sigma_min)^2 + sd^2)
    c_out = sd (sigma - sigma_min) / sqrt(sigma^2 + sd^2)
    c_in = 1 / sqrt(sigma^2 + sd^2),  c_noise = ln(sigma) / 4

Consistency training (``train/consistency.py``) pulls f(x0 + sigma_hi z)
toward the target f(x0 + sigma_lo z) at the adjacent level of the Karras
grid, with iCT's pseudo-Huber metric and 1/(sigma_hi - sigma_lo) weighting.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

__all__ = ["ConsistencyConfig", "cm_precond", "cm_apply", "cm_metric", "pair_weight"]


class ConsistencyConfig(NamedTuple):
    """The papers' CIFAR-10 settings.  ``grid_size`` is N, the training
    discretization of [sigma_min, sigma_max]; with ``grid_init`` > 0 the
    grid doubles from grid_init up to grid_size over ``anneal_steps``
    optimizer steps (iCT section 3.4)."""

    sigma_data: float = 0.5
    sigma_min: float = 0.002
    sigma_max: float = 80.0
    rho: float = 7.0
    grid_size: int = 32
    metric: str = "pseudo_huber"  # or "l2"
    huber_c: float = 0.0  # <= 0: 0.00054 * sqrt(D)
    weighting: str = "ict"  # 1 / (sigma_hi - sigma_lo), or "none"
    target: str = "stopgrad"  # the target network: the live weights, or "ema"
    grid_init: int = 0
    anneal_steps: int = 0

    def validate(self) -> "ConsistencyConfig":
        if not 0.0 < self.sigma_min < self.sigma_max:
            raise ValueError(f"need 0 < sigma_min < sigma_max, got "
                             f"[{self.sigma_min}, {self.sigma_max}]")
        if self.grid_size < 2:
            raise ValueError("grid_size must be >= 2 (adjacent pairs)")
        if self.metric not in ("pseudo_huber", "l2"):
            raise ValueError(f'unknown metric "{self.metric}"')
        if self.weighting not in ("ict", "none"):
            raise ValueError(f'unknown weighting "{self.weighting}"')
        if self.target not in ("stopgrad", "ema"):
            raise ValueError(f'unknown target "{self.target}"')
        if self.grid_init:
            if not 2 <= self.grid_init <= self.grid_size:
                raise ValueError(f"grid_init={self.grid_init} must be in "
                                 f"[2, grid_size={self.grid_size}]")
            if self.anneal_steps < 1:
                raise ValueError("grid annealing needs anneal_steps >= 1")
        return self


def cm_precond(sigma: torch.Tensor, sigma_data: float, sigma_min: float):
    """(c_skip, c_out, c_in, c_noise), each shaped like ``sigma``; exactly
    (1, 0, ., .) at sigma_min."""
    sd2 = sigma_data * sigma_data
    d = sigma - sigma_min
    c_skip = sd2 / (torch.square(d) + sd2)
    denom = torch.sqrt(torch.square(sigma) + sd2)
    c_out = sigma_data * d / denom
    c_in = 1.0 / denom
    c_noise = torch.log(sigma) / 4.0
    return c_skip, c_out, c_in, c_noise


def cm_apply(model_fn: Callable, x: torch.Tensor, sigma: torch.Tensor,
             y: Optional[torch.Tensor], cfg: ConsistencyConfig, **kwargs) -> torch.Tensor:
    """f(x, sigma) for a per-sample sigma [B]; ``model_fn`` is the raw
    network (a guidance wrapper around it guides f, as f is affine in F)."""
    c_skip, c_out, c_in, c_noise = cm_precond(sigma, cfg.sigma_data, cfg.sigma_min)
    bshape = (-1,) + (1,) * (x.ndim - 1)
    out = model_fn(c_in.reshape(bshape) * x, c_noise, y, **kwargs)
    return c_skip.reshape(bshape) * x + c_out.reshape(bshape) * out


def cm_metric(a: torch.Tensor, b: torch.Tensor, metric: str, huber_c: float) -> torch.Tensor:
    """Per-sample distance [B]: the pseudo-Huber sqrt(||a - b||^2 + c^2) - c
    over the whole sample (c <= 0: 0.00054 * sqrt(D)), or the pixel mean of
    the squared error ("l2")."""
    axes = tuple(range(1, a.ndim))
    if metric == "l2":
        return torch.mean(torch.square(a - b), dim=axes)
    dim = 1
    for s in a.shape[1:]:
        dim *= s
    c = float(huber_c) if huber_c > 0 else 0.00054 * float(dim) ** 0.5
    sq = torch.sum(torch.square(a - b), dim=axes)
    return torch.sqrt(sq + c * c) - c


def pair_weight(sig_hi: torch.Tensor, sig_lo: torch.Tensor, weighting: str) -> torch.Tensor:
    """lambda(sigma_hi, sigma_lo): 1 / (sigma_hi - sigma_lo) under "ict"."""
    if weighting == "ict":
        return 1.0 / (sig_hi - sig_lo)
    return torch.ones_like(sig_hi)
