"""EDM: the preconditioned continuous-sigma denoiser (Karras et al.,
arXiv:2206.00364).

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/core/edm.py``.
The model is a denoiser D(x; sigma) of x = x0 + sigma * n, built from the
raw network F with the preconditioning of eq. 7:

    D(x; sigma) = c_skip x + c_out F(c_in x, c_noise)
    c_skip = sd^2 / (sigma^2 + sd^2),  c_out = sigma sd / sqrt(sigma^2 + sd^2)
    c_in = 1 / sqrt(sigma^2 + sd^2),   c_noise = ln(sigma) / 4

(sd = sigma_data).  ``c_noise`` is the network's timestep: a float, negative
below sigma = 1.  Training draws ln sigma ~ N(P_mean, P_std^2) and weights
the loss by lambda(sigma) = 1 / c_out^2 (eq. 8); sampling integrates
dx/dsigma = (x - D)/sigma over the rho-warped grid of eq. 5.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

__all__ = ["EDMConfig", "precond", "edm_denoise", "loss_weight", "karras_sigma_grid"]


class EDMConfig(NamedTuple):
    """The paper's CIFAR-10 settings (Table 1, "EDM" column)."""

    sigma_data: float = 0.5
    P_mean: float = -1.2  # ln sigma ~ N(P_mean, P_std^2) in training
    P_std: float = 1.2
    sigma_min: float = 0.002
    sigma_max: float = 80.0
    rho: float = 7.0


def precond(sigma: torch.Tensor, sigma_data: float):
    """(c_skip, c_out, c_in, c_noise), each shaped like ``sigma`` (> 0)."""
    sd2 = sigma_data * sigma_data
    denom = torch.square(sigma) + sd2
    c_skip = sd2 / denom
    c_out = sigma * sigma_data / torch.sqrt(denom)
    c_in = 1.0 / torch.sqrt(denom)
    c_noise = torch.log(sigma) / 4.0
    return c_skip, c_out, c_in, c_noise


def edm_denoise(model_fn: Callable, x: torch.Tensor, sigma, sigma_data: float,
                y: Optional[torch.Tensor] = None, **kwargs) -> torch.Tensor:
    """D(x; sigma) for a scalar ``sigma`` (one level for the batch: a
    float or a 0-d CPU tensor, kept on the host) or a per-sample [B]
    tensor; the network's timestep is c_noise as a [B] float vector."""
    sigma = torch.as_tensor(sigma, dtype=torch.float32)
    if sigma.ndim:
        c_skip, c_out, c_in, t_vec = precond(sigma.to(x.device), sigma_data)
        bshape = (-1,) + (1,) * (x.ndim - 1)
        c_skip, c_out, c_in = (c.reshape(bshape) for c in (c_skip, c_out, c_in))
    else:
        c_skip, c_out, c_in, c_noise = precond(sigma, sigma_data)
        t_vec = torch.full((x.shape[0],), float(c_noise), device=x.device)
    out = model_fn(c_in * x, t_vec, y, **kwargs)
    return c_skip * x + c_out * out


def loss_weight(sigma: torch.Tensor, sigma_data: float) -> torch.Tensor:
    """lambda(sigma) = (sigma^2 + sd^2) / (sigma sd)^2 (eq. 8)."""
    sd2 = sigma_data * sigma_data
    s2 = torch.square(sigma)
    return (s2 + sd2) / (s2 * sd2)


def karras_sigma_grid(n: int, sigma_min: float = 0.002, sigma_max: float = 80.0,
                      rho: float = 7.0) -> np.ndarray:
    """The ``n`` sigmas of eq. 5, descending from sigma_max to sigma_min
    (float64; the terminal sigma = 0 is not included)."""
    if n < 1:
        raise ValueError("need at least 1 sampling step")
    if n == 1:
        return np.asarray([float(sigma_max)])
    inv = 1.0 / rho
    ramp = np.linspace(0.0, 1.0, n, dtype=np.float64)
    return ((sigma_max ** inv + ramp * (sigma_min ** inv - sigma_max ** inv)) ** rho
            ).astype(np.float64)
