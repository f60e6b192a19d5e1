"""The variational bound (NLL) of a batch in bits/dim.

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/evals/nll.py``
(DDPM eq. (5)):

  * L_T: KL(q(x_T | x_0) || N(0, I));
  * L_0: the discretized Gaussian decoder NLL at t = 1;
  * L_intermediate: the sum over t = 2..T of KL(q(x_{t-1} | x_t, x_0) ||
    p(x_{t-1} | x_t)), with a fresh noising of x_0 at each t;

each divided by ln 2.  The model mean is the unclipped eps -> mu path, the
model's variance the fixed sigma table's (or, for a learned-sigma head, the
interpolation between beta and beta-tilde).  Where JAX scans t in one jit,
the port runs a Python loop with one model call per t, under no_grad; the
results stay on the device until the caller reads them.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from ..core import diffusion as D
from ..core.diffusion import DiffusionTables

__all__ = ["calculate_likelihood"]


@torch.no_grad()
def calculate_likelihood(
    model_fn: Callable,
    tables: DiffusionTables,
    x0: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    sigma_mode: str = "beta",
    y: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """The bound of ``x0`` under ``model_fn(x, t, y)``, in bits/dim.

    Noise: drawn from ``generator`` (on x0's device), L_0's draw first, then
    one for each t = 2..T in ascending order; or given as ``noise`` of shape
    [T, *x0.shape], ``noise[0]`` for L_0 and ``noise[t-1]`` for t.

    Returns L_0, L_T, L_intermediate and nll [B]; L_intermediate_per_t
    [T-1, B]; MSE_per_t [T-1] (the mean squared eps error at t = 2..T) and
    MSE, their mean.
    """
    T = tables.diffusion_steps
    b, ndim = x0.shape[0], x0.ndim
    if noise is None and generator is None:
        raise ValueError("need a torch.Generator (or explicit noise)")
    if noise is not None and tuple(noise.shape) != (T, *x0.shape):
        raise ValueError(f"noise of shape {tuple(noise.shape)}, need {(T, *x0.shape)}")
    ln2 = math.log(2.0)
    sigma_table = tables.sigma_table(sigma_mode)

    def draw(i: int) -> torch.Tensor:
        if noise is not None:
            return noise[i]
        return torch.randn(x0.shape, generator=generator, device=x0.device, dtype=x0.dtype)

    def t_full(value: int) -> torch.Tensor:
        return torch.full((b,), value, dtype=torch.long, device=x0.device)

    # L_T
    q_mean, q_std = D.q_mean_std(tables, x0, t_full(T))
    L_T = D.mean_flat(D.normal_kl(q_mean, 2.0 * torch.log(q_std), 0.0, 0.0)) / ln2

    # L_0
    t1 = t_full(1)
    x_1 = D.q_sample(tables, x0, draw(0), t1)
    eps0, v0 = _eps_and_v(model_fn, x_1, t1, y)
    mean0 = D.model_mean_from_epsilon(tables, x_1, t1, eps0)
    if v0 is not None:
        log_scale0 = 0.5 * D.learned_logvar(tables, t1, v0, ndim)
    else:
        log_scale0 = torch.log(sigma_table[0]) * torch.ones_like(x0)
    L_0 = -D.mean_flat(D.discretized_gaussian_log_likelihood(x0, mean0, log_scale0)) / ln2

    # L_intermediate, t = 2..T
    L_list, mse_list = [], []
    for t_step in range(2, T + 1):
        t = t_full(t_step)
        z = draw(t_step - 1)
        x_t = D.q_sample(tables, x0, z, t)
        mean_t, var_t = D.q_posterior(tables, t, x0, x_t)
        eps, v = _eps_and_v(model_fn, x_t, t, y)
        pred_mean = D.model_mean_from_epsilon(tables, x_t, t, eps)
        if v is not None:
            pred_logvar = D.learned_logvar(tables, t, v, ndim)
        else:
            pred_logvar = 2.0 * torch.log(D.expand_to(sigma_table, t, ndim))
        kl = D.normal_kl(mean_t, torch.log(var_t), pred_mean, pred_logvar)
        L_list.append(D.mean_flat(kl) / ln2)
        mse_list.append(torch.mean(torch.square(eps - z)))

    L_per_t, mse_per_t = torch.stack(L_list), torch.stack(mse_list)
    L_intermediate = L_per_t.sum(dim=0)
    return {
        "L_0": L_0,
        "L_T": L_T,
        "L_intermediate": L_intermediate,
        "L_intermediate_per_t": L_per_t,
        "nll": L_0 + L_intermediate + L_T,
        "MSE": mse_per_t.mean(),
        "MSE_per_t": mse_per_t,
    }


def _eps_and_v(model_fn: Callable, x: torch.Tensor, t: torch.Tensor,
               y: Optional[torch.Tensor]):
    """The model's eps, and v where the head has 2C channels (learned sigma)."""
    out = model_fn(x, t, y)
    if out.shape[-1] == 2 * x.shape[-1]:
        eps, v = out.chunk(2, dim=-1)
        return eps, v
    return out, None
