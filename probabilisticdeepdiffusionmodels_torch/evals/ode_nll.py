"""The exact likelihood of the flow-matching and EDM families through their
probability-flow ODEs (the instantaneous change of variables of Neural
ODEs, arXiv:1806.07366, with FFJORD's Hutchinson trace estimator,
arXiv:1810.01367).

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/evals/ode_nll.py``.
For a velocity field F transporting data (s at the grid's start) to the
prior (its end),

    log p(x0) = log p_prior(x1) + integral of tr(dF/dx)(x_s, s) ds,

the trace estimated at each evaluation with Rademacher probes v drawn once
and reused at every step: tr(J) ~ mean over v of v.(J v).  JAX takes J v by
``jax.jvp``.  The port's gradients through its kernels exist in reverse
mode only (``ops/autograd.py``), so each probe takes the vector-Jacobian
product instead: one forward with x requiring a gradient, then per probe
g = dF/dx^T v by ``torch.autograd.grad`` (the graph kept for all but the
last) and v.g, which equals v.(J v) in exact arithmetic.  On a card that
runs the forward kernels and the backward kernels of ``gn_affine``.

Heun (the default) evaluates both ends of every interval, Euler the start
alone; the loop is a Python loop over the host's grid: ``np.linspace`` for
flow (t from 0 to 1, prior N(0, I)), the reversed Karras grid for EDM (sigma
from sigma_min up to sigma_max, prior N(0, sigma_max^2 I); the likelihood of
the sigma_min-smoothed density).  The probes come from a ``torch.Generator``
on x0's device or are injected (``probes``, [n_probes, *x0.shape]), which is
how the tests feed JAX's own.  Bits/dim on the [-1, 1] inputs, no
dequantization offset.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..core.edm import edm_denoise, karras_sigma_grid
from ..core.flow import TIME_SCALE

__all__ = ["flow_ode_nll", "edm_ode_nll"]


def _probes(x0: torch.Tensor, n_probes: int, generator: Optional[torch.Generator],
            probes: Optional[torch.Tensor]) -> torch.Tensor:
    if n_probes < 1:
        raise ValueError("need at least 1 Hutchinson probe")
    if probes is not None:
        probes = torch.as_tensor(probes, dtype=torch.float32, device=x0.device)
        if tuple(probes.shape) != (n_probes, *x0.shape):
            raise ValueError(f"probes of shape {tuple(probes.shape)}, need "
                             f"{(n_probes, *x0.shape)}")
        return probes
    if generator is None:
        raise ValueError("need a torch.Generator (or explicit probes)")
    signs = torch.randint(0, 2, (n_probes, *x0.shape), generator=generator, device=x0.device)
    return signs.float() * 2.0 - 1.0


def _hutchinson_ode_logp(vel: Callable, x0: torch.Tensor, grid: np.ndarray,
                         probes: torch.Tensor, heun: bool):
    """Integrate dx/ds = vel(x, s) and d(logdet)/ds = tr(d vel/dx) over
    ``grid`` (data end first): (x at the grid's end, delta_logp [B])."""
    b, n = x0.shape[0], probes.shape[0]

    def vel_and_div(x, s):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            out = vel(x, s)
        div = torch.zeros(b, device=x.device)
        for i in range(n):
            v = probes[i]
            g, = torch.autograd.grad(out, x, v, retain_graph=i < n - 1)
            div = div + torch.sum((g * v).reshape(b, -1), dim=1)
        return out.detach(), div / n

    # the grid in float32, as JAX scans it
    grid = grid.astype(np.float32)
    x, ld = x0, torch.zeros(b, device=x0.device)
    for s_a, s_b in zip(grid[:-1], grid[1:]):
        ds = float(s_b - s_a)
        f_a, d_a = vel_and_div(x, float(s_a))
        x_eul = x + ds * f_a
        if not heun:
            x, ld = x_eul, ld + ds * d_a
            continue
        f_b, d_b = vel_and_div(x_eul, float(s_b))
        x, ld = x + ds * 0.5 * (f_a + f_b), ld + ds * 0.5 * (d_a + d_b)
    return x, ld


def _result(logp_prior: torch.Tensor, delta_logp: torch.Tensor, dims: int):
    logp = logp_prior + delta_logp
    return {
        "log_likelihood": logp,
        "nll_bits_per_dim": -logp / (dims * np.log(2.0)),
        "prior_logp": logp_prior,
        "delta_logp": delta_logp,
    }


def flow_ode_nll(
    model_fn: Callable,
    x0: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    n_steps: int = 100,
    n_probes: int = 1,
    heun: bool = True,
    y: Optional[torch.Tensor] = None,
    probes: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Exact ODE log-likelihood of ``x0`` under a flow velocity model
    ``model_fn(x, t * TIME_SCALE, y)`` (the raw network), integrated data
    -> noise over a uniform ``n_steps`` grid, Heun or (``heun=False``)
    Euler.  Per sample: ``log_likelihood`` (nats), ``nll_bits_per_dim``,
    ``prior_logp`` and ``delta_logp``."""
    if n_steps < 1:
        raise ValueError("need at least 1 integration step")
    probes = _probes(x0, n_probes, generator, probes)
    b = x0.shape[0]
    dims = int(np.prod(x0.shape[1:]))

    def vel(x, t):
        return model_fn(x, torch.full((b,), t * TIME_SCALE, device=x.device), y)

    x1, delta_logp = _hutchinson_ode_logp(vel, x0, np.linspace(0.0, 1.0, n_steps + 1),
                                          probes, heun)
    prior_logp = -0.5 * (torch.sum(torch.square(x1).reshape(b, -1), dim=1)
                         + dims * np.log(2.0 * np.pi))
    return _result(prior_logp, delta_logp, dims)


def edm_ode_nll(
    model_fn: Callable,
    x0: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    sigma_data: float = 0.5,
    sigma_min: float = 0.002,
    sigma_max: float = 80.0,
    rho: float = 7.0,
    n_steps: int = 100,
    n_probes: int = 1,
    heun: bool = True,
    y: Optional[torch.Tensor] = None,
    probes: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Exact ODE log-likelihood of ``x0`` under an EDM denoiser built from
    the raw network ``model_fn`` (the preconditioning of ``core/edm.py``):
    dx/dsigma = (x - D(x; sigma)) / sigma from sigma_min up to sigma_max
    over the ascending Karras grid, prior N(0, sigma_max^2 I).  The fields
    of ``flow_ode_nll``."""
    if n_steps < 1:
        raise ValueError("need at least 1 integration step")
    probes = _probes(x0, n_probes, generator, probes)
    b = x0.shape[0]
    dims = int(np.prod(x0.shape[1:]))

    def vel(x, sigma):
        # sigma a host float32: the scalar path of edm_denoise
        return (x - edm_denoise(model_fn, x, np.float32(sigma), sigma_data, y)) / sigma

    grid = karras_sigma_grid(n_steps + 1, sigma_min, sigma_max, rho)[::-1]
    x1, delta_logp = _hutchinson_ode_logp(vel, x0, np.ascontiguousarray(grid), probes, heun)
    prior_logp = -0.5 * (torch.sum(torch.square(x1).reshape(b, -1), dim=1) / sigma_max ** 2
                         + dims * np.log(2.0 * np.pi * sigma_max ** 2))
    return _result(prior_logp, delta_logp, dims)
