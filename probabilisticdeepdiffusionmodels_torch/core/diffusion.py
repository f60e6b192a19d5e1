"""Diffusion-process math on torch tensors.

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/core/diffusion.py``.
Every function is a pure function of (tables, tensors).  Conventions follow
the JAX package:

  * timesteps t are 1-indexed in [1, T]; every table gather is at ``t - 1``;
  * the ancestral update is ``x <- mu - sigma * z``, with no noise at t == 1;
  * images are NHWC.

Eager torch float32 ops are separately rounded IEEE operations, which is
what the JAX package's parity mode emulates, so given the same inputs the
reverse step here matches JAX bit for bit.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .schedules import NoiseSchedule

__all__ = [
    "DiffusionTables",
    "gather",
    "expand_to",
    "expand_to_mask",
    "q_mean_std",
    "q_sample",
    "q_posterior",
    "xstart_from_epsilon",
    "model_mean_from_epsilon",
    "p_step",
    "learned_logvar",
    "mean_flat",
    "normal_kl",
    "approx_standard_normal_cdf",
    "discretized_gaussian_log_likelihood",
    "timestep_embedding",
]


class DiffusionTables(NamedTuple):
    """Schedule buffers as float32 tensors on one device."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_sqrt: torch.Tensor
    alphas_hat: torch.Tensor
    alphas_hat_sqrt: torch.Tensor
    one_min_alphas_hat_sqrt: torch.Tensor
    alphas_hat_prev: torch.Tensor
    posterior_variance: torch.Tensor
    sqrt_recip_alphas_hat: torch.Tensor
    sqrt_recipm1_alphas_hat: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    denoising_coef: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    sigma_beta: torch.Tensor        # sqrt(beta_t)
    sigma_beta_tilde: torch.Tensor  # sqrt(posterior variance)

    @classmethod
    def from_schedule(cls, sched: NoiseSchedule, device) -> "DiffusionTables":
        def dev(x: np.ndarray) -> torch.Tensor:
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        return cls(
            betas=dev(sched.betas),
            alphas=dev(sched.alphas),
            alphas_sqrt=dev(sched.alphas_sqrt),
            alphas_hat=dev(sched.alphas_hat),
            alphas_hat_sqrt=dev(sched.alphas_hat_sqrt),
            one_min_alphas_hat_sqrt=dev(sched.one_min_alphas_hat_sqrt),
            alphas_hat_prev=dev(sched.alphas_hat_prev),
            posterior_variance=dev(sched.posterior_variance),
            sqrt_recip_alphas_hat=dev(sched.sqrt_recip_alphas_hat),
            sqrt_recipm1_alphas_hat=dev(sched.sqrt_recipm1_alphas_hat),
            posterior_mean_coef1=dev(sched.posterior_mean_coef1),
            posterior_mean_coef2=dev(sched.posterior_mean_coef2),
            denoising_coef=dev(sched.denoising_coef),
            posterior_log_variance_clipped=dev(sched.posterior_log_variance_clipped),
            sigma_beta=dev(sched.sigma("beta")),
            sigma_beta_tilde=dev(sched.sigma("beta_tilde")),
        )

    @property
    def diffusion_steps(self) -> int:
        return self.betas.shape[0]

    def sigma_table(self, sigma_mode: str) -> torch.Tensor:
        if sigma_mode == "beta":
            return self.sigma_beta
        if sigma_mode == "beta_tilde":
            return self.sigma_beta_tilde
        raise ValueError(f"Wrong sigma mode: {sigma_mode}")


def gather(table: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """table[t-1] for 1-indexed t (any shape of t)."""
    return table[t - 1]


def expand_to(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """table[t-1] shaped [B, 1, ..., 1] with ``ndim`` dims in all."""
    vals = gather(table, t)
    return vals.reshape(vals.shape + (1,) * (ndim - vals.ndim))


def expand_to_mask(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (ndim - mask.ndim))


def q_mean_std(tables: DiffusionTables, x0: torch.Tensor, t: torch.Tensor):
    """Mean and std of q(x_t | x_0)."""
    mean = x0 * expand_to(tables.alphas_hat_sqrt, t, x0.ndim)
    std = expand_to(tables.one_min_alphas_hat_sqrt, t, x0.ndim)
    return mean, std


def q_sample(tables: DiffusionTables, x0: torch.Tensor, noise: torch.Tensor,
             t: torch.Tensor) -> torch.Tensor:
    """x_t = mean + noise * std for the given noise."""
    mean, std = q_mean_std(tables, x0, t)
    return mean + noise * std


def q_posterior(tables: DiffusionTables, t: torch.Tensor, x0: torch.Tensor,
                x_t: torch.Tensor):
    """Mean and variance of q(x_{t-1} | x_t, x_0), DDPM eq. (6)/(7)."""
    mean = (x0 * expand_to(tables.posterior_mean_coef1, t, x0.ndim)
            + x_t * expand_to(tables.posterior_mean_coef2, t, x0.ndim))
    var = expand_to(tables.posterior_variance, t, x0.ndim)
    return mean, var


def xstart_from_epsilon(tables: DiffusionTables, x_t: torch.Tensor,
                        t: torch.Tensor, epsilon: torch.Tensor,
                        clip: bool = False) -> torch.Tensor:
    """x_0 estimate from predicted noise, optionally clamped to [-1, 1]."""
    x0 = (expand_to(tables.sqrt_recip_alphas_hat, t, x_t.ndim) * x_t
          - expand_to(tables.sqrt_recipm1_alphas_hat, t, x_t.ndim) * epsilon)
    if clip:
        x0 = x0.clamp(-1.0, 1.0)
    return x0


def model_mean_from_epsilon(tables: DiffusionTables, x_t: torch.Tensor,
                            t: torch.Tensor, epsilon: torch.Tensor,
                            clip: bool = False) -> torch.Tensor:
    """Posterior mean from predicted noise.

    Unclipped: mu = (x_t - eps * beta/sqrt(1-ab)) / sqrt(alpha).
    Clipped: through the clamped x0 and the posterior.
    """
    if clip:
        x0 = xstart_from_epsilon(tables, x_t, t, epsilon, clip=True)
        mean, _ = q_posterior(tables, t, x0, x_t)
        return mean
    denois = expand_to(tables.denoising_coef, t, x_t.ndim)
    a_sqrt = expand_to(tables.alphas_sqrt, t, x_t.ndim)
    return (x_t - epsilon * denois) / a_sqrt


def p_step(tables: DiffusionTables, x_t: torch.Tensor, t: torch.Tensor,
           epsilon: torch.Tensor, z: Optional[torch.Tensor],
           sigma_mode: str = "beta", clip: bool = False,
           mean_only: bool = False) -> torch.Tensor:
    """One ancestral reverse step: x <- mu - sigma*z, no noise at t == 1.

    ``z`` is the standard-normal draw; None (or mean_only) takes the mean.
    """
    mean = model_mean_from_epsilon(tables, x_t, t, epsilon, clip=clip)
    if mean_only or z is None:
        return mean
    sigma = expand_to(tables.sigma_table(sigma_mode), t, x_t.ndim)
    nonterminal = expand_to_mask(t > 1, x_t.ndim).to(x_t.dtype)
    return mean - sigma * z * nonterminal


def learned_logvar(tables: DiffusionTables, t: torch.Tensor, v: torch.Tensor,
                   ndim: int) -> torch.Tensor:
    """IDDPM learned log-variance: the model's v in [-1, 1] interpolates
    between log beta_t and the clipped log beta-tilde_t."""
    frac = (v + 1.0) / 2.0
    log_beta = torch.log(expand_to(tables.betas, t, ndim))
    log_beta_tilde = expand_to(tables.posterior_log_variance_clipped, t, ndim)
    return frac * log_beta + (1.0 - frac) * log_beta_tilde


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch dims."""
    return x.mean(dim=tuple(range(1, x.ndim)))


def _as_f32(value, like: torch.Tensor) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def normal_kl(mean1, logvar1, mean2, logvar2) -> torch.Tensor:
    """Broadcasted KL between diagonal Gaussians; Python numbers are float32
    scalars, as in JAX.  At least one argument is a tensor."""
    like = next(v for v in (mean1, logvar1, mean2, logvar2) if isinstance(v, torch.Tensor))
    mean1, logvar1, mean2, logvar2 = (_as_f32(v, like) for v in (mean1, logvar1, mean2, logvar2))
    return 0.5 * (
        -1.0
        + logvar2
        - logvar1
        + torch.exp(logvar1 - logvar2)
        + ((mean1 - mean2) ** 2) * torch.exp(-logvar2)
    )


def approx_standard_normal_cdf(x: torch.Tensor) -> torch.Tensor:
    """Tanh approximation of the standard-normal CDF."""
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * torch.pow(x, 3))))


def discretized_gaussian_log_likelihood(x: torch.Tensor, means: torch.Tensor,
                                        log_scales: torch.Tensor) -> torch.Tensor:
    """Log-likelihood of images discretized to 256 bins under a Gaussian; x
    in [-1, 1], the two edge bins open-ended."""
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_one_minus_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    log_cdf_delta = torch.log(torch.clamp(cdf_plus - cdf_min, min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta))


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embeddings, [cos | sin] (cos first), float32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device)
        / half
    )
    args = timesteps.to(torch.float32)[:, None] * freqs[None]
    embedding = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        embedding = torch.cat([embedding, torch.zeros_like(embedding[:, :1])], dim=-1)
    return embedding
