"""Noise schedules and every derived diffusion buffer.

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/core/schedules.py``.
The tables are built once on the host in float32 NumPy, with the same
float32 emulation as the JAX package (``_sqrt_f32`` goes through
``torch.sqrt`` on CPU tensors, ``_cumprod_f32`` accumulates in float64), so
both packages produce bit-equal buffers.  ``core.diffusion.DiffusionTables``
moves them onto a device.

Beta modes: "linear", "cosine", "mixed" (half the linear alpha-bar table,
half the cosine one) and "custom"; ``rescale_zero_terminal_snr`` rescales a
beta table to a (numerically) zero terminal SNR.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable, Optional, Sequence

import numpy as np
import torch

__all__ = [
    "NoiseSchedule",
    "get_betas",
    "linear_betas",
    "cosine_alpha_bar",
    "betas_for_alpha_bar",
    "mixed_alpha_bar",
    "rescale_zero_terminal_snr",
]


def linear_betas(
    diffusion_steps: int,
    beta_start: Optional[float] = None,
    beta_end: Optional[float] = None,
) -> np.ndarray:
    """Linear beta ramp in float32, ``torch.linspace`` float32 CPU semantics.

    Unset endpoints scale with 1000/T.  The endpoints and the step are
    rounded to float32 and the fill is two-sided (``start + i*step`` below
    the halfway point, ``end - (T-1-i)*step`` above), accumulated in float64.
    """
    if beta_start is None or beta_end is None:
        scale = 1000.0 / diffusion_steps
        beta_start = scale * 0.0001
        beta_end = scale * 0.02
    if diffusion_steps == 1:
        return np.asarray([beta_start], dtype=np.float32)
    s32 = np.float32(beta_start)
    e32 = np.float32(beta_end)
    step = (e32 - s32) / np.float32(diffusion_steps - 1)
    i = np.arange(diffusion_steps)
    lo = np.float64(s32) + i * np.float64(step)
    hi = np.float64(e32) - (diffusion_steps - 1 - i) * np.float64(step)
    out = np.where(i < diffusion_steps // 2, lo, hi)
    return out.astype(np.float32)


def cosine_alpha_bar(t: float) -> float:
    """IDDPM cosine alpha-bar, s=0.008."""
    return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2


def betas_for_alpha_bar(
    alpha_bar: Callable[[float], float],
    diffusion_steps: int,
    max_beta: float = 0.999,
) -> np.ndarray:
    """beta_i = 1 - alpha_bar((i+1)/T) / alpha_bar(i/T), clipped at max_beta,
    computed in float64 and cast to float32."""
    betas = np.empty(diffusion_steps, dtype=np.float64)
    for i in range(diffusion_steps):
        t1 = i / diffusion_steps
        t2 = (i + 1) / diffusion_steps
        betas[i] = min(1.0 - alpha_bar(t2) / alpha_bar(t1), max_beta)
    return betas.astype(np.float32)


def _sqrt_f32(x: np.ndarray) -> np.ndarray:
    """float32 sqrt through torch on the CPU.

    torch's CPU sqrt on large float32 tensors is within 1 ULP of IEEE but not
    correctly rounded; the JAX package calls it for its tables, so calling it
    here keeps the two packages bit-equal.
    """
    x = np.ascontiguousarray(x, dtype=np.float32)
    return torch.sqrt(torch.from_numpy(x)).numpy()


def _cumprod_f32(x: np.ndarray) -> np.ndarray:
    """float32 cumprod accumulated in float64, each output rounded to float32
    (torch's float32 CPU cumprod)."""
    return np.cumprod(x.astype(np.float64)).astype(np.float32)


def _linear_alpha_bar_table(diffusion_steps: int) -> np.ndarray:
    """cumprod(1 - linear betas) in float32."""
    betas = linear_betas(diffusion_steps)
    return _cumprod_f32((np.float32(1.0) - betas).astype(np.float32))


def mixed_alpha_bar(diffusion_steps: int) -> np.ndarray:
    """0.5 * linear + 0.5 * cosine alpha-bar table of length T + 1, in
    float32 arithmetic; the linear table is extrapolated one step past T."""
    lin = _linear_alpha_bar_table(diffusion_steps)
    last = np.float32(2.0) * lin[-1] - lin[-2]
    lin = np.concatenate([lin, np.asarray([last], dtype=np.float32)])
    cos = np.asarray(
        [cosine_alpha_bar(t / diffusion_steps) for t in range(diffusion_steps + 1)],
        dtype=np.float32,
    )
    return (np.float32(0.5) * lin + np.float32(0.5) * cos).astype(np.float32)


def get_betas(
    beta_start: Optional[float] = None,
    beta_end: Optional[float] = None,
    diffusion_steps: int = 1000,
    mode: str = "linear",
    max_beta: float = 0.999,
    custom_alpha_bar: Optional[Callable[[float], float]] = None,
) -> np.ndarray:
    """Beta table for ``mode``."""
    if mode == "linear":
        return linear_betas(diffusion_steps, beta_start, beta_end)
    if mode == "cosine":
        return betas_for_alpha_bar(cosine_alpha_bar, diffusion_steps, max_beta)
    if mode == "mixed":
        table = mixed_alpha_bar(diffusion_steps)
        return betas_for_alpha_bar(
            lambda t: table[int(t * diffusion_steps)], diffusion_steps, max_beta
        )
    if mode == "custom":
        if custom_alpha_bar is None:
            raise ValueError("custom mode requires custom_alpha_bar")
        return betas_for_alpha_bar(custom_alpha_bar, diffusion_steps, max_beta)
    raise ValueError(f"Wrong beta mode: {mode}")


def rescale_zero_terminal_snr(betas: np.ndarray, alpha_floor: float = 1e-4) -> np.ndarray:
    """A beta table rescaled so the terminal SNR is (numerically) zero.

    Lin et al., arXiv:2305.08891, Algorithm 1, in float64: sqrt(alpha-bar)
    is shifted and scaled so its first entry stays and its last becomes 0.
    An exact zero alpha-bar_T would make the inverse tables (sqrt(1/ab),
    sqrt(1/ab - 1)) infinite at t = T, so the terminal entry is floored at
    ``alpha_floor`` times its predecessor.  Needs a v- or x0-parameterized
    model (the eps target at t = T is pure input noise); the engine checks.
    """
    b = np.asarray(betas, np.float64)
    if b.ndim != 1 or b.shape[0] < 2:
        raise ValueError("rescale_zero_terminal_snr needs a 1-D beta table "
                         "with at least 2 steps")
    abar = np.cumprod(1.0 - b)
    s = np.sqrt(abar)
    s0, sT = s[0], s[-1]
    s = (s - sT) * (s0 / (s0 - sT))
    abar = s * s
    abar[-1] = abar[-2] * float(alpha_floor)
    alphas = abar / np.concatenate([[1.0], abar[:-1]])
    out = (1.0 - alphas).astype(np.float32)
    if not (np.all(out > 0.0) and np.all(out < 1.0)):
        raise ValueError("rescale_zero_terminal_snr produced betas outside (0, 1): the input "
                         "table is too short or too aggressive for Algorithm 1")
    return out


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    """Immutable table of every derived diffusion quantity, float32 NumPy.

    Timesteps are 1-indexed, t in [1, T]; the arrays are 0-indexed, so
    lookups gather at ``t - 1``.
    """

    diffusion_steps: int
    mode: str
    betas: np.ndarray                     # beta_t
    alphas: np.ndarray                    # 1 - beta_t
    alphas_sqrt: np.ndarray               # sqrt(alpha_t)
    alphas_hat: np.ndarray                # cumprod alpha (alpha-bar)
    alphas_hat_sqrt: np.ndarray           # sqrt(alpha-bar)
    one_min_alphas_hat_sqrt: np.ndarray   # sqrt(1 - alpha-bar)
    alphas_hat_prev: np.ndarray           # alpha-bar_{t-1}, leading 1.0
    alphas_hat_next: np.ndarray           # alpha-bar_{t+1}, trailing 0.0
    posterior_variance: np.ndarray        # beta-tilde
    sqrt_recip_alphas_hat: np.ndarray     # sqrt(1/alpha-bar)
    sqrt_recipm1_alphas_hat: np.ndarray   # sqrt(1/alpha-bar - 1)
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    denoising_coef: np.ndarray            # beta / sqrt(1 - alpha-bar)
    posterior_log_variance_clipped: np.ndarray

    @classmethod
    def create(
        cls,
        diffusion_steps: int = 1000,
        mode: str = "linear",
        beta_start: Optional[float] = None,
        beta_end: Optional[float] = None,
        max_beta: float = 0.999,
        custom_alpha_bar: Optional[Callable[[float], float]] = None,
        betas: Optional[Sequence[float]] = None,
    ) -> "NoiseSchedule":
        if betas is None:
            betas_np = get_betas(
                beta_start, beta_end, diffusion_steps, mode, max_beta, custom_alpha_bar
            )
        else:
            betas_np = np.asarray(betas, dtype=np.float32)
        t = betas_np.shape[0]
        if t != diffusion_steps:
            raise ValueError(f"{t} betas for {diffusion_steps} diffusion steps")
        if np.any(betas_np >= 1.0):
            warnings.warn(
                f"noise schedule has beta >= 1 (max {betas_np.max():.3g}); "
                "alpha goes non-positive and the sqrt buffers will be NaN. "
                "For the linear mode this happens at small T because betas "
                "scale by 1000/T; use a larger T or explicit "
                "beta_start/beta_end.",
                RuntimeWarning,
                stacklevel=2,
            )

        one = np.float32(1.0)
        alphas = (one - betas_np).astype(np.float32)
        alphas_sqrt = _sqrt_f32(alphas)
        alphas_hat = _cumprod_f32(alphas)
        alphas_hat_sqrt = _sqrt_f32(alphas_hat)
        one_min_alphas_hat_sqrt = _sqrt_f32((one - alphas_hat).astype(np.float32))
        alphas_hat_prev = np.append(one, alphas_hat[:-1]).astype(np.float32)
        alphas_hat_next = np.append(alphas_hat[1:], np.float32(0.0)).astype(np.float32)
        posterior_variance = (
            betas_np * (one - alphas_hat_prev) / (one - alphas_hat)
        ).astype(np.float32)
        sqrt_recip = _sqrt_f32((one / alphas_hat).astype(np.float32))
        sqrt_recipm1 = _sqrt_f32((one / alphas_hat - one).astype(np.float32))
        coef1 = (
            betas_np * _sqrt_f32(alphas_hat_prev) / (one - alphas_hat)
        ).astype(np.float32)
        coef2 = (
            (one - alphas_hat_prev) * alphas_sqrt / (one - alphas_hat)
        ).astype(np.float32)
        denoising_coef = (betas_np / one_min_alphas_hat_sqrt).astype(np.float32)
        # log posterior variance with the t=1 entry backfilled (learned sigma)
        pv = posterior_variance.copy()
        if t > 1:
            pv[0] = posterior_variance[1]
        pv = np.maximum(pv, np.float32(1e-20))
        post_logvar_clipped = np.log(pv, dtype=np.float32)

        return cls(
            diffusion_steps=diffusion_steps,
            mode=mode,
            betas=betas_np,
            alphas=alphas,
            alphas_sqrt=alphas_sqrt,
            alphas_hat=alphas_hat,
            alphas_hat_sqrt=alphas_hat_sqrt,
            one_min_alphas_hat_sqrt=one_min_alphas_hat_sqrt,
            alphas_hat_prev=alphas_hat_prev,
            alphas_hat_next=alphas_hat_next,
            posterior_variance=posterior_variance,
            sqrt_recip_alphas_hat=sqrt_recip,
            sqrt_recipm1_alphas_hat=sqrt_recipm1,
            posterior_mean_coef1=coef1,
            posterior_mean_coef2=coef2,
            denoising_coef=denoising_coef,
            posterior_log_variance_clipped=post_logvar_clipped,
        )

    def sigma(self, sigma_mode: str) -> np.ndarray:
        """Per-step fixed sigma table: "beta" -> sqrt(beta_t),
        "beta_tilde" -> sqrt(posterior variance)."""
        if sigma_mode == "beta":
            return _sqrt_f32(self.betas)
        if sigma_mode == "beta_tilde":
            return _sqrt_f32(self.posterior_variance)
        raise ValueError(f"Wrong sigma mode: {sigma_mode}")
