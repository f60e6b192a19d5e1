"""Ancestral reverse-diffusion sampling and schedule respacing.

PyTorch counterpart of ``p_sample_loop``, ``space_timesteps`` and
``respaced_schedule`` in ``probabilisticdeepdiffusionmodels_tpu/sample/sampler.py``.
The reverse loop is a Python loop of eager steps (PyTorch has no ``scan``);
the update is ``core.diffusion.p_step`` (x <- mu - sigma*z, no noise at
t == 1, optional x0 clipping), so with the same model outputs and the same
z the float32 trajectory equals the JAX one bit for bit.

``model_fn(x, t, y)`` is the model, e.g. a ``UNetModel``; it is fed the
original timestep ``timestep_map[t-1]`` when a respaced schedule is used.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import diffusion as D
from ..core.diffusion import DiffusionTables
from ..core.schedules import NoiseSchedule

__all__ = ["p_sample_loop", "space_timesteps", "respaced_schedule"]


def _model_eps(model_fn: Callable, x: torch.Tensor, t: torch.Tensor,
               y: Optional[torch.Tensor], timestep_map: Optional[torch.Tensor]):
    """Model call with the respaced timestep map; splits a learned-sigma
    head (2C output channels) into (eps, v)."""
    t_model = t if timestep_map is None else timestep_map[t - 1]
    out = model_fn(x, t_model, y)
    if out.shape[-1] == 2 * x.shape[-1]:
        eps, v = out.chunk(2, dim=-1)
        return eps, v
    return out, None


@torch.no_grad()
def p_sample_loop(
    model_fn: Callable,
    tables: DiffusionTables,
    x_t: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    t_start: Optional[int] = None,
    sigma_mode: str = "beta",
    clip: bool = False,
    mean_only: bool = False,
    y: Optional[torch.Tensor] = None,
    steps_to_return: Optional[Sequence[int]] = None,
    return_stds: bool = False,
    noise: Optional[torch.Tensor] = None,
    timestep_map: Optional[torch.Tensor] = None,
    encoder_reuse: int = 1,
):
    """Ancestral sampling from t_start (default T) down to 1.

    Noise: ``noise`` is a pre-drawn z stack [t_start, *x.shape], z for
    t=t_start first; otherwise z is drawn from ``generator``, which must
    live on x's device.  One of them is required unless ``mean_only``.

    Returns x_0, plus (``steps_to_return``) the recorded x_{t-1} after each
    listed t as [B, S, ...] in descending-t order, plus (``return_stds``) the
    std of x before the loop and after every step, [t_start + 1].
    """
    if encoder_reuse and encoder_reuse > 1:
        raise NotImplementedError("encoder_reuse > 1 is not ported yet")
    T = t_start if t_start is not None else tables.diffusion_steps
    b = x_t.shape[0]
    if not mean_only and noise is None and generator is None:
        raise ValueError("need a torch.Generator (or explicit noise)")
    if noise is not None and noise.shape[0] < T:
        raise ValueError(f"noise holds {noise.shape[0]} draws for {T} steps")

    record = {}
    if steps_to_return is not None:
        if not all(t < T for t in steps_to_return):
            raise ValueError("steps_to_return must be < t_start")
        record = {t: i for i, t in enumerate(sorted(set(steps_to_return), reverse=True))}
    recorded = [None] * len(record)
    stds = [x_t.std(correction=0)] if return_stds else []

    x = x_t
    for i, t_step in enumerate(range(T, 0, -1)):
        t = torch.full((b,), t_step, dtype=torch.long, device=x.device)
        eps, v = _model_eps(model_fn, x, t, y, timestep_map)
        if mean_only:
            z = None
        elif noise is not None:
            z = noise[i]
        else:
            z = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)

        if v is not None and not mean_only:
            mean = D.model_mean_from_epsilon(tables, x, t, eps, clip=clip)
            sigma = torch.exp(0.5 * D.learned_logvar(tables, t, v, x.ndim))
            nonterminal = D.expand_to_mask(t > 1, x.ndim).to(x.dtype)
            x = mean - sigma * z * nonterminal
        else:
            x = D.p_step(tables, x, t, eps, z, sigma_mode=sigma_mode, clip=clip,
                         mean_only=mean_only)
        if t_step in record:
            recorded[record[t_step]] = x
        if return_stds:
            stds.append(x.std(correction=0))

    results = [x]
    if steps_to_return is not None:
        results.append(torch.stack(recorded, dim=1))
    if return_stds:
        results.append(torch.stack(stds))
    return results[0] if len(results) == 1 else tuple(results)


def space_timesteps(diffusion_steps: int, section_counts,
                    alphas_hat: Optional[np.ndarray] = None) -> list:
    """Original timesteps (1-indexed, ascending) to keep for strided sampling.

    ``section_counts``: int N (N evenly spaced steps), "ddimN" (stride T/N),
    "trailingN" (round(T - i*T/N), always including t=T), "karrasN" (Karras
    rho=7 sigma spacing on this schedule's sigmas; needs ``alphas_hat``), or
    an IDDPM section-count list, "15,15,20" or [15, 15, 20].
    """
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            n = int(section_counts[len("ddim"):])
            stride = diffusion_steps // n
            return list(range(1, diffusion_steps + 1, stride))[:n]
        if section_counts.startswith("trailing"):
            n = int(section_counts[len("trailing"):])
            if not 1 <= n <= diffusion_steps:
                raise ValueError(
                    f"trailingN needs 1 <= N <= T, got N={n}, T={diffusion_steps}"
                )
            step = diffusion_steps / n
            kept = {int(round(diffusion_steps - i * step)) for i in range(n)}
            return sorted(k for k in kept if k >= 1)
        if section_counts.startswith("karras"):
            if alphas_hat is None:
                raise ValueError("karrasN spacing places its grid on the "
                                 "schedule's sigmas; pass alphas_hat")
            return _karras_spaced(np.asarray(alphas_hat, np.float64),
                                  int(section_counts[len("karras"):]))
        if "," in section_counts:
            section_counts = [int(s) for s in section_counts.split(",")]
        else:
            section_counts = int(section_counts)
    if isinstance(section_counts, (list, tuple)):
        return _section_spaced(diffusion_steps, section_counts)
    n = int(section_counts)
    if n >= diffusion_steps:
        return list(range(1, diffusion_steps + 1))
    idx = np.linspace(0, diffusion_steps - 1, n).round().astype(int)
    return sorted(set(int(i) + 1 for i in idx))


def _section_spaced(diffusion_steps: int, counts) -> list:
    """IDDPM per-section fractional striding."""
    n_sec = len(counts)
    base, extra = divmod(int(diffusion_steps), n_sec)
    kept, start = [], 0
    for i, c in enumerate(counts):
        size = base + (1 if i < extra else 0)
        c = int(c)
        if c > size:
            raise ValueError(f"section {i} asks for {c} steps from a span of {size}")
        stride = (size - 1) / (c - 1) if c > 1 else 1.0
        cursor = 0.0
        for _ in range(c):
            kept.append(start + round(cursor))
            cursor += stride
        start += size
    return sorted(set(k + 1 for k in kept))


def _karras_spaced(alphas_hat: np.ndarray, n: int, rho: float = 7.0) -> list:
    """Karras sigma grid snapped to the nearest discrete timesteps."""
    sigmas = np.sqrt((1.0 - alphas_hat) / alphas_hat)
    smin, smax = float(sigmas[0]), float(sigmas[-1])
    ramp = np.linspace(0.0, 1.0, int(n))
    grid = (smax ** (1.0 / rho) + ramp * (smin ** (1.0 / rho) - smax ** (1.0 / rho))) ** rho
    log_s = np.log(sigmas)
    idx = np.abs(log_s[None, :] - np.log(grid)[:, None]).argmin(axis=1)
    return sorted(set(int(i) + 1 for i in idx))


def respaced_schedule(sched: NoiseSchedule, use_timesteps: Sequence[int]
                      ) -> Tuple[NoiseSchedule, np.ndarray]:
    """The schedule over a kept subsequence of timesteps, and the timestep
    map (new 1-indexed t -> original 1-indexed t).

    beta'_i = 1 - abar[k_i] / abar[k_{i-1}], capped one float32 ulp under 1.
    """
    kept = sorted(set(int(t) for t in use_timesteps))
    abar = sched.alphas_hat.astype(np.float64)
    last = 1.0
    new_betas = []
    for t in kept:
        a = abar[t - 1]
        new_betas.append(min(1.0 - a / last, 1.0 - 6e-8))
        last = a
    new = NoiseSchedule.create(
        diffusion_steps=len(kept),
        mode=f"respaced[{sched.mode}]",
        betas=np.asarray(new_betas, dtype=np.float32),
    )
    return new, np.asarray(kept, dtype=np.int32)
