"""Flow matching: the straight-line interpolant and its velocity target
(Lipman et al., arXiv:2210.02747; Liu et al., arXiv:2209.03003; the
logit-normal time density and the timestep shift of SD3, arXiv:2403.03206).

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/core/flow.py``.
x_t = (1 - t) x0 + t e for t in (0, 1]; the network F(x_t, t * TIME_SCALE)
regresses u = e - x0, and sampling integrates dx/dt = F from t = 1 to 0.  A
VP step with a = sqrt(abar), s = sqrt(1 - abar) shares its marginal with the
flow time t = s / (a + s) at x_flow = x_vp / (a + s): the eps view of a flow
model (``sample.make_flow_to_eps_apply_fn``) rests on that.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..parallel import mesh as P

__all__ = ["FlowConfig", "TIME_SCALE", "sample_t", "interpolate", "flow_time_grid",
           "vp_t_to_flow_t"]

# flow time in (0, 1] enters the timestep embedding as t * TIME_SCALE, the
# range the embedding was made for (discrete t up to 1000)
TIME_SCALE = 1000.0


class FlowConfig(NamedTuple):
    """SD3's base recipe: logit-normal times centred at t = 0.5."""

    t_dist: str = "lognorm"  # "lognorm": sigmoid(N(logit_mean, logit_std^2)); "uniform"
    logit_mean: float = 0.0
    logit_std: float = 1.0
    shift: float = 1.0  # the sampling grid's timestep shift (1: none)


def sample_t(generator: Optional[torch.Generator], batch: int, cfg: FlowConfig,
             device=None) -> torch.Tensor:
    """Per-sample training times in (0, 1), [B] float32, from ``generator``."""
    if cfg.t_dist == "lognorm":
        z = P.randn((batch,), generator=generator, device=device)
        return torch.sigmoid(cfg.logit_mean + cfg.logit_std * z)
    if cfg.t_dist == "uniform":
        u = P.rand((batch,), generator=generator, device=device)
        return torch.clamp(u, 1e-5, 1.0 - 1e-5)
    raise ValueError(f"unknown t_dist {cfg.t_dist!r} (lognorm | uniform)")


def interpolate(x0: torch.Tensor, e: torch.Tensor, t: torch.Tensor):
    """(x_t, u): the point on the line at per-sample ``t`` [B] and its
    velocity target e - x0."""
    t_img = t.reshape((-1,) + (1,) * (x0.ndim - 1)).to(x0.dtype)
    return (1.0 - t_img) * x0 + t_img * e, e - x0


def flow_time_grid(n: int, shift: float = 1.0) -> np.ndarray:
    """n + 1 times descending from 1 to 0 (float64), warped toward t = 1 by
    SD3's shift t = s u / (1 + (s - 1) u)."""
    if n < 1:
        raise ValueError("need at least 1 sampling step")
    s = float(shift)
    if s <= 0.0:
        raise ValueError("shift must be positive")
    u = np.linspace(1.0, 0.0, n + 1, dtype=np.float64)
    return (s * u) / (1.0 + (s - 1.0) * u)


def vp_t_to_flow_t(alphas_hat: torch.Tensor) -> torch.Tensor:
    """The flow time of each VP step: s / (a + s)."""
    a = torch.sqrt(alphas_hat)
    s = torch.sqrt(1.0 - alphas_hat)
    return s / (a + s)
