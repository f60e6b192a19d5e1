"""The reverse-diffusion samplers, the eps views and classifier-free guidance.

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/sample/sampler.py``.
Each loop of the JAX package's ``lax.scan`` is a Python loop of eager steps
here, and each ``lax.cond`` a branch on the host's step index, so no loop
reads the device.  A ``model_fn(x, t, y, **kw)`` is the model (e.g. a
``UNetModel``) or a wrapper around it; the table-driven loops feed it the
original timestep ``timestep_map[t-1]`` under a respaced schedule.

* ``p_sample_loop``: ancestral sampling (``core.diffusion.p_step``), with
  encoder reuse (``encoder_reuse=k``: the UNet's encoder runs every k-th
  step, the steps between rerun the decoder on its cached features);
* ``ddim_sample_loop`` (``eta``, encoder reuse), ``dpmpp_sample_loop``
  (DPM-Solver++ orders 1 and 2), ``heun_sample_loop`` (EDM's Heun, with
  churn), ``inpaint_sample_loop`` (RePaint) and ``ddim_invert_loop``;
* the native loops of the continuous-time models: ``edm_sample_loop``,
  ``flow_sample_loop`` (Euler or Heun) and ``consistency_sample_loop``;
* the eps views of a v, x0, EDM or flow model, which every table-driven
  loop and the NLL take unchanged, and ``make_cfg_apply_fn``.

Random draws come from a ``torch.Generator`` on x's device, in step order;
each loop also takes them injected (``noise``), in the layout its docstring
gives, so a test can feed it the JAX loop's own draws.  Given the same model
outputs and draws, a loop's float32 arithmetic is the JAX loop's, operation
for operation.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import diffusion as D
from ..core.consistency import ConsistencyConfig, cm_apply
from ..core.diffusion import DiffusionTables
from ..core.edm import edm_denoise, karras_sigma_grid, precond
from ..core.flow import TIME_SCALE, flow_time_grid
from ..core.schedules import NoiseSchedule
from ..parallel import mesh as P

__all__ = [
    "p_sample_loop", "ddim_sample_loop", "ddim_invert_loop", "dpmpp_sample_loop",
    "heun_sample_loop", "edm_sample_loop", "flow_sample_loop", "consistency_sample_loop",
    "inpaint_sample_loop", "make_cfg_apply_fn", "make_v_to_eps_apply_fn",
    "make_x0_to_eps_apply_fn", "make_edm_to_eps_apply_fn", "make_flow_to_eps_apply_fn",
    "space_timesteps", "respaced_schedule",
]


# ------------------------------------------------------------- eps views


def _passthrough(out, kwargs, convert):
    """Apply ``convert`` to a model output, leaving a feature dict as it is
    and handing a ``return_cache`` call's cache back beside the result."""
    if kwargs.get("return_features"):
        return out
    if kwargs.get("return_cache"):
        out, cache = out
        return convert(out), cache
    return convert(out)


def _make_to_eps_apply_fn(model_fn: Callable, tables: DiffusionTables,
                          convert: Callable) -> Callable:
    """``model_fn`` seen as an eps model: ``convert(tables, x, t, head)``
    maps its native head to eps on each call.  ``tables`` are the FULL
    schedule's, since the loops apply ``timestep_map`` before the model
    call.  Of a learned-sigma head (2C channels) only the first half is
    converted; the variance interpolation passes through, and so do
    ``return_features`` and the encoder cache."""

    def eps_apply(x: torch.Tensor, t: torch.Tensor, y: Optional[torch.Tensor] = None,
                  **kwargs):
        def to_eps(out):
            if out.shape[-1] == 2 * x.shape[-1]:
                head, var_head = out.chunk(2, dim=-1)
                return torch.cat([convert(tables, x.to(head.dtype), t, head), var_head], dim=-1)
            return convert(tables, x.to(out.dtype), t, out)

        return _passthrough(model_fn(x, t, y, **kwargs), kwargs, to_eps)

    return eps_apply


def make_v_to_eps_apply_fn(model_fn: Callable, tables: DiffusionTables) -> Callable:
    """The eps view of a v-parameterized model (arXiv:2202.00512)."""
    return _make_to_eps_apply_fn(model_fn, tables, D.eps_from_v)


def make_x0_to_eps_apply_fn(model_fn: Callable, tables: DiffusionTables) -> Callable:
    """The eps view of an x0-parameterized model (improved-diffusion's
    ``predict_xstart``)."""
    return _make_to_eps_apply_fn(model_fn, tables, D.eps_from_xstart)


def make_edm_to_eps_apply_fn(model_fn: Callable, tables: DiffusionTables,
                             sigma_data: float) -> Callable:
    """The eps view of an EDM denoiser over a discrete VP schedule.  The
    view changes the model's input: x_t becomes x_ve = x_t / sqrt(ab) at
    sigma = sqrt((1 - ab) / ab), the network runs on (c_in x_ve, c_noise)
    with the fractional c_noise = ln(sigma) / 4, and
    eps = (x_ve - D) / sigma with D = c_skip x_ve + c_out F.  Feature and
    cache calls take the same input and hand their output back as it is."""

    def eps_apply(x: torch.Tensor, t: torch.Tensor, y: Optional[torch.Tensor] = None,
                  **kwargs):
        abar = D.expand_to(tables.alphas_hat, t, x.ndim)
        sigma = torch.sqrt((1.0 - abar) / abar)
        x_ve = x / torch.sqrt(abar)
        c_skip, c_out, c_in, _ = precond(sigma, sigma_data)
        abar_vec = D.gather(tables.alphas_hat, t)
        c_noise = torch.log(torch.sqrt((1.0 - abar_vec) / abar_vec)) / 4.0
        out = model_fn(c_in * x_ve, c_noise, y, **kwargs)
        return _passthrough(out, kwargs,
                            lambda o: (x_ve - (c_skip * x_ve + c_out * o)) / sigma)

    return eps_apply


def make_flow_to_eps_apply_fn(model_fn: Callable, tables: DiffusionTables) -> Callable:
    """The eps view of a flow-matching velocity model over a discrete VP
    schedule.  The view changes the model's input: with a = sqrt(ab),
    s = sqrt(1 - ab), the network runs on x_flow = x_t / (a + s) at the
    fractional time tau * 1000, tau = s / (a + s), and eps = x_flow +
    (1 - tau) u.  Feature and cache calls take the same input and hand their
    output back as it is."""

    def eps_apply(x: torch.Tensor, t: torch.Tensor, y: Optional[torch.Tensor] = None,
                  **kwargs):
        abar = D.expand_to(tables.alphas_hat, t, x.ndim)
        a, s = torch.sqrt(abar), torch.sqrt(1.0 - abar)
        tau = s / (a + s)
        x_flow = x / (a + s)
        abar_vec = D.gather(tables.alphas_hat, t)
        a_vec, s_vec = torch.sqrt(abar_vec), torch.sqrt(1.0 - abar_vec)
        out = model_fn(x_flow, s_vec / (a_vec + s_vec) * TIME_SCALE, y, **kwargs)
        return _passthrough(out, kwargs, lambda o: x_flow + (1.0 - tau) * o)

    return eps_apply


# ------------------------------------------------------------- guidance


def make_cfg_apply_fn(model_fn: Callable, guidance_scale: float, null_class: int,
                      interval: Optional[Tuple[int, int]] = None,
                      guidance_rescale: float = 0.0,
                      tables: Optional[DiffusionTables] = None) -> Callable:
    """Classifier-free guidance (arXiv:2207.12598): ``eps_u + s (eps_c -
    eps_u)`` from ONE call at the doubled batch, ``[x; x]`` with
    ``[y; null_class]``.  Of a learned-sigma head only eps is guided; the
    variance half comes from the conditional half.  The encoder cache made
    and taken through the wrapper is doubled-batch.

    ``interval=(lo, hi)`` (original timesteps, inclusive, arXiv:2404.07724)
    guides only there; a step outside runs one plain conditional call at
    batch B.  The loops decide that on the host: the wrapper has
    ``takes_t_host`` set, and they pass the step's original timestep as
    ``t_host``.  It does not compose with the encoder cache.

    ``guidance_rescale`` phi in (0, 1] (arXiv:2305.08891 section 3.4)
    matches the guided x0 view's per-sample std to the conditional one's
    and blends with weight phi; it needs the FULL schedule's ``tables``.
    """
    s = float(guidance_scale)
    phi = float(guidance_rescale or 0.0)
    if phi:
        if not 0.0 < phi <= 1.0:
            raise ValueError(f"guidance_rescale must be in (0, 1], got {phi}")
        if tables is None:
            raise ValueError("guidance_rescale needs the full-schedule tables")

    def rescaled(x, t, eps_cfg, eps_cond):
        x32 = x.to(eps_cfg.dtype)
        x0_cfg = D.xstart_from_epsilon(tables, x32, t, eps_cfg)
        x0_cond = D.xstart_from_epsilon(tables, x32, t, eps_cond)
        axes = tuple(range(1, x.ndim))
        std_cfg = torch.std(x0_cfg, dim=axes, keepdim=True, correction=0)
        std_cond = torch.std(x0_cond, dim=axes, keepdim=True, correction=0)
        x0_fix = x0_cfg * (std_cond / (std_cfg + 1e-8))
        x0_out = phi * x0_fix + (1.0 - phi) * x0_cfg
        return D.eps_from_xstart(tables, x32, t, x0_out)

    def guided(x, t, y, **kwargs):
        b = x.shape[0]
        out = model_fn(torch.cat([x, x]), torch.cat([t, t]),
                       torch.cat([y, torch.full_like(y, null_class)]), **kwargs)
        cache = None
        if kwargs.get("return_cache"):
            out, cache = out
        if out.shape[-1] == 2 * x.shape[-1]:
            eps2, v2 = out.chunk(2, dim=-1)
            eps = eps2[b:] + s * (eps2[:b] - eps2[b:])
            if phi:
                eps = rescaled(x, t, eps, eps2[:b])
            out = torch.cat([eps, v2[:b]], dim=-1)
        else:
            eps = out[b:] + s * (out[:b] - out[b:])
            if phi:
                eps = rescaled(x, t, eps, out[:b])
            out = eps
        return (out, cache) if kwargs.get("return_cache") else out

    def cfg_apply(x, t, y=None, t_host: Optional[int] = None, **kwargs):
        if y is None:
            raise ValueError("guidance requires class labels")
        if interval is None:
            return guided(x, t, y, **kwargs)
        if kwargs.get("cache") is not None or kwargs.get("return_cache"):
            raise ValueError("guidance_interval does not compose with the encoder cache")
        if t_host is None:
            raise ValueError("guidance_interval decides on the host: pass t_host")
        lo, hi = interval
        if lo <= t_host <= hi:
            return guided(x, t, y, **kwargs)
        return model_fn(x, t, y, **kwargs)

    cfg_apply.takes_t_host = interval is not None
    return cfg_apply


# ------------------------------------------------------------- shared steps


def _host_map(timestep_map) -> Optional[list]:
    """The timestep map as host ints (None stays None).  A map on the card
    costs one copy here, before any loop; the engine passes host arrays."""
    if timestep_map is None:
        return None
    if isinstance(timestep_map, torch.Tensor):
        timestep_map = timestep_map.cpu()
    return [int(v) for v in np.asarray(timestep_map).reshape(-1)]


def _full(b: int, value, x: torch.Tensor, dtype=torch.long) -> torch.Tensor:
    return torch.full((b,), value, dtype=dtype, device=x.device)


def _model_eps(model_fn: Callable, x: torch.Tensor, t_step: int, y: Optional[torch.Tensor],
               tmap: Optional[list], **model_kwargs):
    """The model call at host step ``t_step`` (the original timestep
    ``tmap[t_step-1]`` under a respaced map); splits a learned-sigma head
    (2C output channels) into (eps, v), and returns (eps, v, cache) for a
    ``return_cache`` call."""
    t_model = t_step if tmap is None else tmap[t_step - 1]
    if getattr(model_fn, "takes_t_host", False):
        model_kwargs["t_host"] = t_model
    out = model_fn(x, _full(x.shape[0], t_model, x), y, **model_kwargs)
    cache = None
    if model_kwargs.get("return_cache"):
        out, cache = out
    eps, v = out.chunk(2, dim=-1) if out.shape[-1] == 2 * x.shape[-1] else (out, None)
    return (eps, v, cache) if model_kwargs.get("return_cache") else (eps, v)


def _draw(noise: Optional[torch.Tensor], index, generator: Optional[torch.Generator],
          like: torch.Tensor) -> torch.Tensor:
    """``noise[index]`` where draws are injected, else one from ``generator``."""
    if noise is not None:
        return noise[index]
    return P.randn(like.shape, generator=generator, device=like.device, dtype=like.dtype)


def _ancestral(tables: DiffusionTables, x: torch.Tensor, t: torch.Tensor, eps: torch.Tensor,
               v: Optional[torch.Tensor], z: Optional[torch.Tensor], *, sigma_mode: str,
               clip: bool, mean_only: bool = False) -> torch.Tensor:
    """One ancestral step, x_t -> x_{t-1}: ``p_step``, or with a learned
    variance ``v`` the mean minus its learned sigma times z (no noise at
    t == 1)."""
    if v is not None and not mean_only:
        mean = D.model_mean_from_epsilon(tables, x, t, eps, clip=clip)
        sigma = torch.exp(0.5 * D.learned_logvar(tables, t, v, x.ndim))
        nonterminal = D.expand_to_mask(t > 1, x.ndim).to(x.dtype)
        return mean - sigma * z * nonterminal
    return D.p_step(tables, x, t, eps, z, sigma_mode=sigma_mode, clip=clip,
                    mean_only=mean_only)


def _check_draws(noise, generator, n, what="steps"):
    if noise is None and generator is None:
        raise ValueError("need a torch.Generator (or explicit noise)")
    if noise is not None and noise.shape[0] < n:
        raise ValueError(f"noise holds {noise.shape[0]} draws for {n} {what}")


# ------------------------------------------------------------- ancestral


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
    timestep_map=None,
    encoder_reuse: int = 1,
    reuse_exact_head: int = 0,
    reuse_exact_tail: int = 0,
    reuse_sigma_boost: float = 0.0,
    reuse_prior_noise: float = 0.0,
    reuse_cache_middle: bool = False,
):
    """Ancestral sampling from t_start (default T) down to 1.

    Noise: ``noise`` is a pre-drawn z stack [t_start, *x.shape], z for
    t=t_start first; otherwise z is drawn from ``generator``, which must
    live on x's device.  One of them is required unless ``mean_only``.

    ``encoder_reuse=k`` > 1 ("Faster Diffusion", arXiv:2312.09608; the
    model takes ``cache=`` / ``return_cache=``, as ``UNetModel`` does): see
    ``_p_sample_loop_encoder_reuse`` for the segments and the ``reuse_*``
    knobs; it composes with the plain path only (no ``steps_to_return``
    or ``return_stds``).

    Returns x_0, plus (``steps_to_return``) the recorded x_{t-1} after each
    listed t as [B, S, ...] in descending-t order, plus (``return_stds``) the
    std of x before the loop and after every step, [t_start + 1].
    """
    T = t_start if t_start is not None else tables.diffusion_steps
    if not mean_only:
        _check_draws(noise, generator, T)
    tmap = _host_map(timestep_map)
    if encoder_reuse and encoder_reuse > 1:
        if steps_to_return is not None or return_stds:
            raise ValueError("encoder_reuse composes only with the plain sampling path")
        return _p_sample_loop_encoder_reuse(
            model_fn, tables, x_t, generator, int(encoder_reuse), T, sigma_mode=sigma_mode,
            clip=clip, mean_only=mean_only, y=y, tmap=tmap, noise=noise,
            exact_head=int(reuse_exact_head), exact_tail=int(reuse_exact_tail),
            sigma_boost=float(reuse_sigma_boost), prior_noise=float(reuse_prior_noise),
            cache_middle=bool(reuse_cache_middle))
    b = x_t.shape[0]

    record = {}
    if steps_to_return is not None:
        if not all(t < T for t in steps_to_return):
            raise ValueError("steps_to_return must be < t_start")
        record = {t: i for i, t in enumerate(sorted(set(steps_to_return), reverse=True))}
    recorded = [None] * len(record)
    stds = [x_t.std(correction=0)] if return_stds else []

    x = x_t
    for i, t_step in enumerate(range(T, 0, -1)):
        t = _full(b, t_step, x)
        eps, v = _model_eps(model_fn, x, t_step, y, tmap)
        z = None if mean_only else _draw(noise, i, generator, x)
        x = _ancestral(tables, x, t, eps, v, z, sigma_mode=sigma_mode, clip=clip,
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


def _p_sample_loop_encoder_reuse(model_fn, tables, x_t, generator, k, T, *, sigma_mode, clip,
                                 mean_only, y, tmap, noise=None, exact_head=0, exact_tail=0,
                                 sigma_boost=0.0, prior_noise=0.0, cache_middle=False):
    """Ancestral sampling with the encoder run every k-th step only.

    After a prologue of exact steps (``exact_head`` plus the remainder that
    aligns the segments), each segment of k steps runs the full UNet once,
    keeping its encoder cache, and the k-1 steps after it the middle block
    and decoder on that cache with their own timestep embeddings
    (``cache_middle``: the decoder alone).  The last ``exact_tail`` steps
    are exact again.  On cached steps the noise is scaled by
    sqrt(1 + ``sigma_boost``) and ``prior_noise`` * x_T is added (not at
    t = 1).  z of step t is ``noise[T - t]`` or the generator's next draw.
    """
    b = x_t.shape[0]
    exact_head, exact_tail = max(0, exact_head), max(0, exact_tail)
    if exact_head + exact_tail > T:
        raise ValueError("exact windows exceed the chain")
    head_n = exact_head + (T - exact_head - exact_tail) % k
    mid_kw = {"cache_middle": True} if cache_middle else {}
    boost = float(np.sqrt(1.0 + sigma_boost))

    def update(x, t_step, eps, v, z_scale=1.0):
        z = None if mean_only else z_scale * _draw(noise, T - t_step, generator, x)
        return _ancestral(tables, x, _full(b, t_step, x), eps, v, z, sigma_mode=sigma_mode,
                          clip=clip, mean_only=mean_only)

    def exact(x, t_step):
        eps, v = _model_eps(model_fn, x, t_step, y, tmap)
        return update(x, t_step, eps, v)

    x = x_t
    for t_step in range(T, T - head_n, -1):
        x = exact(x, t_step)
    for t0 in range(T - head_n, exact_tail, -k):
        eps, v, cache = _model_eps(model_fn, x, t0, y, tmap, return_cache=True, **mid_kw)
        x = update(x, t0, eps, v)
        for t_j in range(t0 - 1, t0 - k, -1):
            eps, v = _model_eps(model_fn, x, t_j, y, tmap, cache=cache, **mid_kw)
            x = update(x, t_j, eps, v, z_scale=boost)
            if prior_noise and t_j > 1:
                x = x + prior_noise * x_t
    for t_step in range(exact_tail, 0, -1):
        x = exact(x, t_step)
    return x


# ------------------------------------------------------------- respacing


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


# ------------------------------------------------------------- fast samplers


@torch.no_grad()
def ddim_sample_loop(
    model_fn: Callable,
    tables: DiffusionTables,
    x_t: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    t_start: Optional[int] = None,
    eta: float = 0.0,
    clip: bool = False,
    y: Optional[torch.Tensor] = None,
    timestep_map=None,
    encoder_reuse: int = 1,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """DDIM (deterministic at eta = 0):

        x_{t-1} = sqrt(ab_{t-1}) x0 + sqrt(1 - ab_{t-1} - s^2) eps + s z,
        s = eta sqrt((1 - ab_{t-1}) / (1 - ab_t)) sqrt(1 - ab_t / ab_{t-1}).

    With eta > 0, z of step t is ``noise[T - t]`` or drawn from
    ``generator``.  ``encoder_reuse=k`` runs the encoder every k-th step
    after a prologue of T % k exact steps, as the ancestral loop does.
    """
    T = t_start if t_start is not None else tables.diffusion_steps
    b = x_t.shape[0]
    tmap = _host_map(timestep_map)
    if eta > 0.0:
        _check_draws(noise, generator, T)

    def update(x, t_step, eps):
        t = _full(b, t_step, x)
        x0 = D.xstart_from_epsilon(tables, x, t, eps, clip=clip)
        abar = D.expand_to(tables.alphas_hat, t, x.ndim)
        abar_prev = D.expand_to(tables.alphas_hat_prev, t, x.ndim)
        sigma = (eta * torch.sqrt((1.0 - abar_prev) / (1.0 - abar))
                 * torch.sqrt(1.0 - abar / abar_prev))
        mean = (torch.sqrt(abar_prev) * x0
                + torch.sqrt(torch.clamp(1.0 - abar_prev - sigma * sigma, min=0.0)) * eps)
        if eta > 0.0:
            z = _draw(noise, T - t_step, generator, x)
            nonterminal = D.expand_to_mask(t > 1, x.ndim).to(x.dtype)
            return mean + sigma * z * nonterminal
        return mean

    def exact(x, t_step):
        return update(x, t_step, _model_eps(model_fn, x, t_step, y, tmap)[0])

    k = int(encoder_reuse or 1)
    x = x_t
    if k <= 1:
        for t_step in range(T, 0, -1):
            x = exact(x, t_step)
        return x
    head_n = T % k
    for t_step in range(T, T - head_n, -1):
        x = exact(x, t_step)
    for t0 in range(T - head_n, 0, -k):
        eps, _, cache = _model_eps(model_fn, x, t0, y, tmap, return_cache=True)
        x = update(x, t0, eps)
        for t_j in range(t0 - 1, t0 - k, -1):
            x = update(x, t_j, _model_eps(model_fn, x, t_j, y, tmap, cache=cache)[0])
    return x


@torch.no_grad()
def dpmpp_sample_loop(
    model_fn: Callable,
    tables: DiffusionTables,
    x_t: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    t_start: Optional[int] = None,
    clip: bool = False,
    y: Optional[torch.Tensor] = None,
    timestep_map=None,
    order: int = 2,
) -> torch.Tensor:
    """DPM-Solver++ (arXiv:2211.01095), the multistep data-prediction form.
    With alpha = sqrt(ab), sigma = sqrt(1 - ab), lambda = log(alpha/sigma)
    and h = lambda_{t-1} - lambda_t, each step t -> t-1 is

        x_{t-1} = (sigma_{t-1}/sigma_t) x_t - alpha_{t-1} (e^{-h} - 1) D,

    D the x0 prediction (order 1) or the 2M extrapolation (order 2)
    (1 + 1/(2r)) x0_t - 1/(2r) x0_prev, r = h_prev/h, from the second step
    on.  The step to t = 0 returns the x0 prediction itself ("lower order
    final").  Deterministic: ``generator`` is unused.
    """
    if order not in (1, 2):
        raise ValueError("dpmpp_sample_loop implements orders 1 and 2")
    T = t_start if t_start is not None else tables.diffusion_steps
    b, ndim = x_t.shape[0], x_t.ndim
    tmap = _host_map(timestep_map)
    # JAX clamps ab_{t-1} at 1 - 1e-12, which float32 rounds to 1.0: a no-op
    # (lambda at the t = 1 step's target is +inf, and that step returns x0)

    def lam_of(a):
        return 0.5 * (torch.log(a) - torch.log1p(-a))

    x, x0_prev, h_prev = x_t, torch.zeros_like(x_t), None
    for t_step in range(T, 0, -1):
        t = _full(b, t_step, x)
        eps, _ = _model_eps(model_fn, x, t_step, y, tmap)
        x0 = D.xstart_from_epsilon(tables, x, t, eps, clip=clip)
        if t_step == 1:
            return x0
        a_t = D.expand_to(tables.alphas_hat, t, ndim)
        a_s = D.expand_to(tables.alphas_hat_prev, t, ndim)
        h = lam_of(a_s) - lam_of(a_t)
        if order == 2:
            c = h / (2.0 * h_prev) if h_prev is not None else torch.zeros_like(h)
            d_term = (1.0 + c) * x0 - c * x0_prev
        else:
            d_term = x0
        sigma_t, sigma_s = torch.sqrt(1.0 - a_t), torch.sqrt(1.0 - a_s)
        x = (sigma_s / sigma_t) * x - torch.sqrt(a_s) * torch.expm1(-h) * d_term
        x0_prev, h_prev = x0, h
    return x


@torch.no_grad()
def heun_sample_loop(
    model_fn: Callable,
    tables: DiffusionTables,
    x_t: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    t_start: Optional[int] = None,
    clip: bool = False,
    y: Optional[torch.Tensor] = None,
    timestep_map=None,
    s_churn: float = 0.0,
    s_noise: float = 1.0,
    s_tmin: float = 0.0,
    s_tmax: float = float("inf"),
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """EDM's Heun solver (arXiv:2206.00364 Alg. 2) on the VP tables: in
    x_hat = x / sqrt(ab), sigma = sqrt((1 - ab) / ab) the probability-flow
    ODE is d x_hat / d sigma = eps, and each step t -> t-1 takes an Euler
    step and corrects it with the slope at the target, two model calls.
    The step to t = 0 is Euler alone (one call: JAX evaluates the
    correction there and discards it).  ``clip`` clamps the x0 view and
    rebuilds the slope from it.

    ``s_churn`` > 0: before each step whose sigma lies in [s_tmin, s_tmax],
    noise raises sigma_t to sigma_hat = sigma_t (1 + gamma), gamma =
    min(s_churn / T, sqrt(2) - 1); the model runs at the grid timestep on
    the state rescaled to ab = 1 / (1 + sigma_hat^2).  z of step t is
    ``noise[T - t]`` or drawn from ``generator``.
    """
    T = t_start if t_start is not None else tables.diffusion_steps
    b, ndim = x_t.shape[0], x_t.ndim
    tmap = _host_map(timestep_map)
    churn = float(s_churn) > 0.0
    if churn:
        _check_draws(noise, generator, T)
    gamma_max = min(float(s_churn) / max(T, 1), 2.0 ** 0.5 - 1.0)

    def slope(x, t_step, a, sigma):
        eps, _ = _model_eps(model_fn, x, t_step, y, tmap)
        if clip:
            x0 = D.xstart_from_epsilon(tables, x, _full(b, t_step, x), eps, clip=True)
            eps = (x / torch.sqrt(a) - x0) / torch.clamp(sigma, min=1e-12)
        return eps

    x = x_t
    for t_step in range(T, 0, -1):
        t = _full(b, t_step, x)
        a_t = D.expand_to(tables.alphas_hat, t, ndim)
        a_s = D.expand_to(tables.alphas_hat_prev, t, ndim)
        sig_t = torch.sqrt((1.0 - a_t) / a_t)
        sig_s = torch.sqrt(torch.clamp(1.0 - a_s, min=0.0) / a_s)
        if churn:
            inside = ((sig_t >= s_tmin) & (sig_t <= s_tmax)).to(x.dtype)
            sig_hat = sig_t * (1.0 + inside * gamma_max)
            z = _draw(noise, T - t_step, generator, x)
            x_hat = x / torch.sqrt(a_t) + torch.sqrt(
                torch.clamp(sig_hat * sig_hat - sig_t * sig_t, min=0.0)) * (s_noise * z)
            a_hat = 1.0 / (1.0 + sig_hat * sig_hat)
            d_t = slope(x_hat * torch.sqrt(a_hat), t_step, a_hat, sig_hat)
        else:
            sig_hat = sig_t
            x_hat = x / torch.sqrt(a_t)
            d_t = slope(x, t_step, a_t, sig_t)
        x_euler = torch.sqrt(a_s) * (x_hat + (sig_s - sig_hat) * d_t)
        if t_step == 1:
            return x_euler
        d_s = slope(x_euler, t_step - 1, a_s, sig_s)
        x = torch.sqrt(a_s) * (x_hat + (sig_s - sig_hat) * 0.5 * (d_t + d_s))
    return x


# ------------------------------------------------------------- native loops


def _scalar(value) -> torch.Tensor:
    """A per-step float32 scalar as a 0-d CPU tensor: it combines with a
    tensor on the card without a copy to the device."""
    return torch.tensor(float(value), dtype=torch.float32)


@torch.no_grad()
def edm_sample_loop(
    model_fn: Callable,
    tables: Optional[DiffusionTables],
    x_t: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    n_steps: int = 18,
    sigma_data: float = 0.5,
    sigma_min: float = 0.002,
    sigma_max: float = 80.0,
    rho: float = 7.0,
    clip: bool = False,
    y: Optional[torch.Tensor] = None,
    timestep_map=None,
    s_churn: float = 0.0,
    s_noise: float = 1.0,
    s_tmin: float = 0.0,
    s_tmax: float = float("inf"),
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """EDM's own sampler (arXiv:2206.00364 Alg. 2) for a model trained with
    ``prediction_type="edm"``: Heun on dx/dsigma = (x - D(x; sigma)) / sigma
    over the ``n_steps`` sigmas of the Karras grid, then sigma = 0 (an Euler
    step alone).  ``model_fn`` is the raw network F; the loop owns the
    preconditioning.  ``x_t`` is standard normal noise, scaled to the prior
    sigma_max x_t here.  ``clip`` clamps D to [-1, 1].  ``s_churn`` as in
    ``heun_sample_loop``, natively in sigma; z of step i is ``noise[i]`` or
    drawn from ``generator``.  ``tables`` and ``timestep_map`` are unused.
    """
    n = int(n_steps)
    grid = karras_sigma_grid(n, sigma_min, sigma_max, rho).astype(np.float32)
    nxt = np.concatenate([grid[1:], [0.0]]).astype(np.float32)
    churn = float(s_churn) > 0.0
    if churn:
        _check_draws(noise, generator, n)
    gamma_max = min(float(s_churn) / n, 2.0 ** 0.5 - 1.0)

    def denoise(x, sigma):
        d = edm_denoise(model_fn, x, sigma, sigma_data, y)
        return torch.clamp(d, -1.0, 1.0) if clip else d

    x = _scalar(grid[0]) * x_t
    for i in range(n):
        sig_t, sig_s = _scalar(grid[i]), _scalar(nxt[i])
        if churn:
            gamma = gamma_max if s_tmin <= grid[i] <= s_tmax else 0.0
            sig_hat = sig_t * (1.0 + gamma)
            z = _draw(noise, i, generator, x)
            x_hat = x + torch.sqrt(torch.clamp(sig_hat * sig_hat - sig_t * sig_t, min=0.0)
                                   ) * (s_noise * z)
        else:
            sig_hat, x_hat = sig_t, x
        d_t = (x_hat - denoise(x_hat, sig_hat)) / sig_hat
        x_euler = x_hat + (sig_s - sig_hat) * d_t
        if nxt[i] == 0.0:
            return x_euler
        sig_safe = torch.clamp(sig_s, min=sigma_min)
        d_s = (x_euler - denoise(x_euler, sig_safe)) / sig_safe
        x = x_hat + (sig_s - sig_hat) * 0.5 * (d_t + d_s)
    return x


@torch.no_grad()
def flow_sample_loop(
    model_fn: Callable,
    tables: Optional[DiffusionTables],
    x_t: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    n_steps: int = 25,
    shift: float = 1.0,
    heun: bool = False,
    clip: bool = False,
    y: Optional[torch.Tensor] = None,
    timestep_map=None,
) -> torch.Tensor:
    """The flow model's own sampler: dx/dt = F(x, t) from t = 1 (x = the
    given standard normal noise) to 0 over ``flow_time_grid(n_steps,
    shift)``, Euler, or Heun with ``heun`` (its step to t = 0 an Euler step
    alone).  ``model_fn`` is the raw velocity network, called at the
    fractional time t * 1000.  ``clip`` clamps x0 = x - t F to [-1, 1] and
    rebuilds the slope (above t = 1e-4).  Deterministic; ``generator``,
    ``tables`` and ``timestep_map`` are unused.
    """
    grid = flow_time_grid(int(n_steps), shift).astype(np.float32)
    b = x_t.shape[0]

    def velocity(x, t):
        v = model_fn(x, _full(b, float(t * np.float32(TIME_SCALE)), x, torch.float32), y)
        if clip and t > 1e-4:
            ts = _scalar(t)
            v = (x - torch.clamp(x - ts * v, -1.0, 1.0)) / ts
        return v

    x = x_t
    for t_a, t_b in zip(grid[:-1], grid[1:]):
        dt = _scalar(t_b - t_a)
        v_a = velocity(x, t_a)
        x_euler = x + dt * v_a
        if not heun or t_b == 0.0:
            x = x_euler
            continue
        x = x + dt * 0.5 * (v_a + velocity(x_euler, t_b))
    return x


@torch.no_grad()
def consistency_sample_loop(
    model_fn: Callable,
    tables: Optional[DiffusionTables],
    x_t: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    n_steps: int = 1,
    sigma_data: float = 0.5,
    sigma_min: float = 0.002,
    sigma_max: float = 80.0,
    rho: float = 7.0,
    clip: bool = False,
    y: Optional[torch.Tensor] = None,
    timestep_map=None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """A consistency model's sampler (arXiv:2303.01469 alg. 1): x0 =
    f(sigma_max x_t, sigma_max), then for ``n_steps`` > 1 the interior
    levels tau of an (n+1)-point Karras grid: re-noise x = x0 +
    sqrt(tau^2 - sigma_min^2) z and denoise again.  ``model_fn`` is the raw
    network; z of re-noise i is ``noise[i]`` or drawn from ``generator``.
    ``clip`` clamps each f to [-1, 1].  ``tables`` and ``timestep_map`` are
    unused.
    """
    n = int(n_steps)
    if n < 1:
        raise ValueError("need at least 1 consistency step")
    if n > 1:
        _check_draws(noise, generator, n - 1, "re-noises")
    cfg = ConsistencyConfig(sigma_data=sigma_data, sigma_min=sigma_min, sigma_max=sigma_max,
                            rho=rho)
    b = x_t.shape[0]

    def f(x, sigma):
        out = cm_apply(model_fn, x, _full(b, float(sigma), x, torch.float32), y, cfg)
        return torch.clamp(out, -1.0, 1.0) if clip else out

    sig0 = np.float32(sigma_max)
    x0 = f(_scalar(sig0) * x_t, sig0)
    taus = karras_sigma_grid(n + 1, sigma_min, sigma_max, rho)[1:-1].astype(np.float32)
    for i, tau in enumerate(taus):
        scale = np.sqrt(max(tau * tau - np.float32(sigma_min ** 2), np.float32(0.0)))
        x0 = f(x0 + _scalar(scale) * _draw(noise, i, generator, x0), tau)
    return x0


# ------------------------------------------------------------- editing


@torch.no_grad()
def inpaint_sample_loop(
    model_fn: Callable,
    tables: DiffusionTables,
    x_t: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    x0_known: torch.Tensor,
    mask: torch.Tensor,
    sigma_mode: str = "beta",
    clip: bool = False,
    y: Optional[torch.Tensor] = None,
    timestep_map=None,
    resample_steps: int = 1,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """RePaint inpainting (arXiv:2201.09865): each ancestral step denoises
    the whole image, then the known region (``mask`` == 1, broadcast to the
    image) is overwritten with ``x0_known`` noised to the step's target
    t-1 (x0_known itself at t-1 = 0).  ``resample_steps`` R > 1 repeats a
    step R times, sending x_{t-1} back up through q(x_t | x_{t-1}) between
    passes (R model calls a step).

    Draws of step t, pass i: the step's z, the known region's noise and the
    re-noise, ``noise[T - t, i, 0..2]`` where injected ([T, R, 3, *x.shape]),
    else from ``generator`` in that order (the known region's only for
    t > 1, the re-noise only before the last pass).
    """
    T = tables.diffusion_steps
    b, ndim = x_t.shape[0], x_t.ndim
    R = int(resample_steps)
    if R < 1:
        raise ValueError("resample_steps must be >= 1")
    _check_draws(noise, generator, T)
    tmap = _host_map(timestep_map)
    mask = torch.broadcast_to(mask, x_t.shape).to(x_t.dtype)

    x = x_t
    for t_step in range(T, 0, -1):
        t = _full(b, t_step, x)
        for i in range(R):
            def draw(k):
                return _draw(None if noise is None else noise[T - t_step, i], k, generator, x)

            eps, v = _model_eps(model_fn, x, t_step, y, tmap)
            x_prev = _ancestral(tables, x, t, eps, v, draw(0), sigma_mode=sigma_mode,
                                clip=clip)
            if t_step > 1:
                known = D.q_sample(tables, x0_known, draw(1), t - 1)
            else:
                known = x0_known
            x_prev = mask * known + (1.0 - mask) * x_prev
            if i < R - 1:
                beta = D.expand_to(tables.betas, t, ndim)
                x_prev = torch.sqrt(1.0 - beta) * x_prev + torch.sqrt(beta) * draw(2)
            x = x_prev
    return x


@torch.no_grad()
def ddim_invert_loop(
    model_fn: Callable,
    tables: DiffusionTables,
    x0: torch.Tensor,
    *,
    t_end: Optional[int] = None,
    y: Optional[torch.Tensor] = None,
    timestep_map=None,
) -> torch.Tensor:
    """Deterministic DDIM inversion x_0 -> x_{t_end} (default T): for
    t = 1..t_end, eps at t on the current state, then

        x0' = (x_{t-1} - sqrt(1 - ab_{t-1}) eps) / sqrt(ab_{t-1}),
        x_t = sqrt(ab_t) x0' + sqrt(1 - ab_t) eps,

    the eta = 0 DDIM step solved backwards.  No clipping.
    """
    T = t_end if t_end is not None else tables.diffusion_steps
    b, ndim = x0.shape[0], x0.ndim
    tmap = _host_map(timestep_map)
    x = x0
    for t_step in range(1, T + 1):
        t = _full(b, t_step, x)
        eps, _ = _model_eps(model_fn, x, t_step, y, tmap)
        abar = D.expand_to(tables.alphas_hat, t, ndim)
        abar_prev = D.expand_to(tables.alphas_hat_prev, t, ndim)
        x0_implied = (x - torch.sqrt(1.0 - abar_prev) * eps) / torch.sqrt(abar_prev)
        x = torch.sqrt(abar) * x0_implied + torch.sqrt(1.0 - abar) * eps
    return x
