"""DiffusionEngine: the facade over the model, the train state and the
endpoints, with its optimizer chain and learning-rate schedules.

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/engine.py`` on
the eps-prediction, ``loss_type="simple"`` path: ``DiffusionEngine`` with
``training_step``, ``validation_step`` (EMA and live weights on the same t
and noise), ``get_noised_representation``, ``generate_images`` (the
ancestral sampler, full or respaced), ``calculate_likelihood`` and
``test_step``; ``make_lr_schedule``; and ``AdamChain``, the optimizer chain
the JAX engine builds from optax (``adam`` with an optional
``clip_by_global_norm`` before it and an optional ``MultiSteps`` around
both).  The model and the state live on one device, ``cuda`` unless the
caller asks for another; random draws come from ``torch.Generator``s on it.
Every option the port does not run yet raises ``NotImplementedError`` naming
its ROADMAP.md Queue 1 item.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

import numpy as np
import torch

from .core import diffusion as D
from .core.diffusion import DiffusionTables
from .core.schedules import NoiseSchedule
from .evals.nll import calculate_likelihood
from .models import get_model, resolve_device
from .sample.sampler import p_sample_loop, respaced_schedule, space_timesteps
from .train.samplers import sample_uniform
from .train.state import TrainState
from .train.step import global_norm, make_eval_step, make_train_step

__all__ = ["DiffusionEngine", "make_lr_schedule", "AdamChain", "clip_by_global_norm"]

Schedule = Union[float, Callable[[int], float]]


def make_lr_schedule(scheduler_name: Optional[str], scheduler_kwargs: Optional[dict],
                     base_lr: float, steps_per_epoch: Optional[int] = None) -> Schedule:
    """``base_lr`` with no scheduler, else a function of the optimizer step
    (0 for the first update) to the learning rate.

    As in JAX, ``steps_per_epoch`` makes the schedule a staircase over
    optimizer steps that moves once per epoch (the reference steps its
    torch scheduler per epoch); without it the periods count optimizer steps.
    """
    if not scheduler_name:
        return base_lr
    kw = scheduler_kwargs or {}
    spe = max(1, int(steps_per_epoch)) if steps_per_epoch else 1
    if scheduler_name == "CosineAnnealingWarmRestarts":
        t0 = int(kw.get("T_0", 1000))
        t_mult = int(kw.get("T_mult", 1))
        eta_min = float(kw.get("eta_min", 0.0))

        def sched(step: int) -> float:
            epoch = step // spe
            if t_mult == 1:
                t_cur, t_i = float(epoch % t0), float(t0)
            else:
                # cycle n = floor(log_m(e (m-1)/T_0 + 1)); the 1e-5 nudge keeps
                # restart epochs (exact powers) on the new cycle
                n = math.floor(math.log(epoch * (t_mult - 1) / t0 + 1.0) / math.log(t_mult)
                               + 1e-5)
                t_cur = epoch - t0 * (t_mult ** n - 1.0) / (t_mult - 1)
                t_i = t0 * t_mult ** n
            pos = t_cur / t_i
            return eta_min + (base_lr - eta_min) * 0.5 * (1 + math.cos(math.pi * pos))

        return sched
    if scheduler_name == "CosineAnnealing":
        # optax.cosine_decay_schedule(base_lr, T_max, alpha=eta_min)
        t_max = int(kw.get("T_max", 10000)) * spe
        alpha = float(kw.get("eta_min", 0.0))

        def sched(step: int) -> float:
            cosine = 0.5 * (1 + math.cos(math.pi * min(step, t_max) / t_max))
            return base_lr * ((1 - alpha) * cosine + alpha)

        return sched
    if scheduler_name == "StepLR":
        step_size = int(kw.get("step_size", 30))
        gamma = float(kw.get("gamma", 0.1))
        return lambda step: base_lr * gamma ** ((step // spe) // step_size)
    if scheduler_name == "ExponentialLR":
        gamma = float(kw.get("gamma", 0.95))
        return lambda step: base_lr * gamma ** (step // spe)
    if scheduler_name == "MultiStepLR":
        milestones = sorted(int(m) for m in kw.get("milestones", []))
        gamma = float(kw.get("gamma", 0.1))
        return lambda step: base_lr * gamma ** sum(m <= step // spe for m in milestones)
    raise ValueError(f"Unknown scheduler: {scheduler_name}")


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """optax's form: unchanged when the global norm is below ``max_norm``,
    else ``(g / norm) * max_norm``; no ``+1e-6`` as in
    ``torch.nn.utils.clip_grad_norm_``.  Decided on the device (no sync)."""
    norm = global_norm(grads)
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm) for g in grads]


class AdamChain:
    """``MultiSteps(chain(clip_by_global_norm(grad_clip), adam(lr)), k)``.

    ``step()`` consumes each parameter's ``.grad`` (a missing one counts as
    zeros, so every parameter's Adam count moves in step, as optax's single
    count does).  With ``accumulate_grad_batches`` k > 1 the gradients are
    averaged over k calls (optax's running mean ``acc + (g - acc) / (i + 1)``)
    and every k-th call makes one update.  Adam is ``torch.optim.Adam``,
    whose update is optax's: bias-corrected moments, eps outside the sqrt.
    The learning rate of the n-th update (0-based) is ``lr(n)``, as optax
    evaluates a schedule at its own update count.
    """

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: Schedule, *,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 grad_clip: Optional[float] = None, accumulate_grad_batches: int = 1):
        self.params = list(params)
        self.lr = lr if callable(lr) else (lambda step: lr)
        self.grad_clip = grad_clip
        self.k = int(accumulate_grad_batches)
        self.adam = torch.optim.Adam(self.params, lr=float(self.lr(0)), betas=(b1, b2),
                                     eps=eps)
        self.updates = 0
        self.mini_step = 0
        self.acc = [torch.zeros_like(p) for p in self.params] if self.k > 1 else None

    @torch.no_grad()
    def step(self) -> None:
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        if self.acc is not None:
            for acc, g in zip(self.acc, grads):
                acc.add_((g - acc) / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.k:
                return
            grads, self.mini_step = self.acc, 0
            self.acc = [torch.zeros_like(p) for p in self.params]
        if self.grad_clip:
            grads = clip_by_global_norm(grads, self.grad_clip)
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.adam.param_groups:
            group["lr"] = float(self.lr(self.updates))
        self.adam.step()
        self.updates += 1

    def state_dict(self) -> dict:
        """Adam's moments and counts, the update count that places the lr
        schedule, and the accumulation buffer with its position."""
        return {"adam": self.adam.state_dict(), "updates": self.updates,
                "mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, state: dict) -> None:
        adam = state["adam"]
        for s in adam["state"].values():
            # torch keeps Adam's count on the host (no sync in the update)
            if "step" in s:
                s["step"] = s["step"].cpu()
        self.adam.load_state_dict(adam)
        self.updates, self.mini_step = int(state["updates"]), int(state["mini_step"])
        if state["acc"] is not None:
            self.acc = [a.to(p.device) for a, p in zip(state["acc"], self.params)]


def _later(item: int) -> str:
    return f"is not ported yet (ROADMAP.md Queue 1 item {item})"


# generate_images arguments of the JAX engine that the port does not run yet:
# the values that leave each one off, and the Queue 1 item that ports it
_SAMPLING_LATER = {
    "ddim": ((False,), 10), "ddim_eta": ((0.0,), 10), "dpm_solver": ((False,), 10),
    "dpm_order": ((2,), 10), "heun": ((False,), 10), "heun_churn": ((0.0,), 10),
    "guidance_scale": ((None,), 10), "guidance_interval": ((None,), 10),
    "guidance_rescale": ((None,), 10), "encoder_reuse": ((None, 1), 10),
    "reuse_exact_head": ((None, 0), 10), "reuse_exact_tail": ((None, 0), 10),
    "reuse_sigma_boost": ((None, 0.0), 10), "reuse_prior_noise": ((None, 0.0), 10),
    "reuse_cache_middle": ((None, False), 10),
    "edm": ((False,), 12), "edm_churn": ((0.0,), 12), "flow": ((False,), 12),
    "flow_shift": ((None,), 12), "flow_heun": ((False,), 12), "consistency": ((False,), 12),
    "shard_mode": (("batch",), 18),
}


class DiffusionEngine:
    """The JAX engine's constructor surface; see the module docstring for
    what runs.  ``device`` (None: ``cuda``, which raises without a card)
    holds the model, the EMA copy, the optimizer and the loss history.  The
    weights are drawn from ``seed`` on the host, as ``get_model`` draws them;
    the state's generator (t, noise and dropout of the train step) is a
    ``torch.Generator`` on the device seeded with ``seed + 1``.
    """

    def __init__(
        self,
        model_config: Dict[str, Any],
        optimizer_config: Dict[str, Any],
        diffusion_steps: int = 1000,
        beta_start: Optional[float] = None,
        beta_end: Optional[float] = None,
        mode: str = "linear",
        max_beta: float = 0.999,
        betas: Optional[Any] = None,
        sigma_mode: str = "beta",
        resolution: int = 32,
        clip_while_generating: bool = False,
        sampling: str = "uniform",
        ema: Optional[float] = None,
        scheduler_name: Optional[str] = None,
        scheduler_kwargs: Optional[dict] = None,
        seed: int = 0,
        loss_type: str = "simple",
        grad_clip: Optional[float] = None,
        accumulate_grad_batches: int = 1,
        mesh: Optional[Any] = None,
        param_sharding: str = "replicated",
        fsdp_min_size: int = 65536,
        in_channels: Optional[int] = None,
        steps_per_epoch: Optional[int] = None,
        watch: bool = False,
        class_dropout_prob: float = 0.0,
        prediction_type: str = "epsilon",
        zero_terminal_snr: bool = False,
        loss_weighting: str = "none",
        snr_gamma: float = 5.0,
        edm_config: Optional[Dict[str, Any]] = None,
        flow_config: Optional[Dict[str, Any]] = None,
        consistency_config: Optional[Dict[str, Any]] = None,
        encoder_reuse: int = 1,
        reuse_exact_head: int = 0,
        reuse_exact_tail: int = 0,
        reuse_sigma_boost: float = 0.0,
        reuse_prior_noise: float = 0.0,
        reuse_cache_middle: bool = False,
        device=None,
    ):
        if prediction_type not in ("epsilon", "v", "x0", "edm", "flow", "consistency"):
            raise ValueError(f'Unknown prediction_type: "{prediction_type}"')
        unported = (
            ("mesh", mesh, (None,), 18),
            ("param_sharding", param_sharding, ("replicated",), 18),
            ("prediction_type", prediction_type, ("epsilon", "edm", "flow", "consistency"), 11),
            ("prediction_type", prediction_type, ("epsilon",), 12),
            ("loss_type", loss_type, ("simple",), 11),
            ("zero_terminal_snr", zero_terminal_snr, (False,), 11),
            ("loss_weighting", loss_weighting, ("none",), 11),
            ("class_dropout_prob", class_dropout_prob, (None, 0), 11),
            ("edm_config", edm_config, (None,), 12),
            ("flow_config", flow_config, (None,), 12),
            ("consistency_config", consistency_config, (None,), 12),
            ("encoder_reuse", encoder_reuse, (None, 1), 10),
            ("reuse_exact_head", reuse_exact_head, (None, 0), 10),
            ("reuse_exact_tail", reuse_exact_tail, (None, 0), 10),
            ("reuse_sigma_boost", reuse_sigma_boost, (None, 0), 10),
            ("reuse_prior_noise", reuse_prior_noise, (None, 0), 10),
            ("reuse_cache_middle", reuse_cache_middle, (None, False), 10),
        )
        for name, value, off, item in unported:
            if value not in off:
                raise NotImplementedError(f"{name}={value!r} {_later(item)}")

        self.device = resolve_device(device)
        self.diffusion_steps = diffusion_steps
        self.resolution = resolution
        self.sigma_mode = sigma_mode
        self.clip_while_generating = clip_while_generating
        self.prediction_type = prediction_type
        self.model = get_model(resolution, dict(model_config), device=self.device, seed=seed)
        self.in_channels = in_channels or int(model_config.get("in_channels", 3))
        self.cond_kind = "class" if self.model.num_classes else "none"

        self.schedule = NoiseSchedule.create(diffusion_steps=diffusion_steps, mode=mode,
                                             beta_start=beta_start, beta_end=beta_end,
                                             max_beta=max_beta, betas=betas)
        self.tables = DiffusionTables.from_schedule(self.schedule, self.device)

        # YAML 1.1 reads "2e-4" (no dot) as a string: float() as in JAX
        lr = make_lr_schedule(scheduler_name, scheduler_kwargs,
                              float(optimizer_config.get("lr", 1e-4)),
                              steps_per_epoch=steps_per_epoch)
        opt_kwargs = {k: v for k, v in optimizer_config.items() if k != "lr"}
        optimizer = AdamChain(self.model.parameters(), lr, grad_clip=grad_clip,
                              accumulate_grad_batches=accumulate_grad_batches, **opt_kwargs)
        generator = torch.Generator(self.device).manual_seed(seed + 1)
        self.state = TrainState(self.model, optimizer, diffusion_steps, generator,
                                ema_decay=ema)
        self._train_step = make_train_step(self.tables, sampling=sampling, loss_type=loss_type,
                                           watch=watch)
        self._eval_step = make_eval_step(self.tables)
        self._val_counter = -1

    # ------------ weights and inputs

    def params(self, use_ema: bool = False) -> torch.nn.Module:
        """The module holding the EMA weights (``use_ema``, where the engine
        keeps an EMA) or the live ones; the port's parameters live in their
        module where JAX returns a parameter tree."""
        if use_ema and self.state.ema_model is not None:
            return self.state.ema_model
        return self.state.model

    def _inference(self, use_ema: bool) -> torch.nn.Module:
        return self.params(use_ema).eval()

    def _batch(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _cond(self, y) -> Optional[torch.Tensor]:
        """Dataset labels for the model's conditioning slot: dropped for an
        unconditional model, class labels for a class-conditional one."""
        if y is None or self.cond_kind == "none":
            return None
        return torch.as_tensor(y, device=self.device).long()

    # ------------ training

    def training_step(self, x, y=None) -> Dict[str, torch.Tensor]:
        """One optimizer step on batch ``x``; the metrics stay on the device."""
        return self._train_step(self.state, self._batch(x), self._cond(y))

    def validation_step(self, x, generator: Optional[torch.Generator] = None,
                        y=None) -> Dict[str, torch.Tensor]:
        """``val_loss`` (the EMA weights' where there is an EMA) and
        ``val_loss_no_ema``, both on the same t and noise from ``generator``
        (default: one seeded from a host-side call counter)."""
        if generator is None:
            self._val_counter += 1
            generator = torch.Generator(self.device).manual_seed(self._val_counter)
        x, y = self._batch(x), self._cond(y)
        t, _ = sample_uniform(generator, x.shape[0], self.diffusion_steps)
        noise = torch.randn(x.shape, generator=generator, device=self.device, dtype=x.dtype)
        out = {"val_loss_no_ema": self._eval_step(self.state.model, generator, x, y, t=t,
                                                  noise=noise)}
        if self.state.ema_model is not None:
            out["val_loss"] = self._eval_step(self.state.ema_model, generator, x, y, t=t,
                                              noise=noise)
        else:
            out["val_loss"] = out.pop("val_loss_no_ema")
        return out

    # ------------ forward process

    def get_noised_representation(self, x0, t: Optional[int] = None, seed: Optional[int] = None,
                                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x0 noised to step t (default T) with noise from ``generator``
        (default: seeded with ``seed`` or 0)."""
        t = t if t is not None else self.diffusion_steps
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(seed or 0)
        x0 = self._batch(x0)
        noise = torch.randn(x0.shape, generator=generator, device=self.device, dtype=x0.dtype)
        tb = torch.full((x0.shape[0],), int(t), dtype=torch.long, device=self.device)
        return D.q_sample(self.tables, x0, noise, tb)

    # ------------ sampling

    def _sample_tables(self, num_sample_steps=None):
        """(tables, timestep map or None, steps) for full or respaced
        sampling: an int N, "ddimN", "karrasN", "trailingN", or an IDDPM
        section list ("15,15,20" / [15, 15, 20]); see ``space_timesteps``."""
        if num_sample_steps is None or (isinstance(num_sample_steps, int)
                                        and num_sample_steps >= self.diffusion_steps):
            return self.tables, None, self.diffusion_steps
        kept = space_timesteps(self.diffusion_steps, num_sample_steps,
                               alphas_hat=self.schedule.alphas_hat)
        sched, tmap = respaced_schedule(self.schedule, kept)
        return (DiffusionTables.from_schedule(sched, self.device),
                torch.as_tensor(tmap, device=self.device).long(), len(kept))

    def generate_images(self, n: int = 1, minibatch: int = 4, mean_only: bool = False,
                        seed: Optional[int] = None, use_ema: bool = True,
                        num_sample_steps=None, y=None, x_T=None, **unported) -> np.ndarray:
        """``n`` images from the ancestral sampler in ``minibatch`` chunks,
        as a float32 numpy array [n, H, W, C]; x0 is clipped to [-1, 1] inside
        each step when the engine's ``clip_while_generating`` is set.

        One generator seeded with ``seed`` (default 0) draws each chunk's
        x_T and then its steps' noise.  ``x_T`` ([>= n, ...]) replaces the
        drawn starting noise; ``y`` ([>= n]) are class labels.  Both wrap
        around to pad the last chunk.  The JAX engine's other sampler
        arguments raise ``NotImplementedError`` unless left off.
        """
        for name, value in unported.items():
            if name not in _SAMPLING_LATER:
                raise TypeError(f"generate_images() got an unexpected argument {name!r}")
            off, item = _SAMPLING_LATER[name]
            if value not in off:
                raise NotImplementedError(f"{name}={value!r} {_later(item)}")
        tables, tmap, _ = self._sample_tables(num_sample_steps)
        model = self._inference(use_ema)
        generator = torch.Generator(self.device).manual_seed(seed if seed is not None else 0)
        y = self._cond(y)
        if y is not None and y.shape[0] < n:
            raise ValueError("need conditioning for every image")
        if x_T is not None:
            x_T = self._batch(x_T)
            if x_T.shape[0] < n:
                raise ValueError("need starting noise for every image")
        shape = (minibatch, self.resolution, self.resolution, self.in_channels)
        images = []
        for i in range(-(-n // minibatch)):
            idx = torch.arange(i * minibatch, (i + 1) * minibatch, device=self.device)
            if x_T is not None:
                x_t = x_T[idx % x_T.shape[0]]
            else:
                x_t = torch.randn(shape, generator=generator, device=self.device)
            x = p_sample_loop(model, tables, x_t, generator, sigma_mode=self.sigma_mode,
                              clip=self.clip_while_generating, mean_only=mean_only,
                              y=None if y is None else y[idx % y.shape[0]], timestep_map=tmap)
            images.append(x.float().cpu().numpy())
        return np.concatenate(images, axis=0)[:n]

    # ------------ evaluation

    def calculate_likelihood(self, x, seed: int = 0, use_ema: bool = True, y=None,
                             noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """``evals.nll.calculate_likelihood`` of batch ``x`` with a generator
        on the device seeded with ``seed`` (or the given ``noise`` stack)."""
        generator = torch.Generator(self.device).manual_seed(int(seed))
        return calculate_likelihood(self._inference(use_ema), self.tables, self._batch(x),
                                    generator, sigma_mode=self.sigma_mode, y=self._cond(y),
                                    noise=noise)

    def test_step(self, x, seed: int = 0, use_ema: bool = True, y=None) -> Dict[str, float]:
        nll = self.calculate_likelihood(x, seed=seed, use_ema=use_ema, y=y)
        names = {"test_L_0": "L_0", "test_L_intermediate": "L_intermediate",
                 "test_L_T": "L_T", "test_nll": "nll", "test_mse": "MSE"}
        # one read of the device for the five means
        values = torch.stack([nll[k].mean() for k in names.values()]).tolist()
        return dict(zip(names, values))
