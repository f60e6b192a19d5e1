"""DiffusionEngine: the facade over the model, the train state and the
endpoints, with its optimizer chain and learning-rate schedules.

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/engine.py`` for
every prediction type: eps / v / x0 with the ``simple`` or IDDPM ``hybrid``
loss (a learned-sigma head), min-SNR weighting, zero-terminal-SNR schedules
and class dropout, and the continuous-time ``edm``, ``flow`` and
``consistency`` (consistency training) models.  ``DiffusionEngine`` has
``training_step``, ``validation_step`` (EMA and live weights on the same
draws), ``get_noised_representation``, ``generate_images`` (ancestral,
DDIM, DPM-Solver++ or Heun over the full or respaced schedule, encoder
reuse, classifier-free guidance with its interval and rescale, and the
native EDM, flow and consistency samplers), ``inpaint``, ``ddim_invert``,
``get_feature_vectors``, the visualization endpoints (``sample_from_step``,
``sample_and_return_steps``, ``generate_images_grid``,
``diffuse_and_reconstruct``, ``diffuse_and_reconstruct_grid``),
``calculate_likelihood``, ``calculate_ode_likelihood`` (the flow and EDM
families' exact ODE likelihood) and ``test_step``; ``make_lr_schedule``; and
``AdamChain``, the optimizer chain the JAX engine builds from optax
(``adam`` with an optional ``clip_by_global_norm`` before it and an optional
``MultiSteps`` around both).  The model and the state live on one device,
``cuda`` unless the caller asks for another; random draws come from
``torch.Generator``s on it.  Training runs the raw model; the table-driven
samplers, the NLL and the endpoints run its eps view
(``sample.make_{v,x0,edm,flow}_to_eps_apply_fn``; a consistency model has
none), the native samplers and the ODE likelihood the raw model.  The
device mesh (``mesh``, ``param_sharding``, ``shard_mode``) raises
``NotImplementedError`` naming ROADMAP.md Queue 1 item 18.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch

from .core import diffusion as D
from .core.consistency import ConsistencyConfig
from .core.diffusion import DiffusionTables
from .core.edm import EDMConfig
from .core.flow import FlowConfig
from .core.schedules import NoiseSchedule, rescale_zero_terminal_snr
from .evals.nll import calculate_likelihood
from .evals.ode_nll import edm_ode_nll, flow_ode_nll
from .models import get_model, resolve_device
from .sample.sampler import (
    consistency_sample_loop,
    ddim_invert_loop,
    ddim_sample_loop,
    dpmpp_sample_loop,
    edm_sample_loop,
    flow_sample_loop,
    heun_sample_loop,
    inpaint_sample_loop,
    make_cfg_apply_fn,
    make_edm_to_eps_apply_fn,
    make_flow_to_eps_apply_fn,
    make_v_to_eps_apply_fn,
    make_x0_to_eps_apply_fn,
    p_sample_loop,
    respaced_schedule,
    space_timesteps,
)
from .train.consistency import make_ct_eval_step, make_ct_train_step
from .train.state import TrainState
from .train.step import (
    global_norm,
    make_edm_eval_step,
    make_edm_train_step,
    make_eval_step,
    make_flow_eval_step,
    make_flow_train_step,
    make_train_step,
)

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


def _no_eps_view(*args, **kwargs):
    raise ValueError("a consistency model predicts the PF-ODE endpoint, not the score: the eps "
                     "view (ancestral/DDIM/DPM++ sampling, NLL, inpainting, inversion) is "
                     "undefined. Sample with generate_images(consistency=True).")


class DiffusionEngine:
    """The JAX engine's constructor surface; see the module docstring for
    what runs.  ``device`` (None: ``cuda``, which raises without a card)
    holds the model, the EMA copy, the optimizer and the loss history.  The
    weights are drawn from ``seed`` on the host, as ``get_model`` draws them;
    the state's generator (the train step's draws and dropout) is a
    ``torch.Generator`` on the device seeded with ``seed + 1``.

    ``encoder_reuse`` and the ``reuse_*`` knobs are the defaults of
    ``generate_images``; ``edm_config``, ``flow_config`` and
    ``consistency_config`` override the fields of ``EDMConfig``,
    ``FlowConfig`` and ``ConsistencyConfig`` for those prediction types.
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
        # the constructor's own arguments, as JAX keeps them: a run config
        # rebuilt from them (cli.distill's student_run_config) rebuilds the
        # same engine, explicit betas included
        self.hparams = dict(
            model_config=dict(model_config), optimizer_config=dict(optimizer_config),
            diffusion_steps=diffusion_steps, beta_start=beta_start, beta_end=beta_end,
            mode=mode, max_beta=max_beta,
            betas=None if betas is None else [float(b) for b in betas],
            sigma_mode=sigma_mode, resolution=resolution,
            clip_while_generating=clip_while_generating, sampling=sampling, ema=ema,
            scheduler_name=scheduler_name, scheduler_kwargs=dict(scheduler_kwargs or {}),
            seed=seed, loss_type=loss_type, grad_clip=grad_clip,
            accumulate_grad_batches=accumulate_grad_batches,
            class_dropout_prob=class_dropout_prob, prediction_type=prediction_type,
            zero_terminal_snr=bool(zero_terminal_snr), loss_weighting=loss_weighting,
            snr_gamma=snr_gamma,
            edm_config=None if edm_config is None else dict(edm_config),
            flow_config=None if flow_config is None else dict(flow_config),
            consistency_config=None if consistency_config is None else dict(consistency_config),
            encoder_reuse=encoder_reuse, reuse_exact_head=reuse_exact_head,
            reuse_exact_tail=reuse_exact_tail, reuse_sigma_boost=reuse_sigma_boost,
            reuse_prior_noise=reuse_prior_noise, reuse_cache_middle=reuse_cache_middle,
            param_sharding=param_sharding)
        for name, value, off in (("mesh", mesh, (None,)),
                                 ("param_sharding", param_sharding, ("replicated",))):
            if value not in off:
                raise NotImplementedError(f"{name}={value!r} {_later(18)}")
        if prediction_type in ("edm", "flow", "consistency"):
            # the continuous-time objectives carry their own time density
            # and weighting, and have no learned-sigma head
            if loss_type == "hybrid":
                raise ValueError(f'prediction_type="{prediction_type}" has no learned-sigma '
                                 'head; use loss_type="simple"')
            if sampling == "importance":
                raise ValueError(f'prediction_type="{prediction_type}" draws its time/noise '
                                 "level continuously (that density is its importance "
                                 'choice); use sampling="uniform"')
            if loss_weighting != "none":
                raise ValueError(f'prediction_type="{prediction_type}" carries its own '
                                 'objective weighting; use loss_weighting="none"')
        self.encoder_reuse = int(encoder_reuse or 1)
        self.reuse_exact_head = int(reuse_exact_head or 0)
        self.reuse_exact_tail = int(reuse_exact_tail or 0)
        self.reuse_sigma_boost = float(reuse_sigma_boost or 0.0)
        self.reuse_prior_noise = float(reuse_prior_noise or 0.0)
        self.reuse_cache_middle = bool(reuse_cache_middle)

        self.device = resolve_device(device)
        self.diffusion_steps = diffusion_steps
        self.resolution = resolution
        self.sigma_mode = sigma_mode
        self.clip_while_generating = clip_while_generating
        self.prediction_type = prediction_type
        model_config = dict(model_config)
        if loss_type == "hybrid":
            model_config.setdefault("learn_sigma", True)
        self.model = get_model(resolution, model_config, device=self.device, seed=seed)
        self.in_channels = in_channels or int(model_config.get("in_channels", 3))
        self.cond_kind = "class" if self.model.num_classes else "none"

        self.schedule = NoiseSchedule.create(diffusion_steps=diffusion_steps, mode=mode,
                                             beta_start=beta_start, beta_end=beta_end,
                                             max_beta=max_beta, betas=betas)
        # arXiv:2305.08891: the eps target at t = T is pure input noise once
        # the terminal SNR is zero, so only v or x0 models may take it
        self.zero_terminal_snr = bool(zero_terminal_snr)
        if self.zero_terminal_snr:
            if prediction_type not in ("v", "x0"):
                raise ValueError("zero_terminal_snr requires prediction_type 'v' or 'x0' (got "
                                 f"{prediction_type!r}): the eps target at t=T is pure input "
                                 "noise")
            self.schedule = NoiseSchedule.create(
                diffusion_steps=diffusion_steps, mode=mode,
                betas=rescale_zero_terminal_snr(self.schedule.betas))
        self.tables = DiffusionTables.from_schedule(self.schedule, self.device)
        self.edm = EDMConfig(**(edm_config or {})) if prediction_type == "edm" else None
        self.flow = FlowConfig(**(flow_config or {})) if prediction_type == "flow" else None
        self.cm = (ConsistencyConfig(**(consistency_config or {})).validate()
                   if prediction_type == "consistency" else None)

        self.class_dropout_prob = float(class_dropout_prob or 0.0)
        if self.class_dropout_prob and not (self.cond_kind == "class"
                                            and self.model.cfg_null_class):
            raise ValueError("class_dropout_prob requires a class-conditional model with "
                             "model_config cfg_null_class=True (the reserved null embedding "
                             "row)")
        self.loss_weighting = loss_weighting
        self.snr_gamma = float(snr_gamma)

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
        common = dict(watch=watch, class_dropout_prob=self.class_dropout_prob,
                      null_class=self.model.num_classes if self.class_dropout_prob else None)
        if prediction_type == "edm":
            self._train_step = make_edm_train_step(self.tables, self.edm, **common)
            self._eval_step = make_edm_eval_step(self.edm)
        elif prediction_type == "flow":
            self._train_step = make_flow_train_step(self.tables, self.flow, **common)
            self._eval_step = make_flow_eval_step(self.flow)
        elif prediction_type == "consistency":
            self._train_step = make_ct_train_step(self.tables, self.cm, **common)
            self._eval_step = make_ct_eval_step(self.tables, self.cm)
        else:
            self._train_step = make_train_step(
                self.tables, sampling=sampling, loss_type=loss_type,
                prediction_type=prediction_type, loss_weighting=loss_weighting,
                snr_gamma=self.snr_gamma, **common)
            self._eval_step = make_eval_step(self.tables, prediction_type=prediction_type,
                                             loss_weighting=loss_weighting,
                                             snr_gamma=self.snr_gamma)
        self._val_counter = -1

    def _view(self, model: Callable) -> Callable:
        """The eps view of a raw model (full-schedule tables)."""
        if self.prediction_type == "v":
            return make_v_to_eps_apply_fn(model, self.tables)
        if self.prediction_type == "x0":
            return make_x0_to_eps_apply_fn(model, self.tables)
        if self.prediction_type == "edm":
            return make_edm_to_eps_apply_fn(model, self.tables, self.edm.sigma_data)
        if self.prediction_type == "flow":
            return make_flow_to_eps_apply_fn(model, self.tables)
        if self.prediction_type == "consistency":
            return _no_eps_view
        return model

    # ------------ weights and inputs

    def params(self, use_ema: bool = False) -> torch.nn.Module:
        """The module holding the EMA weights (``use_ema``, where the engine
        keeps an EMA) or the live ones; the port's parameters live in their
        module where JAX returns a parameter tree."""
        if use_ema and self.state.ema_model is not None:
            return self.state.ema_model
        return self.state.model

    def _inference(self, use_ema: bool) -> Callable:
        """The weights' module in eval mode, as an eps model: wrapped in the
        eps view of its prediction type (full-schedule tables)."""
        return self._view(self.params(use_ema).eval())

    def _batch(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _generator(self, seed: Optional[int]) -> torch.Generator:
        return torch.Generator(self.device).manual_seed(int(seed or 0))

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
        ``val_loss_no_ema``, both on the same draws (t or sigma, noise) from
        ``generator`` (default: one seeded from a host-side call counter)."""
        if generator is None:
            self._val_counter += 1
            generator = torch.Generator(self.device).manual_seed(self._val_counter)
        x, y = self._batch(x), self._cond(y)
        draws = self._eval_step.draw(generator, x)
        out = {"val_loss_no_ema": self._eval_step(self.state.model, generator, x, y, **draws)}
        if self.state.ema_model is not None:
            out["val_loss"] = self._eval_step(self.state.ema_model, generator, x, y, **draws)
        else:
            out["val_loss"] = out.pop("val_loss_no_ema")
        return out

    # ------------ forward process

    def get_noised_representation(self, x0, t: Optional[int] = None, seed: Optional[int] = None,
                                  generator: Optional[torch.Generator] = None,
                                  noise=None) -> torch.Tensor:
        """x0 noised to step t (default T) with ``noise`` (x0's shape), or
        noise drawn from ``generator`` (default: seeded with ``seed`` or 0)."""
        t = t if t is not None else self.diffusion_steps
        x0 = self._batch(x0)
        if noise is None:
            generator = generator if generator is not None else self._generator(seed)
            noise = torch.randn(x0.shape, generator=generator, device=self.device, dtype=x0.dtype)
        tb = torch.full((x0.shape[0],), int(t), dtype=torch.long, device=self.device)
        return D.q_sample(self.tables, x0, self._batch(noise), tb)

    # ------------ sampling

    def _sample_tables(self, num_sample_steps=None):
        """(tables, host timestep map or None, steps) for full or respaced
        sampling: an int N, "ddimN", "karrasN", "trailingN", or an IDDPM
        section list ("15,15,20" / [15, 15, 20]); see ``space_timesteps``."""
        if num_sample_steps is None or (isinstance(num_sample_steps, int)
                                        and num_sample_steps >= self.diffusion_steps):
            return self.tables, None, self.diffusion_steps
        kept = space_timesteps(self.diffusion_steps, num_sample_steps,
                               alphas_hat=self.schedule.alphas_hat)
        sched, tmap = respaced_schedule(self.schedule, kept)
        return DiffusionTables.from_schedule(sched, self.device), tmap, len(kept)

    def _validate_cfg(self, guidance_scale, guidance_interval, y):
        """Guidance needs a class-conditional model with its null row and
        labels; returns the interval as two ints (or None)."""
        if guidance_scale is not None:
            if self.cond_kind != "class" or not self.model.cfg_null_class:
                raise ValueError("guidance_scale requires a class-conditional model with "
                                 "cfg_null_class=True (train it with class_dropout_prob)")
            if y is None:
                raise ValueError("guidance_scale requires class labels y")
        if guidance_interval is not None:
            if guidance_scale is None:
                raise ValueError("guidance_interval needs guidance_scale")
            lo, hi = guidance_interval
            guidance_interval = (int(lo), int(hi))
        return guidance_interval

    def _guided(self, model_fn: Callable, guidance_scale, interval=None,
                rescale=None) -> Callable:
        """``model_fn`` under classifier-free guidance where a scale is set."""
        if guidance_scale is None:
            return model_fn
        return make_cfg_apply_fn(model_fn, float(guidance_scale), self.model.num_classes,
                                 interval=interval, guidance_rescale=float(rescale or 0.0),
                                 tables=self.tables)

    def generate_images(self, n: int = 1, minibatch: int = 4, mean_only: bool = False,
                        seed: Optional[int] = None, use_ema: bool = True,
                        num_sample_steps=None, ddim: bool = False, ddim_eta: float = 0.0,
                        dpm_solver: bool = False, dpm_order: int = 2, heun: bool = False,
                        heun_churn: float = 0.0, edm: bool = False, edm_churn: float = 0.0,
                        flow: bool = False, flow_shift: Optional[float] = None,
                        flow_heun: bool = False, consistency: bool = False,
                        shard_mode: str = "batch", y=None, guidance_scale=None,
                        guidance_interval=None, guidance_rescale=None, encoder_reuse=None,
                        x_T=None, reuse_exact_head=None, reuse_exact_tail=None,
                        reuse_sigma_boost=None, reuse_prior_noise=None,
                        reuse_cache_middle=None, noise=None) -> np.ndarray:
        """``n`` images in ``minibatch`` chunks, as a float32 numpy array
        [n, H, W, C]; x0 is clipped to [-1, 1] inside each step when the
        engine's ``clip_while_generating`` is set.

        The sampler: ancestral (default), ``ddim`` (``ddim_eta``),
        ``dpm_solver`` (``dpm_order`` 1 or 2) or ``heun`` (``heun_churn``),
        over the full schedule or ``num_sample_steps`` respaced; or the
        native loop of an ``edm`` (``edm_churn``), ``flow`` (``flow_shift``,
        ``flow_heun``) or ``consistency`` engine, whose ``num_sample_steps``
        is an int, the continuous grid's size (default 18, 25 and 1).
        ``encoder_reuse`` and the ``reuse_*`` knobs override the engine's
        (ancestral; DDIM takes ``encoder_reuse`` alone).
        ``guidance_scale`` (with ``guidance_interval`` and
        ``guidance_rescale``) guides a class-conditional model with labels
        ``y``; the interval does not compose with encoder reuse, the rescale
        applies to the table-driven samplers only.

        One generator seeded with ``seed`` (default 0) draws each chunk's
        x_T and then its steps' noise.  ``x_T`` ([>= n, ...]) replaces the
        drawn starting noise, ``noise`` ([draws, >= n, ...]: the loop's
        injected draws, chunked on axis 1) the steps' draws; ``y`` ([>= n])
        are class labels.  All three wrap around to pad the last chunk.
        """
        if shard_mode != "batch":
            raise NotImplementedError(f"shard_mode={shard_mode!r} {_later(18)}")
        native = bool(edm or flow or consistency)
        if sum((bool(ddim), bool(dpm_solver), bool(heun), bool(edm), bool(flow),
                bool(consistency))) > 1:
            raise ValueError("pass at most one of ddim / dpm_solver / heun / edm / flow / "
                             "consistency")
        if native:
            which = "edm" if edm else ("flow" if flow else "consistency")
            if self.prediction_type != which:
                raise ValueError(f'{which}=True needs an engine with prediction_type="{which}" '
                                 "(table-trained models should use heun=True, the "
                                 "VP-retrofitted solver)")
            if num_sample_steps is not None and not isinstance(num_sample_steps, int):
                raise ValueError(f"native {which} sampling takes an int num_sample_steps (the "
                                 'continuous-grid size); respacing specs like "karrasN" only '
                                 "apply to table-driven samplers")
            tables, tmap = self.tables, None
        else:
            tables, tmap, _ = self._sample_tables(num_sample_steps)
        guidance_interval = self._validate_cfg(guidance_scale, guidance_interval, y)
        if guidance_rescale is not None:
            if guidance_scale is None:
                raise ValueError("guidance_rescale needs guidance_scale")
            if native:
                raise ValueError("guidance_rescale is defined on the table eps-view and does "
                                 "not apply to the native EDM/flow/consistency samplers")
        reuse = int(encoder_reuse if encoder_reuse is not None else self.encoder_reuse)
        if guidance_interval is not None and reuse > 1:
            raise ValueError("guidance_interval does not compose with encoder_reuse (the "
                             "guided/plain branches carry different cache batch sizes)")

        def pick(call, own):
            return call if call is not None else own

        knobs = dict(reuse_exact_head=pick(reuse_exact_head, self.reuse_exact_head),
                     reuse_exact_tail=pick(reuse_exact_tail, self.reuse_exact_tail),
                     reuse_sigma_boost=pick(reuse_sigma_boost, self.reuse_sigma_boost),
                     reuse_prior_noise=pick(reuse_prior_noise, self.reuse_prior_noise))
        cache_middle = bool(pick(reuse_cache_middle, self.reuse_cache_middle))
        if native or dpm_solver or heun:
            which = ("EDM" if edm else "flow" if flow else "consistency" if consistency
                     else "DPM-Solver++" if dpm_solver else "Heun")
            if reuse > 1 or any(knobs.values()):
                raise ValueError("encoder_reuse / reuse calibration knobs are not supported on "
                                 f"the {which} path; clear them or use the ancestral/DDIM "
                                 "samplers")
            if native and guidance_interval is not None:
                raise ValueError("guidance_interval is defined in discrete timestep units and "
                                 f"does not apply to the native {which} sampler; use plain "
                                 "guidance_scale")
        elif ddim:
            active = sorted(k for k, v in dict(knobs, reuse_cache_middle=cache_middle).items()
                            if v)
            if active:
                raise ValueError(f"reuse calibration knobs {active} are not supported on the "
                                 "DDIM path; use the ancestral sampler or clear them")

        raw = self.params(use_ema).eval()
        model_fn = self._guided(raw if native else self._view(raw), guidance_scale,
                                guidance_interval, guidance_rescale)
        clip = self.clip_while_generating
        if consistency:
            c = self.cm
            loop, kw = consistency_sample_loop, dict(
                n_steps=int(num_sample_steps or 1), sigma_data=c.sigma_data,
                sigma_min=c.sigma_min, sigma_max=c.sigma_max, rho=c.rho, clip=clip)
        elif flow:
            loop, kw = flow_sample_loop, dict(
                n_steps=int(num_sample_steps or 25), heun=bool(flow_heun), clip=clip,
                shift=float(flow_shift if flow_shift is not None else self.flow.shift))
        elif edm:
            e = self.edm
            loop, kw = edm_sample_loop, dict(
                n_steps=int(num_sample_steps or 18), sigma_data=e.sigma_data,
                sigma_min=e.sigma_min, sigma_max=e.sigma_max, rho=e.rho, clip=clip,
                s_churn=float(edm_churn))
        elif dpm_solver:
            loop, kw = dpmpp_sample_loop, dict(clip=clip, order=int(dpm_order))
        elif heun:
            loop, kw = heun_sample_loop, dict(clip=clip, s_churn=float(heun_churn))
        elif ddim:
            loop, kw = ddim_sample_loop, dict(eta=float(ddim_eta), clip=clip,
                                              encoder_reuse=reuse)
        else:
            loop, kw = p_sample_loop, dict(sigma_mode=self.sigma_mode, clip=clip,
                                           mean_only=mean_only, encoder_reuse=reuse)
            if reuse > 1:
                kw.update(knobs, reuse_cache_middle=cache_middle)
        takes_noise = loop not in (dpmpp_sample_loop, flow_sample_loop)

        generator = self._generator(seed)
        y = self._cond(y)
        if y is not None and y.shape[0] < n:
            raise ValueError("need conditioning for every image")
        if x_T is not None:
            x_T = self._batch(x_T)
            if x_T.shape[0] < n:
                raise ValueError("need starting noise for every image")
        if noise is not None:
            if not takes_noise:
                raise ValueError(f"{loop.__name__} is deterministic: it takes no noise")
            noise = self._batch(noise)
        shape = (minibatch, self.resolution, self.resolution, self.in_channels)
        images = []
        for i in range(-(-n // minibatch)):
            idx = torch.arange(i * minibatch, (i + 1) * minibatch, device=self.device)
            if x_T is not None:
                x_t = x_T[idx % x_T.shape[0]]
            else:
                x_t = torch.randn(shape, generator=generator, device=self.device)
            if takes_noise:
                kw["noise"] = None if noise is None else noise[:, idx % noise.shape[1]]
            x = loop(model_fn, tables, x_t, generator, timestep_map=tmap,
                     y=None if y is None else y[idx % y.shape[0]], **kw)
            images.append(x.float().cpu().numpy())
        return np.concatenate(images, axis=0)[:n]

    def ddim_invert(self, x0, use_ema: bool = True, y=None, num_sample_steps=None,
                    t_end: Optional[int] = None) -> torch.Tensor:
        """The deterministic DDIM encoding x0 -> x_{t_end} (default: the
        whole chain; respaced units under ``num_sample_steps``), which the
        eta = 0 DDIM chain decodes back up to the ODE's discretization
        error."""
        tables, tmap, n_steps = self._sample_tables(num_sample_steps)
        if t_end is not None and not 1 <= int(t_end) <= n_steps:
            raise ValueError(f"t_end={t_end} outside the chain (1..{n_steps}"
                             + (" respaced units)" if tmap is not None else ")"))
        return ddim_invert_loop(self._inference(use_ema), tables, self._batch(x0),
                                t_end=None if t_end is None else int(t_end),
                                y=self._cond(y), timestep_map=tmap)

    def inpaint(self, x0, mask, seed: Optional[int] = None, use_ema: bool = True, y=None,
                num_sample_steps=None, resample_steps: int = 1, guidance_scale=None,
                guidance_interval=None, x_T=None, noise=None) -> torch.Tensor:
        """RePaint inpainting (``sample.inpaint_sample_loop``): the ``mask``
        == 0 region of ``x0`` filled, conditioned on the rest (``mask``
        broadcasts to x0, 1 = keep), over the full or respaced chain, each
        step harmonized ``resample_steps`` times, under guidance where
        asked (labels ``y``).  One generator seeded with ``seed`` (default 0)
        draws x_T and then the chain's draws; ``x_T`` (x0's shape) and
        ``noise`` (the loop's layout) may be injected."""
        x0, mask = self._batch(x0), self._batch(mask)
        generator = self._generator(seed)
        tables, tmap, _ = self._sample_tables(num_sample_steps)
        x_t = (self._batch(x_T) if x_T is not None
               else torch.randn(x0.shape, generator=generator, device=self.device))
        interval = self._validate_cfg(guidance_scale, guidance_interval, y)
        model_fn = self._guided(self._inference(use_ema), guidance_scale, interval)
        return inpaint_sample_loop(
            model_fn, tables, x_t, generator, x0_known=x0, mask=mask,
            sigma_mode=self.sigma_mode, clip=self.clip_while_generating, y=self._cond(y),
            timestep_map=tmap, resample_steps=int(resample_steps),
            noise=None if noise is None else self._batch(noise))

    def get_feature_vectors(self, x, t, y=None, use_ema: bool = False) -> Dict[str, Any]:
        """The model's activations, ``{"down": [...], "middle": ..., "up":
        [...]}``, at timestep ``t`` (an int, or one per sample), through the
        eps view's input transform."""
        x = self._batch(x)
        if isinstance(t, torch.Tensor):
            t = t.cpu().numpy()
        t_host = np.full(x.shape[0], t) if np.isscalar(t) else np.asarray(t)
        if self.prediction_type in ("edm", "flow") and (
                t_host.min() < 1 or t_host.max() > self.diffusion_steps):
            # the EDM and flow views gather the schedule's tables at t - 1
            raise ValueError(f"t must be in [1, {self.diffusion_steps}] for an "
                             f"{self.prediction_type} engine's feature extraction, got "
                             f"[{t_host.min()}, {t_host.max()}]")
        tb = torch.as_tensor(t_host, device=self.device).long()
        with torch.no_grad():
            return self._view(self.params(use_ema).eval())(x, tb, self._cond(y),
                                                            return_features=True)

    # ------------ the visualization endpoints (full schedule, eps view)

    def _chain(self, x_t: torch.Tensor, t_start: int, generator: torch.Generator,
               use_ema: bool, noise=None, **kw):
        """The ancestral chain of the eps view from ``t_start`` down to 1,
        x0 clipped as ``clip_while_generating`` says; z from ``noise``
        ([t_start, *x_t.shape], z for t_start first) or ``generator``."""
        return p_sample_loop(self._inference(use_ema), self.tables, x_t, generator,
                             t_start=int(t_start), sigma_mode=self.sigma_mode,
                             clip=self.clip_while_generating,
                             noise=None if noise is None else self._batch(noise), **kw)

    def sample_from_step(self, x_t, t_start: int, mean_only: bool = False,
                         seed: Optional[int] = None, use_ema: bool = True,
                         noise=None) -> torch.Tensor:
        """x_0 from ``x_t`` at step ``t_start``; z from a generator seeded
        with ``seed`` (default 0), or the injected ``noise`` stack."""
        return self._chain(self._batch(x_t), t_start, self._generator(seed), use_ema,
                           noise=noise, mean_only=mean_only)

    def sample_and_return_steps(self, x_t, t_start: Optional[int] = None,
                                steps_to_return: Sequence[int] = (1,),
                                mean_only: bool = False, seed: Optional[int] = None,
                                return_stds: bool = False, use_ema: bool = True, noise=None):
        """The chain from ``x_t`` at ``t_start`` (default T): the x_{t-1}
        recorded after each t of ``steps_to_return``, [B, STEPS, H, W, C]
        in descending t, and with ``return_stds`` (steps, stds), the std of
        x before the loop and after every step [t_start + 1]."""
        return self._steps(self._batch(x_t), t_start, steps_to_return, mean_only,
                           self._generator(seed), return_stds, use_ema, noise)

    def _steps(self, x_t, t_start, steps_to_return, mean_only, generator, return_stds,
               use_ema, noise):
        t_start = t_start if t_start is not None else self.diffusion_steps
        out = self._chain(x_t, t_start, generator, use_ema, noise=noise, mean_only=mean_only,
                          steps_to_return=tuple(steps_to_return), return_stds=return_stds)
        return out[1:] if return_stds else out[1]

    def generate_images_grid(self, steps_to_return: Sequence[int], n: int = 1,
                             minibatch: int = 4, mean_only: bool = False,
                             seed: Optional[int] = None, use_ema: bool = True, x_T=None,
                             noise=None):
        """(starting noise [n, H, W, C], steps [n, STEPS, H, W, C]) as numpy,
        from T, in ``minibatch`` chunks.  One generator seeded with ``seed``
        (default 0) draws each chunk's x_T and then its steps' z.  ``x_T``
        ([n, ...]) and ``noise`` ([T, n, ...]) may be injected; both wrap
        around to pad the last chunk."""
        generator = self._generator(seed)
        minibatch = min(int(minibatch), int(n))
        shape = (minibatch, self.resolution, self.resolution, self.in_channels)
        starts, images = [], []
        for i in range(-(-int(n) // minibatch)):
            idx = torch.arange(i * minibatch, (i + 1) * minibatch) % int(n)
            if x_T is not None:
                x_t = self._batch(x_T)[idx.to(self.device)]
            else:
                x_t = torch.randn(shape, generator=generator, device=self.device)
            chunk_noise = None if noise is None else self._batch(noise)[:, idx.to(self.device)]
            steps = self._steps(x_t, self.diffusion_steps, steps_to_return, mean_only,
                                generator, False, use_ema, chunk_noise)
            starts.append(x_t.cpu().numpy())
            images.append(steps.float().cpu().numpy())
        return np.concatenate(starts)[:n], np.concatenate(images)[:n]

    def diffuse_and_reconstruct(self, x0, t: Optional[int] = None, seed: Optional[int] = None,
                                use_ema: bool = True, q_noise=None, noise=None):
        """x0 noised to t (default T) and reconstructed by the sampled chain
        from t: (reconstruction, x_t).  One generator seeded with ``seed``
        (default 0) draws the forward noise and then the chain's z;
        ``q_noise`` (x0's shape) and ``noise`` ([t, *x0.shape]) may be
        injected.  As in JAX, there is no mean-only variant."""
        t = t if t is not None else self.diffusion_steps
        generator = self._generator(seed)
        x_t = self.get_noised_representation(x0, t, generator=generator, noise=q_noise)
        return self._chain(x_t, t, generator, use_ema, noise=noise), x_t

    def diffuse_and_reconstruct_grid(self, x0, t_start: Optional[int] = None,
                                     steps_to_return: Sequence[int] = (1,),
                                     seed: Optional[int] = None, mean_only: bool = False,
                                     return_stds: bool = False, use_ema: bool = True,
                                     q_noise=None, noise=None):
        """``diffuse_and_reconstruct`` recording steps as
        ``sample_and_return_steps`` does: (steps, x_t), or with
        ``return_stds`` ((steps, stds), x_t)."""
        t_start = t_start if t_start is not None else self.diffusion_steps
        generator = self._generator(seed)
        x_t = self.get_noised_representation(x0, t_start, generator=generator, noise=q_noise)
        return self._steps(x_t, t_start, steps_to_return, mean_only, generator, return_stds,
                           use_ema, noise), x_t

    # ------------ evaluation

    def calculate_likelihood(self, x, seed: int = 0, use_ema: bool = True, y=None,
                             noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """``evals.nll.calculate_likelihood`` of batch ``x`` with a generator
        on the device seeded with ``seed`` (or the given ``noise`` stack)."""
        generator = self._generator(seed)
        return calculate_likelihood(self._inference(use_ema), self.tables, self._batch(x),
                                    generator, sigma_mode=self.sigma_mode, y=self._cond(y),
                                    noise=noise)

    def calculate_ode_likelihood(self, x, seed: int = 0, use_ema: bool = True, y=None,
                                 n_steps: int = 100, n_probes: int = 1,
                                 probes: Optional[torch.Tensor] = None
                                 ) -> Dict[str, torch.Tensor]:
        """The exact continuous-time likelihood of batch ``x`` through the
        model's probability-flow ODE (``evals.ode_nll``): for
        ``prediction_type="flow"`` the velocity ODE over t in [0, 1], for
        ``"edm"`` the sigma-space ODE over the Karras grid (the
        sigma_min-smoothed density); Heun over ``n_steps``, ``n_probes``
        Rademacher probes drawn from a generator seeded with ``seed`` (or the
        given ``probes``).  Table-trained engines report the discrete bound,
        ``calculate_likelihood``.  Returns per-sample ``log_likelihood``,
        ``nll_bits_per_dim``, ``prior_logp`` and ``delta_logp``, on the
        device.  The weights are held out of autograd for the call: the
        trace needs the gradient in x alone."""
        if self.prediction_type not in ("flow", "edm"):
            raise ValueError('calculate_ode_likelihood integrates a continuous probability-flow '
                             'ODE and needs prediction_type="flow" or "edm"; use '
                             "calculate_likelihood (discrete VLB) instead")
        model = self.params(use_ema).eval()
        kw = dict(n_steps=int(n_steps), n_probes=int(n_probes), y=self._cond(y), probes=probes)
        if self.prediction_type == "edm":
            e = self.edm
            kw.update(sigma_data=e.sigma_data, sigma_min=e.sigma_min, sigma_max=e.sigma_max,
                      rho=e.rho)
        nll = edm_ode_nll if self.prediction_type == "edm" else flow_ode_nll
        wanted = [p.requires_grad for p in model.parameters()]
        model.requires_grad_(False)
        try:
            return nll(model, self._batch(x), self._generator(seed), **kw)
        finally:
            for p, w in zip(model.parameters(), wanted):
                p.requires_grad_(w)

    def test_step(self, x, seed: int = 0, use_ema: bool = True, y=None) -> Dict[str, float]:
        nll = self.calculate_likelihood(x, seed=seed, use_ema=use_ema, y=y)
        names = {"test_L_0": "L_0", "test_L_intermediate": "L_intermediate",
                 "test_L_T": "L_T", "test_nll": "nll", "test_mse": "MSE"}
        # one read of the device for the five means
        values = torch.stack([nll[k].mean() for k in names.values()]).tolist()
        return dict(zip(names, values))
