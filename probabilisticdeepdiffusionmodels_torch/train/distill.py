"""Progressive distillation (Salimans & Ho, arXiv:2202.00512 section 3):
halve a sampling chain by training a student to match TWO teacher DDIM
(eta = 0) steps with ONE of its own.

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/train/distill.py``.
The student is a self-contained engine over the RESPACED schedule (its beta
table realises the teacher's alpha-bar at every other step) and is
conditioned on its own timestep units 1..T/2, so every endpoint (samplers,
NLL, guidance, checkpoints) works on it unchanged.  It trains in
v-parameterization, warm-started from the teacher's (EMA) weights.

One step: t_s ~ U{1..T/2} and then the noise from the state's generator (or
injected), z = q(x_{t_s} | x0), two teacher DDIM steps from t_hi = 2 t_s,
the x0* that makes one student DDIM step from z land on the teacher's
endpoint (clipped to [-1, 1] with ``clip_target``), its v*, and the v-space
MSE of the student, which runs without dropout as JAX's distillation step
applies it.  The teacher runs under ``no_grad``, on the kernels like every
forward; a learned-sigma teacher's output is cut to its mean head.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import torch

from ..core import diffusion as D
from ..core.diffusion import DiffusionTables
from .samplers import sample_uniform
from .state import TrainState
from .step import _backward_and_apply

__all__ = ["halved_student", "make_distill_step", "teacher_eps_fn", "distill_round"]


def halved_student(teacher, lr: Optional[float] = None, ema: float = 0.995,
                   use_ema_teacher: bool = True):
    """The student engine of one halving round: the teacher's model config,
    optimizer (``lr`` overrides the rate) and device, T/2 steps over the
    respaced betas (alpha-bar equal to the teacher's at its even steps),
    ``prediction_type="v"``, its live and EMA weights copied from the
    teacher's (EMA ones with ``use_ema_teacher``).  An odd T and a
    learned-sigma (hybrid) teacher raise."""
    from ..engine import DiffusionEngine
    from ..sample.sampler import respaced_schedule

    T = teacher.diffusion_steps
    if T % 2 or T < 2:
        raise ValueError(f"cannot halve T={T}")
    hp = dict(teacher.hparams)
    if dict(hp["model_config"]).get("learn_sigma") or hp.get("loss_type") == "hybrid":
        raise NotImplementedError(
            "distilling a learned-sigma (hybrid) teacher is not defined here: the student "
            "regresses a v-space mean target only, and warm-starting its C-channel head from "
            "a 2C-channel teacher conv is shape-incompatible.  Distill an eps/v/x0 teacher.")
    sub_sched, _ = respaced_schedule(teacher.schedule, range(2, T + 1, 2))
    oc = dict(hp["optimizer_config"])
    if lr is not None:
        oc["lr"] = float(lr)
    student = DiffusionEngine(
        model_config=dict(hp["model_config"]), optimizer_config=oc, diffusion_steps=T // 2,
        mode=f"respaced[{teacher.schedule.mode}]x0.5", betas=sub_sched.betas,
        sigma_mode=hp.get("sigma_mode", "beta"), resolution=hp.get("resolution", 32),
        clip_while_generating=hp.get("clip_while_generating", False), ema=ema,
        seed=hp.get("seed", 0), prediction_type="v", in_channels=teacher.in_channels,
        device=teacher.device)
    src = teacher.params(use_ema=use_ema_teacher).state_dict()
    student.state.model.load_state_dict(src)
    if student.state.ema_model is not None:
        student.state.ema_model.load_state_dict(src)
    return student


def make_distill_step(teacher_apply_eps: Callable, student_tables: DiffusionTables,
                      teacher_tables: DiffusionTables,
                      clip_target: bool = True) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build ``step(state, x0, y=None, *, t=None, noise=None) -> metrics``.

    ``teacher_apply_eps(x, t, y)`` is the teacher's eps view (teacher units,
    possibly CFG-wrapped); the student is ``state.model``.  Student step
    t_s maps to teacher t_hi = 2 t_s.  From z ~ q(x_{t_s} | x0) the teacher
    takes two eta = 0 DDIM steps t_hi -> t_hi - 1 -> t_hi - 2, landing on
    z''; the student's target is (paper eq. 9)

        x0* = (z'' - (s_p / s_t) z) / (a_p - (s_p / s_t) a_t)

    (a = sqrt(abar), s = sqrt(1 - abar) at the student's source and target
    levels; at t_s = 1 the target level is clean and x0* = z''), and
    v* = (a_t z - x0*) / s_t.  The loss is the batch mean of the per-sample
    v-space MSE, recorded in the loss history at t_s.  Metrics: ``loss``,
    ``grad_norm``."""
    T_s = student_tables.diffusion_steps
    if teacher_tables.diffusion_steps != 2 * T_s:
        raise ValueError(f"the teacher has {teacher_tables.diffusion_steps} steps, the "
                         f"student {T_s}: a halving needs twice as many")

    def ddim_step(x, t, eps):
        # one eta = 0 DDIM step on the teacher chain (teacher units)
        x0 = D.xstart_from_epsilon(teacher_tables, x, t, eps)
        a_prev = D.expand_to(teacher_tables.alphas_hat_prev, t, x.ndim)
        return torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps

    def step(state: TrainState, x0: torch.Tensor, y: Optional[torch.Tensor] = None, *,
             t: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        b, c = x0.shape[0], x0.shape[-1]
        t_s = sample_uniform(state.generator, b, T_s)[0] if t is None else t.to(x0.device)
        if noise is None:
            noise = torch.randn(x0.shape, generator=state.generator, device=x0.device,
                                dtype=x0.dtype)
        z = D.q_sample(student_tables, x0, noise, t_s)

        def teacher_eps(x, tt):
            out = teacher_apply_eps(x, tt, y)
            # a learned-sigma teacher gives [eps | var-interp]: the DDIM
            # steps take the mean head
            return out[..., :c] if out.shape[-1] == 2 * c else out

        with torch.no_grad():
            t_hi = 2 * t_s
            z1 = ddim_step(z, t_hi, teacher_eps(z, t_hi))
            z2 = ddim_step(z1, t_hi - 1, teacher_eps(z1, t_hi - 1))
            # the implied one-step student target (student units)
            a_t = D.expand_to(student_tables.alphas_hat_sqrt, t_s, x0.ndim)
            s_t = D.expand_to(student_tables.one_min_alphas_hat_sqrt, t_s, x0.ndim)
            ab_p = D.expand_to(student_tables.alphas_hat_prev, t_s, x0.ndim)
            a_p, s_p = torch.sqrt(ab_p), torch.sqrt(1.0 - ab_p)
            ratio = s_p / s_t
            x0_star = (z2 - ratio * z) / (a_p - ratio * a_t)
            if clip_target:
                x0_star = torch.clamp(x0_star, -1.0, 1.0)
            v_star = (a_t * z - x0_star) / s_t

        model = state.model
        model.eval().zero_grad(set_to_none=True)
        per_sample = D.mean_flat(torch.square(v_star - model(z, t_s, y)))
        return _backward_and_apply(state, per_sample.mean(), t_s, per_sample, False)

    return step


def teacher_eps_fn(teacher, use_ema_teacher: bool = True,
                   guidance_scale: Optional[float] = None) -> Callable:
    """The teacher's eps view over its EMA (``use_ema_teacher``) or live
    weights in eval mode, under classifier-free guidance at
    ``guidance_scale`` where one is set, which needs a teacher trained with
    its ``cfg_null_class`` row."""
    from ..sample.sampler import make_cfg_apply_fn

    apply = teacher._view(teacher.params(use_ema=use_ema_teacher).eval())
    if guidance_scale is None:
        return apply
    if not getattr(teacher.model, "cfg_null_class", False):
        raise ValueError("guided distillation needs a teacher trained with cfg_null_class=True "
                         "(otherwise the null-half gather silently clamps to the last real "
                         "class)")
    return make_cfg_apply_fn(apply, float(guidance_scale), teacher.model.num_classes)


def distill_round(student, teacher, batches: Iterable, log_every: int = 50,
                  log: Callable = print, guidance_scale: Optional[float] = None,
                  use_ema_teacher: bool = True) -> Dict[str, float]:
    """Train ``student`` to mimic two teacher steps with one, over an
    iterable of x0 (or (x0, y)) batches; returns the last step's metrics as
    floats.  ``guidance_scale`` distils classifier-free-guided teacher
    sampling at that fixed scale into the student's single forward (Meng et
    al., arXiv:2210.03142), which needs labelled batches.
    ``use_ema_teacher`` picks the teacher's weights for the targets; pass
    ``halved_student`` the same value, so the warm start and the targets
    come from one weight set."""
    step = make_distill_step(teacher_eps_fn(teacher, use_ema_teacher, guidance_scale),
                             student.tables, teacher.tables)
    last, n_steps = {}, 0
    for i, batch in enumerate(batches):
        x0, y = batch if isinstance(batch, (tuple, list)) else (batch, None)
        y = student._cond(y)
        if guidance_scale is not None and y is None:
            raise ValueError("guided distillation needs labels")
        last = step(student.state, student._batch(x0), y)
        if log_every and i % log_every == 0:
            log(f"[distill] step {i} loss={float(last['loss']):.5f}")
        n_steps += 1
    if n_steps == 0:
        raise ValueError("distill_round got zero batches: no training step would run")
    return {k: float(v) for k, v in last.items()}
