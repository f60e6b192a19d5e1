"""Reflow, or 2-rectification (Liu et al., "Rectified Flow",
arXiv:2209.03003 section 3.2; InstaFlow, arXiv:2309.06380): straighten a
generative ODE by retraining a flow-matching student on the teacher's OWN
deterministic couplings (z, x(z)) instead of independent (noise, data) pairs.

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/train/reflow.py``.
Any engine with a deterministic sampler gives couplings: a flow teacher
through its native Euler / Heun ODE, an eps / v / x0 / EDM teacher through
the eps view's DDIM (eta = 0) or DPM-Solver++ chain.  Each integrates from
exactly the standard-normal ``x_T`` it is given, so (z, x) pairs the two
ends of the straight interpolant.  The student is always a flow engine,
warm-started from the teacher's weights when the model configs match.

The couplings stay on the teacher's device; the student's step takes (x, z)
batches gathered there, draws its flow times from the state's generator
(or takes them injected) and runs without dropout, as JAX's reflow step
applies it.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.diffusion import DiffusionTables
from ..core.flow import FlowConfig, sample_t, vp_t_to_flow_t
from .state import TrainState
from .step import _backward_and_apply, _bucket, _flow_per_sample_loss

__all__ = ["reflow_student", "make_reflow_step", "generate_couplings", "reflow_round"]


def reflow_student(teacher, lr: Optional[float] = None, ema: float = 0.995,
                   flow_config: Optional[dict] = None, use_ema_teacher: bool = True,
                   warm_start: bool = True):
    """The flow student of one reflow round: the teacher's model config,
    schedule (its betas; the tables serve the student's eps view and NLL),
    optimizer (``lr`` overrides the rate) and device,
    ``prediction_type="flow"``, its live and EMA weights copied from the
    teacher's (EMA ones with ``use_ema_teacher``) when ``warm_start``.
    ``flow_config`` defaults to a flow teacher's own, else to
    ``FlowConfig``'s.  A learned-sigma (hybrid) teacher raises."""
    from ..engine import DiffusionEngine

    hp = dict(teacher.hparams)
    if dict(hp["model_config"]).get("learn_sigma") or hp.get("loss_type") == "hybrid":
        raise NotImplementedError(
            "reflowing a learned-sigma (hybrid) teacher is not defined: the flow student "
            "regresses a C-channel velocity, and warm-starting its head from a 2C-channel "
            "teacher conv is shape-incompatible.  Reflow an eps/v/x0/edm/flow teacher.")
    if flow_config is None and teacher.flow is not None:
        flow_config = teacher.flow._asdict()
    oc = dict(hp["optimizer_config"])
    if lr is not None:
        oc["lr"] = float(lr)
    student = DiffusionEngine(
        model_config=dict(hp["model_config"]), optimizer_config=oc,
        diffusion_steps=teacher.diffusion_steps, mode=hp.get("mode", "linear"),
        betas=teacher.schedule.betas, sigma_mode=hp.get("sigma_mode", "beta"),
        resolution=hp.get("resolution", 32),
        clip_while_generating=hp.get("clip_while_generating", False), ema=ema,
        seed=hp.get("seed", 0), prediction_type="flow", flow_config=flow_config,
        in_channels=teacher.in_channels, device=teacher.device)
    if warm_start:
        src = teacher.params(use_ema=use_ema_teacher).state_dict()
        student.state.model.load_state_dict(src)
        if student.state.ema_model is not None:
            student.state.ema_model.load_state_dict(src)
    return student


def make_reflow_step(tables: DiffusionTables,
                     flow: FlowConfig) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build ``step(state, x, z, y=None, *, t=None) -> metrics``: the flow
    train step with GIVEN endpoints, ``x`` the teacher's sample and ``z``
    the standard-normal that produced it.  Along x_t = (1 - t) x + t z the
    target is the constant velocity z - x; the per-sample losses go into
    the loss history at each flow time's VP bucket.  Metrics: ``loss``,
    ``grad_norm``."""
    t_flow_of_vp = vp_t_to_flow_t(tables.alphas_hat)

    def step(state: TrainState, x: torch.Tensor, z: torch.Tensor,
             y: Optional[torch.Tensor] = None, *,
             t: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        t = sample_t(state.generator, x.shape[0], flow, x.device) if t is None else t.to(x.device)
        model = state.model
        model.eval().zero_grad(set_to_none=True)
        per_sample = _flow_per_sample_loss(model, x, t, z, y)
        return _backward_and_apply(state, per_sample.mean(), _bucket(t_flow_of_vp, t),
                                   per_sample, False)

    return step


def _default_sampler(teacher) -> dict:
    """The native flow ODE for a flow teacher, DDIM-50 otherwise."""
    if teacher.prediction_type == "flow":
        return dict(flow=True, num_sample_steps=50)
    return dict(ddim=True, num_sample_steps=50)


def generate_couplings(teacher, n: int, generator: Optional[torch.Generator] = None,
                       minibatch: int = 64, sampler_kwargs: Optional[dict] = None,
                       use_ema: bool = True, y=None,
                       z: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic teacher couplings (z, x), paired row-wise, as float32
    tensors on the teacher's device: z ~ N(0, I) from ``generator`` (default
    seeded 0; or the given ``z``), x the teacher's ODE integrated from it by
    ``teacher.generate_images`` with ``sampler_kwargs`` (default: the native
    flow ODE for a flow teacher, DDIM-50 otherwise) and labels ``y``."""
    if sampler_kwargs is None:
        sampler_kwargs = _default_sampler(teacher)
    shape = (n, *(teacher.resolution,) * 2, teacher.in_channels)
    if z is None:
        if generator is None:
            generator = torch.Generator(teacher.device).manual_seed(0)
        z = torch.randn(shape, generator=generator, device=teacher.device)
    z = teacher._batch(z)
    if tuple(z.shape) != shape:
        raise ValueError(f"z must be {shape}, got {tuple(z.shape)}")
    x = teacher.generate_images(n=n, minibatch=min(minibatch, n), x_T=z, use_ema=use_ema, y=y,
                                **sampler_kwargs)
    return z, teacher._batch(x)


def reflow_round(student, teacher, generator: Optional[torch.Generator] = None,
                 n_couplings: int = 4096, batch_size: int = 64, epochs: int = 8,
                 minibatch_gen: int = 64, sampler_kwargs: Optional[dict] = None,
                 use_ema_teacher: bool = True, y=None, log_every: int = 50,
                 log: Callable = print, z: Optional[torch.Tensor] = None,
                 orders=None) -> Dict[str, float]:
    """One rectification round: ``n_couplings`` teacher pairs, then
    ``epochs`` shuffled passes of the student over them in batches of
    ``batch_size`` (the last partial batch dropped); returns the last
    step's metrics as floats.  One generator (default seeded 0 on the
    teacher's device) draws z and then each epoch's order (``z`` and
    ``orders``, one permutation an epoch, may be injected).  ``y``: labels
    [n_couplings] of a conditional teacher, the same label for a pair's
    generation and its student step.  ``use_ema_teacher`` picks the
    teacher's weights for the couplings; pass ``reflow_student`` the same
    value."""
    if n_couplings < batch_size:
        # the drop-last batching would run no step and hand back the warm
        # start as a "reflowed" model
        raise ValueError(f"n_couplings={n_couplings} < batch_size={batch_size}: no training "
                         "step would run")
    if generator is None:
        generator = torch.Generator(teacher.device).manual_seed(0)
    log(f"[reflow] generating {n_couplings} couplings "
        f"({sampler_kwargs or 'default deterministic sampler'})")
    z, x = generate_couplings(teacher, n_couplings, generator, minibatch=minibatch_gen,
                              sampler_kwargs=sampler_kwargs, use_ema=use_ema_teacher, y=y, z=z)
    y = student._cond(None if y is None else np.asarray(y))
    step = make_reflow_step(student.tables, student.flow)
    last, i = {}, 0
    for ep in range(epochs):
        if orders is not None:
            perm = torch.as_tensor(np.ascontiguousarray(orders[ep]), device=x.device).long()
        else:
            perm = torch.randperm(n_couplings, generator=generator, device=generator.device)
            perm = perm.to(x.device)
        for lo in range(0, n_couplings - batch_size + 1, batch_size):
            idx = perm[lo:lo + batch_size]
            last = step(student.state, x[idx], z[idx], None if y is None else y[idx])
            if log_every and i % log_every == 0:
                log(f"[reflow] epoch {ep} step {i} loss={float(last['loss']):.5f}")
            i += 1
    return {k: float(v) for k, v in last.items()}
