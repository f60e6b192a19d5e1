"""The optimizer chain and the learning-rate schedules of the engine.

PyTorch counterpart of ``make_lr_schedule`` (``engine.py:79-150``) and of the
optimizer chain that ``DiffusionEngine`` builds (``engine.py:320-336``) in
``probabilisticdeepdiffusionmodels_tpu``: ``optax.adam`` with an optional
``clip_by_global_norm`` before it and an optional ``MultiSteps`` around both.
The engine facade itself is not ported yet (ROADMAP.md Queue 1 item 9).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Optional, Union

import torch

from .train.step import global_norm

__all__ = ["make_lr_schedule", "AdamChain", "clip_by_global_norm"]

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
