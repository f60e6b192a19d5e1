"""Timestep samplers with the loss history kept on the device.

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/train/samplers.py``.
The per-timestep loss history is a set of fixed-shape tensors on the model's
device; updates, the warmed-up predicate and the importance draw are tensor
ops with no host sync (``torch.where`` on the predicate, never a Python
``if`` on a device value).  Random draws come from an explicit
``torch.Generator`` on that device (at the global batch under a mesh's
batch split, ``parallel.mesh.batch_shard``).

Semantics kept:
  * t is 1-indexed, drawn from [1, T];
  * importance sampling starts once every t has >= ``min_counts``
    observations; before that t is uniform and every weight is 1/B;
  * p_t is proportional to the RMS of the last ``history`` losses at t, + 1e-6;
  * weights = 1 / (p_t * B).

Unlike the JAX NamedTuple, ``LossHistory`` is updated in place: the train
state owns one history and nothing else holds the old one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..parallel import mesh as P

__all__ = ["LossHistory", "sample_uniform", "sample_importance", "importance_probs",
           "importance_weights"]


class LossHistory:
    """Per-timestep ring of recent losses plus totals: ``ring`` [T, H]
    float32, ``ring_pos`` / ``count`` / ``epoch_count`` [T] int32,
    ``epoch_sum`` [T] float32."""

    def __init__(self, diffusion_steps: int, history: int = 10, device=None):
        self.ring = torch.zeros((diffusion_steps, history), dtype=torch.float32,
                                device=device)
        self.ring_pos = torch.zeros(diffusion_steps, dtype=torch.int32, device=device)
        self.count = torch.zeros(diffusion_steps, dtype=torch.int32, device=device)
        self.epoch_sum = torch.zeros(diffusion_steps, dtype=torch.float32, device=device)
        self.epoch_count = torch.zeros(diffusion_steps, dtype=torch.int32, device=device)

    def update(self, t: torch.Tensor, losses: torch.Tensor) -> None:
        """Record a batch of (t, loss): t 1-indexed [B], losses [B].

        Items with the same t land in consecutive ring slots (slot = pos[t] +
        rank among the finite same-t items before it); non-finite losses are
        dropped.  Where two items hit one slot (a NaN ahead of a finite loss,
        or more same-t items than the ring holds), the later item's write
        stands, as in JAX's in-order scatter on the CPU: every item of a slot
        writes the last one's value, so the scatter's order cannot matter,
        and no boolean mask makes the host wait for the device.
        """
        h = self.ring.shape[1]
        tl = t.long() - 1
        losses = losses.float()
        finite = torch.isfinite(losses)
        same = tl[None, :] == tl[:, None]
        rank = (torch.tril(same, diagonal=-1) & finite[None, :]).sum(dim=1)
        slot = (self.ring_pos[tl].long() + rank) % h
        cell = tl * h + slot
        order = torch.arange(cell.shape[0], device=cell.device)
        last = torch.where(cell[None, :] == cell[:, None], order[None, :], -1).amax(dim=1)
        safe = torch.where(finite, losses, torch.zeros_like(losses))
        value = torch.where(finite, safe, self.ring[tl, slot])
        self.ring.view(-1).index_put_((cell,), value[last])
        upd = finite.to(torch.int32)
        self.ring_pos.index_add_(0, tl, upd)
        self.ring_pos.remainder_(h)
        self.count.index_add_(0, tl, upd)
        self.epoch_sum.index_add_(0, tl, safe)
        self.epoch_count.index_add_(0, tl, upd)

    def rms_per_step(self) -> torch.Tensor:
        """sqrt(mean of squared recent losses) per t over the filled part of
        the ring."""
        h = self.ring.shape[1]
        filled = torch.clamp(self.count, max=h)
        mask = (torch.arange(h, device=self.ring.device)[None, :] < filled[:, None]).float()
        denom = torch.clamp(filled.float(), min=1.0)
        return torch.sqrt((self.ring ** 2 * mask).sum(dim=1) / denom)

    def avg_per_step_epoch(self) -> torch.Tensor:
        return self.epoch_sum / torch.clamp(self.epoch_count.float(), min=1.0)

    def reset_epoch(self) -> None:
        self.epoch_sum.zero_()
        self.epoch_count.zero_()

    def is_warmed_up(self, min_counts: int) -> torch.Tensor:
        """0-dim bool tensor: every t observed >= ``min_counts`` times."""
        return (self.count >= min_counts).all()


def sample_uniform(generator: torch.Generator, batch_size: int,
                   diffusion_steps: int) -> Tuple[torch.Tensor, None]:
    """t ~ U{1..T} on the generator's device, no weights."""
    t = P.randint(1, diffusion_steps + 1, (batch_size,), generator=generator,
                  device=generator.device)
    return t, None


def importance_probs(history: LossHistory) -> torch.Tensor:
    """p_t proportional to RMS(last losses at t) + 1e-6."""
    p = history.rms_per_step() + 1e-6
    return p / p.sum()


def importance_weights(history: LossHistory, t: torch.Tensor, min_counts: int,
                       p: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Loss weights of given timesteps: 1 / (p[t-1] * B) once the history is
    warmed up, 1/B before; B is the global batch under a mesh's batch split."""
    b = P.global_batch(t.shape[0])
    p = importance_probs(history) if p is None else p
    w_imp = 1.0 / (p[t.long() - 1] * b)
    return torch.where(history.is_warmed_up(min_counts), w_imp,
                       torch.full_like(w_imp, 1.0 / b))


def sample_importance(generator: torch.Generator, batch_size: int,
                      history: LossHistory,
                      min_counts: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t [B] 1-indexed, weights [B]); uniform with weights 1/B until the
    history is warmed up.  Both draws are always made (no host branch): the
    importance draw by inverse CDF on p, then the uniform one."""
    p = importance_probs(history)
    u = P.rand((batch_size,), generator=generator, device=generator.device)
    cdf = torch.cumsum(p, dim=0)
    idx = torch.clamp(torch.searchsorted(cdf, u * cdf[-1], right=True), max=p.shape[0] - 1)
    t_uni, _ = sample_uniform(generator, batch_size, p.shape[0])
    t = torch.where(history.is_warmed_up(min_counts), idx + 1, t_uni)
    return t, importance_weights(history, t, min_counts, p)
