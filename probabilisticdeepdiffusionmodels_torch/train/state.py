"""Training state: model, optimizer, EMA, loss history, generator.

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/train/state.py``.
The EMA is a copy of the model whose float32 parameters follow

    ema <- decay * ema + (1 - decay) * params

after every optimizer step, over parameters only (the UNet has no buffers).
The state is mutated in place where JAX returns a new pytree.  On a data
mesh ``sync`` (``parallel.sync.MeshSync``) holds the collectives: the
update and the EMA then run on what it names (the FSDP masters), and the
modules' working copies are released after each update.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import torch

from .samplers import LossHistory

__all__ = ["TrainState", "ema_update"]


@torch.no_grad()
def ema_update(ema_params: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
               decay: float) -> None:
    """In place: e <- d*e + (1-d)*p, each product and the sum rounded
    separately, in JAX's order (no ``lerp`` or fused multiply-add)."""
    ema_params, params = list(ema_params), list(params)
    torch._foreach_mul_(ema_params, decay)
    torch._foreach_add_(ema_params, torch._foreach_mul(params, 1.0 - decay))


class TrainState:
    """All mutable training state.

    ``step`` counts calls of ``apply_gradients`` (a host int); ``optimizer``
    is an ``engine.AdamChain`` over ``model``'s parameters; ``ema_model`` is a
    copy of the model holding the EMA parameters (None without ``ema_decay``);
    ``loss_history`` lives on the model's device and ``generator`` draws t and
    noise there; ``sync`` is None off a mesh.
    """

    def __init__(self, model: torch.nn.Module, optimizer, diffusion_steps: int,
                 generator: torch.Generator, ema_decay: Optional[float] = None,
                 history: int = 10):
        device = next(model.parameters()).device
        self.step = 0
        self.model = model
        self.optimizer = optimizer
        self.ema_decay = ema_decay
        self.ema_model = None
        if ema_decay:
            self.ema_model = copy.deepcopy(model).eval().requires_grad_(False)
        self.loss_history = LossHistory(diffusion_steps, history, device=device)
        self.generator = generator
        self.sync = None

    def apply_gradients(self) -> None:
        """Optimizer step on the gradients in ``param.grad``, then the EMA,
        then ``step += 1``."""
        self.optimizer.step()
        if self.ema_model is not None:
            ema, live = ((self.ema_model.parameters(), self.model.parameters())
                         if self.sync is None else self.sync.ema_pairs())
            ema_update(ema, live, self.ema_decay)
        if self.sync is not None:
            self.sync.release()
        self.step += 1
