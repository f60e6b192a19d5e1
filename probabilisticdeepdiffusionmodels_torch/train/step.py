"""The training and validation steps on the eps / ``simple`` path.

PyTorch counterpart of ``make_train_step`` and ``make_eval_step`` in
``probabilisticdeepdiffusionmodels_tpu/train/step.py``.  One call of the train
step draws t (uniform or importance) and then the noise from the state's
generator (or takes them injected), noises x0, runs the model in train mode,
takes the eps-MSE per sample, reduces it (the weighted loss is SUMMED, the
unweighted one MEANED), backpropagates, records the detached per-sample
losses in the loss history, and applies the optimizer and the EMA.  Nothing
in it waits for the device: the metrics are device tensors.  Dropout (a
model with ``dropout > 0``) draws its masks from the state's generator too,
after t and the noise, as JAX draws them from the step's key.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import torch

from ..core import diffusion as D
from ..core.diffusion import DiffusionTables
from .samplers import importance_weights, sample_importance, sample_uniform
from .state import TrainState

__all__ = ["make_train_step", "make_eval_step", "global_norm"]

_LATER = "is not ported yet (ROADMAP.md Queue 1 item 11)"


def global_norm(tensors: Iterable[Optional[torch.Tensor]]) -> torch.Tensor:
    """float32 L2 norm over all tensors (None counts as zeros)."""
    tensors = [t.float() for t in tensors if t is not None]
    if not tensors:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def _check(prediction_type: str, loss_weighting: str) -> None:
    if prediction_type not in ("epsilon", "v", "x0"):
        raise ValueError(f'Unknown prediction_type: "{prediction_type}"')
    if loss_weighting not in ("none", "min_snr"):
        raise ValueError(f'Unknown loss_weighting: "{loss_weighting}"')
    if prediction_type != "epsilon":
        raise NotImplementedError(f"prediction_type={prediction_type!r} {_LATER}")
    if loss_weighting != "none":
        raise NotImplementedError(f"loss_weighting={loss_weighting!r} {_LATER}")


def make_train_step(
    tables: DiffusionTables,
    *,
    sampling: str = "uniform",
    min_counts: int = 10,
    loss_type: str = "simple",
    watch: bool = False,
    class_dropout_prob: float = 0.0,
    prediction_type: str = "epsilon",
    loss_weighting: str = "none",
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build ``step(state, x0, y=None, *, t=None, noise=None) -> metrics``.

    ``state`` is a ``TrainState`` and is updated in place.  ``t`` (1-indexed
    [B]) and ``noise`` (x0's shape) may be injected; an injected t under
    importance sampling is weighted from the state's own history
    (``1/(p[t-1]*B)`` once warmed up, ``1/B`` before).  Metrics: ``loss``,
    ``grad_norm`` (float32 global norm of the gradients before any clipping)
    and, with ``watch``, ``grad_norm_per_module`` for each top-level module.
    """
    T = tables.diffusion_steps
    if sampling not in ("uniform", "importance"):
        raise ValueError(f'Unknown sampling option: "{sampling}"')
    _check(prediction_type, loss_weighting)
    if loss_type != "simple":
        raise NotImplementedError(f"loss_type={loss_type!r} {_LATER}")
    if class_dropout_prob:
        raise NotImplementedError(f"class_dropout_prob > 0 {_LATER}")

    def step(state: TrainState, x0: torch.Tensor, y: Optional[torch.Tensor] = None, *,
             t: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        model, b = state.model, x0.shape[0]
        if t is None:
            if sampling == "importance":
                t, weights = sample_importance(state.generator, b, state.loss_history,
                                               min_counts)
            else:
                t, weights = sample_uniform(state.generator, b, T)
        else:
            t = t.to(x0.device)
            weights = (importance_weights(state.loss_history, t, min_counts)
                       if sampling == "importance" else None)
        if noise is None:
            noise = torch.randn(x0.shape, generator=state.generator, device=x0.device,
                                dtype=x0.dtype)
        x_t = D.q_sample(tables, x0, noise, t)

        model.train()
        for p in model.parameters():
            p.grad = None
        per_sample = D.mean_flat(torch.square(
            noise - model(x_t, t, y, generator=state.generator)))
        loss = (weights * per_sample).sum() if weights is not None else per_sample.mean()
        loss.backward()

        named = list(model.named_parameters())
        metrics = {"loss": loss.detach(), "grad_norm": global_norm(p.grad for _, p in named)}
        if watch:
            modules = {}
            for name, p in named:
                modules.setdefault(name.split(".")[0], []).append(p.grad)
            metrics["grad_norm_per_module"] = {k: global_norm(v) for k, v in modules.items()}
        state.loss_history.update(t, per_sample.detach())
        state.apply_gradients()
        return metrics

    return step


def make_eval_step(tables: DiffusionTables, prediction_type: str = "epsilon",
                   loss_weighting: str = "none") -> Callable[..., torch.Tensor]:
    """Build ``step(model, generator, x0, y=None, *, t=None, noise=None)``:
    the validation loss (uniform t, no weights, no dropout: the model is put
    in eval mode) of ``model``; pass ``state.model`` or ``state.ema_model``."""
    T = tables.diffusion_steps
    _check(prediction_type, loss_weighting)

    @torch.no_grad()
    def step(model: torch.nn.Module, generator: torch.Generator, x0: torch.Tensor,
             y: Optional[torch.Tensor] = None, *, t: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        if t is None:
            t, _ = sample_uniform(generator, x0.shape[0], T)
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator, device=x0.device,
                                dtype=x0.dtype)
        t = t.to(x0.device)
        model.eval()
        out = model(D.q_sample(tables, x0, noise, t), t, y)
        pred = out.chunk(2, dim=-1)[0] if out.shape[-1] == 2 * x0.shape[-1] else out
        return D.mean_flat(torch.square(noise - pred)).mean()

    return step
