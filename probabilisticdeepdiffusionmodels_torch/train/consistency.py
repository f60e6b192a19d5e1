"""Consistency training (CT: Song et al., arXiv:2303.01469 section 5, with
the iCT estimator, metric and weighting of arXiv:2310.14189).

PyTorch counterpart of the CT half of
``probabilisticdeepdiffusionmodels_tpu/train/consistency.py``: the
``prediction_type="consistency"`` train and eval steps.  Each step draws an
adjacent pair of levels sigma_hi > sigma_lo of the Karras grid and one z,
and pulls f(x0 + sigma_hi z, sigma_hi) toward the target f(x0 + sigma_lo z,
sigma_lo), computed without gradients by the live weights ("stopgrad", the
iCT choice) or by the EMA weights ("ema").  With ``grid_init`` the grid
doubles from grid_init to grid_size over ``anneal_steps`` optimizer steps;
the level is read from the state's host-side step count.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..core.consistency import ConsistencyConfig, cm_apply, cm_metric, pair_weight
from ..core.diffusion import DiffusionTables
from ..core.edm import karras_sigma_grid
from .state import TrainState
from .step import _backward_and_apply, _bucket, _check_dropout, _drop_labels

__all__ = ["make_ct_train_step", "make_ct_eval_step"]


def _grid_tables(cfg: ConsistencyConfig, device):
    """The training grid's levels: (sigma_hi [K, W], sigma_lo [K, W], the
    pair count of each level (host ints), the optimizer steps a level
    lasts), W = grid_size - 1.  Without annealing one level, the grid of
    ``grid_size``; with it the levels grid_init, 2 grid_init, ...,
    grid_size, each padded with its last pair, the last level starting at
    about ``anneal_steps``."""
    sizes = [cfg.grid_init or cfg.grid_size]
    while sizes[-1] < cfg.grid_size:
        sizes.append(min(sizes[-1] * 2, cfg.grid_size))
    width = cfg.grid_size - 1
    his, los = [], []
    for n in sizes:
        g = karras_sigma_grid(n, cfg.sigma_min, cfg.sigma_max, cfg.rho)
        pad = width - (n - 1)
        his.append(np.concatenate([g[:-1], np.full(pad, g[-2])]))
        los.append(np.concatenate([g[1:], np.full(pad, g[-1])]))
    steps_per = max(1, int(cfg.anneal_steps) // max(1, len(sizes) - 1))
    return (torch.as_tensor(np.stack(his), dtype=torch.float32, device=device),
            torch.as_tensor(np.stack(los), dtype=torch.float32, device=device),
            [n - 1 for n in sizes], steps_per)


def _ct_parts(tabs, generator: Optional[torch.Generator], x0: torch.Tensor, step: int = 0,
              index: Optional[torch.Tensor] = None, z: Optional[torch.Tensor] = None):
    """(x_hi, sigma_hi, x_lo, sigma_lo, grid size): per-sample adjacent
    pairs (g[i], g[i+1]) of the level active at optimizer step ``step`` (a
    host int), i uniform over its pairs, then one z for both levels (each
    drawn unless injected)."""
    hi, lo, n_pairs, steps_per = tabs
    b = x0.shape[0]
    level = min(step // steps_per, hi.shape[0] - 1)
    if index is None:
        index = torch.randint(0, n_pairs[level], (b,), generator=generator, device=x0.device)
    sig_hi, sig_lo = hi[level, index], lo[level, index]
    if z is None:
        z = torch.randn(x0.shape, generator=generator, device=x0.device)
    bshape = (-1,) + (1,) * (x0.ndim - 1)
    return (x0 + sig_hi.reshape(bshape) * z, sig_hi, x0 + sig_lo.reshape(bshape) * z,
            sig_lo, n_pairs[level] + 1)


def _ct_per_sample_loss(model: Callable, parts, y: Optional[torch.Tensor],
                        cfg: ConsistencyConfig, target: Optional[Callable] = None,
                        **kwargs) -> torch.Tensor:
    """lambda(sigma_hi, sigma_lo) d(f(x_hi, sigma_hi), f^-(x_lo, sigma_lo))
    per sample; the target network f^- is ``target`` (default: ``model``)
    and takes no gradient."""
    x_hi, sig_hi, x_lo, sig_lo = parts[:4]
    pred = cm_apply(model, x_hi, sig_hi, y, cfg, **kwargs)
    with torch.no_grad():
        tgt = cm_apply(model if target is None else target, x_lo, sig_lo, y, cfg, **kwargs)
    return pair_weight(sig_hi, sig_lo, cfg.weighting) * cm_metric(pred, tgt, cfg.metric,
                                                                  cfg.huber_c)


def _sigma_table(tables: DiffusionTables) -> torch.Tensor:
    """The schedule's own VE sigma of each 1-indexed timestep (ascending)."""
    return torch.sqrt((1.0 - tables.alphas_hat) / tables.alphas_hat)


def _vp_bucket(tables: DiffusionTables, sigma: torch.Tensor) -> torch.Tensor:
    """The VP timestep of each sigma on the schedule's sigma table (the
    ceiling), for the loss history."""
    return _bucket(_sigma_table(tables), sigma)


def make_ct_train_step(tables: DiffusionTables, cfg: ConsistencyConfig, *,
                       watch: bool = False, class_dropout_prob: float = 0.0,
                       null_class: Optional[int] = None) -> Callable[..., Dict]:
    """Build ``step(state, x0, y=None, *, index=None, z=None)``: one CT step
    (two forwards, the target's without gradients, one backward), with the
    optimizer, EMA, class dropout and loss history of the eps step.  The
    pair index and z are drawn from the state's generator unless injected.
    Metrics: ``loss``, ``grad_norm``, and under annealing ``grid_n``."""
    cfg.validate()
    _check_dropout(class_dropout_prob, null_class)
    tabs = _grid_tables(cfg, tables.alphas_hat.device)

    def step(state: TrainState, x0: torch.Tensor, y: Optional[torch.Tensor] = None, *,
             index: Optional[torch.Tensor] = None,
             z: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        target = None
        if cfg.target == "ema":
            if state.ema_model is None:
                raise ValueError('consistency target="ema" needs EMA weights: set the '
                                 "engine's ema decay (or use the default target "
                                 '"stopgrad")')
            target = state.ema_model
        parts = _ct_parts(tabs, state.generator, x0, state.step, index, z)
        y = _drop_labels(state, y, x0.shape[0], class_dropout_prob, null_class)
        model = state.model
        model.train().zero_grad(set_to_none=True)
        per_sample = _ct_per_sample_loss(model, parts, y, cfg, target,
                                         generator=state.generator)
        metrics = _backward_and_apply(state, per_sample.mean(), _vp_bucket(tables, parts[1]),
                                      per_sample, watch)
        if cfg.grid_init:
            metrics["grid_n"] = parts[4]
        return metrics

    return step


def make_ct_eval_step(tables: DiffusionTables, cfg: ConsistencyConfig) -> Callable:
    """``step(model, generator, x0, y=None, *, index=None, z=None)``: the CT
    loss of ``model`` in eval mode on the full grid, targeted by the same
    weights (the self-consistency that compares across targets)."""
    tabs = _grid_tables(cfg.validate()._replace(grid_init=0), tables.alphas_hat.device)

    @torch.no_grad()
    def step(model: torch.nn.Module, generator: torch.Generator, x0: torch.Tensor,
             y: Optional[torch.Tensor] = None, *, index: Optional[torch.Tensor] = None,
             z: Optional[torch.Tensor] = None) -> torch.Tensor:
        model.eval()
        parts = _ct_parts(tabs, generator, x0, index=index, z=z)
        return _ct_per_sample_loss(model, parts, y, cfg).mean()

    def draw(generator: torch.Generator, x0: torch.Tensor) -> Dict[str, torch.Tensor]:
        index = torch.randint(0, cfg.grid_size - 1, (x0.shape[0],), generator=generator,
                              device=x0.device)
        return {"index": index, "z": torch.randn(x0.shape, generator=generator,
                                                 device=x0.device)}

    step.draw = draw
    return step
