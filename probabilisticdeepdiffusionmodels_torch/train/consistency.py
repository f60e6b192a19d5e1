"""Consistency training and consistency distillation (Song et al.,
arXiv:2303.01469, with the iCT estimator, metric and weighting of
arXiv:2310.14189).

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/train/consistency.py``.

* Training (CT): the ``prediction_type="consistency"`` train and eval
  steps.  Each step draws an adjacent pair of levels sigma_hi > sigma_lo of
  the Karras grid and one z, and pulls f(x0 + sigma_hi z, sigma_hi) toward
  the target f(x0 + sigma_lo z, sigma_lo), computed without gradients by
  the live weights ("stopgrad", the iCT choice) or by the EMA weights
  ("ema").  With ``grid_init`` the grid doubles from grid_init to
  grid_size over ``anneal_steps`` optimizer steps; the level is read from
  the state's host-side step count.
* Distillation (CD): x_hi = x0 + sigma_hi z, one teacher Heun step of the
  PF-ODE down to the adjacent grid level gives x_lo, and f(x_hi, sigma_hi)
  is pulled toward f(x_lo, sigma_lo).  The teacher is any engine
  (``make_teacher_denoiser``): an EDM or flow teacher at the exact sigma, a
  table-trained one (eps / v / x0) through its eps view at the nearest
  timestep.  The teacher runs under ``no_grad``, on the kernels like every
  forward.  ``consistency_student`` builds the student engine and
  ``consistency_distill_round`` drives the steps.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..core.consistency import ConsistencyConfig, cm_apply, cm_metric, pair_weight
from ..core.diffusion import DiffusionTables
from ..core.edm import edm_denoise, karras_sigma_grid
from ..core.flow import TIME_SCALE
from .state import TrainState
from .step import _backward_and_apply, _bucket, _check_dropout, _drop_labels

__all__ = ["make_teacher_denoiser", "make_cd_step", "make_ct_train_step",
           "make_ct_eval_step", "consistency_student", "consistency_distill_round"]


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


def _per_sample(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-sample [B] value shaped to broadcast over x's sample axes."""
    return v.reshape((-1,) + (1,) * (x.ndim - 1))


def _nearest_t_by_sigma(tables: DiffusionTables, sigma: torch.Tensor) -> torch.Tensor:
    """The 1-indexed timestep whose table sigma is nearest to ``sigma`` in
    log-sigma (the geometric midpoint goes down), the conditioning of a
    table teacher's eps view.  A plain searchsorted is a ceiling and would
    put every off-grid sigma one step high."""
    sig_vp = _sigma_table(tables)
    T = tables.diffusion_steps
    i_hi = torch.clamp(torch.searchsorted(sig_vp, sigma.contiguous()), 0, T - 1)
    i_lo = torch.clamp(i_hi - 1, min=0)
    log_s = torch.log(sigma)
    pick_lo = (log_s - torch.log(sig_vp[i_lo])) <= (torch.log(sig_vp[i_hi]) - log_s)
    return torch.where(pick_lo, i_lo, i_hi) + 1


def make_teacher_denoiser(teacher) -> Callable:
    """``denoise(model, x, sigma, y)``: a VE-frame denoiser D(x; sigma) ~
    E[x0 | x0 + sigma n = x], sigma per sample [B], over any teacher engine
    and its module ``model``:

    * ``edm``: the preconditioned denoiser at the exact sigma;
    * ``flow``: x_t = (1 - t) x0 + t e has sigma = t / (1 - t); x moves to
      the flow frame, the velocity is read at t, and x0 = x_t - t u;
    * table-trained (eps / v / x0): the eps view at the nearest timestep by
      sigma, then D = x - sigma eps with the exact sigma.

    A learned-sigma teacher is refused by ``consistency_student``, so an
    eps view gives C channels here."""
    pt = teacher.prediction_type
    if pt == "edm":
        sigma_data = teacher.edm.sigma_data

        def denoise(model, x, sigma, y):
            return edm_denoise(model, x, sigma, sigma_data, y)

        return denoise

    if pt == "flow":
        def denoise(model, x, sigma, y):
            t = sigma / (1.0 + sigma)  # the flow time of VE level sigma
            x_flow = x / (1.0 + _per_sample(sigma, x))
            u = model(x_flow, t * TIME_SCALE, y)
            return x_flow - _per_sample(t, x) * u

        return denoise

    tables = teacher.tables

    def denoise(model, x, sigma, y):
        t = _nearest_t_by_sigma(tables, sigma)
        sig = _per_sample(sigma, x)
        x_vp = x / torch.sqrt(1.0 + torch.square(sig))  # abar = 1 / (1 + sigma^2)
        return x - sig * teacher._view(model)(x_vp, t, y)

    return denoise


def make_cd_step(denoise_teacher: Callable, cfg: ConsistencyConfig,
                 tables: DiffusionTables) -> Callable[..., Dict]:
    """Build ``step(state, teacher_model, x0, y=None, *, index=None, z=None)``:
    one consistency-distillation step.  x_hi = x0 + sigma_hi z; the teacher
    (``denoise_teacher(teacher_model, ...)``, under ``no_grad``) takes one
    Heun step of dx/dsigma = (x - D)/sigma down to the adjacent level; the
    student's f(x_hi, sigma_hi) regresses f^-(x_lo, sigma_lo), f^- the live
    weights without gradients (``target="stopgrad"``, iCT) or the EMA
    weights (``"ema"``, the original CM), under the iCT metric and
    weighting.  The pair index and z come from the state's generator unless
    injected.  The student runs without dropout, as JAX's CD step applies
    it.  Metrics: ``loss``, ``grad_norm``.  Grid annealing is a CT device
    (the papers distill on one fixed grid): ``grid_init`` raises."""
    cfg.validate()
    if cfg.grid_init:
        raise ValueError("grid_init/anneal_steps (iCT N-annealing) apply to consistency "
                         "TRAINING only; distillation uses the fixed "
                         f"grid_size={cfg.grid_size} grid — clear grid_init")
    tabs = _grid_tables(cfg, tables.alphas_hat.device)

    def step(state: TrainState, teacher_model: Callable, x0: torch.Tensor,
             y: Optional[torch.Tensor] = None, *, index: Optional[torch.Tensor] = None,
             z: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        target = _target(cfg, state)
        x_hi, sig_hi, _, sig_lo, _ = _ct_parts(tabs, state.generator, x0, 0, index, z)
        hi, lo = _per_sample(sig_hi, x0), _per_sample(sig_lo, x0)
        with torch.no_grad():
            d1 = (x_hi - denoise_teacher(teacher_model, x_hi, sig_hi, y)) / hi
            x_euler = x_hi + (lo - hi) * d1
            d2 = (x_euler - denoise_teacher(teacher_model, x_euler, sig_lo, y)) / lo
            x_lo = x_hi + (lo - hi) * 0.5 * (d1 + d2)
        model = state.model
        model.eval().zero_grad(set_to_none=True)
        per_sample = _ct_per_sample_loss(model, (x_hi, sig_hi, x_lo, sig_lo), y, cfg, target)
        return _backward_and_apply(state, per_sample.mean(), _vp_bucket(tables, sig_hi),
                                   per_sample, False)

    return step


def _target(cfg: ConsistencyConfig, state: TrainState) -> Optional[torch.nn.Module]:
    """The target network f^- of ``cfg.target``: None (the live weights,
    without gradients) or the state's EMA weights, which must exist."""
    if cfg.target == "stopgrad":
        return None
    if state.ema_model is None:
        raise ValueError('consistency target="ema" needs EMA weights: set the engine\'s ema '
                         'decay (or use the default target "stopgrad")')
    return state.ema_model


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
        target = _target(cfg, state)
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


def consistency_student(teacher, lr: Optional[float] = None, ema: float = 0.995,
                        consistency_config: Optional[dict] = None,
                        use_ema_teacher: bool = True, warm_start: bool = True):
    """The consistency student of a teacher engine: the teacher's model
    config, schedule (its betas), optimizer (``lr`` overrides the rate) and
    device, ``prediction_type="consistency"``, its live and EMA weights
    copied from the teacher's (EMA ones with ``use_ema_teacher``) when
    ``warm_start``.  ``consistency_config`` defaults to an EDM teacher's own
    sigma frame (sigma_data, min, max, rho), else to ``ConsistencyConfig``'s.
    A learned-sigma (hybrid) teacher raises: its 2C-channel head cannot
    warm-start a C-channel f."""
    from ..engine import DiffusionEngine

    hp = dict(teacher.hparams)
    if dict(hp["model_config"]).get("learn_sigma") or hp.get("loss_type") == "hybrid":
        raise NotImplementedError(
            "distilling a learned-sigma (hybrid) teacher into a consistency model is not "
            "defined: f regresses a C-channel image, and warm-starting its head from a "
            "2C-channel teacher conv is shape-incompatible.  Distill an eps/v/x0/edm/flow "
            "teacher.")
    if consistency_config is None and teacher.prediction_type == "edm":
        e = teacher.edm
        consistency_config = dict(sigma_data=e.sigma_data, sigma_min=e.sigma_min,
                                  sigma_max=e.sigma_max, rho=e.rho)
    oc = dict(hp["optimizer_config"])
    if lr is not None:
        oc["lr"] = float(lr)
    student = DiffusionEngine(
        model_config=dict(hp["model_config"]), optimizer_config=oc,
        diffusion_steps=teacher.diffusion_steps, mode=hp.get("mode", "linear"),
        betas=teacher.schedule.betas, sigma_mode=hp.get("sigma_mode", "beta"),
        resolution=hp.get("resolution", 32),
        clip_while_generating=hp.get("clip_while_generating", False), ema=ema,
        seed=hp.get("seed", 0), prediction_type="consistency",
        consistency_config=consistency_config, in_channels=teacher.in_channels,
        device=teacher.device)
    if warm_start:
        src = teacher.params(use_ema=use_ema_teacher).state_dict()
        student.state.model.load_state_dict(src)
        if student.state.ema_model is not None:
            student.state.ema_model.load_state_dict(src)
    return student


def consistency_distill_round(student, teacher, batches: Iterable, log_every: int = 50,
                              log: Callable = print, use_ema_teacher: bool = True) -> Dict:
    """Train ``student`` by consistency distillation against ``teacher``
    over an iterable of x0 (or (x0, y)) batches; returns the last step's
    metrics as floats.  ``use_ema_teacher`` picks the teacher's weights for
    the targets; pass ``consistency_student`` the same value, so the warm
    start and the targets come from one weight set."""
    step = make_cd_step(make_teacher_denoiser(teacher), student.cm, student.tables)
    teacher_model = teacher.params(use_ema=use_ema_teacher).eval()
    last, n_steps = {}, 0
    for i, batch in enumerate(batches):
        x0, y = batch if isinstance(batch, (tuple, list)) else (batch, None)
        # labels reach a class-conditional student only, as in its train step
        last = step(student.state, teacher_model, student._batch(x0), student._cond(y))
        if log_every and i % log_every == 0:
            log(f"[consistency] step {i} loss={float(last['loss']):.5f}")
        n_steps += 1
    if n_steps == 0:
        raise ValueError("consistency_distill_round got zero batches: no training step would "
                         "run")
    return {k: float(v) for k, v in last.items()}
