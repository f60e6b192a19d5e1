"""The training and validation steps.

PyTorch counterpart of ``make_train_step`` and ``make_eval_step`` in
``probabilisticdeepdiffusionmodels_tpu/train/step.py``.  One call of the train
step draws t (uniform or importance) and then the noise from the state's
generator (or takes them injected), noises x0, runs the model in train mode,
takes the MSE against the target of ``prediction_type`` (eps, v or x0) per
sample, weights it by min-SNR where asked, reduces it (the weighted loss is
SUMMED, the unweighted one MEANED), adds the IDDPM variational bound of a
learned-sigma head under ``loss_type="hybrid"``, backpropagates, records the
detached per-sample losses in the loss history, and applies the optimizer
and the EMA.  Nothing in it waits for the device: the metrics are device
tensors.  With ``class_dropout_prob`` the class-dropout draw follows t and
the noise; dropout (a model with ``dropout > 0``) draws its masks from the
state's generator after that, inside the forward.  A run with neither keeps
the stream of t and noise alone.

The EDM and flow-matching steps (``make_edm_train_step``,
``make_flow_train_step``) share that plumbing: the optimizer, the EMA, class
dropout and the loss history, into which each sample's loss goes at the VP
timestep its noise level or flow time falls on.  EDM draws sigma
log-normally and regresses the preconditioned denoiser on x0 (weighted by
lambda(sigma)); flow matching draws a continuous t and regresses the
straight line's velocity.  Consistency training is in ``train/consistency``.
Each eval step's ``draw(generator, x0)`` gives the draws it takes, so the
engine scores the live and the EMA weights on the same ones.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, Iterable, Optional

import torch

from ..core import diffusion as D
from ..core.diffusion import DiffusionTables
from ..core.edm import EDMConfig, loss_weight, precond
from ..core.flow import TIME_SCALE, FlowConfig, interpolate, sample_t, vp_t_to_flow_t
from ..parallel import mesh as P
from .samplers import importance_weights, sample_importance, sample_uniform
from .state import TrainState

__all__ = ["make_train_step", "make_eval_step", "make_edm_train_step", "make_edm_eval_step",
           "make_flow_train_step", "make_flow_eval_step", "make_fused_train_step",
           "CapturedSteps", "global_norm"]


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


def _check_dropout(class_dropout_prob: float, null_class: Optional[int]) -> None:
    if class_dropout_prob and null_class is None:
        raise ValueError("class_dropout_prob needs null_class (the index of the model's "
                         "cfg_null_class embedding row)")


def _drop_labels(state: TrainState, y: Optional[torch.Tensor], b: int, p: float,
                 null_class: Optional[int]) -> Optional[torch.Tensor]:
    """Class dropout: each label becomes ``null_class`` with probability p,
    from the state's generator (no draw at p = 0)."""
    if not p:
        return y
    if y is None:
        raise ValueError("class_dropout_prob needs labels every step")
    drop = P.rand((b,), generator=state.generator, device=y.device) < p
    return torch.where(drop, torch.full_like(y, null_class), y)


def _backward_and_apply(state: TrainState, loss: torch.Tensor, t_hist: torch.Tensor,
                        per_sample: torch.Tensor, watch: bool,
                        **scalars: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Backpropagate ``loss``, take the metrics (``loss``, the ``scalars``
    given, the gradients' global norm and, with ``watch``, per top-level
    module), record the detached per-sample losses at the timesteps
    ``t_hist`` and apply the optimizer and EMA.

    On a data mesh (``state.sync``) ``loss`` and ``scalars`` are this rank's
    shares of the global batch's: the gradients and the shares are summed
    over the ranks first, the norms are the global gradient's, and the loss
    history records the whole batch's (t, loss) rows."""
    loss.backward()
    named = list(state.model.named_parameters())
    sync = state.sync
    values = [loss.detach(), *(v.detach() for v in scalars.values())]
    if sync is not None:
        values = sync.reduce_gradients(state.model, values)
        t_hist, per_sample = sync.gather_history(t_hist, per_sample)
        grads = [p.grad for p in sync.optimizer_params(state.model)]
        norm = sync.grad_norms if sync.splits else None
    else:
        grads = [p.grad for _, p in named]
        norm = None
    metrics = dict(zip(["loss", *scalars], values))
    metrics["grad_norm"] = global_norm(grads) if norm is None else norm(grads)[0]
    if watch:
        modules = list(dict.fromkeys(name.split(".")[0] for name, _ in named))
        group = [modules.index(name.split(".")[0]) for name, _ in named]
        if norm is None:
            per = [global_norm(g for g, k in zip(grads, group) if k == i)
                   for i in range(len(modules))]
        else:
            per = list(norm(grads, group).unbind(0))
        metrics["grad_norm_per_module"] = dict(zip(modules, per))
    state.loss_history.update(t_hist, per_sample.detach())
    state.apply_gradients()
    return metrics


def _bucket(table: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """The 1-indexed timestep of each value on an ascending per-timestep
    table (the ceiling), for the loss history."""
    return torch.clamp(torch.searchsorted(table, values.contiguous()) + 1, 1, table.shape[0])


def _vlb_term(tables: DiffusionTables, x0: torch.Tensor, x_t: torch.Tensor, t: torch.Tensor,
              eps_pred: torch.Tensor, v_pred: torch.Tensor) -> torch.Tensor:
    """IDDPM L_vlb [B] in bits/dim for a learned-sigma head: the KL of the
    true posterior against the model's, and at t == 1 the discretized
    decoder NLL.  The mean is built from the DETACHED eps, so the bound
    trains only the variance head ``v_pred``."""
    model_logvar = D.learned_logvar(tables, t, v_pred, x0.ndim)
    model_mean = D.model_mean_from_epsilon(tables, x_t, t, eps_pred.detach())
    true_mean, true_var = D.q_posterior(tables, t, x0, x_t)
    kl = D.mean_flat(D.normal_kl(true_mean, torch.log(true_var), model_mean, model_logvar))
    decoder_nll = -D.mean_flat(D.discretized_gaussian_log_likelihood(
        x0, model_mean, 0.5 * model_logvar))
    ln2 = math.log(2.0)
    return torch.where(t == 1, decoder_nll / ln2, kl / ln2)


def _pred_target(tables: DiffusionTables, prediction_type: str, x0: torch.Tensor,
                 noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The regression target of ``prediction_type``: eps, v or x0."""
    if prediction_type == "epsilon":
        return noise
    if prediction_type == "v":
        return D.v_target(tables, x0, noise, t)
    return x0


def _pred_to_eps(tables: DiffusionTables, prediction_type: str, x_t: torch.Tensor,
                 t: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """A native prediction head as eps (for the bound)."""
    if prediction_type == "epsilon":
        return pred
    if prediction_type == "v":
        return D.eps_from_v(tables, x_t, t, pred)
    return D.eps_from_xstart(tables, x_t, t, pred)


def make_train_step(
    tables: DiffusionTables,
    *,
    sampling: str = "uniform",
    min_counts: int = 10,
    loss_type: str = "simple",
    vlb_weight: float = 1e-3,
    watch: bool = False,
    class_dropout_prob: float = 0.0,
    null_class: Optional[int] = None,
    prediction_type: str = "epsilon",
    loss_weighting: str = "none",
    snr_gamma: float = 5.0,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build ``step(state, x0, y=None, *, t=None, noise=None) -> metrics``.

    ``state`` is a ``TrainState`` and is updated in place.  ``t`` (1-indexed
    [B]) and ``noise`` (x0's shape) may be injected; an injected t under
    importance sampling is weighted from the state's own history
    (``1/(p[t-1]*B)`` once warmed up, ``1/B`` before).  Metrics: ``loss``,
    ``grad_norm`` (float32 global norm of the gradients before any
    clipping), ``vlb`` under ``loss_type="hybrid"`` (the batch mean of the
    bound, added to the loss times ``vlb_weight``) and, with ``watch``,
    ``grad_norm_per_module`` for each top-level module.

    ``loss_type="hybrid"`` needs a 2C-channel head: its first half is the
    prediction, its second the variance interpolation.  ``loss_weighting=
    "min_snr"`` multiplies each sample's MSE by ``min_snr_weight`` before
    the reduction and the loss history.  ``class_dropout_prob`` p > 0
    replaces each label by ``null_class`` with probability p.
    """
    T = tables.diffusion_steps
    if sampling not in ("uniform", "importance"):
        raise ValueError(f'Unknown sampling option: "{sampling}"')
    _check(prediction_type, loss_weighting)
    if loss_type not in ("simple", "hybrid"):
        raise ValueError(f'Unknown loss_type: "{loss_type}"')
    _check_dropout(class_dropout_prob, null_class)

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
            noise = P.randn(x0.shape, generator=state.generator, device=x0.device, dtype=x0.dtype)
        y = _drop_labels(state, y, b, class_dropout_prob, null_class)
        x_t = D.q_sample(tables, x0, noise, t)
        target = _pred_target(tables, prediction_type, x0, noise, t)

        model.train().zero_grad(set_to_none=True)
        out = model(x_t, t, y, generator=state.generator)
        pred, v_pred = out.chunk(2, dim=-1) if loss_type == "hybrid" else (out, None)
        per_sample = D.mean_flat(torch.square(target - pred))
        if loss_weighting == "min_snr":
            per_sample = per_sample * D.min_snr_weight(tables, t, snr_gamma, prediction_type)
        loss = (weights * per_sample).sum() if weights is not None else P.batch_mean(per_sample)
        if loss_type == "hybrid":
            vlb = P.batch_mean(_vlb_term(tables, x0, x_t, t,
                                         _pred_to_eps(tables, prediction_type, x_t, t, pred),
                                         v_pred))
            loss = loss + vlb_weight * vlb
            return _backward_and_apply(state, loss, t, per_sample, watch, vlb=vlb)
        return _backward_and_apply(state, loss, t, per_sample, watch)

    return step


def make_eval_step(tables: DiffusionTables, prediction_type: str = "epsilon",
                   loss_weighting: str = "none",
                   snr_gamma: float = 5.0) -> Callable[..., torch.Tensor]:
    """Build ``step(model, generator, x0, y=None, *, t=None, noise=None)``:
    the validation loss (uniform t, no weights, no dropout: the model is put
    in eval mode) of ``model``, against the target of ``prediction_type``
    and weighted as the train step weights it; pass ``state.model`` or
    ``state.ema_model``.  A 2C-channel head is scored on its first half."""
    T = tables.diffusion_steps
    _check(prediction_type, loss_weighting)

    @torch.no_grad()
    def step(model: torch.nn.Module, generator: torch.Generator, x0: torch.Tensor,
             y: Optional[torch.Tensor] = None, *, t: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        if t is None:
            t, _ = sample_uniform(generator, x0.shape[0], T)
        if noise is None:
            noise = P.randn(x0.shape, generator=generator, device=x0.device, dtype=x0.dtype)
        t = t.to(x0.device)
        model.eval()
        target = _pred_target(tables, prediction_type, x0, noise, t)
        out = model(D.q_sample(tables, x0, noise, t), t, y)
        pred = out.chunk(2, dim=-1)[0] if out.shape[-1] == 2 * x0.shape[-1] else out
        per_sample = D.mean_flat(torch.square(target - pred))
        if loss_weighting == "min_snr":
            per_sample = per_sample * D.min_snr_weight(tables, t, snr_gamma, prediction_type)
        return P.batch_mean(per_sample)

    def draw(generator: torch.Generator, x0: torch.Tensor) -> Dict[str, torch.Tensor]:
        t, _ = sample_uniform(generator, x0.shape[0], T)
        return {"t": t, "noise": P.randn(x0.shape, generator=generator, device=x0.device,
                                         dtype=x0.dtype)}

    step.draw = draw
    return step


# ------------------------------------------------------------- EDM


def _edm_sigma(generator: Optional[torch.Generator], b: int, edm: EDMConfig,
               device) -> torch.Tensor:
    """sigma of each sample: ln sigma ~ N(P_mean, P_std^2) (eq. 8)."""
    return torch.exp(edm.P_mean + edm.P_std * P.randn((b,), generator=generator, device=device))


def _edm_per_sample_loss(model: Callable, edm: EDMConfig, x0: torch.Tensor, sigma: torch.Tensor,
                         noise: torch.Tensor, y: Optional[torch.Tensor],
                         **kwargs) -> torch.Tensor:
    """lambda(sigma) times the pixel mean of (D(x0 + sigma n; sigma) - x0)^2."""
    sig_img = sigma.reshape((-1,) + (1,) * (x0.ndim - 1))
    x_sigma = x0 + sig_img * noise
    c_skip, c_out, c_in, c_noise = precond(sig_img, edm.sigma_data)
    out = model(c_in * x_sigma, c_noise.reshape(-1), y, **kwargs)
    denoised = c_skip * x_sigma + c_out * out
    return loss_weight(sigma, edm.sigma_data) * D.mean_flat(torch.square(denoised - x0))


def make_edm_train_step(tables: DiffusionTables, edm: EDMConfig, *, watch: bool = False,
                        class_dropout_prob: float = 0.0,
                        null_class: Optional[int] = None) -> Callable[..., Dict]:
    """Build ``step(state, x0, y=None, *, sigma=None, noise=None)``: the EDM
    train step (arXiv:2206.00364 section 5).  sigma [B] and then the noise
    are drawn from the state's generator unless injected.  ``tables``
    serve only the loss history, bucketed by the schedule's sigma table."""
    _check_dropout(class_dropout_prob, null_class)
    sig_vp = torch.sqrt((1.0 - tables.alphas_hat) / tables.alphas_hat)

    def step(state: TrainState, x0: torch.Tensor, y: Optional[torch.Tensor] = None, *,
             sigma: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        model, b = state.model, x0.shape[0]
        if sigma is None:
            sigma = _edm_sigma(state.generator, b, edm, x0.device)
        if noise is None:
            noise = P.randn(x0.shape, generator=state.generator, device=x0.device, dtype=x0.dtype)
        y = _drop_labels(state, y, b, class_dropout_prob, null_class)
        model.train().zero_grad(set_to_none=True)
        per_sample = _edm_per_sample_loss(model, edm, x0, sigma, noise, y,
                                          generator=state.generator)
        return _backward_and_apply(state, P.batch_mean(per_sample), _bucket(sig_vp, sigma),
                                   per_sample, watch)

    return step


def make_edm_eval_step(edm: EDMConfig) -> Callable[..., torch.Tensor]:
    """``step(model, generator, x0, y=None, *, sigma=None, noise=None)``: the
    EDM loss of ``model`` in eval mode under the train step's draws."""

    @torch.no_grad()
    def step(model: torch.nn.Module, generator: torch.Generator, x0: torch.Tensor,
             y: Optional[torch.Tensor] = None, *, sigma: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        if sigma is None:
            d = draw(generator, x0)
            sigma, noise = d["sigma"], d["noise"] if noise is None else noise
        model.eval()
        return P.batch_mean(_edm_per_sample_loss(model, edm, x0, sigma.to(x0.device), noise, y))

    def draw(generator: torch.Generator, x0: torch.Tensor) -> Dict[str, torch.Tensor]:
        sigma = _edm_sigma(generator, x0.shape[0], edm, x0.device)
        return {"sigma": sigma, "noise": P.randn(x0.shape, generator=generator,
                                                 device=x0.device, dtype=x0.dtype)}

    step.draw = draw
    return step


# ------------------------------------------------------------- flow matching


def _flow_per_sample_loss(model: Callable, x0: torch.Tensor, t: torch.Tensor,
                          noise: torch.Tensor, y: Optional[torch.Tensor],
                          **kwargs) -> torch.Tensor:
    """The pixel mean of (F(x_t, t * 1000) - (e - x0))^2."""
    x_t, u = interpolate(x0, noise, t)
    out = model(x_t, t * TIME_SCALE, y, **kwargs)
    return D.mean_flat(torch.square(out - u))


def make_flow_train_step(tables: DiffusionTables, flow: FlowConfig, *, watch: bool = False,
                         class_dropout_prob: float = 0.0,
                         null_class: Optional[int] = None) -> Callable[..., Dict]:
    """Build ``step(state, x0, y=None, *, t=None, noise=None)``: the
    flow-matching train step (arXiv:2210.02747).  The flow times t [B] and
    then the noise are drawn from the state's generator unless injected.
    ``tables`` serve only the loss history, bucketed by each VP step's flow
    time."""
    _check_dropout(class_dropout_prob, null_class)
    t_flow_of_vp = vp_t_to_flow_t(tables.alphas_hat)

    def step(state: TrainState, x0: torch.Tensor, y: Optional[torch.Tensor] = None, *,
             t: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        model, b = state.model, x0.shape[0]
        if t is None:
            t = sample_t(state.generator, b, flow, x0.device)
        if noise is None:
            noise = P.randn(x0.shape, generator=state.generator, device=x0.device, dtype=x0.dtype)
        y = _drop_labels(state, y, b, class_dropout_prob, null_class)
        model.train().zero_grad(set_to_none=True)
        per_sample = _flow_per_sample_loss(model, x0, t, noise, y, generator=state.generator)
        return _backward_and_apply(state, P.batch_mean(per_sample), _bucket(t_flow_of_vp, t),
                                   per_sample, watch)

    return step


def make_flow_eval_step(flow: FlowConfig) -> Callable[..., torch.Tensor]:
    """``step(model, generator, x0, y=None, *, t=None, noise=None)``: the
    flow-matching loss of ``model`` in eval mode under the train step's
    draws."""

    @torch.no_grad()
    def step(model: torch.nn.Module, generator: torch.Generator, x0: torch.Tensor,
             y: Optional[torch.Tensor] = None, *, t: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        if t is None:
            d = draw(generator, x0)
            t, noise = d["t"], d["noise"] if noise is None else noise
        model.eval()
        return P.batch_mean(_flow_per_sample_loss(model, x0, t.to(x0.device), noise, y))

    def draw(generator: torch.Generator, x0: torch.Tensor) -> Dict[str, torch.Tensor]:
        t = sample_t(generator, x0.shape[0], flow, x0.device)
        return {"t": t, "noise": P.randn(x0.shape, generator=generator, device=x0.device,
                                         dtype=x0.dtype)}

    step.draw = draw
    return step


# ------------------------------------------------------------- K fused steps


def _stack(rows: list) -> Dict:
    """The rows' metrics stacked along a new axis 0, nested dicts too (a
    host number, such as the CT grid size, stacks on the host)."""
    out = {}
    for key, first in rows[0].items():
        values = [row[key] for row in rows]
        if isinstance(first, dict):
            out[key] = _stack(values)
        elif all(isinstance(v, torch.Tensor) for v in values):
            out[key] = torch.stack(values)
        else:
            out[key] = torch.tensor(values)
    return out


def _clone(metrics: Dict) -> Dict:
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in metrics.items()}


class CapturedSteps:
    """K train steps of ``step`` on one train state as one CUDA graph.

    The graph reads its batches from static buffers ``xs`` [K, B, ...] and
    ``ys`` [K, B] (or none), injected draws (``draws``: name -> [K, B, ...],
    each step's row handed to ``step`` by name, as ``training_step`` takes
    them) from more, and the optimizer's per-update scalars from a
    device table (``AdamChain.table_update``); everything else it touches
    (parameters, EMA, Adam's moments, the accumulation buffer, the loss
    history, the state's generator, registered with the graph) keeps its
    address, and its intermediates live in the graph's private pool, so
    every kernel, the conv's TMA maps among them, finds its operands where
    the capture saw them.

    The first call is the warm-up that capture needs: the K steps run as
    they will in the graph, eagerly, on the capture stream (their work is
    the call's work), then the same steps are captured from the same host
    counts (capture records and runs nothing).  Every later call copies its
    chunk into the buffers, writes the table from the host's update count
    (pinned, asynchronous: no sync), replays, and moves the host counts
    (``state.step``, ``AdamChain.advance``) and the parameters' version
    counters, which a replay changes without the host seeing it.  A capture
    that fails raises.  ``capture=False`` runs the graph's steps eagerly on
    every call, on any device: the graph's arithmetic and bookkeeping
    without the graph, for tests on the CPU.

    On a mesh (``state.sync``) the steps' collectives (the gradient
    all-reduce, the history's all-gather, a sharded norm's all-reduce) are
    recorded on the capture stream with the rest, so a replay runs them;
    NCCL's can be captured, gloo's cannot (``engine.training_steps``
    refuses a CUDA mesh over gloo).  The capture then checks only its own
    thread's CUDA calls, since the process group's watchdog thread keeps
    polling while the graph is captured.
    """

    def __init__(self, step: Callable, state: TrainState, xs: torch.Tensor,
                 ys: Optional[torch.Tensor] = None, capture: bool = True,
                 draws: Optional[Dict[str, torch.Tensor]] = None):
        self.step, self.state, self.k = step, state, xs.shape[0]
        self.xs = torch.empty_like(xs, memory_format=torch.contiguous_format)
        self.ys = None if ys is None else torch.empty_like(ys,
                                                           memory_format=torch.contiguous_format)
        self.draws = {k: torch.empty_like(v, memory_format=torch.contiguous_format)
                      for k, v in (draws or {}).items()}
        self.table = torch.zeros((self.k, 2), dtype=torch.float32, device=xs.device)
        state.optimizer.init_state()
        self.capture = capture
        self.graph = None
        self.stream = torch.cuda.Stream(xs.device) if capture else None
        self.static_metrics = None
        self.captures = 0
        self.capture_seconds = None

    def _body(self) -> Dict:
        with self.state.optimizer.table_updates(self.table):
            rows = [self.step(self.state, self.xs[i], None if self.ys is None else self.ys[i],
                              **{k: v[i] for k, v in self.draws.items()})
                    for i in range(self.k)]
        return _stack(rows)

    def _host(self):
        return self.state.step, self.state.optimizer.updates, self.state.optimizer.mini_step

    def _set_host(self, counts) -> None:
        self.state.step, self.state.optimizer.updates, self.state.optimizer.mini_step = counts

    def _advance(self, counts) -> None:
        """Host counts ``counts`` moved by the K steps just run."""
        self._set_host(counts)
        self.state.step += self.k
        self.state.optimizer.advance(self.k)

    def __call__(self, xs: torch.Tensor, ys: Optional[torch.Tensor] = None,
                 draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
        self.xs.copy_(xs)
        if self.ys is not None:
            self.ys.copy_(ys)
        for k, v in (draws or {}).items():
            self.draws[k].copy_(v)
        rows = self.state.optimizer.update_scalars(self.k)
        pin = self.table.device.type == "cuda"
        self.table.copy_(rows.pin_memory() if pin else rows, non_blocking=pin)
        counts = self._host()
        if not self.capture:
            metrics = self._body()
            self._advance(counts)
            return metrics
        if self.graph is None:
            return self._warm_up_and_capture(counts)
        self.graph.replay()
        self._advance(counts)
        self._bump_versions()
        return _clone(self.static_metrics)

    def _warm_up_and_capture(self, counts) -> Dict:
        current = torch.cuda.current_stream(self.xs.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            metrics = self._body()
        current.wait_stream(self.stream)
        self._advance(counts)
        after = self._host()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.state.generator)
        t_start = time.perf_counter()
        try:
            # the capture sees the host counts the warm-up started from
            # (the accumulation phase, the step a CT grid level reads)
            self._set_host(counts)
            mode = "global" if self.state.sync is None else "thread_local"
            with torch.cuda.graph(graph, stream=self.stream, capture_error_mode=mode):
                self.static_metrics = self._body()
        finally:
            self._set_host(after)
        self.capture_seconds = time.perf_counter() - t_start
        self.graph = graph
        self.captures += 1
        return metrics

    def _bump_versions(self) -> None:
        """The replay changed the live and EMA parameters in place where
        autograd's version counters cannot see it; code that caches by
        version (``ops.gn_conv._weight_in``) must see a change."""
        from torch.autograd.graph import increment_version

        models = [self.state.model] + ([self.state.ema_model]
                                       if self.state.ema_model is not None else [])
        for model in models:
            for p in model.parameters():
                increment_version(p)


def make_fused_train_step(step: Callable) -> Callable[..., Dict]:
    """Fuse K train steps into one dispatch: ``fused(state, xs, ys=None,
    **draws)`` over stacked ``[K, B, ...]`` batches (labels ``[K, B]``, the
    steps' injected draws ``[K, B, ...]`` each), metrics stacked ``[K]``
    each, one row a step.

    On a CUDA device the K steps are one captured CUDA graph
    (``CapturedSteps``), one per (K, batch shape and dtype, label presence,
    accumulation phase, and what ``step.host_key(state, K)`` names where the
    step bakes host values, such as a CT grid level); a state whose
    optimizer loaded new tensors (``AdamChain.generation``) drops its
    graphs.  A host key is a tuple whose first value never falls as the
    state's step grows, so a graph whose first value is below the current
    chunk's cannot be replayed again and is dropped with its memory pool.
    On the CPU there is no graph: the K steps run eagerly, the same as K
    calls of ``step``.  ``fused.graphs`` holds the captured chunks and
    ``fused.graph_for(state, xs, ys)`` finds (or makes) the one a call
    replays."""
    graphs: Dict[tuple, CapturedSteps] = {}
    owner = [None]
    host_key = getattr(step, "host_key", None)

    def graph_for(state: TrainState, xs: torch.Tensor, ys: Optional[torch.Tensor] = None,
                  draws: Optional[Dict[str, torch.Tensor]] = None) -> CapturedSteps:
        opt = state.optimizer
        if owner[0] != (id(state), opt.generation):
            graphs.clear()
            owner[0] = (id(state), opt.generation)
        host = None if host_key is None else host_key(state, xs.shape[0])
        if host is not None:
            for old in [key for key in graphs if key[-1][0] < host[0]]:
                del graphs[old]
        key = (tuple(xs.shape), xs.dtype,
               None if ys is None else (tuple(ys.shape), ys.dtype),
               tuple((k, tuple(v.shape), v.dtype) for k, v in sorted((draws or {}).items())),
               opt.mini_step, host)
        chunk = graphs.get(key)
        if chunk is None:
            chunk = graphs[key] = CapturedSteps(step, state, xs, ys, draws=draws)
        return chunk

    def fused(state: TrainState, xs: torch.Tensor, ys: Optional[torch.Tensor] = None,
              **draws: torch.Tensor) -> Dict:
        if xs.device.type != "cuda":
            return _stack([step(state, xs[i], None if ys is None else ys[i],
                                **{k: v[i] for k, v in draws.items()})
                           for i in range(xs.shape[0])])
        return graph_for(state, xs, ys, draws)(xs, ys, draws)

    fused.graphs, fused.graph_for = graphs, graph_for
    return fused
