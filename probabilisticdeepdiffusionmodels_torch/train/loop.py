"""The training loop: epochs, validation, checkpoints and early stopping.

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/train/loop.py``:
  * epochs with validation every ``check_val_every_n_epoch``;
  * early stopping on val_loss after ``patience`` epochs without a new best;
  * a checkpoint at every validation, best-k on val_loss, and the best one
    restored at the end of ``fit``;
  * the EMA updated after every optimizer step (inside the train step);
  * per-epoch quartile losses loss_q1..4 and the per-t curve from the loss
    history on the device;
  * the grad norm of each logged step;
  * validation over at most ``limit_val_batches`` batches;
  * the visualization callback every ``vis_run_every`` epochs and once at
    the end of training.
Metrics are read to the host only at the log cadence.  On a data mesh every
rank runs ``fit`` (the engine's steps, validation and checkpoint saves are
collective); only the engine's main rank writes media.  With
``fused_steps`` K >= 2 each run of K same-shaped batches goes to
``engine.training_steps`` (one CUDA graph on a card); the log, histogram
and checkpoint cadences fire where a chunk crosses them and read its last
row; batches that make no whole chunk (a ragged batch, a short last chunk)
take the per-step path, so an epoch captures one graph.  Prefetch works in
both modes.
"""

from __future__ import annotations

import collections
import itertools
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..engine import DiffusionEngine
from ..logging.sink import MetricLogger, RunDir
from .checkpoint import CheckpointManager

__all__ = ["Trainer", "prefetch_to_device"]


def prefetch_to_device(loader, device, size: int = 2):
    """Yield the (x, y) batches of ``loader`` as tensors on ``device``,
    ``size - 1`` batches ahead: on a CUDA device each host batch is copied
    from pinned memory with ``non_blocking``, so the copy of the next batch
    overlaps the step on this one."""
    device = torch.device(device)
    pin = device.type == "cuda"

    def put(v):
        if v is None:
            return None
        t = torch.as_tensor(v)
        if t.device.type == device.type:
            return t  # already there (data.DeviceDataLoader), or no copy to make
        if pin:
            t = t.pin_memory()
        return t.to(device, non_blocking=pin)

    buf = collections.deque()
    for x, y in loader:
        buf.append((put(x), put(y)))
        if len(buf) >= size:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


def _stack_batches(values):
    """Batches (or labels) stacked on a new axis 0: tensors where they are,
    host arrays on the host; None where any is None."""
    if any(v is None for v in values):
        return None
    if all(isinstance(v, torch.Tensor) for v in values):
        return torch.stack(values)
    return np.stack([np.asarray(v) for v in values])


class Trainer:
    def __init__(
        self,
        engine: DiffusionEngine,
        run_dir: RunDir,
        logger: Optional[MetricLogger] = None,
        max_epochs: int = 100,
        check_val_every_n_epoch: int = 2,
        patience: int = 20,
        limit_val_batches: Optional[int] = None,
        visualization_callback: Optional[Callable] = None,
        vis_run_every: int = 5,
        log_every_steps: int = 50,
        save_every_steps: Optional[int] = None,
        watch_every_steps: Optional[int] = None,
        prefetch: int = 2,
        fused_steps: int = 0,
    ):
        self.engine = engine
        self.run_dir = run_dir
        self.logger = logger or MetricLogger(run_dir)
        self.max_epochs = max_epochs
        self.check_val_every_n_epoch = check_val_every_n_epoch
        self.patience = patience
        self.limit_val_batches = limit_val_batches
        self.vis = visualization_callback
        self.vis_run_every = vis_run_every
        self.log_every_steps = log_every_steps
        # host -> device overlap (prefetch_to_device); 0 or 1 disables it
        self.prefetch = int(prefetch or 0)
        # K >= 2: K train steps a dispatch (engine.training_steps)
        self.fused_steps = int(fused_steps or 0)
        self.save_every_steps = save_every_steps
        self.watch_every_steps = watch_every_steps
        self.ckpt = CheckpointManager(run_dir.checkpoint_dir())

    def fit(self, train_loader, val_loader) -> Dict[str, float]:
        best_val = float("inf")
        epochs_since_best = 0
        step = self.engine.state.step

        for epoch in range(self.max_epochs):
            t0 = time.time()
            batches = (prefetch_to_device(train_loader, self.engine.device, self.prefetch)
                       if self.prefetch >= 2 else train_loader)
            if self.fused_steps >= 2:
                step = self._run_fused_epoch(batches, epoch, step)
            else:
                for x, y in batches:
                    step = self._single_step(x, y, step, epoch)

            self._log_epoch_loss_stats(epoch, step)
            self.logger.log({"epoch_time_s": time.time() - t0, "epoch": epoch}, step=step)

            if (epoch + 1) % self.check_val_every_n_epoch == 0:
                val = self._validate(val_loader, step)
                self.logger.log({**val, "epoch": epoch}, step=step)
                self.ckpt.save(self.engine.state, step, metrics=val)
                if val["val_loss"] < best_val:
                    best_val = val["val_loss"]
                    epochs_since_best = 0
                else:
                    epochs_since_best += self.check_val_every_n_epoch
                    if epochs_since_best >= self.patience:
                        print(f"[train] early stop at epoch {epoch}")
                        break

            if self.vis is not None and (epoch + 1) % self.vis_run_every == 0:
                self.vis(self.engine, epoch)

        if self.vis is not None:
            self.vis(self.engine, -1)  # the train-end pass
        # the best checkpoint goes into the engine before the final test
        best = self.ckpt.best_step()
        if best is not None:
            self.ckpt.restore(self.engine.state, best)
        self.logger.log_artifact(self.run_dir.checkpoint_dir(),
                                 f"{self.run_dir.name}-checkpoints")
        return {"best_val_loss": best_val, "steps": step}

    def _log_train_row(self, metrics, step, epoch, last_of_chunk=False):
        """One metrics row; a fused chunk's stacked metrics give their last
        row."""
        def scalar(v):
            return float(v[-1] if last_of_chunk else v)

        row = {"loss": scalar(metrics["loss"]),
               "total_grad_norm_L2": scalar(metrics["grad_norm"]), "epoch": epoch}
        for k, v in metrics.get("grad_norm_per_module", {}).items():
            row[f"grad_norm/{k}"] = scalar(v)
        self.logger.log(row, step=step)

    def _step_cadence(self, prev, step, metrics, epoch, fused):
        """The log, histogram and checkpoint actions whose cadence the step
        count crossed going from ``prev`` to ``step`` (a chunk crosses them
        inside, so each is a crossing of a multiple, not a modulo)."""
        if step // self.log_every_steps != prev // self.log_every_steps:
            self._log_train_row(metrics, step, epoch, last_of_chunk=fused)
        if self.watch_every_steps and (step // self.watch_every_steps
                                       != prev // self.watch_every_steps):
            self._dump_weight_histograms(step)
        if self.save_every_steps and (step // self.save_every_steps
                                      != prev // self.save_every_steps):
            self.ckpt.save(self.engine.state, step)

    def _run_fused_epoch(self, batches, epoch, step):
        """One epoch in chunks of K same-shaped batches through
        ``engine.training_steps``; the batches that make no whole chunk (a
        partial chunk cut by a batch of another shape, the epoch's short
        last chunk) run one step each, so no chunk of another K is captured.
        Returns the step count."""
        k, buf, shape = self.fused_steps, [], None
        for x, y in batches:
            if buf and tuple(x.shape) != shape:
                for bx, by in buf:
                    step = self._single_step(bx, by, step, epoch)
                buf.clear()
            shape = tuple(x.shape)
            buf.append((x, y))
            if len(buf) == k:
                metrics = self.engine.training_steps(_stack_batches([b[0] for b in buf]),
                                                     _stack_batches([b[1] for b in buf]))
                buf.clear()
                self._step_cadence(step, step + k, metrics, epoch, True)
                step += k
        for bx, by in buf:
            step = self._single_step(bx, by, step, epoch)
        return step

    def _single_step(self, x, y, step, epoch):
        self._step_cadence(step, step + 1, self.engine.training_step(x, y), epoch, False)
        return step + 1

    def _validate(self, val_loader, step) -> Dict[str, float]:
        """Mean val_loss (and val_loss_no_ema) over the val batches, at most
        ``limit_val_batches`` of them; batch i draws its t and noise from a
        generator seeded with ``step + i``."""
        losses, losses_no_ema = [], []
        batches = itertools.islice(val_loader, self.limit_val_batches)
        for i, (x, y) in enumerate(batches):
            generator = torch.Generator(self.engine.device).manual_seed(step + i)
            out = self.engine.validation_step(x, generator, y)
            losses.append(float(out["val_loss"]))
            if "val_loss_no_ema" in out:
                losses_no_ema.append(float(out["val_loss_no_ema"]))
        result = {"val_loss": float(np.mean(losses))}
        if losses_no_ema:
            result["val_loss_no_ema"] = float(np.mean(losses_no_ema))
        return result

    def _dump_weight_histograms(self, step):
        """64-bin weight histograms per top-level module, one npz in the
        run's media directory, plus each module's std and largest |weight|
        in the metric log."""
        modules = collections.defaultdict(list)
        sync = self.engine.state.sync
        # on a mesh the whole weights (FSDP's or tp's shards gathered; a collective)
        named = (self.engine.params().named_parameters() if sync is None
                 else sync.state_dict("model").items())
        for name, p in named:
            modules[name.split(".")[0]].append(p.detach().float().flatten())
        if not self.engine.is_main:
            return
        arrays, summary = {}, {}
        for name, leaves in modules.items():
            flat = torch.cat(leaves).cpu().numpy()
            counts, edges = np.histogram(flat, bins=64)
            arrays[f"{name}/counts"] = counts
            arrays[f"{name}/edges"] = edges
            summary[f"weights/{name}/std"] = float(flat.std())
            summary[f"weights/{name}/absmax"] = float(np.abs(flat).max())
        np.savez(self.run_dir.media_path(f"weights_hist_step{step}.npz"), **arrays)
        self.logger.log(summary, step=step)

    def _log_epoch_loss_stats(self, epoch, step):
        """Quartile losses and the per-t curve of the epoch, then the epoch's
        sums in the loss history set back to 0."""
        hist = self.engine.state.loss_history
        avg = hist.avg_per_step_epoch().cpu().numpy()
        cnt = hist.epoch_count.cpu().numpy()
        T = avg.shape[0]
        qs = {}
        for i in range(4):
            lo = max(1, int(i * T / 4))
            hi = int((i + 1) * T / 4)
            sl = slice(lo - 1, hi - 1 if hi > lo else lo)
            w = cnt[sl].sum()
            qs[f"loss_q{i + 1}"] = float((avg[sl] * cnt[sl]).sum() / w) if w > 0 else float("nan")
        self.logger.log({**qs, "epoch": epoch}, step=step)
        if self.engine.is_main:
            np.save(self.run_dir.media_path(f"loss_per_step_epoch{epoch}.npy"), avg)
        hist.reset_epoch()
