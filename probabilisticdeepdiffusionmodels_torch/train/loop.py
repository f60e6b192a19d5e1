"""The training loop: epochs, validation, checkpoints and early stopping.

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/train/loop.py``:
  * epochs with validation every ``check_val_every_n_epoch``;
  * early stopping on val_loss after ``patience`` epochs without a new best;
  * a checkpoint at every validation, best-k on val_loss, and the best one
    restored at the end of ``fit``;
  * the EMA updated after every optimizer step (inside the train step);
  * per-epoch quartile losses loss_q1..4 and the per-t curve from the loss
    history on the device;
  * the grad norm of each logged step.
Metrics are read to the host only at the log cadence.  Not ported yet: the
fused K-step path (ROADMAP.md Queue 1 item 17) and the visualization
callback (item 15).
"""

from __future__ import annotations

import collections
import time
from typing import Dict, Optional

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


class Trainer:
    def __init__(
        self,
        engine: DiffusionEngine,
        run_dir: RunDir,
        logger: Optional[MetricLogger] = None,
        max_epochs: int = 100,
        check_val_every_n_epoch: int = 2,
        patience: int = 20,
        log_every_steps: int = 50,
        save_every_steps: Optional[int] = None,
        watch_every_steps: Optional[int] = None,
        prefetch: int = 2,
        fused_steps: int = 0,
    ):
        if int(fused_steps or 0) >= 2:
            raise NotImplementedError(
                f"fused_steps={fused_steps} is not ported yet (ROADMAP.md Queue 1 item 17)")
        self.engine = engine
        self.run_dir = run_dir
        self.logger = logger or MetricLogger(run_dir)
        self.max_epochs = max_epochs
        self.check_val_every_n_epoch = check_val_every_n_epoch
        self.patience = patience
        self.log_every_steps = log_every_steps
        # host -> device overlap (prefetch_to_device); 0 or 1 disables it
        self.prefetch = int(prefetch or 0)
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
            for x, y in batches:
                metrics = self.engine.training_step(x, y)
                step += 1
                if step % self.log_every_steps == 0:
                    self._log_train_row(metrics, step, epoch)
                if self.watch_every_steps and step % self.watch_every_steps == 0:
                    self._dump_weight_histograms(step)
                if self.save_every_steps and step % self.save_every_steps == 0:
                    self.ckpt.save(self.engine.state, step)

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

        # the best checkpoint goes into the engine before the final test
        best = self.ckpt.best_step()
        if best is not None:
            self.ckpt.restore(self.engine.state, best)
        self.logger.log_artifact(self.run_dir.checkpoint_dir(),
                                 f"{self.run_dir.name}-checkpoints")
        return {"best_val_loss": best_val, "steps": step}

    def _log_train_row(self, metrics, step, epoch):
        row = {"loss": float(metrics["loss"]),
               "total_grad_norm_L2": float(metrics["grad_norm"]), "epoch": epoch}
        for k, v in metrics.get("grad_norm_per_module", {}).items():
            row[f"grad_norm/{k}"] = float(v)
        self.logger.log(row, step=step)

    def _validate(self, val_loader, step) -> Dict[str, float]:
        """Mean val_loss (and val_loss_no_ema) over the val batches; batch i
        draws its t and noise from a generator seeded with ``step + i``."""
        losses, losses_no_ema = [], []
        for i, (x, y) in enumerate(val_loader):
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
        for name, p in self.engine.state.model.named_parameters():
            modules[name.split(".")[0]].append(p.detach().float().flatten())
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
        np.save(self.run_dir.media_path(f"loss_per_step_epoch{epoch}.npy"), avg)
        hist.reset_epoch()
