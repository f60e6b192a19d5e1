"""Checkpoints of the train state, with best-k retention on val_loss.

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/train/checkpoint.py``
on ``torch.save`` / ``torch.load`` in place of Orbax, with Orbax's policy as
the JAX package configures it: ``max_to_keep`` checkpoints with a
``val_loss`` are kept, the lowest first (ties: the later save); a save
without metrics is never deleted and never counts as best; a step at or
below the latest saved one is not saved again.

Each checkpoint is ``<directory>/<step>/state.pt`` (step, model, EMA model,
optimizer chain, loss history, the state generator's state) beside
``metrics.json``; a step's directory is written under a temporary name and
renamed when complete.  The experiment config lives in the run directory, so
a run can be rebuilt from it alone.
"""

from __future__ import annotations

import json
import math
import shutil
from pathlib import Path
from typing import List, Optional, Tuple

import torch

from .state import TrainState

__all__ = ["CheckpointManager"]

_HISTORY = ("ring", "ring_pos", "count", "epoch_sum", "epoch_count")


class CheckpointManager:
    def __init__(self, directory: Path, max_to_keep: int = 2):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        # (step, metrics or None), ascending in step
        self._saved: List[Tuple[int, Optional[dict]]] = []
        for path in sorted((p for p in self.directory.iterdir()
                            if p.name.isdigit() and (p / "state.pt").exists()),
                           key=lambda p: int(p.name)):
            metrics = json.loads((path / "metrics.json").read_text())
            self._saved.append((int(path.name), metrics))

    def save(self, state: TrainState, step: int, metrics: Optional[dict] = None) -> bool:
        """Save ``state`` as ``step`` unless a step >= it is saved already;
        then delete what the retention policy drops.  Returns whether it saved."""
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        metrics = {k: float(v) for k, v in metrics.items()} if metrics else None
        tmp = self.directory / f"{step}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(_to_saveable(state), tmp / "state.pt")
        (tmp / "metrics.json").write_text(json.dumps(metrics))
        tmp.rename(self.directory / str(step))
        self._saved.append((step, metrics))
        keep = self._kept()
        for s, _ in self._saved:
            if s not in keep:
                shutil.rmtree(self.directory / str(s))
        self._saved = [entry for entry in self._saved if entry[0] in keep]
        return True

    def _by_metric(self) -> List[int]:
        """Steps with metrics, worst first, best last (stable for ties)."""
        scored = [(s, m) for s, m in self._saved if m is not None]
        ranked = sorted(scored, key=lambda e: e[1].get("val_loss", math.inf), reverse=True)
        return [s for s, _ in ranked]

    def _kept(self) -> set:
        if len(self._saved) <= self.max_to_keep:
            return {s for s, _ in self._saved}
        best = self._by_metric()[-self.max_to_keep:] if self.max_to_keep else []
        return set(best) | {s for s, m in self._saved if m is None}

    def latest_step(self) -> Optional[int]:
        return self._saved[-1][0] if self._saved else None

    def best_step(self) -> Optional[int]:
        """The step with the lowest val_loss; None if no save had metrics."""
        ranked = self._by_metric()
        return ranked[-1] if ranked else None

    def restore(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        """Load checkpoint ``step`` (default: the latest) into ``state`` in
        place, every tensor onto the state's device; returns ``state``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        device = next(state.model.parameters()).device
        saved = torch.load(self.directory / str(step) / "state.pt", map_location=device,
                           weights_only=True)
        state.step = int(saved["step"])
        state.model.load_state_dict(saved["model"])
        if state.ema_model is not None:
            state.ema_model.load_state_dict(saved["ema_model"])
        state.optimizer.load_state_dict(saved["optimizer"])
        for name in _HISTORY:
            getattr(state.loss_history, name).copy_(saved["loss_history"][name])
        # a generator's state is a host byte tensor, whatever its device
        state.generator.set_state(saved["generator"].cpu())
        return state


def _to_saveable(state: TrainState) -> dict:
    return {
        "step": state.step,
        "model": state.model.state_dict(),
        "ema_model": None if state.ema_model is None else state.ema_model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "loss_history": {name: getattr(state.loss_history, name) for name in _HISTORY},
        "generator": state.generator.get_state(),
    }
