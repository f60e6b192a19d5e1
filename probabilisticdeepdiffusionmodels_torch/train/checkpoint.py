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

On a mesh (``state.sync``) every rank calls ``save`` and ``restore``: an
FSDP or tensor-parallel state is gathered whole first (a collective), rank 0
writes, and the others wait at a barrier, so a checkpoint of N ranks is the
one-device checkpoint and loads on one device; a restore cuts it to the
rank's shards.
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
        payload = _to_saveable(state)
        writes = state.sync is None or state.sync.is_main
        if writes:
            tmp = self.directory / f"{step}.tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            tmp.mkdir()
            torch.save(payload, tmp / "state.pt")
            (tmp / "metrics.json").write_text(json.dumps(metrics))
            tmp.rename(self.directory / str(step))
        self._saved.append((step, metrics))
        keep = self._kept()
        for s, _ in self._saved:
            if s not in keep and writes:
                shutil.rmtree(self.directory / str(s))
        self._saved = [entry for entry in self._saved if entry[0] in keep]
        if state.sync is not None:
            state.sync.barrier()
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
        sync = state.sync
        if sync is None:
            state.model.load_state_dict(saved["model"])
            if state.ema_model is not None:
                state.ema_model.load_state_dict(saved["ema_model"])
        else:
            sync.load_full("model", saved["model"])
            if state.ema_model is not None:
                sync.load_full("ema", saved["ema_model"])
            saved["optimizer"] = _map_moments(saved["optimizer"], sync.shard_moments)
        state.optimizer.load_state_dict(saved["optimizer"])
        for name in _HISTORY:
            getattr(state.loss_history, name).copy_(saved["loss_history"][name])
        # a generator's state is a host byte tensor, whatever its device
        state.generator.set_state(saved["generator"].cpu())
        return state


def _map_moments(opt: dict, fn) -> dict:
    """An ``AdamChain.state_dict`` with ``fn`` applied to its per-parameter
    lists (Adam's two moments, the accumulation buffer); the optimizer's
    own tensors are not touched.  Adam holds a state for every parameter or
    for none (``AdamChain`` steps them all)."""
    adam = dict(opt["adam"], state={k: dict(v) for k, v in opt["adam"]["state"].items()})
    keys = sorted(adam["state"])
    for name in ("exp_avg", "exp_avg_sq") if keys else ():
        for k, v in zip(keys, fn([adam["state"][k][name] for k in keys])):
            adam["state"][k][name] = v
    return dict(opt, adam=adam, acc=None if opt["acc"] is None else fn(opt["acc"]))


def _to_saveable(state: TrainState) -> dict:
    sync = state.sync
    if sync is None:
        model = state.model.state_dict()
        ema = None if state.ema_model is None else state.ema_model.state_dict()
    else:
        model = sync.state_dict("model")
        ema = None if state.ema_model is None else sync.state_dict("ema")
    optimizer = state.optimizer.state_dict()
    if sync is not None and sync.splits:
        optimizer = _map_moments(optimizer, sync.gather_moments)
    return {
        "step": state.step,
        "model": model,
        "ema_model": ema,
        "optimizer": optimizer,
        "loss_history": {name: getattr(state.loss_history, name) for name in _HISTORY},
        "generator": state.generator.get_state(),
    }
