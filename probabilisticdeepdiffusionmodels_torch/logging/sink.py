"""Metric sinks and the local run directory.

PyTorch-port copy of ``probabilisticdeepdiffusionmodels_tpu/logging/sink.py``:
a JSONL + console sink, an optional W&B mirror when the package and
credentials exist (without them the logger says so once and keeps the local
sink), and a run directory as the store of checkpoints, media and the config
snapshot (``experiment_config.yaml``).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

__all__ = ["MetricLogger", "RunDir", "auto_tags"]


class RunDir:
    """Local artifact store for one run."""

    def __init__(self, root: str, name: Optional[str] = None):
        stamp = time.strftime("%Y%m%d-%H%M%S")
        self.name = name or f"run-{stamp}"
        self.path = Path(root) / self.name
        self.path.mkdir(parents=True, exist_ok=True)
        (self.path / "media").mkdir(exist_ok=True)
        (self.path / "checkpoints").mkdir(exist_ok=True)

    def save_config(self, cfg: Dict[str, Any]) -> None:
        import yaml

        with open(self.path / "experiment_config.yaml", "w") as f:
            yaml.safe_dump(cfg, f, sort_keys=False)

    @staticmethod
    def find(root: str, name: str) -> "RunDir":
        rd = RunDir.__new__(RunDir)
        rd.name = name
        rd.path = Path(root) / name
        if not rd.path.exists():
            raise FileNotFoundError(rd.path)
        return rd

    def checkpoint_dir(self) -> Path:
        return self.path / "checkpoints"

    def media_path(self, filename: str) -> Path:
        return self.path / "media" / filename


class MetricLogger:
    """Console + JSONL metric logging; optional wandb mirroring."""

    def __init__(self, run_dir: RunDir, use_wandb: bool = False,
                 wandb_kwargs: Optional[dict] = None, enabled: bool = True):
        """``enabled=False`` makes every call a no-op: the non-main ranks of
        a data-parallel run use it, so the run writes one metrics stream."""
        self.run_dir = run_dir
        self.enabled = enabled
        self._f = open(run_dir.path / "metrics.jsonl", "a") if enabled else None
        self._wandb = None
        if use_wandb and enabled:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(dir=str(run_dir.path), **(wandb_kwargs or {}))
            except Exception as e:  # no package / no creds: degrade cleanly
                print(f"[log] wandb unavailable ({e}); using local sink only")

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        if not self.enabled:
            return
        clean = {}
        for k, v in metrics.items():
            if hasattr(v, "item"):
                v = v.item()
            if isinstance(v, (np.floating, np.integer)):
                v = v.item()
            clean[k] = v
        if step is not None:
            clean["step"] = int(step)
        clean["time"] = time.time()
        self._f.write(json.dumps(clean) + "\n")
        self._f.flush()
        if self._wandb is not None:
            self._wandb.log(clean, step=step)

    def log_image(self, name: str, path: Path) -> None:
        """Mirror an image file to W&B under ``name``; no-op without the
        wandb mirror (the file stays in the run's ``media/``)."""
        if self._wandb is not None:
            self._wandb.log({name: self._wandb.Image(str(path))})

    def log_artifact(self, path, name: str, type: str = "checkpoint") -> None:
        """Mirror a file or directory as a W&B artifact; no-op without the
        wandb mirror."""
        if self._wandb is None:
            return
        art = self._wandb.Artifact(name, type=type)
        p = Path(path)
        if p.is_dir():
            art.add_dir(str(p))
        else:
            art.add_file(str(p))
        self._wandb.log_artifact(art)

    def close(self):
        if self._f is not None:
            self._f.close()
        if self._wandb is not None:
            self._wandb.finish()


def auto_tags(cfg: Dict[str, Any]) -> list:
    """Run tags derived from the config: dataset, effective batch, lr, T,
    schedule mode, ema, sampling."""
    tags = []
    data = cfg.get("data", {})
    engine = cfg.get("engine", {})
    trainer = cfg.get("trainer", {})
    if "name" in data:
        tags.append(str(data["name"]))
    bs = data.get("batch_size")
    acc = trainer.get("accumulate_grad_batches", 1)
    if bs:
        tags.append(f"bs{bs * acc}")
    if "optimizer_config" in engine:
        tags.append(f"lr{engine['optimizer_config'].get('lr')}")
    if "diffusion_steps" in engine:
        tags.append(f"T{engine['diffusion_steps']}")
    if "mode" in engine:
        tags.append(str(engine["mode"]))
    if engine.get("ema"):
        tags.append(f"ema{engine['ema']}")
    if engine.get("sampling", "uniform") != "uniform":
        tags.append(str(engine["sampling"]))
    return tags
