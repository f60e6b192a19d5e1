"""Restore a run mirrored to Weights & Biases into the local run store.

PyTorch-port copy of ``probabilisticdeepdiffusionmodels_tpu/logging/remote.py``.
``MetricLogger.log_artifact`` (``sink.py``) uploads a run's
``checkpoints/`` directory as a ``checkpoint`` artifact at the end of
training; ``fetch_run`` downloads a mirrored run's files and its newest
checkpoint artifact back into ``<dest_root>/<name>``, the layout every
``run_dir=`` CLI reads (``checkpoints/<step>/state.pt``).  ``python -m
probabilisticdeepdiffusionmodels_torch.cli.runs pull <entity/project/run_id>``
is the command.  The W&B client is injectable (``_api``), so the logic is
tested against a fake one without a network.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

__all__ = ["fetch_run"]


def fetch_run(run_spec: str, dest_root: str = "./runs",
              name: Optional[str] = None, _api=None, log=print) -> Path:
    """Download the W&B run ``run_spec`` ("entity/project/run_id") into
    ``dest_root/<name>`` (default: the run id): every file it logged
    (``experiment_config.yaml``, ``metrics.jsonl``, media) but W&B's own,
    and the newest ``checkpoint`` artifact into ``checkpoints/``.  Returns
    the local run directory.  ``_api`` defaults to ``wandb.Api()``."""
    if _api is None:
        try:
            import wandb
        except ImportError as e:
            raise RuntimeError("fetching a remote run needs the wandb package "
                               "(pip install wandb) and credentials") from e
        _api = wandb.Api()
    run = _api.run(run_spec)
    dest = Path(dest_root) / (name or run_spec.rsplit("/", 1)[-1])
    dest.mkdir(parents=True, exist_ok=True)
    for f in run.files():
        # W&B's own files are not the run's
        if f.name.startswith(("wandb-", "config.yaml", "requirements")):
            continue
        f.download(root=str(dest), replace=True)
        log(f"[pull] {dest / f.name}")
    ckpts = [a for a in run.logged_artifacts() if a.type == "checkpoint"]
    if ckpts:
        ckpts[-1].download(root=str(dest / "checkpoints"))
        log(f"[pull] checkpoint artifact -> {dest / 'checkpoints'}")
    else:
        log("[pull] run has no checkpoint artifact (metrics/config only)")
    if not (dest / "experiment_config.yaml").exists():
        log("[pull] WARNING: no experiment_config.yaml in the mirror — "
            "run_dir CLIs need it; was the run logged with this framework?")
    return dest
