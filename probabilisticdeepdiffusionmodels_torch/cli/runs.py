"""The local run store: list runs, their checkpoints and last metrics, and
pull a W&B-mirrored run into it.

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/cli/runs.py``
over the port's run layout: a run is a directory with
``experiment_config.yaml``, ``metrics.jsonl`` and
``checkpoints/<step>/state.pt``.

    python -m probabilisticdeepdiffusionmodels_torch.cli.runs list [out_dir]
    python -m probabilisticdeepdiffusionmodels_torch.cli.runs show <run> [out_dir]
    python -m probabilisticdeepdiffusionmodels_torch.cli.runs pull \\
        <entity/project/run_id> [out_dir]   # a W&B-mirrored run -> the local store
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import List, Optional

__all__ = ["list_runs", "list_checkpoints", "latest_checkpoint", "last_metrics", "main"]


def list_runs(out_dir: str = "./runs") -> List[str]:
    """The runs under ``out_dir``: directories with a config snapshot."""
    root = Path(out_dir)
    if not root.exists():
        return []
    return sorted(p.name for p in root.iterdir() if (p / "experiment_config.yaml").exists())


def list_checkpoints(run: str, out_dir: str = "./runs") -> List[int]:
    """The steps of a run's complete checkpoints (``<step>/state.pt``)."""
    ckpt_dir = Path(out_dir) / run / "checkpoints"
    if not ckpt_dir.exists():
        return []
    return sorted(int(p.name) for p in ckpt_dir.iterdir()
                  if p.name.isdigit() and (p / "state.pt").exists())


def latest_checkpoint(run: str, out_dir: str = "./runs") -> Optional[int]:
    """The latest checkpoint's step, or None."""
    steps = list_checkpoints(run, out_dir)
    return steps[-1] if steps else None


def last_metrics(run: str, out_dir: str = "./runs") -> dict:
    """Every metric's last value in the run's ``metrics.jsonl``."""
    path = Path(out_dir) / run / "metrics.jsonl"
    last: dict = {}
    if path.exists():
        with open(path) as f:
            for line in f:
                try:
                    last.update(json.loads(line))
                except json.JSONDecodeError:
                    pass
    return last


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    cmd = argv[0] if argv else "list"
    if cmd == "list":
        out_dir = argv[1] if len(argv) > 1 else "./runs"
        for name in list_runs(out_dir):
            steps = list_checkpoints(name, out_dir)
            val = last_metrics(name, out_dir).get("val_loss")
            print(f"{name:32s} ckpts={steps} val_loss={val}")
    elif cmd == "show":
        run = argv[1]
        out_dir = argv[2] if len(argv) > 2 else "./runs"
        print(json.dumps(last_metrics(run, out_dir), indent=2, default=str))
    elif cmd == "pull":
        from ..logging import remote

        dest = remote.fetch_run(argv[1], argv[2] if len(argv) > 2 else "./runs")
        print(f"[runs] pulled -> {dest}")
    else:
        print(__doc__)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
