"""FID floor check: the FID of the real dataset's train split against its
val split, the lower bound a model's FID is read against.

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/cli/fid_debug.py``:

    python -m probabilisticdeepdiffusionmodels_torch.cli.fid_debug data=cifar10

``device`` (null: cuda) places the Inception forward; ``trainer.devices=N``
computes the statistics sharded over N ranks (``cli.train.run_on_devices``),
rank 0 printing.
"""

from __future__ import annotations

import sys

from ..config import load_config
from ..evals.fid import compute_fid_for_loaders
from .train import build_loaders, mesh_runtime, run_on_devices

__all__ = ["main"]


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    cfg = load_config("default", argv)
    return run_on_devices(_floor, (cfg.get("trainer") or {}).get("devices"), cfg.get("device"),
                          cfg)


def _floor(device, cfg) -> int:
    """One rank's floor (the only one off a mesh)."""
    mesh, runtime = mesh_runtime(device)
    train_loader, val_loader = build_loaders(cfg)
    normalize = (cfg["data"].get("transformation_kwargs") or {}).get("normalize")
    fid = compute_fid_for_loaders(train_loader, val_loader, normalize=normalize, device=device,
                                  mesh=mesh)
    if runtime.is_main:
        print(f"FID floor (train vs val): {fid}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
