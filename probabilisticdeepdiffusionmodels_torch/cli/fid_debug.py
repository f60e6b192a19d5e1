"""FID floor check: the FID of the real dataset's train split against its
val split, the lower bound a model's FID is read against.

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/cli/fid_debug.py``:

    python -m probabilisticdeepdiffusionmodels_torch.cli.fid_debug data=cifar10

``device`` (null: cuda) places the Inception forward; a mesh
(``trainer.devices`` other than null or 1) raises, ROADMAP.md Queue 1
item 18.
"""

from __future__ import annotations

import sys

from ..config import load_config
from ..evals.fid import compute_fid_for_loaders
from .train import build_loaders, check_devices

__all__ = ["main"]


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    cfg = load_config("default", argv)
    check_devices((cfg.get("trainer") or {}).get("devices"))
    train_loader, val_loader = build_loaders(cfg)
    normalize = (cfg["data"].get("transformation_kwargs") or {}).get("normalize")
    fid = compute_fid_for_loaders(train_loader, val_loader, normalize=normalize,
                                  device=cfg.get("device"))
    print(f"FID floor (train vs val): {fid}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
