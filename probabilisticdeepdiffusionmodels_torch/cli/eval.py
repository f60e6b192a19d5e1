"""NLL evaluation entry point (bits/dim).

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/cli/eval.py``:
load a trained run's best checkpoint and run the NLL test on its train or
val loader over ``trainer.limit_test_batches`` batches, batch i with seed
``seed + i``:

    python -m probabilisticdeepdiffusionmodels_torch.cli.eval \\
        run_dir=runs/run-xyz use_train_data=false trainer.limit_test_batches=10

``device`` (null: cuda) places the engine.  ``ode_nll=true`` raises: the
ODE likelihood is not ported yet (ROADMAP.md Queue 1 items 12 and 14).
"""

from __future__ import annotations

import sys

import numpy as np

from ..config import load_config
from .sample import load_engine_from_run
from .train import build_loaders

__all__ = ["run_eval", "main"]


def run_eval(cfg) -> dict:
    if not cfg.get("run_dir"):
        raise ValueError("pass run_dir=<path to a training run>")
    if cfg.get("ode_nll", False):
        raise NotImplementedError("ode_nll=true is not ported yet (ROADMAP.md Queue 1 "
                                  "items 12 and 14)")
    engine, run_cfg = load_engine_from_run(cfg["run_dir"], device=cfg.get("device"))
    train_loader, val_loader = build_loaders(run_cfg)
    loader = train_loader if bool(cfg.get("use_train_data", True)) else val_loader
    limit = (cfg.get("trainer") or {}).get("limit_test_batches")
    seed = int(cfg.get("seed", 0) or 0)

    agg: dict = {}
    for i, (x, y) in enumerate(loader):
        if limit is not None and i >= int(limit):
            break
        for k, v in engine.test_step(x, seed=seed + i, y=y).items():
            agg.setdefault(k, []).append(v)
    result = {k: float(np.mean(v)) for k, v in agg.items()}
    print(f"[eval] {result}")
    return result


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    return run_eval(load_config("eval", argv))


if __name__ == "__main__":
    main()
