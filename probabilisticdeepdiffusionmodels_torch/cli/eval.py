"""NLL evaluation entry point (bits/dim).

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/cli/eval.py``:
load a trained run's best checkpoint and run the NLL test on its train or
val loader over ``trainer.limit_test_batches`` batches, batch i with seed
``seed + i``:

    python -m probabilisticdeepdiffusionmodels_torch.cli.eval \\
        run_dir=runs/run-xyz use_train_data=false trainer.limit_test_batches=10

``device`` (null: cuda) places the engine.  ``ode_nll=true`` on a flow or
EDM run adds the exact continuous-time likelihood (``evals/ode_nll.py``,
``ode_steps`` Heun steps, ``ode_probes`` Hutchinson probes) as
``test_ode_nll`` in bits/dim beside the bound's columns.
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
    engine, run_cfg = load_engine_from_run(cfg["run_dir"], device=cfg.get("device"))
    ode = bool(cfg.get("ode_nll", False))
    if ode and engine.prediction_type not in ("flow", "edm"):
        raise ValueError('ode_nll=true needs a prediction_type="flow" or "edm" run')
    train_loader, val_loader = build_loaders(run_cfg)
    loader = train_loader if bool(cfg.get("use_train_data", True)) else val_loader
    limit = (cfg.get("trainer") or {}).get("limit_test_batches")
    seed = int(cfg.get("seed", 0) or 0)

    agg: dict = {}
    for i, (x, y) in enumerate(loader):
        if limit is not None and i >= int(limit):
            break
        m = engine.test_step(x, seed=seed + i, y=y)
        if ode:
            o = engine.calculate_ode_likelihood(x, seed=seed + i, y=y,
                                                n_steps=int(cfg.get("ode_steps", 100)),
                                                n_probes=int(cfg.get("ode_probes", 1)))
            m["test_ode_nll"] = float(o["nll_bits_per_dim"].mean())
        for k, v in m.items():
            agg.setdefault(k, []).append(v)
    result = {k: float(np.mean(v)) for k, v in agg.items()}
    print(f"[eval] {result}")
    return result


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    return run_eval(load_config("eval", argv))


if __name__ == "__main__":
    main()
