"""Consistency-distillation entry point.

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/cli/consistency.py``:
distill a trained run into a consistency model for one- or few-step
sampling (arXiv:2303.01469 with the iCT choices, arXiv:2310.14189): the
student's f(x, sigma) learns to map any point of the teacher's PF-ODE
trajectories to their end, supervised by single teacher Heun steps between
adjacent Karras levels (``train/consistency.py``).

    python -m probabilisticdeepdiffusionmodels_torch.cli.consistency \\
        run_dir=runs/flagship_linear_T1000_v epochs=20

Takes eps / v / x0 teachers (the eps view at the nearest timestep) and EDM
/ flow teachers (the exact sigma).  Writes a run directory
``<teacher>_cd`` under ``out_dir``: the config, a checkpoint, the metrics
and ``final_test.json`` with the CT validation loss (a consistency model
has no eps view, so no discrete bound), which ``cli.sample
sampler=consistency`` reads as any trained run.  ``device`` (null: cuda)
places teacher and student.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..config import load_config
from ..logging.sink import MetricLogger, RunDir
from ..train.checkpoint import CheckpointManager
from ..train.consistency import consistency_distill_round, consistency_student
from .distill import student_run_config
from .sample import load_engine_from_run
from .train import build_loaders

__all__ = ["run_consistency_distillation", "main"]


def run_consistency_distillation(cfg) -> dict:
    if not cfg.get("run_dir"):
        raise ValueError("pass run_dir=<path to the trained teacher>")
    teacher, run_cfg = load_engine_from_run(cfg["run_dir"], device=cfg.get("device"))
    train_loader, val_loader = build_loaders(run_cfg)
    epochs = int(cfg.get("epochs", 10))
    use_ema_teacher = bool(cfg.get("use_ema_teacher", True))

    cm_cfg = {
        k: cfg[k]
        for k in ("sigma_data", "sigma_min", "sigma_max", "rho", "grid_size", "metric",
                  "huber_c", "weighting", "target")
        if cfg.get(k) is not None
    } or None
    student = consistency_student(
        teacher, lr=(float(cfg["lr"]) if cfg.get("lr") else None),
        ema=float(cfg.get("ema", 0.995)), consistency_config=cm_cfg,
        use_ema_teacher=use_ema_teacher, warm_start=bool(cfg.get("warm_start", True)))

    base_name = str(cfg["run_dir"]).rstrip("/").rsplit("/", 1)[-1]
    run = RunDir(cfg.get("out_dir", "./runs"), f"{base_name}_cd")
    run.save_config(student_run_config(student, run_cfg))
    logger = MetricLogger(run)
    print(f"[consistency] teacher {cfg['run_dir']} ({teacher.prediction_type}) -> "
          f"consistency student {run.path}")

    # labels go to conditional models only (an unconditional UNet has no
    # label slot)
    cond = bool(teacher.model.num_classes)

    def batches():
        for _ in range(epochs):
            for x0, y in train_loader:
                yield x0, (y if cond else None)

    last = consistency_distill_round(student, teacher, batches(),
                                     log_every=int(cfg.get("log_every", 50)),
                                     log=lambda m: print(m, flush=True),
                                     use_ema_teacher=use_ema_teacher)
    logger.log(last, step=int(student.state.step))
    CheckpointManager(run.checkpoint_dir()).save(student.state, int(student.state.step),
                                                 metrics={"val_loss": last.get("loss", 0.0)})

    # the CT validation loss on the first limit_test_batches val batches,
    # batch i's draws from a generator seeded i
    limit = int(cfg.get("limit_test_batches", 4))
    losses = []
    for i, (x, y) in enumerate(val_loader):
        if i >= limit:
            break
        gen = torch.Generator(student.device).manual_seed(i)
        losses.append(float(student.validation_step(x, gen, y=(y if cond else None))
                            ["val_loss"]))
    test = {"test_ct_loss": float(np.mean(losses))}
    (run.path / "final_test.json").write_text(json.dumps({**last, **test}, default=float))
    logger.close()
    print(f"[consistency] done: {last} test: {test}")
    return {**last, **test, "run_dir": str(run.path)}


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    return run_consistency_distillation(load_config("consistency", argv))


if __name__ == "__main__":
    main()
