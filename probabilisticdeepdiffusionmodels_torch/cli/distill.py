"""Progressive-distillation entry point.

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/cli/distill.py``:
halve a trained run's sampling chain ``rounds`` times (Salimans & Ho,
arXiv:2202.00512 section 3).  Each round trains a v-parameterized student
over the respaced half-chain to match two teacher DDIM steps with one
(``train/distill.py``), then the student becomes the next round's teacher.

    python -m probabilisticdeepdiffusionmodels_torch.cli.distill \\
        run_dir=runs/flagship_linear_T1000 rounds=3 epochs=20

Each round writes a run directory ``<teacher>_distillT<T>`` under
``out_dir``: the config, a checkpoint, the metrics and ``final_test.json``
with the student's NLL, which ``cli.sample``, ``cli.eval`` and
``cli.fid_score`` read as any trained run (the student is a self-contained
engine over its own T/2-step schedule).  ``device`` (null: cuda) places
teacher and student.  ``student_run_config`` is shared with
``cli.consistency`` and ``cli.reflow``.
"""

from __future__ import annotations

import json
import sys

import numpy as np

from ..config import load_config
from ..logging.sink import MetricLogger, RunDir
from ..train.checkpoint import CheckpointManager
from ..train.distill import distill_round, halved_student
from .sample import load_engine_from_run
from .train import build_loaders

__all__ = ["run_distillation", "student_run_config", "final_nll", "main"]


def student_run_config(student, run_cfg) -> dict:
    """A config that rebuilds the student engine as it is (its betas ride in
    the engine section), with the teacher's data and model groups, so the
    sample, eval and FID CLIs read the student's run as any other.  The keys
    left out of the engine section belong to the trainer or the loop and
    are not the engine constructor's."""
    scfg = dict(run_cfg)
    eng_cfg = {
        k: v for k, v in student.hparams.items()
        if k not in ("model_config", "optimizer_config", "scheduler_name", "scheduler_kwargs",
                     "seed", "accumulate_grad_batches", "grad_clip")
    }
    eng_cfg["optimizer_config"] = student.hparams["optimizer_config"]
    scfg["engine"] = eng_cfg
    scfg["model"] = dict(student.hparams["model_config"])
    scfg["scheduler"] = {}
    return scfg


def final_nll(engine, val_loader, limit: int) -> dict:
    """The NLL test of ``engine`` (``test_step``, batch i seeded i) averaged
    over the first ``limit`` val batches."""
    rows = []
    for i, (x, y) in enumerate(val_loader):
        if i >= limit:
            break
        rows.append(engine.test_step(x, seed=i, y=y))
    return {k: float(np.mean([m[k] for m in rows])) for k in rows[0]}


def run_distillation(cfg) -> dict:
    if not cfg.get("run_dir"):
        raise ValueError("pass run_dir=<path to the trained teacher>")
    teacher, run_cfg = load_engine_from_run(cfg["run_dir"], device=cfg.get("device"))
    train_loader, val_loader = build_loaders(run_cfg)
    rounds = int(cfg.get("rounds", 1))
    epochs = int(cfg.get("epochs", 10))
    lr = cfg.get("lr")
    use_ema_teacher = bool(cfg.get("use_ema_teacher", True))
    # labels go to conditional models only (an unconditional UNet has no
    # label slot)
    cond = bool(teacher.model.num_classes)

    def batches():
        for _ in range(epochs):
            for x0, y in train_loader:
                yield x0, (y if cond else None)

    base_name = str(cfg["run_dir"]).rstrip("/").rsplit("/", 1)[-1]
    results = {}
    for r in range(rounds):
        student = halved_student(teacher, lr=(float(lr) if lr else None),
                                 ema=float(cfg.get("ema", 0.995)),
                                 use_ema_teacher=use_ema_teacher)
        T_s = student.diffusion_steps
        run = RunDir(cfg.get("out_dir", "./runs"), f"{base_name}_distillT{T_s}")
        run.save_config(student_run_config(student, run_cfg))
        logger = MetricLogger(run)
        print(f"[distill] round {r + 1}/{rounds}: T {teacher.diffusion_steps} -> {T_s}, "
              f"{epochs} epochs -> {run.path}")
        last = distill_round(student, teacher, batches(),
                             log_every=int(cfg.get("log_every", 50)),
                             log=lambda m: print(m, flush=True),
                             guidance_scale=cfg.get("guidance_scale"),
                             use_ema_teacher=use_ema_teacher)
        logger.log(last, step=int(student.state.step))
        CheckpointManager(run.checkpoint_dir()).save(
            student.state, int(student.state.step), metrics={"val_loss": last.get("loss", 0.0)})
        # the distilled chain's NLL, comparable to the teacher's final test
        test = final_nll(student, val_loader, int(cfg.get("limit_test_batches", 4)))
        (run.path / "final_test.json").write_text(json.dumps({**last, **test}, default=float))
        logger.close()
        print(f"[distill] T={T_s} done: {last} test: {test}")
        results[T_s] = {**last, **test, "run_dir": str(run.path)}
        teacher = student  # the next round halves again
    return results


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    return run_distillation(load_config("distill", argv))


if __name__ == "__main__":
    main()
