"""Reflow (rectification) entry point.

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/cli/reflow.py``:
straighten a trained run's generative ODE (Liu et al., arXiv:2209.03003
section 3.2): generate deterministic (z, x) couplings from the teacher, then
train a flow-matching student on them, so that 1-4 Euler steps sample well
(``train/reflow.py``).

    python -m probabilisticdeepdiffusionmodels_torch.cli.reflow \\
        run_dir=runs/synstudy_linear_T1000_flow n_couplings=4096 epochs=8

Takes flow teachers (native-ODE couplings) and eps / v / x0 / EDM teachers
(``gen_sampler=ddim`` or ``dpmpp`` over the eps view, ``gen_steps`` steps;
the default is the flow ODE for a flow teacher, else DDIM-50).  A
conditional teacher's labels cycle through the classes.  Writes a run
directory ``<teacher>_reflow`` under ``out_dir``: the config, a checkpoint,
the metrics and ``final_test.json`` with the student's NLL through its eps
view, which ``cli.sample``, ``cli.eval`` and ``cli.fid_score`` read as any
trained run.  ``seed`` seeds the generator of z and the epochs' orders;
``device`` (null: cuda) places teacher and student.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..config import load_config
from ..logging.sink import MetricLogger, RunDir
from ..train.checkpoint import CheckpointManager
from ..train.reflow import reflow_round, reflow_student
from .distill import final_nll, student_run_config
from .sample import load_engine_from_run
from .train import build_loaders

__all__ = ["run_reflow", "main"]


def run_reflow(cfg) -> dict:
    if not cfg.get("run_dir"):
        raise ValueError("pass run_dir=<path to the trained teacher>")
    teacher, run_cfg = load_engine_from_run(cfg["run_dir"], device=cfg.get("device"))
    _, val_loader = build_loaders(run_cfg)
    use_ema_teacher = bool(cfg.get("use_ema_teacher", True))
    student = reflow_student(teacher, lr=(float(cfg["lr"]) if cfg.get("lr") else None),
                             ema=float(cfg.get("ema", 0.995)), use_ema_teacher=use_ema_teacher,
                             warm_start=bool(cfg.get("warm_start", True)))

    gen_sampler = cfg.get("gen_sampler")
    sampler_kwargs = None
    if gen_sampler is not None:
        steps = int(cfg.get("gen_steps", 50))
        samplers = {"flow": dict(flow=True, num_sample_steps=steps),
                    "ddim": dict(ddim=True, num_sample_steps=steps),
                    "dpmpp": dict(dpm_solver=True, num_sample_steps=steps)}
        if gen_sampler not in samplers:
            raise ValueError(f"gen_sampler={gen_sampler!r}: flow | ddim | dpmpp")
        sampler_kwargs = samplers[gen_sampler]

    base_name = str(cfg["run_dir"]).rstrip("/").rsplit("/", 1)[-1]
    run = RunDir(cfg.get("out_dir", "./runs"), f"{base_name}_reflow")
    run.save_config(student_run_config(student, run_cfg))
    logger = MetricLogger(run)
    print(f"[reflow] teacher {cfg['run_dir']} ({teacher.prediction_type}) -> flow student "
          f"{run.path}")

    n_couplings = int(cfg.get("n_couplings", 4096))
    # a conditional teacher generates every class evenly; the student then
    # rectifies the per-class ODEs
    num_classes = int(teacher.model.num_classes or 0)
    y = np.arange(n_couplings) % num_classes if num_classes else None
    generator = torch.Generator(teacher.device).manual_seed(int(cfg.get("seed", 0) or 0))
    last = reflow_round(student, teacher, generator, n_couplings=n_couplings,
                        batch_size=int(cfg.get("batch_size", 64)),
                        epochs=int(cfg.get("epochs", 8)),
                        minibatch_gen=int(cfg.get("minibatch_gen", 64)),
                        sampler_kwargs=sampler_kwargs, use_ema_teacher=use_ema_teacher, y=y,
                        log_every=int(cfg.get("log_every", 50)),
                        log=lambda m: print(m, flush=True))
    logger.log(last, step=int(student.state.step))
    CheckpointManager(run.checkpoint_dir()).save(student.state, int(student.state.step),
                                                 metrics={"val_loss": last.get("loss", 0.0)})
    # the NLL through the student's eps view, comparable to the teacher's
    test = final_nll(student, val_loader, int(cfg.get("limit_test_batches", 4)))
    (run.path / "final_test.json").write_text(json.dumps({**last, **test}, default=float))
    logger.close()
    print(f"[reflow] done: {last} test: {test}")
    return {**last, **test, "run_dir": str(run.path)}


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    return run_reflow(load_config("reflow", argv))


if __name__ == "__main__":
    main()
