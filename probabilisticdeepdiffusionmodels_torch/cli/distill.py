"""Progressive distillation's entry point: for now the run config of a
distilled student, which ``cli.consistency`` writes too.

PyTorch counterpart of ``student_run_config`` in
``probabilisticdeepdiffusionmodels_tpu/cli/distill.py``.  Progressive
distillation itself (``train/distill.py``, this CLI's ``main``) is not
ported yet: ROADMAP.md Queue 1 item 13.
"""

from __future__ import annotations

__all__ = ["student_run_config", "main"]


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


def main(argv=None):
    raise NotImplementedError("progressive distillation (cli.distill) is not ported yet "
                              "(ROADMAP.md Queue 1 item 13)")


if __name__ == "__main__":
    main()
