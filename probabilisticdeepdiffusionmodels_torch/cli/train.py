"""Training entry point.

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/cli/train.py``,
with the same config surface (hydra-style overrides):

    python -m probabilisticdeepdiffusionmodels_torch.cli.train \\
        model=unet data=synthetic visualization=none trainer.max_epochs=10

Flow: compose config -> run dir + logger -> data loaders -> engine (fresh,
or resumed from a run directory by ``cont_run=<run-name>``; with
``auto_resume=true`` from this run's own latest checkpoint) -> Trainer.fit
(which ends on the best checkpoint) -> NLL test in bits/dim over
``trainer.limit_test_batches`` val batches, written to ``final_test.json``.
``device`` (null: cuda) places the run; ``device=cpu`` runs on the CPU.  Not
ported yet, and raising: a mesh (``trainer.devices`` other than null/1,
ROADMAP.md Queue 1 item 18), the visualization suites (item 15: pass
``visualization=none``) and the device-resident loader (item 17).
"""

from __future__ import annotations

import json
import sys

import numpy as np

from ..config import load_config
from ..data.datasets import DataLoader, get_dataset
from ..engine import DiffusionEngine
from ..logging.sink import MetricLogger, RunDir, auto_tags
from ..models import resolve_device
from ..train.checkpoint import CheckpointManager
from ..train.loop import Trainer

__all__ = ["build_loaders", "build_engine", "run_training", "main"]


def build_loaders(cfg):
    """(train, val) loaders of the config's data group; the val loader's
    seed is the run seed + 1."""
    data_cfg = dict(cfg["data"])
    name = data_cfg.pop("name")
    data_cfg.pop("num_workers", None)
    if data_cfg.pop("device_resident", False):
        raise NotImplementedError(
            "data.device_resident is not ported yet (ROADMAP.md Queue 1 item 17)")
    if data_cfg.pop("superres_factor", None):
        raise NotImplementedError(
            "data.superres_factor (super-resolution) is not ported yet (ROADMAP.md Queue 1 "
            "item 16)")
    resolution = cfg["engine"].get("resolution")
    extra = {k: data_cfg.pop(k) for k in list(data_cfg)
             if k not in ("batch_size", "transformation_kwargs", "num_samples_per_epoch")}
    train_ds = get_dataset(name, train=True, resolution=resolution, **extra)
    val_ds = get_dataset(name, train=False, resolution=resolution, **extra)
    seed = int(cfg.get("seed", 0) or 0)
    train_loader = DataLoader(train_ds, train=True, seed=seed, **data_cfg)
    val_loader = DataLoader(val_ds, train=False, seed=seed + 1, **data_cfg)
    return train_loader, val_loader


def check_devices(devices) -> None:
    """One device only: ``trainer.devices`` null or 1."""
    if devices not in (None, 1, "1"):
        raise NotImplementedError(f"trainer.devices={devices!r}: a device mesh is not ported "
                                  "yet (ROADMAP.md Queue 1 item 18)")


def build_engine(cfg, steps_per_epoch=None) -> DiffusionEngine:
    """The engine of a composed config, on the config's ``device``."""
    trainer = cfg.get("trainer") or {}
    check_devices(trainer.get("devices"))
    scheduler = dict(cfg.get("scheduler") or {})
    return DiffusionEngine(
        model_config=dict(cfg["model"]),
        seed=int(cfg.get("seed", 0) or 0),
        scheduler_name=scheduler.get("scheduler_name"),
        scheduler_kwargs=scheduler.get("scheduler_kwargs"),
        accumulate_grad_batches=int(trainer.get("accumulate_grad_batches", 1)),
        # the reference's schedulers step once per epoch
        steps_per_epoch=steps_per_epoch,
        watch=bool(trainer.get("watch")),
        device=cfg.get("device"),
        **dict(cfg["engine"]),
    )


def run_training(cfg) -> dict:
    # refuse what cannot run before the run directory is made
    resolve_device(cfg.get("device"))
    check_devices((cfg.get("trainer") or {}).get("devices"))
    vis_cfg = dict(cfg.get("visualization") or {})
    if int(vis_cfg.get("run_every", 5) or 0) > 0:
        raise NotImplementedError(
            "the visualization suites are not ported yet (ROADMAP.md Queue 1 item 15): "
            "pass visualization=none")
    run_dir = RunDir(cfg.get("out_dir", "./runs"), cfg.get("run_name"))
    run_dir.save_config(cfg)
    logger = MetricLogger(run_dir, use_wandb=bool(cfg.get("use_wandb")))
    print(f"[train] run dir: {run_dir.path}  tags: {auto_tags(cfg)}")

    train_loader, val_loader = build_loaders(cfg)
    engine = build_engine(cfg, steps_per_epoch=len(train_loader))

    resume_from = cfg.get("cont_run")
    if cfg.get("auto_resume") and not resume_from:
        if any(run_dir.checkpoint_dir().iterdir()):
            resume_from = run_dir.name
    if resume_from:
        prev = RunDir.find(cfg.get("out_dir", "./runs"), resume_from)
        CheckpointManager(prev.checkpoint_dir()).restore(engine.state)
        print(f"[train] resumed from {prev.path} at step {engine.state.step}")

    trainer_cfg = dict(cfg.get("trainer") or {})
    trainer = Trainer(
        engine,
        run_dir,
        logger=logger,
        max_epochs=int(trainer_cfg.get("max_epochs", 100)),
        check_val_every_n_epoch=int(trainer_cfg.get("check_val_every_n_epoch", 2)),
        patience=int(cfg.get("patience", 20)),
        save_every_steps=trainer_cfg.get("save_every_steps"),
        watch_every_steps=trainer_cfg.get("watch_every_steps"),
        prefetch=int(trainer_cfg.get("prefetch", 2)),
        fused_steps=int(trainer_cfg.get("fused_steps", 0)),
    )
    result = trainer.fit(train_loader, val_loader)

    # NLL test on the best checkpoint over limit_test_batches val batches
    limit = trainer_cfg.get("limit_test_batches", 100)
    test_metrics = {}
    for i, (x, y) in enumerate(val_loader):
        if limit is not None and i >= int(limit):
            break
        for k, v in engine.test_step(x, seed=i, y=y).items():
            test_metrics.setdefault(k, []).append(v)
    test_metrics = {k: float(np.mean(v)) for k, v in test_metrics.items()}
    logger.log(test_metrics, step=result["steps"])
    print(f"[train] done: {result} test: {test_metrics}")
    (run_dir.path / "final_test.json").write_text(
        json.dumps({**result, **test_metrics}, default=float))
    logger.close()
    return {**result, **test_metrics, "run_dir": str(run_dir.path)}


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    return run_training(load_config("default", argv))


if __name__ == "__main__":
    main()
