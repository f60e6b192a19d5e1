"""Training entry point.

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/cli/train.py``,
with the same config surface (hydra-style overrides):

    python -m probabilisticdeepdiffusionmodels_torch.cli.train \\
        model=unet data=synthetic trainer.max_epochs=10

Flow: compose config -> run dir + logger -> data loaders -> engine (fresh,
or resumed from a run directory by ``cont_run=<run-name>``; with
``auto_resume=true`` from this run's own latest checkpoint) -> the
visualization callback on the first validation batch (``visualization``:
``more`` by default, ``none`` turns it off) -> Trainer.fit (which runs the
callback every ``run_every`` epochs and at the end, and ends on the best
checkpoint) -> NLL test in bits/dim over ``trainer.limit_test_batches`` val
batches (a consistency model, which has no eps view, runs no views and
records its CT loss, ``test_ct_loss``, instead), written to
``final_test.json``.  ``device`` (null: cuda) places the
run; ``device=cpu`` runs on the CPU.  ``data.device_resident=true`` holds
the dataset on the run's device (``data.DeviceDataLoader``);
``trainer.fused_steps=K`` runs K train steps a dispatch, one CUDA graph on
a card (``engine.training_steps``).  ``model.name=superres
data.superres_factor=f`` trains the super-resolution model on the loaders'
(x, f-times-smaller x) pairs; its run draws no views (they sample without
the low-res input; the JAX CLI would stop on them).

``trainer.devices=N`` (or ``all``, every card) trains data-parallel on N
ranks, as Lightning's DDP spawn does for the reference's
``pl.Trainer(gpus=N)``: N processes (``parallel.spawn``), rank r on
``cuda:r`` (or all on the CPU with ``device=cpu``), one mesh over them
(``engine.param_sharding`` replicated or fsdp); the global batch stays
``data.batch_size``, every rank loads it and runs its 1/N.  Rank 0 writes
the run's metrics, media, config snapshot and checkpoints; the call returns
its result.  A launch declared in the environment (``PDDM_*`` or
``torchrun``'s ``WORLD_SIZE``/``RANK``/``MASTER_*``) keeps JAX's
multi-host meaning: every process joins one mesh and loads its own disjoint
shard of the data.  More cards than the machine has raise.
``trainer.devices=DxM`` (e.g. ``1x2``) spawns D x M ranks on a data x model
mesh (``parallel.make_mesh_2d``), for ``engine.param_sharding=tp``: the
model ranks of one data index see the same batch rows.
``trainer.fused_steps`` runs on a mesh too: one CUDA graph over NCCL, K
eager steps on the CPU.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ..config import load_config
from ..data.datasets import DataLoader, get_dataset
from ..data.device_loader import DeviceDataLoader
from ..engine import DiffusionEngine
from ..logging.sink import MetricLogger, RunDir, auto_tags
from ..models import resolve_device
from ..parallel import (RuntimeInfo, initialize_runtime, make_mesh, make_mesh_2d,
                        runtime_from_env, spawn)
from ..train.checkpoint import CheckpointManager
from ..train.loop import Trainer
from ..viz.hooks import VisualizationCallback

__all__ = ["build_loaders", "build_engine", "run_training", "main", "device_count",
           "mesh_shape", "run_on_devices"]


def build_loaders(cfg, shard_id: int = 0, num_shards: int = 1):
    """(train, val) loaders of the config's data group; the val loader's
    seed is the run seed + 1.  With ``data.device_resident`` both hold
    their dataset on the config's ``device`` (``DeviceDataLoader``).
    ``shard_id`` / ``num_shards``: this process's disjoint shard of every
    epoch (a multi-process launch declared in the environment)."""
    data_cfg = dict(cfg["data"])
    name = data_cfg.pop("name")
    data_cfg.pop("num_workers", None)
    loader_cls, kw = DataLoader, {}
    if data_cfg.pop("device_resident", False):
        loader_cls, kw = DeviceDataLoader, {"device": cfg.get("device")}
    resolution = cfg["engine"].get("resolution")
    extra = {k: data_cfg.pop(k) for k in list(data_cfg)
             if k not in ("batch_size", "transformation_kwargs", "num_samples_per_epoch",
                          "superres_factor")}
    train_ds = get_dataset(name, train=True, resolution=resolution, **extra)
    val_ds = get_dataset(name, train=False, resolution=resolution, **extra)
    seed = int(cfg.get("seed", 0) or 0)
    kw.update(shard_id=shard_id, num_shards=num_shards)
    train_loader = loader_cls(train_ds, train=True, seed=seed, **data_cfg, **kw)
    val_loader = loader_cls(val_ds, train=False, seed=seed + 1, **data_cfg, **kw)
    return train_loader, val_loader


def mesh_shape(devices):
    """(D, M) of a ``DxM`` devices value, else None."""
    if "x" not in str(devices):
        return None
    try:
        n_data, n_model = (int(v) for v in str(devices).split("x"))
    except ValueError:
        raise ValueError(f"devices={devices!r}: a data x model mesh is DxM, e.g. 2x2") from None
    if n_data < 1 or n_model < 1:
        raise ValueError(f"devices={devices!r}: both axes need at least one rank")
    return n_data, n_model


def device_count(devices, device=None) -> int:
    """The ranks ``devices`` asks for: null or 1 one, an int N, ``DxM``
    D times M (a data x model mesh), ``all`` every card (one on the CPU)."""
    if devices in (None, "", 1, "1"):
        return 1
    shape = mesh_shape(devices)
    if shape is not None:
        return shape[0] * shape[1]
    if str(devices) == "all":
        return torch.cuda.device_count() if resolve_device(device).type == "cuda" else 1
    return int(devices)


def _rank_device(device, rank: int) -> torch.device:
    """This process's device in a launch declared in the environment:
    ``cuda:LOCAL_RANK`` (torchrun's; else the rank modulo the cards)."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
    torch.cuda.set_device(local)
    return torch.device("cuda", local)


def _spawned(rank: int, device: torch.device, fn, args):
    return fn(device, *args)


def run_on_devices(fn, devices, device, *args):
    """``fn(device, *args)`` on the ranks ``devices`` asks for: in this
    process alone (one rank), in the process group of a launch declared in
    the environment (joined here), or in ``devices`` spawned ranks; rank
    0's result.  Inside ``fn`` a process group exists exactly when there is
    more than one rank (``make_mesh()`` spans it)."""
    n = device_count(devices, device)
    runtime = runtime_from_env()
    if runtime.is_distributed:
        if n not in (1, runtime.process_count) and str(devices) != "all":
            raise ValueError(f"devices={devices!r} but the launch has "
                             f"{runtime.process_count} processes")
        dev = _rank_device(device, runtime.process_index)  # before NCCL's rendezvous
        initialize_runtime(device=dev)
        return fn(dev, *args)
    if n == 1:
        return fn(resolve_device(device), *args)
    return spawn(_spawned, n, (fn, args), device=device)


def mesh_runtime(device, devices=None) -> tuple:
    """(mesh or None, RuntimeInfo) of this rank inside ``run_on_devices``:
    a data x model mesh where ``devices`` is ``DxM``, else a data mesh over
    every rank."""
    if not dist.is_initialized():
        return None, RuntimeInfo()
    shape = mesh_shape(devices)
    mesh = make_mesh(device=device) if shape is None else make_mesh_2d(*shape, device=device)
    return mesh, RuntimeInfo(dist.get_rank(), dist.get_world_size(), "process group")


def build_engine(cfg, steps_per_epoch=None, mesh=None) -> DiffusionEngine:
    """The engine of a composed config, on the config's ``device`` (and
    ``mesh``)."""
    trainer = cfg.get("trainer") or {}
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
        mesh=mesh,
        **dict(cfg["engine"]),
    )


def run_training(cfg) -> dict:
    # refuse what cannot run before the run directory is made
    resolve_device(cfg.get("device"))
    trainer = cfg.get("trainer") or {}
    device_count(trainer.get("devices"), cfg.get("device"))
    return run_on_devices(_train, trainer.get("devices"), cfg.get("device"), cfg)


def _train(device: torch.device, cfg) -> dict:
    """One rank's run (the only one off a mesh)."""
    cfg = dict(cfg, device=str(device))
    mesh, runtime = mesh_runtime(device, (cfg.get("trainer") or {}).get("devices"))
    if mesh is not None:
        # one run directory for every rank: rank 0's name
        name = [cfg.get("run_name") or f"run-{time.strftime('%Y%m%d-%H%M%S')}"]
        dist.broadcast_object_list(name, src=0)
        cfg["run_name"] = name[0]
    run_dir = RunDir(cfg.get("out_dir", "./runs"), cfg.get("run_name"))
    if runtime.is_main:
        run_dir.save_config(cfg)
    logger = MetricLogger(run_dir, use_wandb=bool(cfg.get("use_wandb")) and runtime.is_main,
                          enabled=runtime.is_main)
    print(f"[train] run dir: {run_dir.path}  tags: {auto_tags(cfg)}"
          + (f"  rank {runtime.process_index}/{runtime.process_count}"
             if runtime.is_distributed else ""))

    # a launch declared in the env: each process loads its own shard (JAX's
    # multi-host meaning); spawned ranks load the same global batches
    # (by data index: the model ranks of one data index load one shard)
    shards = runtime_from_env()
    n_model = (mesh_shape((cfg.get("trainer") or {}).get("devices")) or (1, 1))[1]
    train_loader, val_loader = build_loaders(cfg, shards.process_index // n_model,
                                             max(1, shards.process_count // n_model))
    engine = build_engine(cfg, steps_per_epoch=len(train_loader), mesh=mesh)

    resume_from = cfg.get("cont_run")
    if cfg.get("auto_resume") and not resume_from:
        if any(run_dir.checkpoint_dir().iterdir()):
            resume_from = run_dir.name
    if resume_from:
        prev = RunDir.find(cfg.get("out_dir", "./runs"), resume_from)
        CheckpointManager(prev.checkpoint_dir()).restore(engine.state)
        print(f"[train] resumed from {prev.path} at step {engine.state.step}")

    # visualization timesteps: 10 points of linspace(1, T - 1), 5 if T <= 30
    T = engine.diffusion_steps
    ts = sorted(set(int(t) for t in np.linspace(1, T - 1, 5 if T <= 30 else 10)))
    vis_cfg = dict(cfg.get("visualization") or {})
    vis = None
    if engine.prediction_type == "consistency":
        # the views render ancestral chains through the eps view, which a
        # consistency model has not; cli.sample sampler=consistency draws it
        print('[train] visualization suites need the eps-view; disabled for '
              'prediction_type="consistency"')
    elif engine.cond_kind == "superres":
        # the views sample without conditioning, which the model needs
        print("[train] visualization suites sample without a low-res input; disabled for "
              "the superres model")
    elif int(vis_cfg.get("run_every", 5) or 0) > 0:
        vis = VisualizationCallback(
            val_batch=next(iter(val_loader))[0], ts=ts, media_dir=run_dir.path / "media",
            normalize=(cfg["data"].get("transformation_kwargs") or {}).get("normalize"),
            logger=logger, **vis_cfg)

    trainer_cfg = dict(cfg.get("trainer") or {})
    trainer = Trainer(
        engine,
        run_dir,
        logger=logger,
        max_epochs=int(trainer_cfg.get("max_epochs", 100)),
        check_val_every_n_epoch=int(trainer_cfg.get("check_val_every_n_epoch", 2)),
        patience=int(cfg.get("patience", 20)),
        visualization_callback=vis,
        vis_run_every=max(1, int(vis_cfg.get("run_every", 5) or 1)),
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
        if engine.prediction_type == "consistency":
            # no eps view, so no discrete bound: the CT loss instead
            gen = torch.Generator(engine.device).manual_seed(i)
            test_metrics.setdefault("test_ct_loss", []).append(
                float(engine.validation_step(x, gen, y=y)["val_loss"]))
            continue
        for k, v in engine.test_step(x, seed=i, y=y).items():
            test_metrics.setdefault(k, []).append(v)
    test_metrics = {k: float(np.mean(v)) for k, v in test_metrics.items()}
    logger.log(test_metrics, step=result["steps"])
    print(f"[train] done: {result} test: {test_metrics}")
    if runtime.is_main:
        (run_dir.path / "final_test.json").write_text(
            json.dumps({**result, **test_metrics}, default=float))
    logger.close()
    return {**result, **test_metrics, "run_dir": str(run_dir.path)}


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    return run_training(load_config("default", argv))


if __name__ == "__main__":
    main()
