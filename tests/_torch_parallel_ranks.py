"""The spawned ranks of ``test_torch_parallel.py``: every scenario one rank
runs, in one function, so the module pays for one rendezvous.  No JAX here:
a spawned rank imports this module and the port only.

``train_two_steps`` and ``chain_inpaint_test`` also give the test process
its one-process reference: the same calls on an engine without a mesh.
"""

import numpy as np
import torch
import torch.distributed as dist

from probabilisticdeepdiffusionmodels_torch.convert import load_flax_params
from probabilisticdeepdiffusionmodels_torch.engine import DiffusionEngine
from probabilisticdeepdiffusionmodels_torch.evals.fid import compute_statistics
from probabilisticdeepdiffusionmodels_torch.models import get_model
from probabilisticdeepdiffusionmodels_torch.parallel import (fsdp_sharding, make_mesh,
                                                             make_mesh_2d, tp_sharding)
from probabilisticdeepdiffusionmodels_torch.train.checkpoint import _to_saveable


def make_engine(spec, mesh=None, mode="replicated", model=None):
    return DiffusionEngine(dict(model or spec["model"]), {"lr": spec["lr"]},
                           diffusion_steps=spec["T"], resolution=spec["res"], ema=0.999,
                           seed=spec["seed"], grad_clip=spec["grad_clip"], device="cpu",
                           mesh=mesh, param_sharding=mode, fsdp_min_size=spec["min_size"])


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    return tree


def train_two_steps(engine, spec, before_save=None) -> dict:
    """Two steps on the global batches with the injected draws; the metrics
    and the whole state (gathered where it is sharded), as a checkpoint
    holds it.  ``before_save(engine)`` runs between the two."""
    metrics = []
    for i in range(2):
        m = engine.training_step(spec["x"][i], t=torch.as_tensor(spec["t"][i]),
                                 noise=torch.as_tensor(spec["noise"][i]))
        metrics.append({k: float(v) for k, v in m.items()})
    extra = None if before_save is None else before_save(engine)
    return {"metrics": metrics, "state": _host(_to_saveable(engine.state)), "extra": extra}


def holdings(engine) -> dict:
    """What this FSDP rank holds of each split leaf: (dim, the working
    copy's shape, the shard's shape, the working copy's storage bytes)."""
    sync = engine.state.sync
    held = {}
    for which in ("model", "ema"):
        params = list(sync.modules[which].parameters())
        for name, p, master, d in zip(sync.names, params, sync.masters[which], sync.dims):
            if d is not None:
                held[f"{which}:{name}"] = (d, tuple(p.shape), tuple(master.shape),
                                           p.untyped_storage().nbytes())
    adam = engine.state.optimizer.adam.state
    for name, master, d in zip(sync.names, sync.masters["model"], sync.dims):
        if d is not None:
            held[f"adam:{name}"] = (d, None, tuple(adam[master]["exp_avg"].shape), 0)
    every = [None] * sync.size
    dist.all_gather_object(every, held)
    return {"held": every, "dims": dict(zip(sync.names, sync.dims))}


def chain_inpaint_test(engine, spec) -> dict:
    """The batch-sharded ancestral chain, RePaint and the NLL test on a
    fresh engine."""
    x0 = torch.as_tensor(spec["x"][0])
    images = engine.generate_images(n=4, minibatch=4, num_sample_steps=spec["chain_steps"],
                                    seed=5)
    painted = engine.inpaint(x0, torch.as_tensor(spec["mask"]), seed=3,
                             num_sample_steps=spec["chain_steps"])
    return {"chain": images, "inpaint": painted.numpy(), "test_step": engine.test_step(x0, seed=2)}


def features(x: torch.Tensor) -> torch.Tensor:
    """A cheap feature map for the statistics: 12 numbers an image."""
    flat = x.reshape(x.shape[0], -1)
    return torch.cat([flat[:, :8] * 3.0, flat[:, 8:12].square()], dim=1)


def scenarios(rank: int, device, spec) -> dict:
    """Every 2-rank scenario; rank 0's results (and, for FSDP, every rank's
    holdings)."""
    torch.set_num_threads(1)
    mesh = make_mesh(device="cpu")
    out = {}
    for mode in ("replicated", "fsdp"):
        out[mode] = train_two_steps(make_engine(spec, mesh, mode), spec,
                                    holdings if mode == "fsdp" else None)
    model = get_model(spec["res"], spec["jax"]["model"], device="cpu")

    def dims(layout, axis):
        return {name: (None if not p[axis].is_shard() else p[axis].dim)
                for name, p in layout.items()}

    out["rules"] = {"fsdp": dims(fsdp_sharding(mesh, model, min_size=1000), 0),
                    "tp": dims(tp_sharding(make_mesh_2d(1, 2, device="cpu"), model,
                                           min_size=1000), 1)}
    out["sampling"] = chain_inpaint_test(make_engine(spec, mesh), spec)
    out["fid"] = compute_statistics(spec["fid_batches"], feature_fn=features, mesh=mesh)

    # against JAX's own mesh: its weights, its draws
    jax_side = spec["jax"]
    engine = make_engine(spec, mesh, model=jax_side["model"])
    for module in (engine.state.model, engine.state.ema_model):
        load_flax_params(module, jax_side["params"])
    m = engine.training_step(jax_side["x"], t=torch.as_tensor(jax_side["t"]),
                             noise=torch.as_tensor(jax_side["noise"]))
    out["jax_step"] = {"metrics": {k: float(v) for k, v in m.items()},
                       "state": _host(_to_saveable(engine.state))}
    engine = make_engine(spec, mesh, model=jax_side["model"])
    for module in (engine.state.model, engine.state.ema_model):
        load_flax_params(module, jax_side["params"])
    out["jax_ddim"] = engine.generate_images(n=4, minibatch=4, ddim=True,
                                             num_sample_steps=jax_side["ddim_steps"],
                                             x_T=jax_side["x_T"])
    return out
