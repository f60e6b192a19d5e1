"""The spawned ranks of ``test_torch_parallel.py`` and
``test_torch_model_parallel.py``: every scenario one rank runs, in one
function a world size, so a module pays for one rendezvous of each.  No JAX
here: a spawned rank imports this module and the port only.

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
                                                             make_mesh_2d, spatial, tp_sharding)
from probabilisticdeepdiffusionmodels_torch.train.checkpoint import (CheckpointManager,
                                                                     _to_saveable)


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


# ------------------------------------------------------------- model parallelism


def _gathered(engine) -> dict:
    """The whole train state (tp slices gathered) as a checkpoint holds it."""
    return _host(_to_saveable(engine.state))


def tp_holdings(engine) -> list:
    """Every rank's shapes of each parameter, its EMA copy and its Adam
    moments: {name: (model, ema, exp_avg)}."""
    state = engine.state
    adam = state.optimizer.adam.state
    held = {name: (tuple(p.shape), tuple(e.shape), tuple(adam[p]["exp_avg"].shape))
            for (name, p), e in zip(state.model.named_parameters(),
                                    state.ema_model.parameters())}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, held)
    return every


def _refuses(fn, *errors) -> str:
    try:
        fn()
    except errors as e:
        return f"{type(e).__name__}: {e}"
    raise AssertionError(f"{fn} did not raise")


def _spatial_forward(spec, mesh) -> np.ndarray:
    """JAX's spatial test model on its perturbed weights, sharded by height."""
    side = spec["spatial"]
    model = get_model(side["res"], side["model"], device="cpu")
    load_flax_params(model, side["params"])
    fn = spatial.sharded_forward(model.eval(), mesh)
    return fn(torch.as_tensor(side["x"]), torch.as_tensor(side["t"]).long()).numpy()


def _filled(engine, seed: int = 7):
    """Every weight (live and EMA) moved by a seeded 0.05 normal, so the
    zero-initialised convs count in a forward."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for module in (engine.state.model, engine.state.ema_model):
            for p in module.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return engine


def spatial_chain(engine, spec, shard_mode) -> np.ndarray:
    return engine.generate_images(n=2, minibatch=2, num_sample_steps=spec["chain_steps"],
                                  seed=5, shard_mode=shard_mode)


def four_steps(engine, spec, stop=None) -> dict:
    """Four steps on the injected batches; with ``stop`` (a directory) a
    checkpoint after two, restored into a fresh engine that takes the last
    two."""
    def steps(e, lo, hi):
        for i in range(lo, hi):
            e.training_step(spec["x4"][i], t=torch.as_tensor(spec["t4"][i]),
                            noise=torch.as_tensor(spec["noise4"][i]))

    steps(engine, 0, 2)
    if stop is not None:
        manager = CheckpointManager(stop)
        manager.save(engine.state, 2)
        engine = make_engine(spec, engine.mesh, engine.param_sharding)
        manager.restore(engine.state)
    steps(engine, 2, 4)
    return _gathered(engine)


def fused_and_eager(spec, mesh, mode) -> dict:
    """K = 2 fused steps and two eager steps from one seed, their draws from
    the generator: both whole states."""
    fused = make_engine(spec, mesh, mode)
    metrics = fused.training_steps(spec["x"])
    eager = make_engine(spec, mesh, mode)
    for x in spec["x"]:
        eager.training_step(x)
    return {"fused": _gathered(fused), "eager": _gathered(eager),
            "fused_loss": metrics["loss"].tolist()}


def sampling_suite(engine, spec) -> dict:
    """``chain_inpaint_test`` and the DDIM chain, on the weights of the
    one-process engine ``_filled`` gives (on a mesh loaded whole and cut to
    the layout)."""
    if engine.mesh is None:
        engine = _filled(engine)
    else:
        src = _filled(make_engine(spec))
        engine.state.sync.load_full("model", src.state.model.state_dict())
        engine.state.sync.load_full("ema", src.state.ema_model.state_dict())
    out = chain_inpaint_test(engine, spec)
    out["ddim"] = engine.generate_images(n=4, minibatch=4, ddim=True,
                                         num_sample_steps=spec["chain_steps"], seed=5)
    return out


def jax_tp(spec, mesh) -> dict:
    """JAX's weights and draws on a tp engine: two steps, the DDIM chain
    from JAX's weights after them, and the two steps fused."""
    side = spec["jax_tp"]
    out = {}
    engine = make_engine(spec, mesh, "tp", model=side["model"])
    for module in (engine.state.model, engine.state.ema_model):
        load_flax_params(module, side["params"])
    metrics = []
    for i in range(2):
        m = engine.training_step(side["x"][i], t=torch.as_tensor(side["t"][i]),
                                 noise=torch.as_tensor(side["noise"][i]))
        metrics.append({k: float(v) for k, v in m.items()})
    out["steps"] = {"metrics": metrics, "state": _gathered(engine)}
    load_flax_params(engine.state.model, side["after"])
    out["ddim"] = engine.generate_images(n=len(side["x_T"]), minibatch=len(side["x_T"]),
                                         ddim=True, num_sample_steps=side["ddim_steps"],
                                         x_T=side["x_T"], use_ema=False)
    engine = make_engine(spec, mesh, "tp", model=side["model"])
    for module in (engine.state.model, engine.state.ema_model):
        load_flax_params(module, side["params"])
    m = engine.training_steps(side["x"], t=torch.as_tensor(side["t"]),
                              noise=torch.as_tensor(side["noise"]))
    out["fused"] = {"metrics": {k: v.tolist() for k, v in m.items()},
                    "state": _gathered(engine)}
    return out


def model_parallel_2(rank: int, device, spec) -> dict:
    """Two ranks: tensor parallelism on a 1x2 mesh (steps, sampling, the
    shards, a resume, against JAX), fused steps on a data mesh and the 1x2
    mesh, the spatial forward and chain, and the refusals."""
    torch.set_num_threads(1)
    mesh = make_mesh_2d(1, 2, device="cpu")
    data = make_mesh(device="cpu")
    out = {}
    engine = make_engine(spec, mesh, "tp")
    out["tp"] = train_two_steps(engine, spec)
    out["tp_held"] = tp_holdings(engine)
    out["tp_sampling"] = sampling_suite(make_engine(spec, mesh, "tp"), spec)
    out["mesh"] = (tuple(mesh.mesh.shape), tuple(mesh.mesh_dim_names),
                   [mesh.get_local_rank(a) for a in mesh.mesh_dim_names])
    out["resume"] = {"straight": four_steps(make_engine(spec, mesh, "tp"), spec),
                     "stopped": four_steps(make_engine(spec, mesh, "tp"), spec,
                                           stop=spec["ckpt_dir"])}
    out["fused"] = {"data": fused_and_eager(spec, data, "replicated"),
                    "tp": fused_and_eager(spec, mesh, "tp")}
    out["jax_tp"] = jax_tp(spec, mesh)
    out["spatial_forward"] = _spatial_forward(spec, data)
    filled = _filled(make_engine(spec, data))
    out["spatial_chain"] = {"spatial": spatial_chain(filled, spec, "spatial"),
                            "batch": spatial_chain(filled, spec, "batch")}
    out["refusals"] = {
        "mesh_2d_too_few": _refuses(lambda: make_mesh_2d(2, 2, device="cpu"), RuntimeError),
        "tp_no_model_axis": _refuses(lambda: make_engine(spec, data, "tp"), ValueError),
        "spatial_height": _refuses(lambda: spatial_chain(
            make_engine(spec, data, model=dict(spec["model"], channel_mult=[1, 2, 2, 2])),
            spec, "spatial"), ValueError),
    }
    return out


def model_parallel_4(rank: int, device, spec) -> dict:
    """Four ranks: tensor parallelism with a data axis on a 2x2 mesh, the
    batch split over the data axis alone, and the spatial forward."""
    torch.set_num_threads(1)
    mesh = make_mesh_2d(2, 2, device="cpu")
    out = {}
    out["tp"] = train_two_steps(make_engine(spec, mesh, "tp"), spec)
    out["tp_sampling"] = sampling_suite(make_engine(spec, mesh, "tp"), spec)
    engine = make_engine(spec, mesh, "tp")
    x = spec["x"][0]
    out["batch_2"] = {k: float(v) for k, v in engine.training_step(x[:2]).items()}
    out["batch_3"] = _refuses(lambda: engine.training_step(x[:3]), ValueError)
    out["spatial_forward"] = _spatial_forward(spec, make_mesh(device="cpu"))
    return out
