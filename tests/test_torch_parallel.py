"""The port's data parallelism on the CPU: the runtime, the mesh's placement
rules, the sharded loaders, the data-parallel and FSDP train steps, the
batch-sharded chain, RePaint and NLL test, the mesh FID statistics, the
2-rank train CLI, and the refusals (model parallelism itself is in
``test_torch_model_parallel.py``).

Two ranks over gloo run every scenario from one module fixture
(``_torch_parallel_ranks.scenarios``, one rendezvous on a free port, the
ranks killed and the fixture failed after 120 s), and the fixture runs the
2-rank train CLI once.  The one-process references run here.

Tolerances: a 2-rank step against the one-process step within 1e-6 (the
loss, the grad norm, the parameters, EMA and Adam moments after two steps,
the loss history's rows), at lr 2e-4 on a UNet of 64 channels: Adam moves
a parameter by about lr * g / |g|, so a parameter whose gradient is zero
analytically (a bias under a one-channel GroupNorm group) takes round-off
up to lr, and this model has none.  The chain, RePaint and the test step
within 1e-6, the FID moments 1e-7 relative.  Against JAX's own engine on
``make_mesh(2)``: the step at ``test_torch_train.py``'s tolerances (loss
1e-5 and grad norm 1e-4 relative, parameters and EMA 2 * lr) and the
DDIM chain at 1e-4, as the engine's sampler endpoints are held.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probabilisticdeepdiffusionmodels_torch.cli import train as cli_train
from probabilisticdeepdiffusionmodels_torch.cli.sample import load_engine_from_run
from probabilisticdeepdiffusionmodels_torch.convert import _convert_leaf, _flatten
from probabilisticdeepdiffusionmodels_torch.data import ArrayDataset, DataLoader, DeviceDataLoader
from probabilisticdeepdiffusionmodels_torch.engine import DiffusionEngine
from probabilisticdeepdiffusionmodels_torch.evals.fid import compute_statistics
from probabilisticdeepdiffusionmodels_torch.parallel import (initialize_runtime, make_mesh,
                                                             runtime_from_env, spawn)
from probabilisticdeepdiffusionmodels_tpu.engine import DiffusionEngine as JaxEngine
from probabilisticdeepdiffusionmodels_tpu.parallel import (fsdp_sharding as jax_fsdp_sharding,
                                                           make_mesh as jax_make_mesh,
                                                           make_mesh_2d as jax_make_mesh_2d,
                                                           runtime_from_env as jax_runtime_from_env,
                                                           tp_sharding as jax_tp_sharding)
import _torch_parallel_ranks as R
from test_cli import TINY
from test_torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_train import _jax_draws

CPU = ["device=cpu"]
SMALL = dict(name="unet", in_channels=3, model_channels=64, num_res_blocks=1,
             attention_resolutions=[4], channel_mult=[1, 2], num_heads=2)
T, RES, B, LR = 50, 8, 4, 2e-4


def _spec(jax_side):
    rng = np.random.default_rng(0)
    mask = np.ones((RES, RES, 1), np.float32)
    mask[:, RES // 2:] = 0.0
    return dict(
        model=dict(SMALL, dropout=0.1), lr=LR, T=T, res=RES, seed=3, grad_clip=1.0,
        min_size=1000, chain_steps=10, mask=mask,
        x=rng.normal(size=(2, B, RES, RES, 3)).astype(np.float32),
        t=rng.integers(1, T + 1, size=(2, B)),
        noise=rng.normal(size=(2, B, RES, RES, 3)).astype(np.float32),
        fid_batches=[rng.uniform(size=(n, RES, RES, 3)).astype(np.float32) for n in (5, 3, 4)],
        jax=jax_side)


def _jax_side():
    """JAX's engine on its own 2-device mesh: its initial weights, one step
    (with the draws it makes, read back) and its DDIM chain."""
    jengine = JaxEngine(dict(SMALL), {"lr": LR}, diffusion_steps=T, resolution=RES,
                        ema=0.999, seed=3, grad_clip=1.0, mesh=jax_make_mesh(2))
    params = jax.tree.map(np.asarray, jengine.state.params)
    x = np.random.default_rng(1).normal(size=(B, RES, RES, 3)).astype(np.float32)
    x_T = np.random.default_rng(2).normal(size=(B, RES, RES, 3)).astype(np.float32)
    ddim = np.asarray(jengine.generate_images(n=B, minibatch=B, ddim=True,
                                              num_sample_steps=10, x_T=x_T))
    t, noise = _jax_draws(jengine.state, B, T, x.shape, "uniform", 10)
    metrics = jengine.training_step(jnp.asarray(x))
    after = {"params": jax.tree.map(np.asarray, jengine.state.params),
             "ema": jax.tree.map(np.asarray, jengine.state.ema_params),
             "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"])}
    return dict(model=dict(SMALL), params=params, x=x, t=t, noise=noise, x_T=x_T,
                ddim_steps=10), {"ddim": ddim, **after}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every spawned scenario and its one-process reference, and the train
    CLI on one device and on two ranks."""
    jax_side, jax_out = _jax_side()
    spec = _spec(jax_side)
    ranks = spawn(R.scenarios, 2, (spec,), device="cpu", join_timeout=120)
    one = {"plain": R.train_two_steps(R.make_engine(spec), spec)}
    one["sampling"] = R.chain_inpaint_test(R.make_engine(spec), spec)
    one["fid"] = compute_statistics(spec["fid_batches"], feature_fn=R.features)
    out_dir = tmp_path_factory.mktemp("dp_runs")
    args = TINY + CPU + [f"out_dir={out_dir}", "trainer.max_epochs=1", "visualization=none"]
    cli = {"one": cli_train.main(args + ["run_name=one"]),
           "two": cli_train.main(args + ["run_name=two", "trainer.devices=2"])}
    return dict(spec=spec, ranks=ranks, one=one, jax=jax_out, cli=cli)


# ------------------------------------------------------------- the runtime


_ENVS = [
    {},
    {"PDDM_NUM_PROCESSES": "1"},
    {"PDDM_NUM_PROCESSES": "4", "PDDM_PROCESS_ID": "2", "PDDM_COORDINATOR": "h:1234"},
    {"PDDM_NUM_PROCESSES": "2", "PDDM_PROCESS_ID": "0", "PDDM_COORDINATOR": "10.0.0.1:9"},
    {"PDDM_NUM_PROCESSES": "2", "PDDM_PROCESS_ID": "1"},
    {"PDDM_NUM_PROCESSES": "2", "PDDM_COORDINATOR": "h:1"},
]


@pytest.mark.parametrize("env", _ENVS, ids=["empty", "one", "four", "main", "no_coord",
                                             "no_id"])
def test_runtime_from_env_matches_jax(env):
    """The PDDM_* variables read as JAX reads them: the same RuntimeInfo, or
    a ValueError where JAX raises one."""
    try:
        want = jax_runtime_from_env(env)
    except ValueError:
        with pytest.raises(ValueError):
            runtime_from_env(env)
        return
    got = runtime_from_env(env)
    assert (got.process_index, got.process_count, got.coordinator, got.is_main,
            got.is_distributed) == (want.process_index, want.process_count, want.coordinator,
                                    want.is_main, want.is_distributed)


def test_runtime_reads_torch_launcher_and_initializes():
    """torchrun's variables where JAX reads JAX_*, PDDM_* winning; the
    injected initializer gets gloo for the CPU and the coordinator."""
    env = {"WORLD_SIZE": "3", "RANK": "1", "MASTER_ADDR": "a", "MASTER_PORT": "7"}
    info = runtime_from_env(env)
    assert (info.process_index, info.process_count, info.coordinator) == (1, 3, "a:7")
    assert runtime_from_env(dict(env, PDDM_PROCESS_ID="2")).process_index == 2
    calls = []
    assert initialize_runtime(env, device="cpu",
                              _distributed_initialize=lambda **kw: calls.append(kw)) == info
    assert calls == [dict(backend="gloo", init_method="tcp://a:7", world_size=3, rank=1)]
    assert initialize_runtime({}, device="cpu", _distributed_initialize=None).process_count == 1


def test_make_mesh_needs_a_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(1, device="cpu")


# ------------------------------------------------------------- placement rules


def _port_axis(path, flax_axis, shape):
    """The port's axis holding Flax axis ``flax_axis`` of leaf ``path``:
    convert an array that varies along that axis alone and see where."""
    probe = np.broadcast_to(np.arange(shape[flax_axis], dtype=np.float32).reshape(
        [-1 if i == flax_axis else 1 for i in range(len(shape))]), shape)
    key, arr = _convert_leaf(path, np.ascontiguousarray(probe))
    varies = [i for i in range(arr.ndim) if arr.shape[i] > 1 and np.ptp(arr, axis=i).max() > 0]
    return key, (varies[0] if varies else None)


@pytest.mark.parametrize("rule", ["fsdp", "tp"])
def test_placement_rules_pick_jax_axis(world, rule):
    """For every leaf of the tiny UNet, the port's rule splits the port axis
    that holds the Flax axis JAX's rule splits (a square conv's Cout, not
    its Cin), or nothing where JAX replicates."""
    params = world["spec"]["jax"]["params"]
    if rule == "fsdp":
        specs = jax_fsdp_sharding(jax_make_mesh(2), params, min_size=1000)
        axis = "data"
    else:
        specs = jax_tp_sharding(jax_make_mesh_2d(1, 2), params, min_size=1000)
        axis = "model"
    got = world["ranks"]["rules"][rule]
    flat = dict(_flatten(params))
    n_split = 0
    for keys, sharding in jax.tree_util.tree_flatten_with_path(specs)[0]:
        path = tuple(str(k.key) for k in keys)
        spec = tuple(sharding.spec) + (None,) * (flat[path].ndim - len(tuple(sharding.spec)))
        key, _ = _convert_leaf(path, flat[path])
        if axis not in spec:
            assert got[key] is None, key
            continue
        key, want = _port_axis(path, spec.index(axis), flat[path].shape)
        assert got[key] == want, (key, got[key], want)
        n_split += 1
    assert n_split > 10 and len(got) == len(flat)


# ------------------------------------------------------------- loaders


@pytest.mark.parametrize("device_resident", [False, True], ids=["host", "device"])
def test_sharded_loaders_partition_the_epoch(device_resident):
    """Two shards of a seeded epoch: disjoint, their union the one-process
    epoch, each ``order[shard::2]``; ``__len__`` counts its batches."""
    n, bs = 23, 4
    images = np.arange(n, dtype=np.uint8).reshape(n, 1, 1, 1) * np.ones((1, 2, 2, 1), np.uint8)
    ds = ArrayDataset(images, np.arange(n))
    kw = dict(batch_size=bs, train=True, seed=7, drop_last=False)
    if device_resident:
        kw["device"] = "cpu"
    cls = DeviceDataLoader if device_resident else DataLoader

    def order(loader):
        return np.concatenate([np.asarray(y) for _, y in loader.epoch()])

    whole = order(cls(ds, **kw))
    shards = [cls(ds, shard_id=s, num_shards=2, **kw) for s in range(2)]
    parts = [order(s) for s in shards]
    for s, (loader, part) in enumerate(zip(shards, parts)):
        np.testing.assert_array_equal(part, whole[s::2])
        assert len(loader) == -(-(-(-(n - s) // 2)) // bs)
    assert not set(parts[0]) & set(parts[1])
    assert sorted(np.concatenate(parts)) == sorted(whole) == list(range(n))


# ------------------------------------------------------------- the steps


def _close_tree(got, want, atol, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close_tree(got[k], want[k], atol, f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close_tree(g, w, atol, f"{path}/{i}")
    elif isinstance(want, torch.Tensor):
        if want.dtype.is_floating_point:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=atol,
                                       err_msg=path)
        else:
            assert torch.equal(got, want), path
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=path)
    else:
        assert got == want, path


@pytest.mark.parametrize("mode", ["replicated", "fsdp"])
def test_two_rank_step_matches_one_process(world, mode):
    """Two steps at float32, dropout 0.1, the draws injected: the metrics,
    the parameters, EMA, Adam's moments and counts, the loss history and the
    generator's state (every rank draws the global masks) within 1e-6 of
    one process; the FSDP state gathered whole first."""
    got, want = world["ranks"][mode], world["one"]["plain"]
    for g, w in zip(got["metrics"], want["metrics"]):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-6, err_msg=k)
    _close_tree(got["state"], want["state"], atol=1e-6)
    assert got["state"]["step"] == 2


def test_fsdp_ranks_hold_one_shard_each(world):
    """Each rank keeps 1/2 of every leaf the rule splits (parameter, EMA,
    Adam moment) along its dim, and after the update the modules' working
    copies of those leaves hold no storage."""
    held = world["ranks"]["fsdp"]["extra"]["held"]
    dims = world["ranks"]["fsdp"]["extra"]["dims"]
    assert len(held) == 2 and sum(d is not None for d in dims.values()) > 10
    for rank_held in held:
        for key, (d, full, master, nbytes) in rank_held.items():
            which, name = key.split(":", 1)
            assert dims[name] == d
            if full is not None:
                assert nbytes == 0, key
                assert master[d] * 2 == full[d] and master[:d] + master[d + 1:] == \
                    full[:d] + full[d + 1:], key
        assert {k.split(":", 1)[1] for k in rank_held} == {n for n, d in dims.items()
                                                           if d is not None}


def test_sharded_chain_inpaint_and_test_step_match(world):
    """The batch-sharded ancestral chain, RePaint and the NLL test on two
    ranks: one process's results within 1e-6, whole on rank 0."""
    got, want = world["ranks"]["sampling"], world["one"]["sampling"]
    assert got["chain"].shape == want["chain"].shape == (4, RES, RES, 3)
    np.testing.assert_allclose(got["chain"], want["chain"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["inpaint"], want["inpaint"], rtol=0, atol=1e-6)
    assert set(got["test_step"]) == set(want["test_step"])
    for k, v in want["test_step"].items():
        np.testing.assert_allclose(got["test_step"][k], v, rtol=1e-6, err_msg=k)


def test_mesh_fid_statistics_match_one_process(world):
    """Ragged batches (the padding weighted 0) over two ranks: the mean and
    the covariance within 1e-7 relative."""
    (mu, cov), (mu1, cov1) = world["ranks"]["fid"], world["one"]["fid"]
    np.testing.assert_allclose(mu, mu1, rtol=1e-7, atol=0)
    np.testing.assert_allclose(cov, cov1, rtol=1e-7, atol=1e-12)


def test_two_ranks_match_jax_mesh(world):
    """The port's 2 ranks against JAX's engine on ``make_mesh(2)``, the same
    weights and draws: one step and the DDIM chain."""
    got, want = world["ranks"]["jax_step"], world["jax"]
    np.testing.assert_allclose(got["metrics"]["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["metrics"]["grad_norm"], want["grad_norm"], rtol=1e-4)
    from probabilisticdeepdiffusionmodels_torch.convert import params_from_flax

    for ours, theirs in (("model", "params"), ("ema_model", "ema")):
        for k, w in params_from_flax(want[theirs]).items():
            np.testing.assert_allclose(got["state"][ours][k].numpy(), w.numpy(), rtol=0,
                                       atol=2 * LR, err_msg=k)
    np.testing.assert_allclose(world["ranks"]["jax_ddim"], want["ddim"], rtol=0, atol=1e-4)


# ------------------------------------------------------------- the CLI


def test_train_cli_on_two_ranks(world):
    """``trainer.devices=2 device=cpu``: rank 1 writes nothing (the run
    holds what a one-device run holds, each metric row once), the run
    follows the one-device run, and its checkpoint loads on one device."""
    one, two = (pathlib.Path(world["cli"][k]["run_dir"]) for k in ("one", "two"))

    def files(p):
        return sorted(str(f.relative_to(p)) for f in p.rglob("*") if f.is_file())

    assert files(one) == files(two)
    rows = [json.loads(line) for line in (two / "metrics.jsonl").read_text().splitlines()]
    assert len(rows) == len((one / "metrics.jsonl").read_text().splitlines())
    a, b = world["cli"]["one"], world["cli"]["two"]
    assert a["steps"] == b["steps"] == 2
    np.testing.assert_allclose(b["best_val_loss"], a["best_val_loss"], rtol=1e-3)
    engine, _ = load_engine_from_run(two, device="cpu")
    assert engine.mesh is None and engine.state.step == 2
    x = np.random.default_rng(0).normal(size=(2, 8, 8, 1)).astype(np.float32)
    assert all(np.isfinite(v) for v in engine.test_step(x).values())


def test_unported_raises_name_item_21():
    """The refusals left once ROADMAP item 21 (model parallelism) is ported:
    a malformed ``DxM``, tp or fsdp without a mesh (JAX's
    test_tp_requires_model_axis), an unknown shard mode; a spatial chain
    without a mesh runs whole, as JAX's does."""
    with pytest.raises(ValueError, match="DxM"):
        cli_train.main(TINY + CPU + ["trainer.devices=2xa"])
    for mode in ("tp", "fsdp"):
        with pytest.raises(ValueError, match="requires a mesh"):
            DiffusionEngine(dict(SMALL), {"lr": LR}, resolution=RES, device="cpu",
                            param_sharding=mode)
    engine = DiffusionEngine(dict(SMALL), {"lr": LR}, diffusion_steps=T, resolution=RES,
                             device="cpu")
    with pytest.raises(ValueError, match="shard_mode"):
        engine.generate_images(n=1, shard_mode="rows")
    whole = engine.generate_images(n=1, minibatch=1, num_sample_steps=2, seed=1)
    np.testing.assert_array_equal(engine.generate_images(n=1, minibatch=1, num_sample_steps=2,
                                                         seed=1, shard_mode="spatial"), whole)
