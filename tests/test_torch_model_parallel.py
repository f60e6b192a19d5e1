"""The port's model parallelism on the CPU: tensor parallelism on a data x
model mesh, the spatially sharded forward and chain, K fused steps on a
mesh, a 1x2 train CLI, the fold of GroupNorm's statistics alone, and the
refusals.

Two gloo ranks run every 2-rank scenario from one module fixture
(``_torch_parallel_ranks.model_parallel_2``), four ranks every 4-rank one
(``model_parallel_4``); each rendezvous is on a free port, its ranks killed
and the fixture failed after 240 s.  The one-process references and JAX's
side run here.

Tolerances:

  * against the port's one process (the 64-channel UNet of
    ``test_torch_parallel.py``, dropout 0.1, draws injected): every tensor
    of the state within 1e-5 of its group's largest (the parameters, the
    EMA, each Adam moment), the metrics 1e-5 relative, the chains 1e-5 of
    the largest pixel: the data-parallel gloo gate.  The gathered tensor-parallel
    products sum in another order than the whole ones;
  * a resume after 2 steps and the fused K = 2 steps against their eager
    steps: bit for bit (the same kernels in the same order);
  * against JAX's engine on ``make_mesh_2d(1, 2)`` with
    ``param_sharding="tp"``: the loss 1e-5 and the grad norm 1e-4 relative,
    the parameters and EMA within 2 lr (``test_two_ranks_match_jax_mesh``),
    the DDIM chain from the same weights rtol and atol 2e-5 (JAX's own
    ``test_tp_engine_matches_replicated``);
  * the spatial forward (JAX's ``test_spatial_sharded_forward_matches_single
    _device`` model and weights) against JAX's sharded forward and the port's
    unsharded one: rtol 2e-5, atol 2e-6 (JAX's own);
  * the fold alone against ``gn_affine_plain``: 1e-6.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probabilisticdeepdiffusionmodels_torch.cli import train as cli_train
from probabilisticdeepdiffusionmodels_torch.convert import (_convert_leaf, _flatten,
                                                            load_flax_params, params_from_flax)
from probabilisticdeepdiffusionmodels_torch.models import get_model
from probabilisticdeepdiffusionmodels_torch.ops.gn_conv import gn_affine_plain, gn_affine_slab
from probabilisticdeepdiffusionmodels_torch.ops.groupnorm import (gn_fold, gn_fold_plain,
                                                                  group_norm_silu_plain,
                                                                  group_norm_silu_slab,
                                                                  moments_plain)
from probabilisticdeepdiffusionmodels_torch.parallel import spatial, spawn
from probabilisticdeepdiffusionmodels_tpu.engine import DiffusionEngine as JaxEngine
from probabilisticdeepdiffusionmodels_tpu.models import get_model as jax_get_model
from probabilisticdeepdiffusionmodels_tpu.parallel import (make_mesh as jax_make_mesh,
                                                           make_mesh_2d as jax_make_mesh_2d,
                                                           replicated as jax_replicated,
                                                           spatial_sharding as jax_spatial,
                                                           tp_sharding as jax_tp_sharding)
import _torch_parallel_ranks as R
from test_cli import TINY
from test_torch_parallel import SMALL, B, LR, RES, T, _spec
from test_torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_train import _jax_draws

CPU = ["device=cpu"]
# JAX's test_spatial_sharded_forward_matches_single_device (tests/test_parallel.py)
SPATIAL_CFG = dict(name="unet", in_channels=3, model_channels=32, num_res_blocks=1,
                   attention_resolutions=[16], channel_mult=[1, 2], num_heads=2)
SPATIAL_RES = 32


def _jax_tp_side():
    """JAX's tp engine on a 1x2 mesh: its initial weights, two steps (with
    the draws it makes, read back), the DDIM chain from its weights after
    them, and the same two steps fused on a second engine."""
    def engine():
        return JaxEngine(dict(SMALL), {"lr": LR}, diffusion_steps=T, resolution=RES, ema=0.999,
                         seed=3, grad_clip=1.0, mesh=jax_make_mesh_2d(1, 2),
                         param_sharding="tp")

    jengine = engine()
    params = jax.tree.map(np.asarray, jengine.state.params)
    rng = np.random.default_rng(11)
    xs = rng.normal(size=(2, B, RES, RES, 3)).astype(np.float32)
    x_T = rng.normal(size=(B, RES, RES, 3)).astype(np.float32)
    ts, noises, metrics = [], [], []
    for x in xs:
        t, noise = _jax_draws(jengine.state, B, T, x.shape, "uniform", 10)
        m = jengine.training_step(jnp.asarray(x))
        ts.append(t)
        noises.append(noise)
        metrics.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])})
    after = jax.tree.map(np.asarray, jengine.state.params)
    out = {"metrics": metrics, "params": after,
           "ema": jax.tree.map(np.asarray, jengine.state.ema_params),
           "ddim": np.asarray(jengine.generate_images(n=B, minibatch=B, ddim=True,
                                                      num_sample_steps=10, x_T=x_T,
                                                      use_ema=False))}
    fused = engine()
    m = fused.training_steps(jnp.asarray(xs))
    out["fused"] = {"metrics": {k: np.asarray(m[k]) for k in ("loss", "grad_norm")},
                    "params": jax.tree.map(np.asarray, fused.state.params),
                    "ema": jax.tree.map(np.asarray, fused.state.ema_params)}
    side = dict(model=dict(SMALL), params=params, x=xs, t=np.stack(ts), noise=np.stack(noises),
                after=after, x_T=x_T, ddim_steps=10)
    return side, out


def _jax_spatial_side():
    """JAX's spatial test: its model, its perturbed weights, the forward on
    one device and sharded by height over 2 and 4 devices."""
    model = jax_get_model(SPATIAL_RES, dict(SPATIAL_CFG))
    x = jax.random.normal(jax.random.PRNGKey(0), (2, SPATIAL_RES, SPATIAL_RES, 3))
    t = jnp.full((2,), 10, jnp.int32)
    params = model.init(jax.random.PRNGKey(1), x, t)["params"]
    leaves, tree = jax.tree.flatten(params)
    leaves = [l + 0.02 * jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(2), i),
                                           l.shape) for i, l in enumerate(leaves)]
    params = jax.tree.unflatten(tree, leaves)
    fwd = jax.jit(lambda p, x, t: model.apply({"params": p}, x, t))
    out = {"one": np.asarray(fwd(params, x, t))}
    for n in (2, 4):
        mesh = jax_make_mesh(n)
        out[n] = np.asarray(fwd(jax.device_put(params, jax_replicated(mesh)),
                                jax.device_put(x, jax_spatial(mesh)), t))
    side = dict(model=dict(SPATIAL_CFG), res=SPATIAL_RES,
                params=jax.tree.map(np.asarray, params), x=np.asarray(x), t=np.asarray(t))
    return side, out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every spawned scenario, its one-process references, JAX's side, and
    the train CLI on one device and on a 1x2 mesh."""
    jax_tp, jax_tp_out = _jax_tp_side()
    jax_spatial, jax_spatial_out = _jax_spatial_side()
    spec = _spec(None)
    rng = np.random.default_rng(5)
    spec.update(jax_tp=jax_tp, spatial=jax_spatial, ckpt_dir=str(tmp_path_factory.mktemp("tp")),
                x4=rng.normal(size=(4, B, RES, RES, 3)).astype(np.float32),
                t4=rng.integers(1, T + 1, size=(4, B)),
                noise4=rng.normal(size=(4, B, RES, RES, 3)).astype(np.float32))
    two = spawn(R.model_parallel_2, 2, (spec,), device="cpu", join_timeout=240)
    four = spawn(R.model_parallel_4, 4, (spec,), device="cpu", join_timeout=240)
    one = {"plain": R.train_two_steps(R.make_engine(spec), spec),
           "four": R.four_steps(R.make_engine(spec), spec),
           "sampling": R.sampling_suite(R.make_engine(spec), spec)}
    model = load_flax_params(get_model(SPATIAL_RES, SPATIAL_CFG, device="cpu"),
                             jax_spatial["params"])
    with torch.no_grad():
        one["spatial"] = model(torch.as_tensor(jax_spatial["x"]),
                               torch.as_tensor(jax_spatial["t"]).long()).numpy()
    out_dir = tmp_path_factory.mktemp("tp_runs")
    args = TINY + CPU + [f"out_dir={out_dir}", "trainer.max_epochs=1", "visualization=none",
                         "trainer.watch_every_steps=2"]
    cli = {"one": cli_train.main(args + ["run_name=one"]),
           "tp": cli_train.main(args + ["run_name=tp", "trainer.devices=1x2",
                                        "engine.param_sharding=tp", "trainer.fused_steps=2"])}
    return dict(spec=spec, two=two, four=four, one=one, cli=cli,
                jax_tp=jax_tp_out, jax_spatial=jax_spatial_out)


# ------------------------------------------------------------- helpers


def _scale(tree) -> float:
    if isinstance(tree, dict):
        return max((_scale(v) for v in tree.values()), default=0.0)
    if isinstance(tree, (list, tuple)):
        return max((_scale(v) for v in tree), default=0.0)
    if isinstance(tree, torch.Tensor) and tree.dtype.is_floating_point:
        return float(tree.abs().max()) if tree.numel() else 0.0
    return 0.0


def _close(got, want, atol, path=""):
    """Every float tensor within ``atol``, everything else equal."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], atol, f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, atol, f"{path}/{i}")
    elif isinstance(want, torch.Tensor):
        if want.dtype.is_floating_point:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=atol,
                                       err_msg=path)
        else:
            assert torch.equal(got, want), path
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=path)
    else:
        assert got == want, path


def _close_state(got, want, rel=1e-5):
    """A gathered train state against one process's: each group (model, EMA,
    each Adam moment) within ``rel`` of its largest element; the counts,
    the loss history's integers and the generator equal."""
    for key in ("model", "ema_model"):
        _close(got[key], want[key], rel * _scale(want[key]), key)
    adam_got, adam_want = got["optimizer"]["adam"], want["optimizer"]["adam"]
    for name in ("exp_avg", "exp_avg_sq"):
        w = {k: v[name] for k, v in adam_want["state"].items()}
        g = {k: v[name] for k, v in adam_got["state"].items()}
        _close(g, w, rel * _scale(w), name)
    for k, v in adam_want["state"].items():
        assert float(adam_got["state"][k]["step"]) == float(v["step"])
    assert got["step"] == want["step"]
    _close(got["loss_history"], want["loss_history"], rel * _scale(want["loss_history"]))
    assert torch.equal(got["generator"], want["generator"])


def _equal_state(a, b, path=""):
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            _equal_state(a[k], b[k], f"{path}/{k}")
    elif isinstance(b, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_state(x, y, f"{path}/{i}")
    elif isinstance(b, torch.Tensor):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def _metrics(got, want):
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)


def _close_to_jax(state, want_params, want_ema):
    for ours, theirs in (("model", want_params), ("ema_model", want_ema)):
        for k, w in params_from_flax(theirs).items():
            np.testing.assert_allclose(state[ours][k].numpy(), w.numpy(), rtol=0, atol=2 * LR,
                                       err_msg=k)


# ------------------------------------------------------------- the mesh


def test_make_mesh_2d_axes(world):
    """JAX's test_make_mesh_2d: a (1, 2) mesh with axes (data, model); rank
    0 at (0, 0); fewer ranks than D x M raise."""
    shape, names, coords = world["two"]["mesh"]
    assert shape == (1, 2) and names == ("data", "model") and coords == [0, 0]
    assert "rank" in world["two"]["refusals"]["mesh_2d_too_few"]


def test_tp_shards_follow_tp_sharding(world):
    """Each rank holds, of every parameter, its EMA copy and its Adam
    moments, the half that JAX's ``tp_sharding`` puts on it (the
    output-feature axis of every large >= 2-D leaf), or the whole leaf
    where JAX replicates it."""
    params = world["spec"]["jax_tp"]["params"]
    specs = jax_tp_sharding(jax_make_mesh_2d(1, 2), params)
    flat = dict(_flatten(params))
    held = world["two"]["tp_held"]
    n_split = 0
    for keys, sharding in jax.tree_util.tree_flatten_with_path(specs)[0]:
        path = tuple(str(k.key) for k in keys)
        key, full = _convert_leaf(path, flat[path])
        want = list(full.shape)
        if "model" in tuple(sharding.spec):
            axis = tuple(sharding.spec).index("model")
            probe = np.broadcast_to(np.arange(flat[path].shape[axis], dtype=np.float32).reshape(
                [-1 if i == axis else 1 for i in range(flat[path].ndim)]), flat[path].shape)
            _, arr = _convert_leaf(path, np.ascontiguousarray(probe))
            port_axis = [i for i in range(arr.ndim) if np.ptp(arr, axis=i).max() > 0][0]
            want[port_axis] //= 2
            n_split += 1
        for rank_held in held:
            assert rank_held[key] == (tuple(want),) * 3, (key, rank_held[key], want)
    assert n_split > 10 and len(held[0]) == len(flat)


# ------------------------------------------------------------- tensor parallelism


@pytest.mark.parametrize("ranks", ["two", "four"], ids=["1x2", "2x2"])
def test_tp_steps_match_one_process(world, ranks):
    """Two float32 steps, dropout 0.1, the draws injected, on a 1x2 mesh and
    on a 2x2 mesh (the batch over the data axis): the metrics, the gathered
    parameters, EMA, Adam's moments and counts, the loss history and the
    generator against one process."""
    got, want = world[ranks]["tp"], world["one"]["plain"]
    _metrics(got["metrics"], want["metrics"])
    _close_state(got["state"], want["state"])


@pytest.mark.parametrize("ranks", ["two", "four"], ids=["1x2", "2x2"])
def test_tp_sampling_matches_one_process(world, ranks):
    """The ancestral and DDIM chains, RePaint and the NLL test from the same
    (filled) weights: 1e-5 of the largest pixel, the test means 1e-5."""
    got, want = world[ranks]["tp_sampling"], world["one"]["sampling"]
    for key in ("chain", "ddim", "inpaint"):
        scale = float(np.abs(want[key]).max())
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5 * scale, err_msg=key)
    for k, v in want["test_step"].items():
        np.testing.assert_allclose(got["test_step"][k], v, rtol=1e-5, err_msg=k)


def test_tp_resume_is_bit_for_bit(world):
    """2 steps, a checkpoint (the one-device file, written by rank 0),
    restored onto the 1x2 layout, 2 more: equal to 4 straight steps in every
    bit; and 4 straight steps against one process's."""
    got = world["two"]["resume"]
    _equal_state(got["stopped"], got["straight"])
    _close_state(got["straight"], world["one"]["four"])


def test_tp_matches_jax(world):
    """The port's 1x2 tp engine and JAX's on ``make_mesh_2d(1, 2)``, the same
    weights and draws: two steps, and the DDIM chain from JAX's weights
    after them."""
    got, want = world["two"]["jax_tp"], world["jax_tp"]
    for g, w in zip(got["steps"]["metrics"], want["metrics"]):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-4)
    _close_to_jax(got["steps"]["state"], want["params"], want["ema"])
    np.testing.assert_allclose(got["ddim"], want["ddim"], rtol=2e-5, atol=2e-5)


def test_tp_batch_divides_the_data_axis(world):
    """JAX's test_tp_mesh_batch_divisibility_uses_data_axis on a 2x2 mesh:
    a batch of 2 divides the data axis (not the 4 ranks), 3 does not."""
    assert np.isfinite(world["four"]["batch_2"]["loss"])
    assert "divisible" in world["four"]["batch_3"]


# ------------------------------------------------------------- fused steps on a mesh


@pytest.mark.parametrize("mesh", ["data", "tp"])
def test_fused_mesh_steps_match_eager(world, mesh):
    """``training_steps`` with K = 2 on a 2-rank data mesh and on the 1x2 tp
    mesh: the state of two eager mesh steps in every bit."""
    got = world["two"]["fused"][mesh]
    _equal_state(got["fused"], got["eager"])
    assert len(got["fused_loss"]) == 2


def test_fused_mesh_steps_match_jax(world):
    """``training_steps`` (K = 2) on the 1x2 tp mesh with JAX's draws
    injected against JAX's ``training_steps`` on its mesh."""
    got, want = world["two"]["jax_tp"]["fused"], world["jax_tp"]["fused"]
    np.testing.assert_allclose(got["metrics"]["loss"], want["metrics"]["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["metrics"]["grad_norm"], want["metrics"]["grad_norm"],
                               rtol=1e-4)
    _close_to_jax(got["state"], want["params"], want["ema"])


# ------------------------------------------------------------- spatial sharding


@pytest.mark.parametrize("ranks", ["two", "four"], ids=["2", "4"])
def test_spatial_forward_matches_jax(world, ranks):
    """JAX's spatial test model and weights, the height split over 2 and 4
    ranks: JAX's sharded forward and the port's unsharded one."""
    got = world[ranks]["spatial_forward"]
    n = 2 if ranks == "two" else 4
    np.testing.assert_allclose(got, world["jax_spatial"][n], rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(got, world["one"]["spatial"], rtol=2e-5, atol=2e-6)


def test_spatial_chain_matches_batch_sharded(world):
    """``generate_images(shard_mode="spatial")`` on 2 ranks against the
    batch-sharded chain of the same weights and seed: 1e-5 of the largest."""
    got = world["two"]["spatial_chain"]
    scale = float(np.abs(got["batch"]).max())
    assert got["spatial"].shape == got["batch"].shape == (2, RES, RES, 3)
    np.testing.assert_allclose(got["spatial"], got["batch"], rtol=0, atol=1e-5 * scale)


def test_spatial_refuses_an_indivisible_height(world):
    """Three downsamples of an 8-pixel height cannot split over 2 ranks."""
    assert "divisible by 2 * 2^3" in world["two"]["refusals"]["spatial_height"]


def test_check_height():
    spatial.check_height(256, 5, 2)
    with pytest.raises(ValueError, match="divisible"):
        spatial.check_height(24, 3, 2)


# ------------------------------------------------------------- the CLI and the refusals


def test_train_cli_on_a_1x2_mesh(world):
    """``trainer.devices=1x2 engine.param_sharding=tp trainer.fused_steps=2
    device=cpu``: the run holds what the one-device run holds (the weight
    histograms of the whole weights among it), follows it, and its
    checkpoint (the one-device file) loads on one device."""
    from probabilisticdeepdiffusionmodels_torch.cli.sample import load_engine_from_run

    one, tp = (pathlib.Path(world["cli"][k]["run_dir"]) for k in ("one", "tp"))

    def files(p):
        return sorted(str(f.relative_to(p)) for f in p.rglob("*") if f.is_file())

    assert files(one) == files(tp)
    rows = [json.loads(line) for line in (tp / "metrics.jsonl").read_text().splitlines()]
    assert len(rows) == len((one / "metrics.jsonl").read_text().splitlines())
    a, b = world["cli"]["one"], world["cli"]["tp"]
    assert a["steps"] == b["steps"] == 2
    np.testing.assert_allclose(b["best_val_loss"], a["best_val_loss"], rtol=1e-3)
    engine, _ = load_engine_from_run(tp, device="cpu")
    assert engine.mesh is None and engine.state.step == 2
    # the weight histograms count the whole weights, not rank 0's slices
    hist = [np.load(run / "media" / "weights_hist_step2.npz") for run in (one, tp)]
    for key in hist[0].files:
        if key.endswith("/counts"):
            assert hist[1][key].sum() == hist[0][key].sum(), key


def test_refusals_in_ranks(world):
    """tp on a mesh without a model axis raises as JAX's does."""
    assert "model" in world["two"]["refusals"]["tp_no_model_axis"]


# ------------------------------------------------------------- the fold alone


@pytest.mark.parametrize("mode", ["plain", "emb", "film"])
def test_fold_plain_matches_gn_affine_plain(mode):
    """The fold from E[x], E[x^2] (``gn_fold_plain``, the plain version of
    the fold kernel) against ``gn_affine_plain``'s (a, off): 1e-6."""
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(1.0, 2.0, size=(3, 4, 5, 64)).astype(np.float32))
    gamma, beta = (torch.as_tensor(rng.normal(size=64).astype(np.float32)) for _ in range(2))
    conds = [torch.as_tensor(rng.normal(size=(3, 64)).astype(np.float32)) for _ in range(2)]
    kw = {"plain": {}, "emb": {"emb": conds[0]}, "film": {"film": tuple(conds)}}[mode]
    a, off = gn_affine_plain(x, gamma, beta, 32, 1e-5, **kw)
    ao = gn_fold(moments_plain(x), gamma, beta, 32, 1e-5, **kw)
    assert ao.shape == (4, 3, 64)
    np.testing.assert_allclose(ao[0].numpy(), a.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ao[1].numpy(), off.numpy(), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(ao[2:], moments_plain(x), rtol=0, atol=0)
    np.testing.assert_array_equal(gn_fold_plain(moments_plain(x), gamma, beta, 32, 1e-5,
                                                **kw).numpy(), ao.numpy())


def test_slab_norms_on_one_rank_are_the_whole_norms():
    """With nothing to average (one rank holds the image), the slab versions
    of GroupNorm and ``gn_affine`` give the whole-image results."""
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.normal(size=(2, 8, 8, 64)).astype(np.float32))
    gamma, beta = (torch.as_tensor(rng.normal(size=64).astype(np.float32)) for _ in range(2))
    emb = torch.as_tensor(rng.normal(size=(2, 64)).astype(np.float32))
    same = lambda m: m  # noqa: E731
    np.testing.assert_allclose(group_norm_silu_slab(x, gamma, beta, 32, 1e-5, True, same),
                               group_norm_silu_plain(x, gamma, beta, 32, 1e-5, True),
                               rtol=1e-5, atol=1e-5)
    for got, want in zip(gn_affine_slab(x, gamma, beta, 32, 1e-5, same, emb=emb),
                         gn_affine_plain(x, gamma, beta, 32, 1e-5, emb=emb)):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

