"""The port's EDM, flow-matching and consistency families against the JAX
package: the preconditioning, grids and metrics of ``core``; the native
samplers' arithmetic on an analytic network; the EDM, flow and consistency
training steps (stopgrad and EMA targets, the annealed grid) with their
gradients; and the engine's native ``generate_images`` chains on converted
weights with JAX's draws injected.

Tolerances: the helpers and the analytic loops within 1e-6 (relative and
absolute: log, exp and the float32 grids round in their own ways); a train
step at test_torch_objectives.py's tolerances (loss 1e-5, grad_norm 1e-4
relative, each gradient within 1e-4 of its largest element); an engine chain
through the small UNet at 1e-4.  The EDM and consistency networks take
c_noise = ln(sigma) / 4 and the flow network t * 1000 as their timestep:
fractional, often negative, and held here against JAX's through the UNet.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

pytest.importorskip("flax")
pytest.importorskip("optax")
import optax  # noqa: E402

from probabilisticdeepdiffusionmodels_tpu.core import (  # noqa: E402
    DiffusionTables as JaxTables,
    NoiseSchedule as JaxSchedule,
)
from probabilisticdeepdiffusionmodels_tpu.core import consistency as JC  # noqa: E402
from probabilisticdeepdiffusionmodels_tpu.core import edm as JE  # noqa: E402
from probabilisticdeepdiffusionmodels_tpu.core import flow as JF  # noqa: E402
from probabilisticdeepdiffusionmodels_tpu.engine import (  # noqa: E402
    DiffusionEngine as JaxEngine,
)
from probabilisticdeepdiffusionmodels_tpu.models import get_model as jax_get_model  # noqa: E402
from probabilisticdeepdiffusionmodels_tpu.sample import (  # noqa: E402
    edm_sample_loop as jax_edm_sample_loop,
    flow_sample_loop as jax_flow_sample_loop,
)
from probabilisticdeepdiffusionmodels_tpu.sample.sampler import (  # noqa: E402
    consistency_sample_loop as jax_consistency_sample_loop,
)
from probabilisticdeepdiffusionmodels_tpu.train.consistency import (  # noqa: E402
    make_ct_train_step as jax_make_ct_train_step,
)
from probabilisticdeepdiffusionmodels_tpu.train.state import (  # noqa: E402
    TrainState as JaxTrainState,
)
from probabilisticdeepdiffusionmodels_tpu.train.step import (  # noqa: E402
    make_edm_train_step as jax_make_edm_train_step,
    make_flow_train_step as jax_make_flow_train_step,
)
from probabilisticdeepdiffusionmodels_torch.convert import (  # noqa: E402
    load_flax_params,
    params_from_flax,
)
from probabilisticdeepdiffusionmodels_torch.core import (  # noqa: E402
    ConsistencyConfig,
    DiffusionTables,
    EDMConfig,
    FlowConfig,
    NoiseSchedule,
    cm_metric,
    cm_precond,
    flow_time_grid,
    interpolate,
    karras_sigma_grid,
    loss_weight,
    pair_weight,
    precond,
    vp_t_to_flow_t,
)
from probabilisticdeepdiffusionmodels_torch.engine import AdamChain, DiffusionEngine  # noqa: E402
from probabilisticdeepdiffusionmodels_torch.models import get_model  # noqa: E402
from probabilisticdeepdiffusionmodels_torch.sample import (  # noqa: E402
    consistency_sample_loop,
    edm_sample_loop,
    flow_sample_loop,
)
from probabilisticdeepdiffusionmodels_torch.train import TrainState  # noqa: E402
from probabilisticdeepdiffusionmodels_torch.train.consistency import (  # noqa: E402
    make_ct_eval_step,
    make_ct_train_step,
)
from probabilisticdeepdiffusionmodels_torch.train.step import (  # noqa: E402
    make_edm_train_step,
    make_flow_train_step,
)
from test_torch_train import _adam_first_grads  # noqa: E402
from test_torch_unet import SMALL, _random_flax_params  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401

RES = 8
ONE_LEVEL = dict(SMALL, channel_mult=[1], attention_resolutions=[8])
# the train steps' UNet: no attention (the JAX step compiles for seconds)
TRAIN_CFG = dict(SMALL, channel_mult=[1], attention_resolutions=[])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _near(got, want, tol=1e-6):
    got = got.detach().numpy() if hasattr(got, "detach") else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# ------------------------------------------------------------- core helpers


def test_core_helpers_match_jax():
    """EDM's preconditioning, weight and grid; flow's interpolant, grid and
    VP map; consistency's preconditioning, metrics and pair weight."""
    sigma = np.array([0.002, 0.03, 0.5, 1.7, 80.0], np.float32)
    for got, want in zip(precond(_t(sigma), 0.5), JE.precond(jnp.asarray(sigma), 0.5)):
        _near(got, want)
    _near(loss_weight(_t(sigma), 0.5), JE.loss_weight(jnp.asarray(sigma), 0.5))
    for got, want in zip(cm_precond(_t(sigma), 0.5, 0.002),
                         JC.cm_precond(jnp.asarray(sigma), 0.5, 0.002)):
        _near(got, want)
    c_skip, c_out = (float(v[0]) for v in cm_precond(_t(sigma), 0.5, 0.002)[:2])
    assert (c_skip, c_out) == (1.0, 0.0)  # the boundary condition, exactly
    for n in (1, 2, 18):
        np.testing.assert_array_equal(karras_sigma_grid(n), JE.karras_sigma_grid(n))
    for n, shift in ((1, 1.0), (6, 3.0)):
        np.testing.assert_array_equal(flow_time_grid(n, shift), JF.flow_time_grid(n, shift))
    rng = np.random.RandomState(70)
    a, b = rng.randn(2, 3, 4, 4, 2).astype(np.float32)
    t = np.array([0.1, 0.5, 0.93], np.float32)
    for got, want in zip(interpolate(_t(a), _t(b), _t(t)), JF.interpolate(a, b, jnp.asarray(t))):
        _near(got, want)
    abar = np.asarray(JaxSchedule.create(50, "cosine").alphas_hat, np.float32)
    _near(vp_t_to_flow_t(_t(abar)), JF.vp_t_to_flow_t(jnp.asarray(abar)))
    for metric, c in (("pseudo_huber", 0.0), ("pseudo_huber", 0.3), ("l2", 0.0)):
        _near(cm_metric(_t(a), _t(b), metric, c), JC.cm_metric(a, b, metric, c))
    lo, hi = np.array([0.1, 2.0], np.float32), np.array([0.2, 3.5], np.float32)
    for w in ("ict", "none"):
        _near(pair_weight(_t(hi), _t(lo), w), JC.pair_weight(jnp.asarray(hi), jnp.asarray(lo), w))
    with pytest.raises(ValueError, match="grid_init"):
        ConsistencyConfig(grid_init=64).validate()


# ------------------------------------------------------------- native loops

B, H, W, C = 2, 6, 6, 1


def _jax_net(params, x, t, y=None):
    return jax.lax.optimization_barrier(0.1 * x + 1e-3 * t[:, None, None, None])


def _torch_net(x, t, y=None):
    return 0.1 * x + 1e-3 * t[:, None, None, None]


def _x_T(seed):
    return np.random.RandomState(seed).randn(B, H, W, C).astype(np.float32)


def _fold(key, n, shape):
    return np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, i), shape))
                     for i in range(n)])


def test_native_loops_match_jax():
    """EDM's Heun (with churn on every step), flow's Euler and Heun (shifted,
    clipped) and consistency's 3-step sampler on an analytic network that
    reads its fractional timestep, on JAX's draws (fold_in(key, i))."""
    x_T, key = _x_T(71), jax.random.PRNGKey(72)
    ref = np.asarray(jax_edm_sample_loop(_jax_net, None, None, jnp.asarray(x_T), key,
                                         n_steps=6, s_churn=3.0, clip=True))
    got = edm_sample_loop(_torch_net, None, _t(x_T), n_steps=6, s_churn=3.0, clip=True,
                          noise=_t(_fold(key, 6, x_T.shape)))
    _near(got, ref)
    for heun in (False, True):
        ref = np.asarray(jax_flow_sample_loop(_jax_net, None, None, jnp.asarray(x_T),
                                              n_steps=5, shift=2.0, heun=heun, clip=True))
        _near(flow_sample_loop(_torch_net, None, _t(x_T), n_steps=5, shift=2.0, heun=heun,
                               clip=True), ref)
    ref = np.asarray(jax_consistency_sample_loop(_jax_net, None, None, jnp.asarray(x_T), key,
                                                 n_steps=3, clip=True))
    _near(consistency_sample_loop(_torch_net, None, _t(x_T), n_steps=3, clip=True,
                                  noise=_t(_fold(key, 2, x_T.shape))), ref)
    with pytest.raises(ValueError, match="Generator"):
        consistency_sample_loop(_torch_net, None, _t(x_T), n_steps=2)


# ------------------------------------------------------------- train steps

T = 100


def _jax_setup(seed, ema=None):
    x0 = (np.random.RandomState(seed).randint(0, 256, size=(4, RES, RES, 3)) / 127.5
          - 1.0).astype(np.float32)
    jm = jax_get_model(RES, TRAIN_CFG)
    params = _random_flax_params(jm, jnp.asarray(x0), jnp.ones((4,), jnp.int32), seed=seed)
    jstate = JaxTrainState.create(params, optax.adam(2e-4), T, jax.random.PRNGKey(seed),
                                  ema_decay=ema)

    def apply_fn(p, x, t, y=None, **kwargs):
        return jm.apply({"params": p}, x, t, y)

    return x0, jm, params, jstate, apply_fn


def _port_state(params, seed, ema=None):
    model = load_flax_params(get_model(RES, TRAIN_CFG, device="cpu"), params)
    return TrainState(model, AdamChain(model.parameters(), 2e-4), T,
                      torch.Generator().manual_seed(seed), ema_decay=ema)


def _hold_step(metrics, jmetrics, state, jstate):
    assert set(metrics) == set(jmetrics)
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jmetrics["grad_norm"]),
                               rtol=1e-4)
    want = params_from_flax(_adam_first_grads(jstate))
    named = dict(state.model.named_parameters())
    assert set(want) == set(named)
    for k, w in want.items():
        np.testing.assert_allclose(named[k].grad.numpy(), w.numpy(), rtol=0,
                                   atol=1e-4 * float(w.abs().max()), err_msg=k)
    # the pseudo-Huber sqrt(d^2 + c^2) - c cancels for small d: each entry
    # within 1e-5 of the largest
    ring = np.asarray(jstate.loss_history.ring)
    np.testing.assert_allclose(state.loss_history.ring.numpy(), ring, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ring).max()))
    np.testing.assert_array_equal(state.loss_history.count.numpy(),
                                  np.asarray(jstate.loss_history.count))


def _tables():
    return (JaxTables.from_schedule(JaxSchedule.create(T, "cosine")),
            DiffusionTables.from_schedule(NoiseSchedule.create(T, "cosine"), "cpu"))


def test_edm_train_step_matches_jax():
    """One EDM step on JAX's sigma and noise; the loss history bucketed by
    the schedule's sigmas."""
    x0, _, params, jstate, apply_fn = _jax_setup(73)
    jt, tables = _tables()
    edm = EDMConfig()
    rng = jax.random.fold_in(jstate.rng, jstate.step)
    key_sig, key_noise, _ = jax.random.split(rng, 3)
    sigma = np.asarray(jnp.exp(edm.P_mean + edm.P_std * jax.random.normal(key_sig, (4,))))
    noise = np.asarray(jax.random.normal(key_noise, x0.shape))
    jstate, jmetrics = jax.jit(jax_make_edm_train_step(apply_fn, jt, JE.EDMConfig()))(
        jstate, jnp.asarray(x0))
    state = _port_state(params, 73)
    metrics = make_edm_train_step(tables, edm)(state, _t(x0), sigma=_t(sigma), noise=_t(noise))
    _hold_step(metrics, jmetrics, state, jstate)


def test_flow_train_step_matches_jax():
    """One flow-matching step on JAX's logit-normal t and noise."""
    x0, _, params, jstate, apply_fn = _jax_setup(74)
    jt, tables = _tables()
    rng = jax.random.fold_in(jstate.rng, jstate.step)
    key_t, key_noise, _ = jax.random.split(rng, 3)
    t = np.asarray(JF.sample_t(key_t, 4, JF.FlowConfig()))
    noise = np.asarray(jax.random.normal(key_noise, x0.shape))
    jstate, jmetrics = jax.jit(jax_make_flow_train_step(apply_fn, jt, JF.FlowConfig()))(
        jstate, jnp.asarray(x0))
    state = _port_state(params, 74)
    metrics = make_flow_train_step(tables, FlowConfig())(state, _t(x0), t=_t(t),
                                                         noise=_t(noise))
    _hold_step(metrics, jmetrics, state, jstate)


@pytest.mark.parametrize("config", [
    dict(),
    dict(target="ema", grid_size=16, grid_init=4, anneal_steps=4, metric="l2"),
], ids=["stopgrad", "ema_annealed"])
def test_ct_train_step_matches_jax(config):
    """One consistency-training step on JAX's pair index and z: the iCT
    default (stopgrad target, pseudo-Huber, fixed grid), and the EMA target
    (other weights than the live ones) at step 3 of an annealed grid, whose
    level (grid 8) is read from the host's step count."""
    x0, jm, params, jstate, apply_fn = _jax_setup(75, ema=0.99 if config else None)
    jt, tables = _tables()
    cfg = ConsistencyConfig(**config)
    state = _port_state(params, 75, ema=0.99 if config else None)
    if config:
        ema = _random_flax_params(jm, jnp.asarray(x0), jnp.ones((4,), jnp.int32), seed=76)
        jstate = jstate.replace(ema_params=ema, step=jnp.asarray(3, jnp.int32))
        load_flax_params(state.ema_model, ema)
        state.step = 3
    rng = jax.random.fold_in(jstate.rng, jstate.step)
    key_noise, _ = jax.random.split(rng)
    key_i, key_z = jax.random.split(key_noise)
    n_pairs = 7 if config else cfg.grid_size - 1
    index = np.asarray(jax.random.randint(key_i, (4,), 0, n_pairs))
    z = np.asarray(jax.random.normal(key_z, x0.shape, jnp.float32))
    jstate, jmetrics = jax.jit(jax_make_ct_train_step(apply_fn, jt, JC.ConsistencyConfig(
        **config)))(jstate, jnp.asarray(x0))
    metrics = make_ct_train_step(tables, cfg)(state, _t(x0), index=_t(index), z=_t(z))
    _hold_step(metrics, jmetrics, state, jstate)
    if config:
        assert metrics["grid_n"] == int(jmetrics["grid_n"]) == 8
    # the eval step is self-targeted on the full grid
    ev = make_ct_eval_step(tables, cfg)
    gen = torch.Generator().manual_seed(1)
    draws = ev.draw(gen, _t(x0))
    assert int(draws["index"].max()) < cfg.grid_size - 1
    assert torch.isfinite(ev(state.model, gen, _t(x0), **draws))


# ------------------------------------------------------------- engine chains

ENGINE_KW = dict(diffusion_steps=T, mode="cosine", resolution=RES, ema=0.9)


@pytest.fixture(scope="module")
def engines():
    """JAX's and the port's engine of each family on the same weights."""
    params = _random_flax_params(jax_get_model(RES, ONE_LEVEL), jnp.zeros((1, RES, RES, 3)),
                                 jnp.ones((1,), jnp.int32), seed=77)
    pairs = {}
    for kind in ("edm", "flow", "consistency"):
        jengine = JaxEngine(dict(ONE_LEVEL), {"lr": 2e-4}, prediction_type=kind, **ENGINE_KW)
        jengine.state = jengine.state.replace(params=params)
        engine = DiffusionEngine(dict(ONE_LEVEL), {"lr": 2e-4}, device="cpu",
                                 prediction_type=kind, **ENGINE_KW)
        load_flax_params(engine.state.model, params)
        pairs[kind] = (jengine, engine)
    return pairs


def _loop_key(seed):
    _, _, kloop = jax.random.split(jax.random.PRNGKey(seed), 3)
    return kloop


_CHAINS = {
    "edm_churn": ("edm", dict(edm=True, num_sample_steps=4, edm_churn=2.0), 4),
    "flow_euler": ("flow", dict(flow=True, num_sample_steps=4, flow_shift=3.0), 0),
    "flow_heun": ("flow", dict(flow=True, num_sample_steps=3, flow_heun=True), 0),
    "consistency_1": ("consistency", dict(consistency=True), 0),
    "consistency_2": ("consistency", dict(consistency=True, num_sample_steps=2), 1),
}


@pytest.mark.parametrize("name", sorted(_CHAINS))
def test_native_generate_images_matches_jax(engines, name):
    """The native chains from the same x_T (x0 unclipped), their draws
    JAX's."""
    kind, kw, n_draws = _CHAINS[name]
    jengine, engine = engines[kind]
    x_T = np.random.RandomState(78).randn(2, RES, RES, 3).astype(np.float32)
    want = jengine.generate_images(n=2, minibatch=2, seed=5, use_ema=False, x_T=x_T, **kw)
    noise = _fold(_loop_key(5), n_draws, x_T.shape) if n_draws else None
    got = engine.generate_images(n=2, minibatch=2, use_ema=False, x_T=x_T, noise=noise, **kw)
    _near(got, want, 1e-4)


def test_engine_family_refusals(engines):
    """A consistency engine has no eps view; a native sampler needs its own
    family and an int step count; the continuous objectives refuse the
    hybrid loss, importance sampling and min-SNR."""
    _, cm = engines["consistency"]
    _, edm = engines["edm"]
    with pytest.raises(ValueError, match="eps view"):
        cm.generate_images(n=1, ddim=True)
    with pytest.raises(ValueError, match="eps view"):
        cm.calculate_likelihood(np.zeros((1, RES, RES, 3), np.float32))
    with pytest.raises(ValueError, match='prediction_type="flow"'):
        edm.generate_images(n=1, flow=True)
    with pytest.raises(ValueError, match="int num_sample_steps"):
        edm.generate_images(n=1, edm=True, num_sample_steps="karras5")
    for kw in (dict(loss_type="hybrid"), dict(sampling="importance"),
               dict(loss_weighting="min_snr")):
        with pytest.raises(ValueError, match="flow"):
            DiffusionEngine(dict(ONE_LEVEL), {"lr": 2e-4}, device="cpu", prediction_type="flow",
                            **ENGINE_KW, **kw)
