"""The port's fast samplers against the JAX package: DDIM (with eta), DPM-Solver++
(orders 1 and 2), Heun (with and without churn), RePaint inpainting, DDIM
inversion and the encoder-reuse segments, each loop on the analytic eps model
of test_torch_sampler.py (eps = 0.1 * x) at T = 20 with JAX's draws injected;
then the engine's endpoints (``generate_images`` with each of these samplers,
``inpaint``, ``ddim_invert``, ``get_feature_vectors``) on converted weights
against the JAX engine.

Tolerances: each loop is held at 1e-6 (relative and absolute) against JAX's parity-mode
trajectory (``jax.enable_x64()``), on a schedule that keeps the states of
order 1.  Not bit for bit even where a loop's arithmetic is + - * / and sqrt
alone: XLA's CPU compiler contracts a product and a sum into one fused
multiply-add (DDIM's sqrt(ab') x0 + sqrt(1 - ab' - s^2) eps differs by one
float32 ulp from the same two terms rounded separately), and DPM-Solver++'s
log, log1p and expm1 round in their own ways.  An engine endpoint through the
small UNet is held at 1e-4, as test_torch_viz.py holds the five
visualization endpoints.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

pytest.importorskip("flax")
pytest.importorskip("optax")

from probabilisticdeepdiffusionmodels_tpu.core import (  # noqa: E402
    DiffusionTables as JaxTables,
    NoiseSchedule as JaxSchedule,
)
from probabilisticdeepdiffusionmodels_tpu.engine import (  # noqa: E402
    DiffusionEngine as JaxEngine,
)
from probabilisticdeepdiffusionmodels_tpu.sample import (  # noqa: E402
    ddim_invert_loop as jax_ddim_invert_loop,
    ddim_sample_loop as jax_ddim_sample_loop,
    dpmpp_sample_loop as jax_dpmpp_sample_loop,
    heun_sample_loop as jax_heun_sample_loop,
    inpaint_sample_loop as jax_inpaint_sample_loop,
    p_sample_loop as jax_p_sample_loop,
    respaced_schedule as jax_respaced_schedule,
    space_timesteps as jax_space_timesteps,
)
from probabilisticdeepdiffusionmodels_torch.convert import load_flax_params  # noqa: E402
from probabilisticdeepdiffusionmodels_torch.core import (  # noqa: E402
    DiffusionTables,
    NoiseSchedule,
)
from probabilisticdeepdiffusionmodels_torch.engine import DiffusionEngine  # noqa: E402
from probabilisticdeepdiffusionmodels_torch.sample import (  # noqa: E402
    ddim_invert_loop,
    ddim_sample_loop,
    dpmpp_sample_loop,
    heun_sample_loop,
    inpaint_sample_loop,
    p_sample_loop,
    respaced_schedule,
    space_timesteps,
)
from test_torch_unet import SMALL, _random_flax_params  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401

T = 20
B, H, W, C = 2, 6, 6, 1
EPS_COEF = np.float32(0.1)


def _x_T(seed=0):
    return np.random.RandomState(seed).randn(B, H, W, C).astype(np.float32)


def _jax_eps(params, x, t, y=None):
    # the barrier keeps XLA from simplifying through the model
    return jax.lax.optimization_barrier(EPS_COEF * x)


def _torch_eps(x, t, y=None):
    return EPS_COEF * x


def _schedules(respaced):
    """(JAX tables, port tables, timestep map or None): a linear ramp to
    beta = 0.1 over T = 20 steps, or respaced to its "ddim5" steps.  (With
    this model a chain to ab_T ~ 0 multiplies x by hundreds, and float32
    rounding with it.)"""
    kw = dict(beta_start=1e-3, beta_end=0.1)
    if not respaced:
        return (JaxTables.from_schedule(JaxSchedule.create(T, "linear", **kw)),
                DiffusionTables.from_schedule(NoiseSchedule.create(T, "linear", **kw), "cpu"),
                None)
    kept = jax_space_timesteps(T, "ddim5")
    jsched, jmap = jax_respaced_schedule(JaxSchedule.create(T, "linear", **kw), kept)
    sched, tmap = respaced_schedule(NoiseSchedule.create(T, "linear", **kw),
                                    space_timesteps(T, "ddim5"))
    np.testing.assert_array_equal(tmap, jmap)
    return (JaxTables.from_schedule(jsched), DiffusionTables.from_schedule(sched, "cpu"), tmap)


def _near(got, ref):
    """Within 1e-6 relative and absolute of JAX's parity-mode trajectory
    (values of order 1)."""
    assert np.isfinite(ref).all() and np.abs(ref).max() < 10
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


def _fold_noise(key, ts, shape):
    """normal(fold_in(key, t)) for each t of ``ts``, stacked."""
    return np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, int(t)), shape,
                                                   jnp.float32)) for t in ts])


# ------------------------------------------------------------- the loops


@pytest.mark.parametrize("eta,clip,respaced", [(0.0, False, False), (0.0, True, True),
                                                (0.5, True, False)],
                         ids=["eta0", "eta0_clip_respaced", "eta0.5_clip"])
def test_ddim_matches_jax(eta, clip, respaced):
    """Deterministic, clipped and respaced, and eta > 0 on JAX's z of each step."""
    jt, tables, tmap = _schedules(respaced)
    n = tables.diffusion_steps
    x_T, key = _x_T(), jax.random.PRNGKey(3)
    with jax.enable_x64():
        ref = np.asarray(jax_ddim_sample_loop(
            _jax_eps, None, jt, jnp.asarray(x_T), key, eta=eta, clip=clip,
            timestep_map=None if tmap is None else jnp.asarray(tmap)))
        z = _fold_noise(key, range(n, 0, -1), x_T.shape)
    out = ddim_sample_loop(_torch_eps, tables, torch.from_numpy(x_T), eta=eta, clip=clip,
                           timestep_map=tmap, noise=torch.from_numpy(z))
    _near(out, ref)


@pytest.mark.parametrize("order,clip", [(1, False), (2, False), (2, True)])
def test_dpmpp_matches_jax(order, clip):
    """Within 1e-6 relative and absolute (log, log1p and expm1 round in
    their own ways, and h = lambda_{t-1} - lambda_t cancels); the last step
    returns the x0 prediction, as JAX's float32 clamp of ab_{t-1} at
    1 - 1e-12 is 1.0 (a no-op)."""
    jt, tables, _ = _schedules(False)
    x_T = _x_T(1)
    with jax.enable_x64():
        ref = np.asarray(jax_dpmpp_sample_loop(_jax_eps, None, jt, jnp.asarray(x_T),
                                               order=order, clip=clip))
    out = dpmpp_sample_loop(_torch_eps, tables, torch.from_numpy(x_T), order=order, clip=clip)
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="orders 1 and 2"):
        dpmpp_sample_loop(_torch_eps, tables, torch.from_numpy(x_T), order=3)


@pytest.mark.parametrize("churn,clip", [(0.0, False), (0.0, True), (10.0, False)],
                         ids=["plain", "clip", "churn"])
def test_heun_matches_jax(churn, clip):
    """Plain, clipped, and with churn at every step on JAX's z of each step;
    two model calls a step, one for the last."""
    jt, tables, _ = _schedules(False)
    x_T, key = _x_T(2), jax.random.PRNGKey(4)
    with jax.enable_x64():
        ref = np.asarray(jax_heun_sample_loop(_jax_eps, None, jt, jnp.asarray(x_T), key,
                                              clip=clip, s_churn=churn))
        z = _fold_noise(key, range(T, 0, -1), x_T.shape)
    calls = []

    def counting(x, t, y=None):
        calls.append(int(t[0]))
        return _torch_eps(x, t)

    out = heun_sample_loop(counting, tables, torch.from_numpy(x_T), clip=clip, s_churn=churn,
                           noise=torch.from_numpy(z))
    _near(out, ref)
    assert len(calls) == 2 * T - 1


def test_heun_churn_window():
    """A step whose sigma lies outside [s_tmin, s_tmax] takes no noise: with
    an empty window the churned chain is the plain one (up to the rounding
    of ab = 1 / (1 + sigma^2)); with a window the noise enters.  (JAX's
    compiled loop is not held here: XLA contracts sigma_hat^2 - sigma_t^2
    into a fused multiply-add, so a step outside the window takes noise of
    the size sqrt(ulp(sigma^2)) * z, ROADMAP.md Queue 3.)"""
    _, tables, _ = _schedules(False)
    x_T = torch.from_numpy(_x_T(2))
    plain = heun_sample_loop(_torch_eps, tables, x_T)
    z = torch.from_numpy(np.random.RandomState(3).randn(T, B, H, W, C).astype(np.float32))
    empty = heun_sample_loop(_torch_eps, tables, x_T, s_churn=10.0, s_tmin=50.0, noise=z)
    np.testing.assert_allclose(empty.numpy(), plain.numpy(), rtol=0, atol=1e-5)
    window = heun_sample_loop(_torch_eps, tables, x_T, s_churn=10.0, s_tmin=0.5, s_tmax=5.0,
                              noise=z)
    assert float((window - plain).abs().max()) > 1e-2
    with pytest.raises(ValueError, match="Generator"):
        heun_sample_loop(_torch_eps, tables, x_T, s_churn=1.0)


@pytest.mark.parametrize("resample_steps", [1, 2])
def test_inpaint_loop_matches_jax(resample_steps):
    """RePaint on JAX's three draws of each step and pass: the step's z, the
    known region's noise and the re-noise; the known region is x0 exactly."""
    jt, tables, _ = _schedules(False)
    rng = np.random.RandomState(5)
    x_T, x0 = _x_T(5), rng.uniform(-1, 1, size=(B, H, W, C)).astype(np.float32)
    mask = np.zeros((H, W, C), np.float32)
    mask[:, : W // 2] = 1.0
    key = jax.random.PRNGKey(6)
    with jax.enable_x64():
        ref = np.asarray(jax_inpaint_sample_loop(
            _jax_eps, None, jt, jnp.asarray(x_T), key, x0_known=jnp.asarray(x0),
            mask=jnp.asarray(mask), clip=True, resample_steps=resample_steps))
        draws = np.stack([np.stack([
            np.stack([np.asarray(jax.random.normal(k, x_T.shape, jnp.float32))
                      for k in jax.random.split(
                jax.random.fold_in(jax.random.fold_in(key, t), i), 3)])
            for i in range(resample_steps)]) for t in range(T, 0, -1)])
    out = inpaint_sample_loop(_torch_eps, tables, torch.from_numpy(x_T),
                              x0_known=torch.from_numpy(x0), mask=torch.from_numpy(mask),
                              clip=True, resample_steps=resample_steps,
                              noise=torch.from_numpy(draws))
    _near(out, ref)
    np.testing.assert_array_equal(out.numpy()[:, :, : W // 2], x0[:, :, : W // 2])


def test_ddim_invert_matches_jax_and_round_trips():
    """The inversion, full and to t_end; for an x-independent eps
    the eta = 0 DDIM chain decodes it back to x0 (float32 rounding)."""
    jt, tables, tmap = _schedules(True)
    x0 = np.random.RandomState(7).uniform(-1, 1, size=(B, H, W, C)).astype(np.float32)
    with jax.enable_x64():
        ref = np.asarray(jax_ddim_invert_loop(_jax_eps, None, jt, jnp.asarray(x0),
                                              timestep_map=jnp.asarray(tmap)))
        ref3 = np.asarray(jax_ddim_invert_loop(_jax_eps, None, jt, jnp.asarray(x0), t_end=3))
    out = ddim_invert_loop(_torch_eps, tables, torch.from_numpy(x0), timestep_map=tmap)
    _near(out, ref)
    _near(ddim_invert_loop(_torch_eps, tables, torch.from_numpy(x0), t_end=3), ref3)
    const = torch.from_numpy(np.random.RandomState(8).randn(B, H, W, C).astype(np.float32))
    fixed = lambda x, t, y=None: const  # noqa: E731
    latent = ddim_invert_loop(fixed, tables, torch.from_numpy(x0))
    back = ddim_sample_loop(fixed, tables, latent)
    np.testing.assert_allclose(back.numpy(), x0, atol=1e-4)


# a model with the UNet's cache interface: eps = 0.1 h + 0.01 * t-term,
# with h the input, or the cached input (x 2 where the middle is cached)
def _jax_cached(params, x, t, y=None, cache=None, return_cache=False, cache_middle=False):
    h = x if cache is None else cache[0]
    if cache_middle and cache is None:
        h = 2.0 * h
    eps = jax.lax.optimization_barrier(EPS_COEF * h)
    return (eps, (h, ())) if return_cache else eps


def _torch_cached(x, t, y=None, cache=None, return_cache=False, cache_middle=False):
    h = x if cache is None else cache[0]
    if cache_middle and cache is None:
        h = 2.0 * h
    eps = EPS_COEF * h
    return (eps, (h, ())) if return_cache else eps


@pytest.mark.parametrize("knobs", [
    dict(),
    dict(reuse_exact_head=2, reuse_exact_tail=3, reuse_sigma_boost=0.3,
         reuse_prior_noise=0.05, reuse_cache_middle=True),
], ids=["plain", "head_tail_boost_prior_middle"])
def test_encoder_reuse_segments_match_jax(knobs):
    """Ancestral encoder reuse (k = 3) on a model with the cache interface:
    the segments, exact windows, boost, prior noise and middle cache as
    JAX's, on JAX's z (fold_in(key, t)); and DDIM's reuse (k = 3)."""
    jt, tables, _ = _schedules(False)
    x_T, key = _x_T(9), jax.random.PRNGKey(10)
    with jax.enable_x64():
        ref = np.asarray(jax_p_sample_loop(_jax_cached, None, jt, jnp.asarray(x_T), key,
                                           clip=True, encoder_reuse=3, **knobs))
        ref_ddim = np.asarray(jax_ddim_sample_loop(_jax_cached, None, jt, jnp.asarray(x_T),
                                                   encoder_reuse=3))
        z = _fold_noise(key, range(T, 0, -1), x_T.shape)
    calls = []

    def counting(x, t, y=None, **kw):
        calls.append("cached" if kw.get("cache") is not None else "full")
        return _torch_cached(x, t, y, **kw)

    out = p_sample_loop(counting, tables, torch.from_numpy(x_T), clip=True, encoder_reuse=3,
                        noise=torch.from_numpy(z), **knobs)
    _near(out, ref)
    head = knobs.get("reuse_exact_head", 0) + (T - knobs.get("reuse_exact_head", 0)
                                                - knobs.get("reuse_exact_tail", 0)) % 3
    middle = T - head - knobs.get("reuse_exact_tail", 0)
    assert calls.count("cached") == 2 * middle // 3 and len(calls) == T
    out_ddim = ddim_sample_loop(_torch_cached, tables, torch.from_numpy(x_T), encoder_reuse=3)
    _near(out_ddim, ref_ddim)
    with pytest.raises(ValueError, match="plain sampling path"):
        p_sample_loop(_torch_cached, tables, torch.from_numpy(x_T), torch.Generator(),
                      encoder_reuse=3, return_stds=True)


# ------------------------------------------------------------- engine endpoints

ET = 20
RES = 8
CFG = dict(SMALL, channel_mult=[1], attention_resolutions=[8], use_scale_shift_norm=True)
ENGINE_KW = dict(diffusion_steps=ET, mode="linear", beta_start=1e-4, beta_end=0.2,
                 resolution=RES, clip_while_generating=True)
TOL = 1e-4


@pytest.fixture(scope="module")
def engines():
    """The JAX engine and the port's, on the same random Flax weights."""
    jengine = JaxEngine(dict(CFG), {"lr": 2e-4}, **ENGINE_KW)
    params = _random_flax_params(jengine.model, jnp.zeros((1, RES, RES, 3)),
                                 jnp.ones((1,), jnp.int32), seed=40)
    jengine.state = jengine.state.replace(params=params)
    engine = DiffusionEngine(dict(CFG), {"lr": 2e-4}, device="cpu", **ENGINE_KW)
    load_flax_params(engine.state.model, params)
    return jengine, engine


def _close(got, want, tol=TOL):
    got = got.numpy() if hasattr(got, "numpy") else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _loop_key(seed):
    """The first chunk's loop key of the JAX engine's generate_images."""
    _, _, kloop = jax.random.split(jax.random.PRNGKey(seed), 3)
    return kloop


# (generate_images options, steps, whether the loop draws one z a step);
# each JAX chain compiles for several seconds, so one chain a sampler
_SAMPLERS = {
    "ddim_eta": (dict(ddim=True, ddim_eta=0.7), "ddim5", True),
    "dpmpp2": (dict(dpm_solver=True), "karras6", False),
    "heun_churn": (dict(heun=True, heun_churn=5.0), 4, True),
}


@pytest.mark.parametrize("name", sorted(_SAMPLERS))
def test_generate_images_matches_jax(engines, name):
    """One chunk of 2 from the same x_T, each sampler over its respaced
    chain, the draws of a stochastic one JAX's (fold_in(loop key, t))."""
    jengine, engine = engines
    kw, steps, draws = _SAMPLERS[name]
    x_T = np.random.RandomState(41).randn(2, RES, RES, 3).astype(np.float32)
    want = jengine.generate_images(n=2, minibatch=2, seed=3, use_ema=False,
                                   num_sample_steps=steps, x_T=x_T, **kw)
    noise = None
    if draws:
        n_steps = engine._sample_tables(steps)[2]
        noise = _fold_noise(_loop_key(3), range(n_steps, 0, -1), x_T.shape)
    got = engine.generate_images(n=2, minibatch=2, use_ema=False, num_sample_steps=steps,
                                 x_T=x_T, noise=noise, **kw)
    _close(got, want)


def test_inpaint_matches_jax(engines):
    """RePaint over 4 respaced steps with 2 passes each, from JAX's x_T and
    draws; the known (left) half is x0 exactly."""
    jengine, engine = engines
    x0 = np.random.RandomState(42).uniform(-1, 1, size=(2, RES, RES, 3)).astype(np.float32)
    mask = np.zeros((RES, RES, 1), np.float32)
    mask[:, : RES // 2] = 1.0
    want = jengine.inpaint(x0, mask, seed=4, use_ema=False, num_sample_steps=4,
                           resample_steps=2)
    knoise, kloop = jax.random.split(jax.random.PRNGKey(4))
    x_T = np.asarray(jax.random.normal(knoise, x0.shape))
    draws = np.stack([np.stack([
        np.stack([np.asarray(jax.random.normal(k, x0.shape)) for k in jax.random.split(
            jax.random.fold_in(jax.random.fold_in(kloop, t), i), 3)])
        for i in range(2)]) for t in range(4, 0, -1)])
    got = engine.inpaint(x0, mask, use_ema=False, num_sample_steps=4, resample_steps=2,
                         x_T=x_T, noise=draws)
    _close(got, want)
    np.testing.assert_array_equal(got.numpy()[:, :, : RES // 2], x0[:, :, : RES // 2])


def test_ddim_invert_matches_jax(engines):
    """The encoding over 5 respaced steps to t_end = 4, and the range check
    of t_end."""
    jengine, engine = engines
    x0 = np.random.RandomState(43).uniform(-1, 1, size=(2, RES, RES, 3)).astype(np.float32)
    _close(engine.ddim_invert(x0, use_ema=False, num_sample_steps=5, t_end=4),
           jengine.ddim_invert(x0, use_ema=False, num_sample_steps=5, t_end=4))
    with pytest.raises(ValueError, match="outside the chain"):
        engine.ddim_invert(x0, num_sample_steps=5, t_end=6)


def test_get_feature_vectors_matches_jax(engines):
    """Every down, middle and up activation at per-sample timesteps."""
    jengine, engine = engines
    x = np.random.RandomState(44).randn(2, RES, RES, 3).astype(np.float32)
    t = np.array([3, 17], np.int32)
    want = jengine.get_feature_vectors(jnp.asarray(x), jnp.asarray(t))
    got = engine.get_feature_vectors(x, t)
    assert set(got) == {"down", "middle", "up"}
    for part in ("down", "up"):
        assert len(got[part]) == len(want[part])
        for g, w in zip(got[part], want[part]):
            _close(g, w)
    _close(got["middle"], want["middle"])
    assert engine.get_feature_vectors(x, 5)["middle"].shape == got["middle"].shape
