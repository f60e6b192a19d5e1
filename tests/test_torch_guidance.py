"""The port's encoder reuse and classifier-free guidance against the JAX
package: the UNet's feature and cache API, the eps views (v, x0, EDM, flow)
with the cache passed through them, CFG chains (a learned-sigma head with the
rescale, a guidance interval), an encoder-reuse chain with exact head and tail
steps, and the engine's ``generate_images`` under guidance and encoder reuse,
all on converted weights of a small UNet with JAX's draws injected, within
1e-4 (as test_torch_sampler.py holds its UNet chain)."""

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
from probabilisticdeepdiffusionmodels_tpu.models import get_model as jax_get_model  # noqa: E402
from probabilisticdeepdiffusionmodels_tpu.sample import (  # noqa: E402
    ddim_sample_loop as jax_ddim_sample_loop,
    make_cfg_apply_fn as jax_make_cfg_apply_fn,
    make_edm_to_eps_apply_fn as jax_edm_view,
    make_flow_to_eps_apply_fn as jax_flow_view,
    make_v_to_eps_apply_fn as jax_v_view,
    make_x0_to_eps_apply_fn as jax_x0_view,
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
from probabilisticdeepdiffusionmodels_torch.models import get_model  # noqa: E402
from probabilisticdeepdiffusionmodels_torch.sample import (  # noqa: E402
    ddim_sample_loop,
    make_cfg_apply_fn,
    make_edm_to_eps_apply_fn,
    make_flow_to_eps_apply_fn,
    make_v_to_eps_apply_fn,
    make_x0_to_eps_apply_fn,
    p_sample_loop,
    respaced_schedule,
    space_timesteps,
)
from test_torch_unet import SMALL, _random_flax_params  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401

RES = 8
TOL = 1e-4
# two levels, so the cache holds skips at two resolutions; attention at 4
TWO_LEVEL = dict(SMALL, model_channels=32, channel_mult=[1, 2], attention_resolutions=[4],
                 use_scale_shift_norm=True)
# one level, class-conditional with the null row and a learned-sigma head
COND = dict(SMALL, model_channels=32, channel_mult=[1], attention_resolutions=[8],
            num_classes=3, cfg_null_class=True, learn_sigma=True)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if hasattr(got, "detach") else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _pair(cfg, seed, batch=2):
    """(JAX apply(params, x, t, y, **kw), params, the port's model) on the
    same random weights."""
    jm = jax_get_model(RES, cfg)
    y = jnp.zeros((batch,), jnp.int32) if cfg.get("num_classes") else None
    args = (jnp.zeros((batch, RES, RES, 3)), jnp.ones((batch,), jnp.int32))
    params = _random_flax_params(jm, *args, y, seed=seed)

    def apply(p, x, t, y=None, **kw):
        return jm.apply({"params": p}, x, t, y, **kw)

    return apply, params, load_flax_params(get_model(RES, cfg, device="cpu"), params)


@pytest.fixture(scope="module")
def two_level():
    return _pair(TWO_LEVEL, seed=50)


@pytest.fixture(scope="module")
def cond():
    return _pair(COND, seed=51)


def _inputs(seed, batch=2):
    rng = np.random.RandomState(seed)
    return rng.randn(batch, RES, RES, 3).astype(np.float32)


# ------------------------------------------------------------- the cache API


@pytest.mark.parametrize("cache_middle", [False, True], ids=["encoder", "middle"])
def test_cache_api_matches_jax(two_level, cache_middle):
    """``return_cache`` gives (out, (h, skips)) as JAX's; a cached call at
    another timestep (the decoder alone with the middle cached) matches
    JAX's cached call; at the cache's own timestep it is the full output."""
    apply, params, model = two_level
    x, t, t2 = _inputs(52), np.array([7, 300], np.int32), np.array([6, 280], np.int32)
    kw = dict(cache_middle=True) if cache_middle else {}
    jout, jcache = jax.jit(lambda p, x, t: apply(p, x, t, return_cache=True, **kw))(
        params, x, t)
    jcached = jax.jit(lambda p, x, t, c: apply(p, x, t, cache=c, **kw))(params, x, t2, jcache)
    with torch.no_grad():
        out, cache = model(_t(x), _t(t).long(), return_cache=True, **kw)
        cached = model(_t(x), _t(t2).long(), cache=cache, **kw)
        again = model(_t(x), _t(t).long(), cache=cache, **kw)
    _close(out, jout)
    _close(cache[0], jcache[0])
    assert len(cache[1]) == len(jcache[1]) == 4  # the input conv, res, down, res
    for got, want in zip(cache[1], jcache[1]):
        _close(got, want)
    _close(cached, jcached)
    np.testing.assert_allclose(again.numpy(), out.numpy(), rtol=1e-5, atol=1e-5)
    assert float((cached - out).abs().max()) > 1e-3  # the new timestep counts
    with pytest.raises(ValueError, match="return_features"):
        model(_t(x), _t(t).long(), cache=cache, return_features=True)


# ------------------------------------------------------------- the eps views


_VIEWS = {
    "v": (jax_v_view, make_v_to_eps_apply_fn, ()),
    "x0": (jax_x0_view, make_x0_to_eps_apply_fn, ()),
    "edm": (jax_edm_view, make_edm_to_eps_apply_fn, (0.5,)),
    "flow": (jax_flow_view, make_flow_to_eps_apply_fn, ()),
}


@pytest.mark.parametrize("name", sorted(_VIEWS))
def test_eps_view_passes_the_cache_through(two_level, name):
    """Each view's ``return_cache`` call hands back (eps, cache) and its
    cached call eps, as JAX's view does; the EDM and flow views change the
    model's input and give it fractional timesteps."""
    apply, params, model = two_level
    jview, view, extra = _VIEWS[name]
    jt = JaxTables.from_schedule(JaxSchedule.create(1000, "linear"))
    tables = DiffusionTables.from_schedule(NoiseSchedule.create(1000, "linear"), "cpu")
    x, t, t2 = _inputs(53), np.array([40, 700], np.int32), np.array([35, 680], np.int32)
    jv = jview(apply, jt, *extra)
    jeps, jcache = jax.jit(lambda p, x, t: jv(p, x, t, None, return_cache=True))(params, x, t)
    jcached = jax.jit(lambda p, x, t, c: jv(p, x, t, None, cache=c))(params, x, t2, jcache)
    seen = []

    def recording(x, t, y=None, **kw):
        seen.append(t)
        return model(x, t, y, **kw)

    fn = view(recording, tables, *extra)
    with torch.no_grad():
        eps, cache = fn(_t(x), _t(t).long(), return_cache=True)
        cached = fn(_t(x), _t(t2).long(), cache=cache)
    _close(eps, jeps)
    _close(cache[0], jcache[0])
    _close(cached, jcached)
    if name in ("edm", "flow"):
        assert seen[0].dtype == torch.float32
        assert not torch.equal(seen[0], seen[0].floor())  # fractional, never floored


# ------------------------------------------------------------- guidance chains


# a linear ramp to 0.02 over 100 steps (ab_T ~ 0.37): nearer ab_T = 0 the
# x0 view magnifies the two UNets' float32 differences by 1 / sqrt(ab_T)
RAMP = dict(beta_start=1e-4, beta_end=0.02)


def _respaced(T, steps):
    jfull = JaxSchedule.create(T, "linear", **RAMP)
    full = NoiseSchedule.create(T, "linear", **RAMP)
    jsched, jmap = jax_respaced_schedule(jfull, jax_space_timesteps(T, steps))
    sched, tmap = respaced_schedule(full, space_timesteps(T, steps))
    return (JaxTables.from_schedule(jfull), JaxTables.from_schedule(jsched), jmap,
            DiffusionTables.from_schedule(full, "cpu"),
            DiffusionTables.from_schedule(sched, "cpu"), tmap)


def test_cfg_learned_sigma_rescale_chain_matches_jax(cond):
    """An ancestral chain of 5 respaced steps under guidance 3 with the
    rescale 0.7, a learned-sigma head (eps guided, v from the conditional
    half), on injected z; every call at the doubled batch."""
    apply, params, model = cond
    jfull, jt, jmap, full, tables, tmap = _respaced(100, 5)
    x_T, y = _inputs(54), np.array([0, 2], np.int32)
    z = np.random.RandomState(55).randn(5, 2, RES, RES, 3).astype(np.float32)
    jfn = jax_make_cfg_apply_fn(apply, 3.0, 3, guidance_rescale=0.7, tables=jfull)
    ref = np.asarray(jax.jit(lambda p, x: jax_p_sample_loop(
        jfn, p, jt, x, y=jnp.asarray(y), noise=jnp.asarray(z), clip=True,
        timestep_map=jnp.asarray(jmap)))(params, x_T))
    batches = []

    def recording(x, t, y=None, **kw):
        batches.append(x.shape[0])
        return model(x, t, y, **kw)

    fn = make_cfg_apply_fn(recording, 3.0, 3, guidance_rescale=0.7, tables=full)
    out = p_sample_loop(fn, tables, _t(x_T), y=_t(y).long(), noise=_t(z), clip=True,
                        timestep_map=tmap)
    _close(out, ref)
    assert batches == [4] * 5


def test_cfg_interval_chain_matches_jax(cond):
    """A DDIM chain of 6 respaced steps guided only in [30, 70] (original
    timesteps): inside, one call at the doubled batch, outside one plain
    conditional call at batch 2."""
    apply, params, model = cond
    _, jt, jmap, _, tables, tmap = _respaced(100, 6)
    x_T, y = _inputs(56), np.array([1, 0], np.int32)
    jfn = jax_make_cfg_apply_fn(apply, 2.5, 3, interval=(30, 70))
    ref = np.asarray(jax.jit(lambda p, x: jax_ddim_sample_loop(
        jfn, p, jt, x, y=jnp.asarray(y), clip=True, timestep_map=jnp.asarray(jmap)))(
        params, x_T))
    calls = []

    def recording(x, t, y=None, **kw):
        calls.append((int(t[0]), x.shape[0]))
        return model(x, t, y, **kw)

    fn = make_cfg_apply_fn(recording, 2.5, 3, interval=(30, 70))
    out = ddim_sample_loop(fn, tables, _t(x_T), y=_t(y).long(), clip=True, timestep_map=tmap)
    _close(out, ref)
    assert calls == [(int(t), 4 if 30 <= t <= 70 else 2) for t in tmap[::-1]]
    assert {b for _, b in calls} == {2, 4}
    with pytest.raises(ValueError, match="encoder cache"):
        fn(_t(x_T), torch.tensor([50, 50]), _t(y).long(), t_host=50, return_cache=True)


def test_encoder_reuse_chain_matches_jax(two_level):
    """Ancestral encoder reuse, k = 3, with one exact head and two exact
    tail steps over 10 respaced steps, on JAX's z (fold_in(key, t)): full
    calls at the exact steps and each segment's first, cached calls
    between."""
    apply, params, model = two_level
    _, jt, jmap, _, tables, tmap = _respaced(100, 10)
    x_T, key = _inputs(57), jax.random.PRNGKey(58)
    kw = dict(encoder_reuse=3, reuse_exact_head=1, reuse_exact_tail=2)
    ref = np.asarray(jax.jit(lambda p, x, k: jax_p_sample_loop(
        apply, p, jt, x, k, clip=True, timestep_map=jnp.asarray(jmap), **kw))(
        params, x_T, key))
    z = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, t), x_T.shape))
                  for t in range(10, 0, -1)])
    kinds = []

    def recording(x, t, y=None, **k):
        kinds.append("cached" if k.get("cache") is not None else "full")
        return model(x, t, y, **k)

    out = p_sample_loop(recording, tables, _t(x_T), clip=True, noise=_t(z), timestep_map=tmap,
                        **kw)
    _close(out, ref)
    # head 1 + (10 - 1 - 2) % 3 = 2 exact, two segments of 3, 2 exact
    assert kinds == ["full"] * 2 + ["full", "cached", "cached"] * 2 + ["full"] * 2


# ------------------------------------------------------------- the engine

ENGINE_KW = dict(diffusion_steps=100, mode="linear", resolution=RES, clip_while_generating=True,
                 class_dropout_prob=0.1, **RAMP)


@pytest.fixture(scope="module")
def engines(cond):
    """The JAX engine and the port's, class-conditional with the null row
    and a learned-sigma head, on the weights of ``cond``."""
    _, params, _ = cond
    jengine = JaxEngine(dict(COND), {"lr": 2e-4}, **ENGINE_KW)
    jengine.state = jengine.state.replace(params=params)
    engine = DiffusionEngine(dict(COND), {"lr": 2e-4}, device="cpu", **ENGINE_KW)
    load_flax_params(engine.state.model, params)
    return jengine, engine


def test_generate_images_guided_reuse_matches_jax(engines):
    """DDIM over 6 respaced steps under guidance 2 with encoder reuse k = 2:
    the cache made and taken at the doubled batch."""
    jengine, engine = engines
    x_T, y = _inputs(59), np.array([2, 1])
    kw = dict(n=2, minibatch=2, use_ema=False, num_sample_steps=6, ddim=True, y=y,
              guidance_scale=2.0, encoder_reuse=2, x_T=x_T)
    _close(engine.generate_images(**kw), jengine.generate_images(**kw))


def test_generate_images_reuse_knobs_match_jax(engines):
    """The ancestral chain with reuse k = 3, the middle cached, the noise
    boosted and the prior re-injected, on JAX's z; and guidance with an
    interval (the learned sigma's variance from the conditional half)."""
    jengine, engine = engines
    x_T, y = _inputs(60), np.array([0, 1])
    kw = dict(n=2, minibatch=2, use_ema=False, num_sample_steps=8, y=y, x_T=x_T)
    knobs = dict(encoder_reuse=3, reuse_cache_middle=True, reuse_sigma_boost=0.2,
                 reuse_prior_noise=0.02)
    _, _, kloop = jax.random.split(jax.random.PRNGKey(6), 3)
    z = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(kloop, t), x_T.shape))
                  for t in range(8, 0, -1)])
    _close(engine.generate_images(noise=z, **knobs, **kw),
           jengine.generate_images(seed=6, **knobs, **kw))
    guided = dict(guidance_scale=3.0, guidance_interval=(20, 60))
    _close(engine.generate_images(noise=z, **guided, **kw),
           jengine.generate_images(seed=6, **guided, **kw))


def test_engine_guidance_refusals(engines):
    """JAX's preconditions: the interval with reuse, the rescale without a
    scale or on a native sampler, guidance without labels or on an
    unconditional model."""
    _, engine = engines
    with pytest.raises(ValueError, match="does not compose with encoder_reuse"):
        engine.generate_images(n=1, minibatch=1, y=[0], guidance_scale=2.0,
                               guidance_interval=(1, 5), encoder_reuse=2)
    with pytest.raises(ValueError, match="needs guidance_scale"):
        engine.generate_images(n=1, minibatch=1, guidance_rescale=0.5)
    with pytest.raises(ValueError, match="class labels"):
        engine.generate_images(n=1, minibatch=1, guidance_scale=2.0)
    with pytest.raises(ValueError, match="not supported on the DPM-Solver"):
        engine.generate_images(n=1, minibatch=1, dpm_solver=True, encoder_reuse=2)
    with pytest.raises(ValueError, match="not supported on the DDIM path"):
        engine.generate_images(n=1, minibatch=1, ddim=True, reuse_sigma_boost=0.1)
    with pytest.raises(ValueError, match="at most one"):
        engine.generate_images(n=1, ddim=True, heun=True)
    plain = DiffusionEngine(dict(TWO_LEVEL), {"lr": 2e-4}, diffusion_steps=10,
                            resolution=RES, device="cpu")
    with pytest.raises(ValueError, match="class-conditional"):
        plain.generate_images(n=1, y=[0], guidance_scale=2.0)
