"""The port's ancestral sampler against the JAX package.

With the analytic eps model of tests/test_sampler.py (eps = 0.1 * x) and
injected noise, the port's float32 trajectory equals JAX's parity-mode
trajectory (``jax.enable_x64()``) bit for bit: eager torch float32 ops are
separately rounded IEEE operations, which is what parity mode emulates.  A
short chain through a small UNet with converted weights is held at 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

pytest.importorskip("flax")  # as in test_torch_unet.py

from probabilisticdeepdiffusionmodels_tpu.core import (
    DiffusionTables as JaxTables,
    NoiseSchedule as JaxSchedule,
)
from probabilisticdeepdiffusionmodels_tpu.models import get_model as jax_get_model
from probabilisticdeepdiffusionmodels_tpu.sample import (
    p_sample_loop as jax_p_sample_loop,
    respaced_schedule as jax_respaced_schedule,
    space_timesteps as jax_space_timesteps,
)
from probabilisticdeepdiffusionmodels_torch.convert import load_flax_params
from probabilisticdeepdiffusionmodels_torch.core import DiffusionTables, NoiseSchedule
from probabilisticdeepdiffusionmodels_torch.models import get_model
from probabilisticdeepdiffusionmodels_torch.sample import (
    p_sample_loop,
    respaced_schedule,
    space_timesteps,
)
from test_torch_unet import SMALL, _random_flax_params
from test_torch_threads import one_torch_thread  # noqa: E402,F401

T = 40
B, H, W, C = 2, 6, 6, 1
EPS_COEF = np.float32(0.1)


def _setup():
    rng = np.random.RandomState(0)
    x_T = rng.randn(B, H, W, C).astype(np.float32)
    zs = rng.randn(T, B, H, W, C).astype(np.float32)  # z for t=T first
    return x_T, zs


def _jax_eps(params, x, t, y=None):
    # the barrier keeps XLA from simplifying through the model (as in
    # tests/test_sampler.py)
    return jax.lax.optimization_barrier(EPS_COEF * x)


def _torch_eps(x, t, y=None):
    return EPS_COEF * x


def _jax_tables():
    return JaxTables.from_schedule(JaxSchedule.create(T, "linear"))


def _tables():
    return DiffusionTables.from_schedule(NoiseSchedule.create(T, "linear"), "cpu")


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("sigma_mode", ["beta", "beta_tilde"])
def test_trajectory_bit_equal(clip, sigma_mode):
    x_T, zs = _setup()
    steps = list(range(T - 1, 0, -1))
    with jax.enable_x64():
        ref_x, ref_steps = jax_p_sample_loop(
            _jax_eps, None, _jax_tables(), jnp.asarray(x_T), sigma_mode=sigma_mode,
            clip=clip, noise=jnp.asarray(zs), steps_to_return=steps)
        ref_x, ref_steps = np.asarray(ref_x), np.asarray(ref_steps)
    x, recorded = p_sample_loop(
        _torch_eps, _tables(), torch.from_numpy(x_T), sigma_mode=sigma_mode, clip=clip,
        noise=torch.from_numpy(zs), steps_to_return=steps)
    assert ref_x.dtype == np.float32
    np.testing.assert_array_equal(x.numpy(), ref_x)
    np.testing.assert_array_equal(recorded.numpy(), ref_steps)


def test_mean_only_and_partial_start_bit_equal():
    x_T, zs = _setup()
    with jax.enable_x64():
        ref_mean = np.asarray(jax_p_sample_loop(
            _jax_eps, None, _jax_tables(), jnp.asarray(x_T), mean_only=True))
        ref_part = np.asarray(jax_p_sample_loop(
            _jax_eps, None, _jax_tables(), jnp.asarray(x_T), t_start=17, clip=True,
            noise=jnp.asarray(zs[:17])))
    mean = p_sample_loop(_torch_eps, _tables(), torch.from_numpy(x_T), mean_only=True)
    part = p_sample_loop(_torch_eps, _tables(), torch.from_numpy(x_T), t_start=17,
                         clip=True, noise=torch.from_numpy(zs[:17]))
    np.testing.assert_array_equal(mean.numpy(), ref_mean)
    np.testing.assert_array_equal(part.numpy(), ref_part)


def test_return_stds_and_learned_sigma():
    """std(x) trace and the learned-sigma step (log/exp and a reduction are
    not separately rounded alike in both frameworks: allclose at 1e-6)."""
    x_T, zs = _setup()

    def jax_two_head(params, x, t, y=None):
        return jax.lax.optimization_barrier(
            jnp.concatenate([EPS_COEF * x, jnp.tanh(x)], axis=-1))

    def torch_two_head(x, t, y=None):
        return torch.cat([EPS_COEF * x, torch.tanh(x)], dim=-1)

    ref_x, ref_stds = jax_p_sample_loop(
        jax_two_head, None, _jax_tables(), jnp.asarray(x_T), clip=True,
        noise=jnp.asarray(zs), return_stds=True)
    x, stds = p_sample_loop(torch_two_head, _tables(), torch.from_numpy(x_T), clip=True,
                            noise=torch.from_numpy(zs), return_stds=True)
    assert stds.shape == (T + 1,)
    np.testing.assert_allclose(x.numpy(), np.asarray(ref_x), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(stds.numpy(), np.asarray(ref_stds), rtol=1e-6, atol=1e-6)


def test_generator_draws_on_the_tensor_device():
    x_T, _ = _setup()
    x0 = torch.from_numpy(x_T)
    a = p_sample_loop(_torch_eps, _tables(), x0, torch.Generator().manual_seed(3))
    b = p_sample_loop(_torch_eps, _tables(), x0, torch.Generator().manual_seed(3))
    c = p_sample_loop(_torch_eps, _tables(), x0, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="Generator"):
        p_sample_loop(_torch_eps, _tables(), x0)

    # encoder reuse draws its z from the generator in the same order
    def cached(x, t, y=None, cache=None, return_cache=False):
        eps = _torch_eps(x if cache is None else cache, t)
        return (eps, x) if return_cache else eps

    r = p_sample_loop(cached, _tables(), x0, torch.Generator().manual_seed(3), encoder_reuse=2)
    assert torch.equal(r, p_sample_loop(cached, _tables(), x0, torch.Generator().manual_seed(3),
                                        encoder_reuse=2))
    assert not torch.equal(r, a)  # the cached steps see the segment's first state


def test_unet_respaced_chain_matches_jax():
    """5 steps respaced from T=1000, clip=True, injected noise, a small UNet
    with the same weights in both frameworks."""
    # one level (no resampling, covered by test_torch_unet.py) keeps the
    # JAX scan's compile short; attention at 8 is the full resolution
    cfg = dict(SMALL, model_channels=32, channel_mult=[1], attention_resolutions=[8],
               use_scale_shift_norm=True)
    rng = np.random.RandomState(7)
    x_T = rng.randn(2, 8, 8, 3).astype(np.float32)
    zs = rng.randn(5, 2, 8, 8, 3).astype(np.float32)

    jm = jax_get_model(8, cfg)
    params = _random_flax_params(jm, jnp.asarray(x_T), jnp.ones((2,), jnp.int32), seed=7)
    jsched, jmap = jax_respaced_schedule(JaxSchedule.create(1000, "linear"),
                                         jax_space_timesteps(1000, 5))
    apply = jax.jit(lambda p, x, t, y=None: jm.apply({"params": p}, x, t))
    ref = np.asarray(jax_p_sample_loop(
        apply, params, JaxTables.from_schedule(jsched), jnp.asarray(x_T), clip=True,
        noise=jnp.asarray(zs), timestep_map=jnp.asarray(jmap)))

    model = load_flax_params(get_model(8, cfg, device="cpu"), params)
    sched, tmap = respaced_schedule(NoiseSchedule.create(1000, "linear"),
                                    space_timesteps(1000, 5))
    seen = []

    def model_fn(x, t, y=None):
        seen.append(int(t[0]))
        return model(x, t, y)

    out = p_sample_loop(model_fn, DiffusionTables.from_schedule(sched, "cpu"),
                        torch.from_numpy(x_T), clip=True, noise=torch.from_numpy(zs),
                        timestep_map=torch.from_numpy(tmap).long())
    assert seen == list(tmap[::-1])  # the model sees original timesteps
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)
