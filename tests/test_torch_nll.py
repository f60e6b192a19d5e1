"""The port's NLL bound against the JAX package: the Gaussian helpers, and
``calculate_likelihood`` of a small UNet with Flax weights carried over,
fed the JAX function's own noise draws."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# The JAX model needs Flax; where it is missing (a machine set up for the
# card) the module skips, as test_torch_unet.py does.
pytest.importorskip("flax")

from probabilisticdeepdiffusionmodels_tpu.core import (  # noqa: E402
    DiffusionTables as JaxTables,
    NoiseSchedule as JaxSchedule,
    diffusion as JD,
)
from probabilisticdeepdiffusionmodels_tpu.evals.nll import (  # noqa: E402
    calculate_likelihood as jax_calculate_likelihood,
)
from probabilisticdeepdiffusionmodels_tpu.models import get_model as jax_get_model  # noqa: E402
from probabilisticdeepdiffusionmodels_torch.convert import load_flax_params  # noqa: E402
from probabilisticdeepdiffusionmodels_torch.core import (  # noqa: E402
    DiffusionTables,
    NoiseSchedule,
    approx_standard_normal_cdf,
    discretized_gaussian_log_likelihood,
    normal_kl,
)
from probabilisticdeepdiffusionmodels_torch.engine import DiffusionEngine  # noqa: E402
from probabilisticdeepdiffusionmodels_torch.evals import calculate_likelihood  # noqa: E402
from probabilisticdeepdiffusionmodels_torch.models import get_model  # noqa: E402
from test_torch_unet import SMALL, _random_flax_params  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401

T_SMALL = 12
# one level of SMALL, attention at full resolution: the JAX scan compiles fast
ONE_LEVEL = dict(SMALL, channel_mult=[1], attention_resolutions=[8])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _images(shape, seed):
    """Images in [-1, 1] on the 256 levels of 8-bit data, the edge bins
    included."""
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, size=shape) / 127.5 - 1.0).astype(np.float32)


# ------------------------------------------------------------- Gaussian helpers


def test_normal_kl_matches_jax():
    rng = np.random.RandomState(0)
    m1, v1, m2, v2 = (rng.randn(3, 5, 4).astype(np.float32) for _ in range(4))
    want = np.asarray(JD.normal_kl(*map(jnp.asarray, (m1, v1, m2, v2))))
    got = normal_kl(*map(_t, (m1, v1, m2, v2))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # Python numbers stand for float32 scalars (L_T's KL against N(0, I))
    want0 = np.asarray(JD.normal_kl(jnp.asarray(m1), jnp.asarray(v1), 0.0, 0.0))
    got0 = normal_kl(_t(m1), _t(v1), 0.0, 0.0)
    assert got0.dtype == torch.float32
    np.testing.assert_allclose(got0.numpy(), want0, rtol=1e-6, atol=1e-6)


def test_cdf_and_discretized_likelihood_match_jax():
    """At the decoder's scales (sigma_1 of the shipped schedules, 0.006 to
    0.05) with means within a sigma of x.  Further out in a tail the bin's
    two CDFs cancel in float32 and the frameworks' tanh, which differ in
    their last ulps, leave differences of that cancellation's size."""
    rng = np.random.RandomState(1)
    x = _images((4, 6, 6, 3), seed=2)
    log_scales = rng.uniform(-5.1, -3.0, size=x.shape).astype(np.float32)
    means = (x + np.exp(log_scales) * rng.uniform(-1, 1, size=x.shape)).astype(np.float32)
    z = (3 * rng.randn(200)).astype(np.float32)
    np.testing.assert_allclose(approx_standard_normal_cdf(_t(z)).numpy(),
                               np.asarray(JD.approx_standard_normal_cdf(jnp.asarray(z))),
                               rtol=1e-6, atol=1e-6)
    want = np.asarray(JD.discretized_gaussian_log_likelihood(
        *map(jnp.asarray, (x, means, log_scales))))
    got = discretized_gaussian_log_likelihood(*map(_t, (x, means, log_scales))).numpy()
    assert (x < -0.999).any() and (x > 0.999).any()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------- the bound


def _jax_draws(key, T, shape):
    """The draws of the JAX function, in its split order: L_0's key split
    off first, then one split of the carried key per t = 2..T."""
    key, k0 = jax.random.split(key)
    draws = [jax.random.normal(k0, shape, jnp.float32)]
    for _ in range(2, T + 1):
        key, k = jax.random.split(key)
        draws.append(jax.random.normal(k, shape, jnp.float32))
    return np.stack([np.asarray(d) for d in draws])


@pytest.mark.parametrize("sigma_mode,learn_sigma", [("beta", False), ("beta_tilde", True)],
                         ids=["fixed_sigma", "learned_sigma"])
def test_likelihood_matches_jax(sigma_mode, learn_sigma):
    """Batch 4 at 8x8 through a one-level UNet, T = 12 cosine: every output within
    1e-4 relative (the two UNets sum in other orders, and the KL squares
    their difference), L_T (no model call) within 1e-6."""
    cfg = dict(ONE_LEVEL, learn_sigma=learn_sigma)
    x0 = _images((4, 8, 8, 3), seed=3)
    jm = jax_get_model(8, cfg)
    params = _random_flax_params(jm, jnp.asarray(x0), jnp.ones((4,), jnp.int32), seed=4)
    # a head 10x smaller keeps eps near the noise's scale, so L_0's decoder
    # means sit within a few sigma of x0: further out its bins' two CDFs
    # cancel in float32 and magnify the UNets' float32 differences
    params["out_conv"] = jax.tree.map(lambda a: 0.1 * a, params["out_conv"])
    key = jax.random.PRNGKey(5)

    def apply_fn(p, x, t, y=None):
        return jm.apply({"params": p}, x, t, y)

    jt = JaxTables.from_schedule(JaxSchedule.create(T_SMALL, "cosine"))
    fn = jax.jit(functools.partial(jax_calculate_likelihood, apply_fn, sigma_mode=sigma_mode))
    want = jax.tree.map(np.asarray, fn(params, jt, jnp.asarray(x0), key))

    model = load_flax_params(get_model(8, cfg, device="cpu"), params)
    tables = DiffusionTables.from_schedule(NoiseSchedule.create(T_SMALL, "cosine"), "cpu")
    noise = _t(_jax_draws(key, T_SMALL, x0.shape))
    got = calculate_likelihood(model, tables, _t(x0), sigma_mode=sigma_mode, noise=noise)
    assert set(got) == set(want)
    assert got["L_intermediate_per_t"].shape == (T_SMALL - 1, 4)
    assert got["MSE_per_t"].shape == (T_SMALL - 1,)
    for k, w in want.items():
        tol = 1e-6 if k == "L_T" else 1e-4
        np.testing.assert_allclose(got[k].numpy(), w, rtol=tol, atol=0, err_msg=k)
    # the MSE is the mean over t = 2..T only
    np.testing.assert_allclose(float(got["MSE"]), float(got["MSE_per_t"].mean()), rtol=1e-7)


def test_likelihood_draws_from_the_generator():
    """Without ``noise`` the draws come from the generator: L_0's first,
    then t = 2..T in order; the same seed gives the same bits."""
    model = get_model(8, ONE_LEVEL, device="cpu", seed=1)
    tables = DiffusionTables.from_schedule(NoiseSchedule.create(6, "cosine"), "cpu")
    x0 = _t(_images((2, 8, 8, 3), seed=6))
    drawn = calculate_likelihood(model, tables, x0, torch.Generator().manual_seed(7))
    gen = torch.Generator().manual_seed(7)
    noise = torch.stack([torch.randn(x0.shape, generator=gen) for _ in range(6)])
    given = calculate_likelihood(model, tables, x0, noise=noise)
    for k in drawn:
        assert torch.equal(drawn[k], given[k]), k
    with pytest.raises(ValueError, match="noise of shape"):
        calculate_likelihood(model, tables, x0, noise=noise[1:])
    with pytest.raises(ValueError, match="Generator"):
        calculate_likelihood(model, tables, x0)


def test_engine_test_step_reads_the_bound():
    """``test_step`` is the batch means of the engine's bound with the EMA
    weights, seeded by ``seed``."""
    engine = DiffusionEngine(ONE_LEVEL, {"lr": 2e-4}, diffusion_steps=6, mode="cosine",
                             resolution=8, ema=0.9, device="cpu")
    x0 = _images((2, 8, 8, 3), seed=8)
    m = engine.test_step(x0, seed=3)
    ref = calculate_likelihood(engine.state.ema_model, engine.tables, _t(x0),
                               torch.Generator().manual_seed(3))
    assert set(m) == {"test_L_0", "test_L_intermediate", "test_L_T", "test_nll", "test_mse"}
    assert m["test_nll"] == float(ref["nll"].mean())
    assert m["test_mse"] == float(ref["MSE"])
    assert m["test_L_T"] == float(ref["L_T"].mean())
