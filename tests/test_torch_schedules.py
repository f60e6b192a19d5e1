"""The port's schedule tables and respacing against the JAX package:
bit-equal tables (linear, cosine and mixed modes, zero-terminal-SNR
rescaling), kept steps and timestep maps."""

import dataclasses

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (both frameworks in one process, as the other port tests)

from probabilisticdeepdiffusionmodels_tpu.core import NoiseSchedule as JaxSchedule
from probabilisticdeepdiffusionmodels_tpu.core.schedules import (
    mixed_alpha_bar as jax_mixed_alpha_bar,
    rescale_zero_terminal_snr as jax_rescale_zero_terminal_snr,
)
from probabilisticdeepdiffusionmodels_tpu.sample import (
    respaced_schedule as jax_respaced_schedule,
    space_timesteps as jax_space_timesteps,
)
from probabilisticdeepdiffusionmodels_torch.core import (
    DiffusionTables,
    NoiseSchedule,
    mixed_alpha_bar,
    rescale_zero_terminal_snr,
)
from probabilisticdeepdiffusionmodels_torch.sample import (
    respaced_schedule,
    space_timesteps,
)
from test_torch_threads import one_torch_thread  # noqa: E402,F401


def _assert_same_schedule(ours, ref):
    for field in dataclasses.fields(ref):
        a, b = getattr(ours, field.name), getattr(ref, field.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype == np.float32, field.name
            np.testing.assert_array_equal(a, b, err_msg=field.name)
        else:
            assert a == b, field.name
    for mode in ("beta", "beta_tilde"):
        np.testing.assert_array_equal(ours.sigma(mode), ref.sigma(mode))


@pytest.mark.parametrize("mode", ["linear", "cosine"])
@pytest.mark.parametrize("steps", [50, 1000, 4000])
def test_tables_bit_equal(mode, steps):
    _assert_same_schedule(NoiseSchedule.create(steps, mode),
                          JaxSchedule.create(steps, mode))


def test_custom_betas_bit_equal():
    betas = np.linspace(1e-4, 0.05, 30).astype(np.float32)
    _assert_same_schedule(NoiseSchedule.create(30, betas=betas),
                          JaxSchedule.create(30, betas=betas))


@pytest.mark.parametrize("steps", [50, 1000, 4000])
def test_mixed_tables_bit_equal(steps):
    """Half the linear alpha-bar table (extrapolated one step past T), half
    the cosine one, in float32: the table and every buffer bit for bit."""
    table = mixed_alpha_bar(steps)
    assert table.dtype == np.float32 and table.shape == (steps + 1,)
    np.testing.assert_array_equal(table, jax_mixed_alpha_bar(steps))
    _assert_same_schedule(NoiseSchedule.create(steps, "mixed"),
                          JaxSchedule.create(steps, "mixed"))


@pytest.mark.parametrize("mode", ["linear", "cosine"])
def test_zero_terminal_snr_bit_equal(mode):
    """Algorithm 1 of arXiv:2305.08891 in float64 with the terminal floor:
    the rescaled betas and the schedule built on them bit for bit; the
    first alpha-bar kept, the terminal SNR near zero."""
    betas = NoiseSchedule.create(1000, mode).betas
    ours = rescale_zero_terminal_snr(betas)
    ref = jax_rescale_zero_terminal_snr(betas)
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)
    sched = NoiseSchedule.create(1000, mode, betas=ours)
    _assert_same_schedule(sched, JaxSchedule.create(1000, mode, betas=ref))
    np.testing.assert_allclose(sched.alphas_hat[0], 1.0 - betas[0], rtol=1e-6)
    assert sched.alphas_hat[-1] / (1.0 - sched.alphas_hat[-1]) < 1e-9
    with pytest.raises(ValueError, match="at least 2 steps"):
        rescale_zero_terminal_snr(betas[:1])


@pytest.mark.parametrize("spacing", [250, 10, "ddim50", "trailing10", "karras10",
                                     "15,15,20"])
def test_respacing_equal(spacing):
    ref_sched = JaxSchedule.create(1000, "linear")
    sched = NoiseSchedule.create(1000, "linear")
    kept = space_timesteps(1000, spacing, alphas_hat=sched.alphas_hat)
    assert kept == jax_space_timesteps(1000, spacing, alphas_hat=ref_sched.alphas_hat)
    ours, tmap = respaced_schedule(sched, kept)
    ref, ref_map = jax_respaced_schedule(ref_sched, kept)
    np.testing.assert_array_equal(tmap, ref_map)
    assert tmap.dtype == ref_map.dtype
    _assert_same_schedule(ours, ref)


def test_tables_on_device_hold_the_schedule():
    sched = NoiseSchedule.create(100, "cosine")
    tables = DiffusionTables.from_schedule(sched, "cpu")
    assert tables.diffusion_steps == 100
    np.testing.assert_array_equal(tables.betas.numpy(), sched.betas)
    np.testing.assert_array_equal(tables.sigma_table("beta").numpy(), sched.sigma("beta"))
    np.testing.assert_array_equal(tables.sigma_table("beta_tilde").numpy(),
                                  sched.sigma("beta_tilde"))
    assert all(t.dtype == torch.float32 for t in tables)
