"""The port's exact ODE likelihood (``evals/ode_nll.py``) against the JAX
package, its engine endpoint and ``cli.eval ode_nll=true``, and the guard
that keeps a forward-mode tangent away from the kernels.

JAX takes each Hutchinson probe's J v by ``jax.jvp``; the port takes
J^T v by ``torch.autograd.grad`` (its kernels' gradients are reverse mode
only), and v.(J^T v) = v.(J v).  On ``unet_small_grey`` at 8x8 with three
Heun steps and JAX's own Rademacher probes injected, every field is held
within 1e-4 relative (of its largest value).  The analytic Gaussian
fields of tests/test_ode_nll.py, whose Jacobians are diagonal (one probe
is exact), are held against their closed forms with JAX's bounds.
"""

import numpy as np
import pytest
import torch
import yaml
from torch.autograd import forward_ad

import jax
import jax.numpy as jnp

from probabilisticdeepdiffusionmodels_tpu.evals.ode_nll import (
    edm_ode_nll as jax_edm_ode_nll,
    flow_ode_nll as jax_flow_ode_nll,
)
from probabilisticdeepdiffusionmodels_torch.cli import eval as cli_eval
from probabilisticdeepdiffusionmodels_torch.config import CONFIG_DIR
from probabilisticdeepdiffusionmodels_torch.convert import load_flax_params
from probabilisticdeepdiffusionmodels_torch.core import TIME_SCALE, precond
from probabilisticdeepdiffusionmodels_torch.engine import DiffusionEngine
from probabilisticdeepdiffusionmodels_torch.evals.ode_nll import edm_ode_nll, flow_ode_nll
from probabilisticdeepdiffusionmodels_torch.models import get_model
from probabilisticdeepdiffusionmodels_torch.ops import gn_affine
from probabilisticdeepdiffusionmodels_torch.ops.autograd import kernel_op
from test_torch_cli import write_run

RES = 8
GREY = yaml.safe_load((CONFIG_DIR / "model" / "unet_small_grey.yaml").read_text())
# two probes on flow (the graph kept between them), one on EDM: each JAX
# compile unrolls a jvp per probe and Heun stage
PROBES = {"flow": 2, "edm": 1}
FIELDS = ("log_likelihood", "nll_bits_per_dim", "prior_logp", "delta_logp")
CPU = ["device=cpu"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one intra-op thread, restored after: the suite runs
    several workers on few cores, where torch's small CPU ops wait longer
    for their thread pool than they compute (about 10x under that load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def small_unet():
    """unet_small_grey's Flax weights and apply, the port's model on them and
    a batch in [-1, 1].  The Flax model is imported here: the card's machine
    has JAX but no Flax, and the module's card tests run there."""
    pytest.importorskip("flax")
    from probabilisticdeepdiffusionmodels_tpu.models import get_model as jax_get_model
    from test_torch_unet import _random_flax_params

    x = np.random.RandomState(0).uniform(-1.0, 1.0, (3, RES, RES, 1)).astype(np.float32)
    jm = jax_get_model(RES, GREY)
    params = _random_flax_params(jm, jnp.asarray(x), jnp.ones((3,), jnp.float32), seed=3)
    model = load_flax_params(get_model(RES, GREY, device="cpu"), params).requires_grad_(False)

    def apply_fn(p, xx, t, y=None):
        return jm.apply({"params": p}, xx, t, y)

    return apply_fn, params, model, x


@pytest.mark.parametrize("family", ["flow", "edm"])
def test_ode_nll_matches_jax(small_unet, family):
    apply_fn, params, model, x = small_unet
    jax_fn, fn = (jax_flow_ode_nll, flow_ode_nll) if family == "flow" else (jax_edm_ode_nll,
                                                                             edm_ode_nll)
    n, key = PROBES[family], jax.random.PRNGKey(5)
    want = jax.jit(lambda p, xx, k: jax_fn(apply_fn, p, xx, k, n_steps=3, n_probes=n))(
        params, jnp.asarray(x), key)
    # JAX's own draw of the probes
    probes = np.asarray(jax.random.rademacher(key, (n, *x.shape), jnp.float32))
    got = fn(model, torch.from_numpy(x), n_steps=3, n_probes=n, probes=torch.from_numpy(probes))
    for k in FIELDS:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape == (3,) and np.isfinite(w).all()
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=k)


# ------------------------------------------------------------- analytic fields


def _gaussian_flow(c2):
    """The exact velocity of data ~ N(0, c2 I)."""
    def model(x, t_in, y=None):
        t = (t_in / TIME_SCALE).reshape((-1,) + (1,) * (x.ndim - 1))
        return (t - (1 - t) * c2) / ((1 - t) ** 2 * c2 + t ** 2) * x

    return model


def _gaussian_edm(c2, sigma_data=0.5):
    """The raw EDM network whose denoiser is c2 / (c2 + sigma^2) x."""
    def model(x_in, c_noise, y=None):
        sigma = torch.exp(4.0 * c_noise)
        c_skip, c_out, c_in, _ = precond(sigma, sigma_data)
        b = (-1,) + (1,) * (x_in.ndim - 1)
        x = x_in / c_in.reshape(b)
        denoised = (c2 / (c2 + torch.square(sigma))).reshape(b) * x
        return (denoised - c_skip.reshape(b) * x) / c_out.reshape(b)

    return model


def _gaussian_logp(x, v):
    return -0.5 * (np.sum(x.reshape(len(x), -1) ** 2, axis=1) / v + x[0].size
                   * np.log(2 * np.pi * v))


def test_flow_ode_nll_matches_the_analytic_gaussian():
    """The density of the exact field is N(0, c2 I): Heun converges to it at
    second order (the error drops more than 3x a grid doubling, under 0.05
    at 64 steps), Euler is the worse integrator, bits/dim bookkeeping."""
    c2 = 0.49
    x = (np.random.RandomState(1).randn(8, 4, 4, 1) * np.sqrt(c2)).astype(np.float32)
    want = _gaussian_logp(x, c2)
    gen = torch.Generator().manual_seed(1)

    def err(n, heun):
        got = flow_ode_nll(_gaussian_flow(c2), torch.from_numpy(x), gen, n_steps=n, heun=heun)
        return float(np.abs(got["log_likelihood"].numpy() - want).max())

    e = [err(n, True) for n in (16, 32, 64)]
    assert e[0] > e[1] > e[2] and e[0] / e[1] > 3.0 and e[1] / e[2] > 3.0, e
    assert e[2] < 0.05 and err(64, False) > e[2]
    out = flow_ode_nll(_gaussian_flow(c2), torch.from_numpy(x), gen, n_steps=8)
    np.testing.assert_allclose(out["nll_bits_per_dim"].numpy(),
                               -out["log_likelihood"].numpy() / (16 * np.log(2.0)), rtol=1e-6)


def test_edm_ode_nll_matches_the_analytic_gaussian():
    """The sigma-space ODE of the exact denoiser carries N(0, c2 +
    sigma_min^2) to N(0, c2 + sigma_max^2): second-order convergence to the
    smoothed density."""
    c2, s_min, s_max = 0.49, 0.002, 20.0
    x = (np.random.RandomState(2).randn(8, 4, 4, 1) * np.sqrt(c2)).astype(np.float32)
    want = _gaussian_logp(x, c2 + s_min ** 2)
    gen = torch.Generator().manual_seed(2)

    def err(n):
        got = edm_ode_nll(_gaussian_edm(c2), torch.from_numpy(x), gen, sigma_min=s_min,
                          sigma_max=s_max, n_steps=n)
        return float(np.abs(got["log_likelihood"].numpy() - want).max())

    e = [err(n) for n in (32, 64, 128)]
    assert e[0] > e[1] > e[2] and e[0] / e[1] > 3.0 and e[1] / e[2] > 3.0, e
    assert e[2] < 0.05, e


def test_ode_nll_is_per_sample_and_validates():
    """A row's likelihood does not depend on its batch companions (the same
    probe rows); the step and probe counts and the probes' shape are checked."""
    x = torch.from_numpy(np.random.RandomState(3).randn(6, 4, 4, 1).astype(np.float32))
    probes = torch.from_numpy(np.sign(np.random.RandomState(4).randn(1, 6, 4, 4, 1))
                              .astype(np.float32))
    model = _gaussian_flow(1.0)
    full = flow_ode_nll(model, x, n_steps=16, probes=probes)["log_likelihood"]
    half = flow_ode_nll(model, x[:3], n_steps=16, probes=probes[:, :3])["log_likelihood"]
    np.testing.assert_allclose(full[:3].numpy(), half.numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="integration step"):
        flow_ode_nll(model, x, n_steps=0, probes=probes)
    with pytest.raises(ValueError, match="probe"):
        edm_ode_nll(model, x, torch.Generator(), n_probes=0)
    with pytest.raises(ValueError, match="probes of shape"):
        flow_ode_nll(model, x, n_steps=2, n_probes=2, probes=probes)
    with pytest.raises(ValueError, match="Generator"):
        flow_ode_nll(model, x, n_steps=2)
    # drawn probes are Rademacher
    out = flow_ode_nll(model, x, torch.Generator().manual_seed(0), n_steps=2, n_probes=3)
    assert out["delta_logp"].shape == (6,)


# ------------------------------------------------------------- the engine


ENGINE = dict(model_config=dict(GREY, channel_mult=[1, 2], use_scale_shift_norm=True),
              optimizer_config={"lr": 2e-3}, diffusion_steps=10, mode="cosine",
              resolution=RES, ema=0.99, device="cpu")


@pytest.mark.parametrize("family", ["flow", "edm"])
def test_engine_ode_likelihood_endpoint(family):
    """The endpoint is the function on the engine's weights (EMA by
    default) with its EDM frame; the weights' gradient flags are restored;
    a generator seeded ``seed`` draws the probes."""
    engine = DiffusionEngine(prediction_type=family, **ENGINE)
    x = np.full((4, RES, RES, 1), 0.3, np.float32)
    probes = torch.from_numpy(np.sign(np.random.RandomState(5).randn(1, *x.shape))
                              .astype(np.float32))
    out = engine.calculate_ode_likelihood(x, n_steps=2, probes=probes)
    fn = flow_ode_nll if family == "flow" else edm_ode_nll
    want = fn(engine.state.ema_model, torch.from_numpy(x), n_steps=2, probes=probes)
    for k in FIELDS:
        assert out[k].shape == (4,) and bool(torch.isfinite(out[k]).all())
        torch.testing.assert_close(out[k], want[k], rtol=0, atol=0)
    assert all(p.requires_grad for p in engine.state.model.parameters())
    live = engine.calculate_ode_likelihood(x, n_steps=1, use_ema=False, seed=1)
    again = engine.calculate_ode_likelihood(x, n_steps=1, use_ema=False, seed=1)
    assert torch.equal(live["log_likelihood"], again["log_likelihood"])
    assert all(p.requires_grad for p in engine.state.model.parameters())


def test_engine_ode_likelihood_refuses_table_engines():
    engine = DiffusionEngine(**ENGINE)
    with pytest.raises(ValueError, match='prediction_type="flow"'):
        engine.calculate_ode_likelihood(np.zeros((1, RES, RES, 1), np.float32))


@pytest.mark.parametrize("family", ["flow", "edm"])
def test_eval_cli_ode_nll(family, tmp_path):
    """``cli.eval ode_nll=true`` adds ``test_ode_nll`` (bits/dim) beside the
    bound's columns on a flow or EDM run."""
    run = write_run(tmp_path, [f"engine.prediction_type={family}"])
    out = cli_eval.main([f"run_dir={run}", "ode_nll=true", "ode_steps=2",
                         "trainer.limit_test_batches=1"] + CPU)
    assert {"test_ode_nll", "test_nll"} <= set(out) and np.isfinite(out["test_ode_nll"])


# ------------------------------------------------------------- the kernels' guard


def test_forward_mode_tangent_through_a_kernel_op_raises():
    """A kernel reads its inputs' memory and would drop a tangent: the op
    raises instead, through the CPU stand-in of ``kernel_op`` (the plain
    version in the kernel's place) and before ``gn_affine``'s kernel
    (a tensor on the meta device takes the kernel's path here); the same
    ops without a tangent run, inside a forward-mode level or not."""
    plain = lambda t: 2.0 * t  # noqa: E731
    x = torch.randn(2, 4, 4, 32)
    with forward_ad.dual_level():
        dual = forward_ad.make_dual(x, torch.ones_like(x))
        with pytest.raises(RuntimeError, match="forward-mode tangent"):
            kernel_op(plain, plain, dual)
        assert torch.equal(kernel_op(plain, plain, x), 2.0 * x)
        meta = torch.empty(2, 4, 4, 32, device="meta")
        with pytest.raises(RuntimeError, match="forward-mode tangent"):
            gn_affine(forward_ad.make_dual(meta, torch.empty_like(meta)), torch.ones(32),
                      torch.zeros(32), 32, 1e-5)
    with pytest.raises(RuntimeError, match="torch.func"):
        torch.func.jvp(lambda t: kernel_op(plain, plain, t), (x,), (torch.ones_like(x),))
    assert torch.equal(kernel_op(plain, plain, x), 2.0 * x)
    with pytest.raises(ValueError, match="unsupported device"):
        gn_affine(torch.empty(2, 4, 4, 32, device="meta"), torch.ones(32), torch.zeros(32),
                  32, 1e-5)


# ------------------------------------------------------------- on the card


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["flow", "edm"])
def test_card_ode_nll_kernels_match_plain(family):
    """The float32 likelihood on the kernels (forward, and ``gn_affine``'s
    backward in the VJPs) against the same model on the plain versions,
    within 1e-3 of each field's largest value."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from probabilisticdeepdiffusionmodels_torch import ops
    from probabilisticdeepdiffusionmodels_torch.evals.inception import true_float32
    from probabilisticdeepdiffusionmodels_torch.models import layers, unet

    sites = [(unet, "gn_affine"), (unet, "gn_silu_conv3x3"), (unet, "qkv_attention"),
             (layers, "group_norm_silu")]
    engine = DiffusionEngine(prediction_type=family, **dict(ENGINE, device="cuda"))
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        # the zero-initialised head would make the field, and the trace, 0
        for p in engine.state.ema_model.parameters():
            if not p.any():
                p.copy_(0.02 * torch.randn(p.shape, generator=gen))
    x = torch.rand(4, RES, RES, 1, device="cuda") * 2 - 1
    with true_float32():
        got = engine.calculate_ode_likelihood(x, n_steps=3)
        saved = [getattr(m, n) for m, n in sites]
        try:
            for m, n in sites:
                setattr(m, n, getattr(ops, n + "_plain"))
            want = engine.calculate_ode_likelihood(x, n_steps=3)
        finally:
            for (m, n), f in zip(sites, saved):
                setattr(m, n, f)
    for k in ("nll_bits_per_dim", "delta_logp"):
        rel = float((got[k] - want[k]).abs().max() / want[k].abs().max())
        assert rel <= 1e-3, (k, rel)
