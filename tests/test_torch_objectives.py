"""The port's objectives against the JAX package: the v / x0 / min-SNR
helpers, the IDDPM bound of the hybrid loss, one train step of each
objective (hybrid, v, x0, min-SNR) with its gradients, the eval step, class
dropout, and the eps view that samples a v or x0 model, all on the same
numpy inputs with t and noise drawn from JAX's key stream and injected."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# The JAX train state needs Flax and optax; where they are missing (a machine
# set up for the card) the module skips, as test_torch_train.py does.
pytest.importorskip("flax")
pytest.importorskip("optax")
import optax  # noqa: E402

from probabilisticdeepdiffusionmodels_tpu.core import (  # noqa: E402
    DiffusionTables as JaxTables,
    NoiseSchedule as JaxSchedule,
    diffusion as JD,
)
from probabilisticdeepdiffusionmodels_tpu.models import get_model as jax_get_model  # noqa: E402
from probabilisticdeepdiffusionmodels_tpu.sample import (  # noqa: E402
    make_v_to_eps_apply_fn as jax_v_view,
    make_x0_to_eps_apply_fn as jax_x0_view,
    p_sample_loop as jax_p_sample_loop,
    respaced_schedule as jax_respaced_schedule,
    space_timesteps as jax_space_timesteps,
)
from probabilisticdeepdiffusionmodels_tpu.train.samplers import (  # noqa: E402
    sample_uniform as jax_sample_uniform,
)
from probabilisticdeepdiffusionmodels_tpu.train.state import (  # noqa: E402
    TrainState as JaxTrainState,
)
from probabilisticdeepdiffusionmodels_tpu.train.step import (  # noqa: E402
    _vlb_term as jax_vlb_term,
    make_eval_step as jax_make_eval_step,
    make_train_step as jax_make_train_step,
)
from probabilisticdeepdiffusionmodels_torch.convert import (  # noqa: E402
    load_flax_params,
    params_from_flax,
)
from probabilisticdeepdiffusionmodels_torch.core import (  # noqa: E402
    DiffusionTables,
    NoiseSchedule,
    eps_from_v,
    eps_from_xstart,
    min_snr_weight,
    v_target,
)
from probabilisticdeepdiffusionmodels_torch.engine import AdamChain, DiffusionEngine  # noqa: E402
from probabilisticdeepdiffusionmodels_torch.models import get_model  # noqa: E402
from probabilisticdeepdiffusionmodels_torch.sample import (  # noqa: E402
    make_v_to_eps_apply_fn,
    make_x0_to_eps_apply_fn,
    p_sample_loop,
    respaced_schedule,
    space_timesteps,
)
from probabilisticdeepdiffusionmodels_torch.train import (  # noqa: E402
    TrainState,
    make_eval_step,
    make_train_step,
    sample_uniform,
)
from probabilisticdeepdiffusionmodels_torch.train.step import _vlb_term  # noqa: E402
from test_torch_train import _adam_first_grads, _jax_draws  # noqa: E402
from test_torch_unet import SMALL, _random_flax_params  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401

T_HELPERS = 50
# one level, attention at full resolution: the JAX step compiles fast
ONE_LEVEL = dict(SMALL, channel_mult=[1], attention_resolutions=[8])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _images(shape, seed):
    """Images in [-1, 1] on the 256 levels of 8-bit data, the edge bins
    included."""
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, size=shape) / 127.5 - 1.0).astype(np.float32)


def _both_tables(T, mode="cosine"):
    return (DiffusionTables.from_schedule(NoiseSchedule.create(T, mode), "cpu"),
            JaxTables.from_schedule(JaxSchedule.create(T, mode)))


def _helper_inputs(seed):
    rng = np.random.RandomState(seed)
    x0 = _images((6, 4, 4, 3), seed)
    noise, head = (rng.randn(6, 4, 4, 3).astype(np.float32) for _ in range(2))
    t = np.array([1, 2, 17, 25, 49, T_HELPERS], np.int32)
    return x0, noise, head, t


# ------------------------------------------------------------- helpers


def test_v_and_x0_helpers_match_jax():
    """v_target, eps_from_v, eps_from_xstart within 1e-6, and each inverse
    undoes its forward map."""
    tables, jt = _both_tables(T_HELPERS)
    x0, noise, head, t = _helper_inputs(0)
    x_t = np.asarray(JD.q_sample(jt, jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t)))
    tt = _t(t).long()
    pairs = [
        (v_target(tables, _t(x0), _t(noise), tt), JD.v_target(jt, x0, noise, t)),
        (eps_from_v(tables, _t(x_t), tt, _t(head)), JD.eps_from_v(jt, x_t, t, head)),
        (eps_from_xstart(tables, _t(x_t), tt, _t(head)), JD.eps_from_xstart(jt, x_t, t, head)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    v = v_target(tables, _t(x0), _t(noise), tt)
    np.testing.assert_allclose(eps_from_v(tables, _t(x_t), tt, v).numpy(), noise, atol=1e-5)
    np.testing.assert_allclose(eps_from_xstart(tables, _t(x_t), tt, _t(x0))[1:].numpy(),
                               noise[1:], atol=1e-4)


@pytest.mark.parametrize("prediction_type", ["epsilon", "v", "x0"])
def test_min_snr_weight_matches_jax(prediction_type):
    """The clamped-SNR weight of each target within 1e-6 relative."""
    tables, jt = _both_tables(T_HELPERS)
    t = np.arange(1, T_HELPERS + 1, dtype=np.int32)
    got = min_snr_weight(tables, _t(t).long(), 5.0, prediction_type)
    want = JD.min_snr_weight(jt, jnp.asarray(t), 5.0, prediction_type)
    assert got.shape == (T_HELPERS,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="prediction_type"):
        min_snr_weight(tables, _t(t).long(), 5.0, "edm")


# ------------------------------------------------------------- the bound


def test_vlb_term_matches_jax():
    """The hybrid loss's L_vlb on the same x0, x_t, t (t == 1 and t > 1) and
    head outputs within 1e-5; its gradient reaches the variance head only."""
    tables, jt = _both_tables(T_HELPERS)
    x0, noise, eps, t = _helper_inputs(1)
    v = np.random.RandomState(2).uniform(-1, 1, size=x0.shape).astype(np.float32)
    x_t = np.asarray(JD.q_sample(jt, jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t)))
    want = np.asarray(jax_vlb_term(jt, None, None, jnp.asarray(x0), jnp.asarray(x_t),
                                   jnp.asarray(t), jnp.asarray(eps), jnp.asarray(v)))
    eps_t = _t(eps).requires_grad_(True)
    v_t = _t(v).requires_grad_(True)
    got = _vlb_term(tables, _t(x0), _t(x_t), _t(t).long(), eps_t, v_t)
    assert got.shape == (6,) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    got.sum().backward()
    assert eps_t.grad is None  # the mean is built from the detached eps
    assert v_t.grad is not None and v_t.grad.abs().sum() > 0


# ------------------------------------------------------------- train step

# (model config extras, train-step options), each against JAX's step
_OBJECTIVES = {
    "hybrid": (dict(learn_sigma=True), dict(loss_type="hybrid")),
    "hybrid_v": (dict(learn_sigma=True), dict(loss_type="hybrid", prediction_type="v")),
    "v": ({}, dict(prediction_type="v")),
    "x0": ({}, dict(prediction_type="x0")),
    "min_snr": ({}, dict(prediction_type="v", loss_weighting="min_snr")),
}


@pytest.mark.parametrize("name", sorted(_OBJECTIVES))
def test_train_step_objective_matches_jax(name):
    """One float32 step of a one-level UNet with Flax weights in both
    frameworks and JAX's t and noise injected, at test_torch_train.py's
    tolerances: loss (and the bound) 1e-5 and grad_norm 1e-4 relative,
    each gradient within 1e-4 of its largest element; the loss history
    records the same (weighted) per-sample losses within 1e-5."""
    extra, kw = _OBJECTIVES[name]
    cfg, T = dict(ONE_LEVEL, **extra), 1000
    x0 = _images((4, 8, 8, 3), seed=13)
    jm = jax_get_model(8, cfg)
    params = _random_flax_params(jm, jnp.asarray(x0), jnp.ones((4,), jnp.int32), seed=13)

    def apply_fn(p, x, t, y=None, **kwargs):
        return jm.apply({"params": p}, x, t, y)

    jt = JaxTables.from_schedule(JaxSchedule.create(T, "linear"))
    jstate = JaxTrainState.create(params, optax.adam(2e-4), T, jax.random.PRNGKey(13))
    t, noise = _jax_draws(jstate, 4, T, x0.shape, "uniform", 10)
    jstate, jmetrics = jax.jit(jax_make_train_step(apply_fn, jt, **kw))(jstate, jnp.asarray(x0))

    model = load_flax_params(get_model(8, cfg, device="cpu"), params)
    tables = DiffusionTables.from_schedule(NoiseSchedule.create(T, "linear"), "cpu")
    state = TrainState(model, AdamChain(model.parameters(), 2e-4), T,
                       torch.Generator().manual_seed(13))
    metrics = make_train_step(tables, **kw)(state, _t(x0), t=_t(t).long(), noise=_t(noise))
    assert set(metrics) == set(jmetrics)
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    if "vlb" in jmetrics:
        np.testing.assert_allclose(float(metrics["vlb"]), float(jmetrics["vlb"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jmetrics["grad_norm"]),
                               rtol=1e-4)
    want = params_from_flax(_adam_first_grads(jstate))
    named = dict(state.model.named_parameters())
    assert set(want) == set(named)
    for k, w in want.items():
        np.testing.assert_allclose(named[k].grad.numpy(), w.numpy(), rtol=0,
                                   atol=1e-4 * float(w.abs().max()), err_msg=k)
    np.testing.assert_allclose(state.loss_history.ring.numpy(),
                               np.asarray(jstate.loss_history.ring), rtol=1e-5, atol=0)


@pytest.mark.parametrize("prediction_type,weighting", [("v", "min_snr"), ("x0", "none")])
def test_eval_step_matches_jax(prediction_type, weighting):
    """The validation loss of each target and weighting, on JAX's t and
    noise (``jax.random.split`` of the step's key), within 1e-5."""
    cfg, T = dict(ONE_LEVEL, learn_sigma=True), 100
    x0 = _images((3, 8, 8, 3), seed=14)
    jm = jax_get_model(8, cfg)
    params = _random_flax_params(jm, jnp.asarray(x0), jnp.ones((3,), jnp.int32), seed=14)
    jt = JaxTables.from_schedule(JaxSchedule.create(T, "cosine"))
    key = jax.random.PRNGKey(3)
    want = jax_make_eval_step(lambda p, x, t, y=None: jm.apply({"params": p}, x, t, y), jt,
                              prediction_type=prediction_type, loss_weighting=weighting)(
        params, key, jnp.asarray(x0))
    key_t, key_noise = jax.random.split(key)
    t, _ = jax_sample_uniform(key_t, 3, T)
    noise = jax.random.normal(key_noise, x0.shape, jnp.float32)
    tables = DiffusionTables.from_schedule(NoiseSchedule.create(T, "cosine"), "cpu")
    model = load_flax_params(get_model(8, cfg, device="cpu"), params)
    got = make_eval_step(tables, prediction_type=prediction_type, loss_weighting=weighting)(
        model, torch.Generator(), _t(x0), t=_t(np.asarray(t)).long(), noise=_t(np.asarray(noise)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


# ------------------------------------------------------------- class dropout


def _cond_state(seed=0):
    cfg = dict(SMALL, model_channels=32, channel_mult=[1], attention_resolutions=[],
               num_classes=3, cfg_null_class=True, use_scale_shift_norm=True)
    model = get_model(8, cfg, device="cpu", seed=seed)
    return TrainState(model, AdamChain(model.parameters(), 2e-4), 20,
                      torch.Generator().manual_seed(seed + 1))


def test_class_dropout_leaves_a_run_without_cfg_unchanged():
    """Without class dropout the step draws t and the noise alone from the
    state's generator, bit for bit as an injected run; with p the labels
    take the null class where the draw after t and the noise is below p
    (p = 1: every label)."""
    tables = DiffusionTables.from_schedule(NoiseSchedule.create(20, "cosine"), "cpu")
    x0 = _t(_images((4, 8, 8, 3), seed=15))
    y = torch.tensor([0, 1, 2, 1])
    plain = make_train_step(tables)

    drawn = _cond_state()
    ref = copy.deepcopy(drawn)
    gen = torch.Generator().manual_seed(1)
    t, _ = sample_uniform(gen, 4, 20)
    noise = torch.randn(x0.shape, generator=gen)
    got = make_train_step(tables, class_dropout_prob=0.0, null_class=3)(drawn, x0, y)
    want = plain(ref, x0, y, t=t, noise=noise)
    assert torch.equal(drawn.generator.get_state(), gen.get_state())
    assert torch.equal(got["loss"], want["loss"])
    for p, q in zip(drawn.model.parameters(), ref.model.parameters()):
        assert torch.equal(p, q)

    for prob in (0.5, 1.0):
        dropped, ref = _cond_state(), _cond_state()
        gen = torch.Generator().manual_seed(1)
        t, _ = sample_uniform(gen, 4, 20)
        noise = torch.randn(x0.shape, generator=gen)
        mask = torch.rand(4, generator=gen) < prob
        got = make_train_step(tables, class_dropout_prob=prob, null_class=3)(dropped, x0, y)
        want = plain(ref, x0, torch.where(mask, torch.full_like(y, 3), y), t=t, noise=noise)
        assert torch.equal(got["loss"], want["loss"]), prob
    assert bool(mask.all())
    with pytest.raises(ValueError, match="null_class"):
        make_train_step(tables, class_dropout_prob=0.1)
    with pytest.raises(ValueError, match="cfg_null_class"):
        DiffusionEngine(dict(SMALL, num_classes=3), {"lr": 1e-4}, diffusion_steps=10,
                        resolution=8, device="cpu", class_dropout_prob=0.1)


# ------------------------------------------------------------- the eps view


@pytest.mark.parametrize("prediction_type,learn_sigma", [("v", False), ("x0", True)])
def test_eps_view_chain_matches_jax(prediction_type, learn_sigma):
    """A mean_only chain of 5 steps respaced from T=1000 ("ddim5": t = 801
    down to 1) through the eps view of a v or x0 model (with a learned-sigma
    head: only its first half is converted), against JAX's wrapped apply
    function, within 1e-4 (as test_torch_sampler.py's UNet chain); the view
    converts at the original timesteps with the full schedule's tables.
    (Nearer t = T the view's x0 of a v head, x_t / sqrt(ab) - ..., magnifies
    float32 rounding by 1 / sqrt(ab_T) = 158.)"""
    cfg = dict(SMALL, model_channels=32, channel_mult=[1], attention_resolutions=[8],
               use_scale_shift_norm=True, learn_sigma=learn_sigma)
    x_T = np.random.RandomState(16).randn(2, 8, 8, 3).astype(np.float32)
    jm = jax_get_model(8, cfg)
    params = _random_flax_params(jm, jnp.asarray(x_T), jnp.ones((2,), jnp.int32), seed=16)
    jfull = JaxSchedule.create(1000, "linear")
    jsched, jmap = jax_respaced_schedule(jfull, jax_space_timesteps(1000, "ddim5"))
    view = {"v": jax_v_view, "x0": jax_x0_view}[prediction_type]
    apply = view(lambda p, x, t, y=None: jm.apply({"params": p}, x, t),
                 JaxTables.from_schedule(jfull))
    ref = np.asarray(jax_p_sample_loop(
        jax.jit(apply), params, JaxTables.from_schedule(jsched), jnp.asarray(x_T),
        clip=True, mean_only=True, timestep_map=jnp.asarray(jmap)))

    model = load_flax_params(get_model(8, cfg, device="cpu"), params)
    full = NoiseSchedule.create(1000, "linear")
    sched, tmap = respaced_schedule(full, space_timesteps(1000, "ddim5"))
    make = {"v": make_v_to_eps_apply_fn, "x0": make_x0_to_eps_apply_fn}[prediction_type]
    fn = make(model, DiffusionTables.from_schedule(full, "cpu"))
    out = p_sample_loop(fn, DiffusionTables.from_schedule(sched, "cpu"), _t(x_T), clip=True,
                        mean_only=True, timestep_map=_t(tmap).long())
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)
    # the variance half passes through the view untouched
    x, tt = _t(x_T), torch.tensor([150, 3])
    with torch.no_grad():
        raw, viewed = model(x, tt), fn(x, tt)
    if learn_sigma:
        assert torch.equal(raw[..., 3:], viewed[..., 3:])
    assert not torch.equal(raw[..., :3], viewed[..., :3])


def test_engine_samples_and_scores_through_the_eps_view():
    """A v engine on a zero-terminal-SNR schedule: sampling and the NLL run
    the eps view of the EMA weights (the raw model trains); eps models
    cannot take that schedule."""
    ztsnr = DiffusionEngine(dict(ONE_LEVEL), {"lr": 1e-4}, diffusion_steps=12, mode="linear",
                            beta_start=1e-4, beta_end=0.2, resolution=8, ema=0.9,
                            prediction_type="v", zero_terminal_snr=True, device="cpu")
    from probabilisticdeepdiffusionmodels_torch.core import rescale_zero_terminal_snr
    want = rescale_zero_terminal_snr(NoiseSchedule.create(12, "linear", beta_start=1e-4,
                                                          beta_end=0.2).betas)
    np.testing.assert_array_equal(ztsnr.schedule.betas, want)
    x0 = _t(_images((2, 8, 8, 3), seed=17))
    images = ztsnr.generate_images(n=2, minibatch=2, seed=3, mean_only=True)
    view = make_v_to_eps_apply_fn(ztsnr.state.ema_model, ztsnr.tables)
    chain = p_sample_loop(view, ztsnr.tables, torch.randn(
        (2, 8, 8, 3), generator=torch.Generator().manual_seed(3)), mean_only=True)
    np.testing.assert_array_equal(images, chain.numpy())
    nll = ztsnr.test_step(x0, seed=1)
    assert all(np.isfinite(v) for v in nll.values())
    with pytest.raises(ValueError, match="zero_terminal_snr"):
        DiffusionEngine(dict(ONE_LEVEL), {"lr": 1e-4}, diffusion_steps=12, resolution=8,
                        zero_terminal_snr=True, device="cpu")
    hybrid = DiffusionEngine(dict(ONE_LEVEL), {"lr": 1e-4}, diffusion_steps=12, mode="cosine",
                             resolution=8, loss_type="hybrid", device="cpu")
    assert hybrid.model(x0, torch.tensor([3, 4])).shape == (2, 8, 8, 6)  # learn_sigma
    assert "vlb" in hybrid.training_step(x0)
