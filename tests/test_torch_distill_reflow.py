"""The port's progressive distillation and reflow against the JAX package:
the halved student's schedule and warm start, one distillation step (its
targets x0* and v*, plain, classifier-free guided and from a learned-sigma
teacher; its loss and gradients), the reflow step, the teacher couplings of
the DDIM and flow chains from one z, the rounds and their guards, and
``cli.distill`` and ``cli.reflow`` end to end into ``cli.sample``.

JAX's draws (t, noise) are injected into the port's steps.  The targets are
read through a probe student, one parameter shaped like x0 that the network
returns as its output: the gradient of the v-space MSE is then -2 v* / N on
both sides, so v* (and x0* = a_t z - s_t v*) comes out of JAX's own step.

Tolerances: the betas bit for bit; targets, losses and couplings within
1e-5 (relative to the largest value; float32 through a small UNet, summed in
another order); each gradient within 1e-5 of its largest element; the loss
history's counts exactly, its values within 1e-5.
"""

import json
import pathlib
import types

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from probabilisticdeepdiffusionmodels_torch.cli import distill as cli_distill
from probabilisticdeepdiffusionmodels_torch.cli import reflow as cli_reflow
from probabilisticdeepdiffusionmodels_torch.cli import sample as cli_sample
from probabilisticdeepdiffusionmodels_torch.convert import load_flax_params, params_from_flax
from probabilisticdeepdiffusionmodels_torch.core import DiffusionTables, FlowConfig, NoiseSchedule
from probabilisticdeepdiffusionmodels_torch.engine import AdamChain, DiffusionEngine
from probabilisticdeepdiffusionmodels_torch.models import get_model
from probabilisticdeepdiffusionmodels_torch.sample import make_cfg_apply_fn, respaced_schedule
from probabilisticdeepdiffusionmodels_torch.train import TrainState
from probabilisticdeepdiffusionmodels_torch.train.distill import (
    distill_round,
    halved_student,
    make_distill_step,
)
from probabilisticdeepdiffusionmodels_torch.train.reflow import (
    generate_couplings,
    make_reflow_step,
    reflow_round,
    reflow_student,
)
from test_torch_cli import write_run
from test_torch_threads import one_torch_thread  # noqa: E402,F401

# a 2-level UNet at 8x8 with FiLM conditioning (GroupNorm's groups of one
# channel would normalise an added embedding away); cosine T = 20
RES, T, B = 8, 20, 4
CFG = dict(name="unet", in_channels=3, model_channels=16, num_res_blocks=1,
           attention_resolutions=[4], channel_mult=[1, 2], num_heads=1,
           use_scale_shift_norm=True)
COND = dict(CFG, num_classes=3, cfg_null_class=True)
SIGMA = dict(CFG, learn_sigma=True)
ENGINE_KW = dict(diffusion_steps=T, mode="cosine", resolution=RES, device="cpu")
LR = 2e-4
TOL = 1e-5
CPU = ["device=cpu"]


@pytest.fixture(scope="module")
def jx():
    """The JAX side (Flax and optax; the card's machine lacks them): the
    distillation and reflow modules, the tables, the samplers, a TrainState
    maker and random Flax weights for each model config."""
    pytest.importorskip("flax")
    optax = pytest.importorskip("optax")
    from probabilisticdeepdiffusionmodels_tpu.core import DiffusionTables as JT
    from probabilisticdeepdiffusionmodels_tpu.core import NoiseSchedule as JS
    from probabilisticdeepdiffusionmodels_tpu.core import flow as JF
    from probabilisticdeepdiffusionmodels_tpu.models import get_model as jax_get_model
    from probabilisticdeepdiffusionmodels_tpu.sample import sampler as JSam
    from probabilisticdeepdiffusionmodels_tpu.train import distill as JD
    from probabilisticdeepdiffusionmodels_tpu.train import reflow as JR
    from probabilisticdeepdiffusionmodels_tpu.train.samplers import sample_uniform
    from probabilisticdeepdiffusionmodels_tpu.train.state import TrainState as JState
    from test_torch_unet import _random_flax_params

    sched = JS.create(diffusion_steps=T, mode="cosine")
    half, _ = JSam.respaced_schedule(sched, list(range(2, T + 1, 2)))

    def model(cfg, seed):
        jm = jax_get_model(RES, cfg)
        y = jnp.zeros((1,), jnp.int32) if cfg.get("num_classes") else None
        params = _random_flax_params(jm, jnp.zeros((1, RES, RES, 3)), jnp.ones((1,), jnp.int32),
                                     y, seed=seed)

        def apply(p, x, t, y=None, **kw):
            return jm.apply({"params": p}, x, t, y)

        return params, apply

    def state(params, steps, seed):
        return JState.create(params, optax.adam(LR), steps, jax.random.PRNGKey(seed))

    return types.SimpleNamespace(
        D=JD, R=JR, F=JF, S=JSam, sample_uniform=sample_uniform, sched=sched, half=half,
        tables=JT.from_schedule(sched), half_tables=JT.from_schedule(half), model=model,
        state=state)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _x0(seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, size=(B, RES, RES, 3)) / 127.5 - 1.0).astype(np.float32)


def _tables():
    sched = NoiseSchedule.create(T, "cosine")
    half, _ = respaced_schedule(sched, range(2, T + 1, 2))
    return DiffusionTables.from_schedule(sched, "cpu"), DiffusionTables.from_schedule(half, "cpu")


def _port_model(cfg, params):
    return load_flax_params(get_model(RES, cfg, device="cpu"), params).eval()


def _state(model, steps, seed):
    return TrainState(model, AdamChain(model.parameters(), LR), steps,
                      torch.Generator().manual_seed(seed))


def _first_grads(jstate):
    """optax's first Adam moment after one update is (1 - b1) * g."""
    return jax.tree.map(lambda m: np.asarray(m) / np.float32(0.1), jstate.opt_state[0].mu)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())))


# ------------------------------------------------------------- the student


def test_halved_student_schedule_and_warm_start():
    """Betas equal JAX's respacing of the teacher's schedule bit for bit; the
    student is a v engine over T/2 steps on the teacher's device whose live
    and EMA weights are the teacher's EMA weights; an engine rebuilt from
    its hparams has the same betas."""
    pytest.importorskip("flax")
    from probabilisticdeepdiffusionmodels_tpu.core import NoiseSchedule as JS
    from probabilisticdeepdiffusionmodels_tpu.sample.sampler import respaced_schedule as jrs

    teacher = DiffusionEngine(dict(CFG), {"lr": LR}, ema=0.9, **ENGINE_KW)
    with torch.no_grad():
        for p in teacher.state.ema_model.parameters():
            p.add_(0.01)
    student = halved_student(teacher, lr=1e-3)
    want, _ = jrs(JS.create(diffusion_steps=T, mode="cosine"), list(range(2, T + 1, 2)))
    np.testing.assert_array_equal(np.asarray(student.schedule.betas), np.asarray(want.betas))
    assert (student.diffusion_steps, student.prediction_type) == (T // 2, "v")
    assert student.hparams["mode"] == "respaced[cosine]x0.5" and student.device == teacher.device
    assert student.hparams["optimizer_config"]["lr"] == 1e-3
    src = teacher.state.ema_model.state_dict()
    for model in (student.state.model, student.state.ema_model):
        assert all(torch.equal(v, src[k]) for k, v in model.state_dict().items())
    rebuilt = DiffusionEngine(**dict(student.hparams, device="cpu"))
    assert torch.equal(rebuilt.tables.betas, student.tables.betas)


def test_halved_student_rejections():
    """JAX's refusals: an odd T and a learned-sigma (hybrid) teacher; and
    guided distillation of a teacher without its null class."""
    odd = DiffusionEngine(dict(CFG), {"lr": LR}, **dict(ENGINE_KW, diffusion_steps=7))
    with pytest.raises(ValueError, match="cannot halve T=7"):
        halved_student(odd)
    hybrid = DiffusionEngine(dict(CFG), {"lr": LR}, loss_type="hybrid", **ENGINE_KW)
    with pytest.raises(NotImplementedError, match="learned-sigma"):
        halved_student(hybrid)
    teacher = DiffusionEngine(dict(CFG), {"lr": LR}, **ENGINE_KW)
    student = halved_student(teacher)
    x = _x0(0)
    with pytest.raises(ValueError, match="cfg_null_class"):
        distill_round(student, teacher, [x], guidance_scale=2.0)
    with pytest.raises(ValueError, match="twice as many"):
        make_distill_step(None, teacher.tables, teacher.tables)


# ------------------------------------------------------------- one distillation step


class _Probe(torch.nn.Module):
    """A 'network' whose output is its one parameter, shaped like x0."""

    def __init__(self):
        super().__init__()
        self.probe = torch.nn.Parameter(torch.zeros(B, RES, RES, 3))

    def forward(self, x, t, y=None):
        return self.probe


def _jax_draws(jx, jstate, steps):
    """The t and noise JAX's step draws from its state."""
    key_t, key_noise = jax.random.split(jax.random.fold_in(jstate.rng, jstate.step))
    t, _ = jx.sample_uniform(key_t, B, steps)
    return np.asarray(t), np.asarray(jax.random.normal(key_noise, (B, RES, RES, 3)))


@pytest.mark.parametrize("kind", ["guided", "learned_sigma"])
def test_distill_targets_match_jax(jx, kind):
    """x0* and v* of one step through JAX's step and the port's, read off a
    probe student: a CFG teacher at scale 2 (the doubled-batch call with
    the null class), and a learned-sigma teacher whose output is cut to its
    mean head.  The plain teacher's targets reach the loss and gradients of
    ``test_distill_step_matches_jax``."""
    cfg = {"guided": COND, "learned_sigma": SIGMA}[kind]
    t_params, t_apply = jx.model(cfg, 10)
    teacher = _port_model(cfg, t_params)
    y = np.array([0, 2, 1, 0], np.int32) if kind == "guided" else None
    if kind == "guided":
        jteach = jx.S.make_cfg_apply_fn(t_apply, 2.0, 3)
        pteach = make_cfg_apply_fn(lambda x, t, yy: teacher(x, t, yy), 2.0, 3)
    else:
        jteach, pteach = t_apply, (lambda x, t, yy: teacher(x, t, yy))
    x0 = _x0(11)
    jstate = jx.state({"probe": jnp.zeros((B, RES, RES, 3))}, T // 2, 12)
    t_s, noise = _jax_draws(jx, jstate, T // 2)
    jstep = jax.jit(jx.D.make_distill_step(lambda p, x, t, yy=None: p["probe"], jteach,
                                           jx.half_tables, jx.tables))
    jstate, jm = jstep(jstate, jnp.asarray(x0), t_params, None if y is None else jnp.asarray(y))
    n = x0.size
    v_want = -_first_grads(jstate)["probe"] * n / 2

    tables, half = _tables()
    state = _state(_Probe(), T // 2, 12)
    step = make_distill_step(pteach, half, tables)
    metrics = step(state, _t(x0), None if y is None else _t(y).long(), t=_t(t_s).long(),
                   noise=_t(noise))
    v_got = -state.model.probe.grad.numpy() * n / 2
    _close(v_got, v_want)
    a_t = half.alphas_hat_sqrt.numpy()[t_s - 1][:, None, None, None]
    s_t = half.one_min_alphas_hat_sqrt.numpy()[t_s - 1][:, None, None, None]
    z = a_t * x0 + s_t * noise
    _close(a_t * z - s_t * v_got, a_t * z - s_t * v_want)  # x0*
    assert np.abs(a_t * z - s_t * v_got).max() <= 1.0 + 1e-4  # clip_target
    _close(float(metrics["loss"]), float(jm["loss"]))
    assert all(p.grad is None for p in teacher.parameters())


def test_distill_step_matches_jax(jx):
    """One step of a UNet student (the teacher another UNet): the loss, each
    gradient and the loss history at t_s."""
    s_params, s_apply = jx.model(CFG, 13)
    t_params, t_apply = jx.model(CFG, 14)
    x0 = _x0(15)
    jstate = jx.state(s_params, T // 2, 16)
    t_s, noise = _jax_draws(jx, jstate, T // 2)
    jstep = jax.jit(jx.D.make_distill_step(s_apply, t_apply, jx.half_tables, jx.tables))
    jstate, jm = jstep(jstate, jnp.asarray(x0), t_params)

    tables, half = _tables()
    teacher = _port_model(CFG, t_params)
    state = _state(_port_model(CFG, s_params), T // 2, 16)
    step = make_distill_step(lambda x, t, y: teacher(x, t, y), half, tables)
    metrics = step(state, _t(x0), t=_t(t_s).long(), noise=_t(noise))
    _close(float(metrics["loss"]), float(jm["loss"]))
    _close(float(metrics["grad_norm"]), float(jm["grad_norm"]))
    named = dict(state.model.named_parameters())
    for k, w in params_from_flax(_first_grads(jstate)).items():
        _close(named[k].grad.numpy(), w.numpy())
    _close(state.loss_history.ring.numpy(), np.asarray(jstate.loss_history.ring))
    np.testing.assert_array_equal(state.loss_history.count.numpy(),
                                  np.asarray(jstate.loss_history.count))


def test_distill_round():
    """The round runs one step a batch, (x0, y) or x0 alike, logs from step 0
    and returns floats; no batch raises; a guided round needs labels."""
    teacher = DiffusionEngine(dict(COND), {"lr": LR}, **ENGINE_KW)
    student = halved_student(teacher)
    x, y = _x0(17), np.array([0, 1, 2, 0])
    logged = []
    out = distill_round(student, teacher, [(x, y), (x, y), (x, y)], log_every=2,
                        log=logged.append, guidance_scale=1.5)
    assert set(out) == {"loss", "grad_norm"} and all(np.isfinite(v) for v in out.values())
    assert student.state.step == 3 and len(logged) == 2
    with pytest.raises(ValueError, match="zero batches"):
        distill_round(student, teacher, [])
    with pytest.raises(ValueError, match="needs labels"):
        distill_round(student, teacher, [x], guidance_scale=1.5)


# ------------------------------------------------------------- reflow


def test_reflow_step_matches_jax(jx):
    """One reflow step on JAX's flow times: the loss, each gradient and the
    loss history at each time's VP bucket."""
    params, apply = jx.model(CFG, 20)
    x, z = _x0(21), np.random.RandomState(22).randn(B, RES, RES, 3).astype(np.float32)
    jstate = jx.state(params, T, 23)
    key_t, _ = jax.random.split(jax.random.fold_in(jstate.rng, jstate.step))
    t = np.asarray(jx.F.sample_t(key_t, B, jx.F.FlowConfig()))
    jstep = jax.jit(jx.R.make_reflow_step(apply, jx.tables, jx.F.FlowConfig()))
    jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(z))

    tables, _ = _tables()
    state = _state(_port_model(CFG, params), T, 23)
    metrics = make_reflow_step(tables, FlowConfig())(state, _t(x), _t(z), t=_t(t))
    _close(float(metrics["loss"]), float(jm["loss"]))
    named = dict(state.model.named_parameters())
    for k, w in params_from_flax(_first_grads(jstate)).items():
        _close(named[k].grad.numpy(), w.numpy())
    _close(state.loss_history.ring.numpy(), np.asarray(jstate.loss_history.ring))
    np.testing.assert_array_equal(state.loss_history.count.numpy(),
                                  np.asarray(jstate.loss_history.count))


@pytest.mark.parametrize("kind", ["epsilon", "flow"])
def test_generate_couplings_match_jax(jx, kind):
    """JAX's ``generate_couplings`` (its z from its key, its sampler through
    a stand-in engine: eta = 0 DDIM over 5 respaced steps for an eps
    teacher, the flow ODE's 5 Euler steps for a flow teacher) against the
    port's from the same z."""
    params, apply = jx.model(CFG, 24)
    steps = 5

    def generate_images(n, minibatch, x_T, use_ema, y, ddim=False, flow=False,
                        num_sample_steps=None):
        if flow:
            return jx.S.flow_sample_loop(apply, params, jx.tables, x_T, n_steps=num_sample_steps)
        kept = jx.S.space_timesteps(T, num_sample_steps)
        sub, tmap = jx.S.respaced_schedule(jx.sched, kept)
        from probabilisticdeepdiffusionmodels_tpu.core import DiffusionTables as JT

        return jx.S.ddim_sample_loop(apply, params, JT.from_schedule(sub), x_T,
                                     timestep_map=jnp.asarray(tmap))

    stand_in = types.SimpleNamespace(prediction_type=kind, resolution=RES, dims=2,
                                     in_channels=3, generate_images=generate_images)
    kw = dict(flow=True) if kind == "flow" else dict(ddim=True)
    key = jax.random.PRNGKey(25)
    z_want, x_want = jx.R.generate_couplings(stand_in, B, key,
                                             sampler_kwargs=dict(kw, num_sample_steps=steps))
    teacher = DiffusionEngine(dict(CFG), {"lr": LR}, prediction_type=kind, **ENGINE_KW)
    load_flax_params(teacher.state.model, params)
    z, x = generate_couplings(teacher, B, z=z_want, sampler_kwargs=dict(
        kw, num_sample_steps=steps))
    np.testing.assert_array_equal(z.numpy(), z_want)
    _close(x.numpy(), x_want)


def test_reflow_student_and_round():
    """The student: a flow engine on the teacher's betas and device with its
    (EMA) weights, a flow teacher's flow config; a learned-sigma teacher
    raises.  The round trains epochs x (n // batch) steps over the
    couplings in the injected orders, logs, and returns floats; fewer
    couplings than a batch raise."""
    teacher = DiffusionEngine(dict(CFG), {"lr": LR}, prediction_type="flow", ema=0.9,
                              flow_config=dict(logit_std=0.5), **ENGINE_KW)
    student = reflow_student(teacher, lr=1e-3)
    assert student.prediction_type == "flow" and student.flow.logit_std == 0.5
    np.testing.assert_array_equal(student.schedule.betas, teacher.schedule.betas)
    src = teacher.state.ema_model.state_dict()
    assert all(torch.equal(v, src[k]) for k, v in student.state.model.state_dict().items())
    cold = reflow_student(DiffusionEngine(dict(CFG), {"lr": LR}, **ENGINE_KW), warm_start=False)
    assert cold.flow == FlowConfig()
    with pytest.raises(NotImplementedError, match="learned-sigma"):
        reflow_student(DiffusionEngine(dict(CFG), {"lr": LR}, loss_type="hybrid", **ENGINE_KW))
    logged = []
    out = reflow_round(student, teacher, n_couplings=6, batch_size=2, epochs=2,
                       sampler_kwargs=dict(flow=True, num_sample_steps=2), log_every=4,
                       log=logged.append, orders=[np.arange(6), np.arange(6)[::-1]])
    assert set(out) == {"loss", "grad_norm"} and all(np.isfinite(v) for v in out.values())
    assert student.state.step == 6 and len(logged) == 1 + 2
    with pytest.raises(ValueError, match="no training step"):
        reflow_round(student, teacher, n_couplings=3, batch_size=4)


# ------------------------------------------------------------- the CLIs


def _trained_on_card(run_dir):
    """``run_dir`` with a config that names the card and the device-resident
    loader, as a run trained there leaves it."""
    config = pathlib.Path(run_dir) / "experiment_config.yaml"
    run_cfg = yaml.safe_load(config.read_text())
    run_cfg["device"], run_cfg["data"]["device_resident"] = "cuda", True
    config.write_text(yaml.safe_dump(run_cfg))
    return run_dir


def test_distill_cli_then_sample(tmp_path):
    """``cli.distill`` halves a T = 12 eps run once into ``<teacher>_distillT6``
    (config, checkpoint, metrics, ``final_test.json`` with the NLL) that
    ``cli.sample`` reads.  The teacher's config names the card and the
    device-resident loader: the CLI's ``device=cpu`` places the loaders too."""
    teacher = _trained_on_card(write_run(tmp_path, name="teacher"))
    out = cli_distill.main([f"run_dir={teacher}", "epochs=1", f"out_dir={tmp_path}",
                            "limit_test_batches=1", "log_every=1"] + CPU)
    run_dir = pathlib.Path(out[6]["run_dir"])
    assert run_dir.name == "teacher_distillT6" and set(out) == {6}
    final = json.loads((run_dir / "final_test.json").read_text())
    assert final == {k: v for k, v in out[6].items() if k != "run_dir"}
    assert {"loss", "grad_norm", "test_nll"} <= set(final)
    assert all(np.isfinite(v) for v in final.values())
    assert [p.name for p in (run_dir / "checkpoints").iterdir()] == ["2"]
    engine, _ = cli_sample.load_engine_from_run(run_dir, device="cpu")
    assert (engine.diffusion_steps, engine.prediction_type) == (6, "v")
    sampled = cli_sample.main([f"run_dir={run_dir}", "sampler=ddim", "num_sample_steps=3",
                               "n_random=2", "regular_viz=false"] + CPU)
    assert sampled["images"].shape == (2, RES, RES, 1) and np.isfinite(sampled["images"]).all()


def test_reflow_cli_then_sample(tmp_path):
    """``cli.reflow`` on a flow run writes ``<teacher>_reflow`` (config,
    checkpoint, ``final_test.json`` with the NLL through the eps view) that
    ``cli.sample sampler=flow`` reads; an unknown coupling sampler raises.
    The teacher's config names the card and the device-resident loader:
    the CLI's ``device=cpu`` places the loader too."""
    teacher = _trained_on_card(write_run(tmp_path, ["engine.prediction_type=flow"],
                                         name="flowteacher"))
    out = cli_reflow.main([f"run_dir={teacher}", "n_couplings=4", "batch_size=2", "epochs=1",
                           "gen_sampler=flow", "gen_steps=2", "minibatch_gen=4",
                           f"out_dir={tmp_path}", "limit_test_batches=1", "log_every=1"] + CPU)
    run_dir = pathlib.Path(out["run_dir"])
    assert run_dir.name == "flowteacher_reflow"
    final = json.loads((run_dir / "final_test.json").read_text())
    assert final == {k: v for k, v in out.items() if k != "run_dir"}
    assert all(np.isfinite(v) for v in final.values())
    assert [p.name for p in (run_dir / "checkpoints").iterdir()] == ["2"]
    sampled = cli_sample.main([f"run_dir={run_dir}", "sampler=flow", "num_sample_steps=2",
                               "n_random=2", "regular_viz=false"] + CPU)
    assert sampled["images"].shape == (2, RES, RES, 1) and np.isfinite(sampled["images"]).all()
    with pytest.raises(ValueError, match="gen_sampler"):
        cli_reflow.main([f"run_dir={teacher}", "gen_sampler=euler", f"out_dir={tmp_path}"]
                        + CPU)


# ------------------------------------------------------------- on the card


@pytest.mark.gpu
def test_card_distill_and_reflow_kernels_match_plain():
    """One float32 distillation step and one reflow step on the kernels
    (teacher, student and ``gn_affine``'s backward) against the plain
    versions, the same draws: gradients within 1e-3 of their largest value."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from probabilisticdeepdiffusionmodels_torch import ops
    from probabilisticdeepdiffusionmodels_torch.evals.inception import true_float32
    from probabilisticdeepdiffusionmodels_torch.models import layers, unet

    kw = dict(ENGINE_KW, device="cuda")
    teacher = DiffusionEngine(dict(CFG), {"lr": LR}, **kw)
    x0 = torch.rand(B, RES, RES, 3, device="cuda") * 2 - 1
    z = torch.randn(x0.shape, device="cuda")
    t_s = torch.tensor([1, 3, 6, 10], device="cuda")
    t = torch.tensor([0.1, 0.4, 0.6, 0.95], device="cuda")
    sites = [(unet, "gn_affine"), (unet, "gn_silu_conv3x3"), (unet, "qkv_attention"),
             (layers, "group_norm_silu")]

    def run(kind):
        student = (halved_student if kind == "distill" else reflow_student)(teacher)
        if kind == "distill":
            view = teacher._view(teacher.params(True).eval())
            make_distill_step(view, student.tables, teacher.tables)(student.state, x0, t=t_s,
                                                                    noise=z)
        else:
            make_reflow_step(student.tables, student.flow)(student.state, x0, z, t=t)
        return student.state.model

    for kind in ("distill", "reflow"):
        with true_float32():
            got = run(kind)
            saved = [getattr(m, n) for m, n in sites]
            try:
                for m, n in sites:
                    setattr(m, n, getattr(ops, n + "_plain"))
                want = dict(run(kind).named_parameters())
            finally:
                for (m, n), f in zip(sites, saved):
                    setattr(m, n, f)
        for name, p in got.named_parameters():
            g = want[name].grad
            assert float((p.grad - g).abs().max()) <= 1e-3 * max(1e-6, float(g.abs().max())), \
                (kind, name)
