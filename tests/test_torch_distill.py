"""The port's consistency distillation (CD) against the JAX package: the
teacher denoisers of the EDM, flow and table (eps, v) teachers, the nearest
timestep lookup, one CD step with JAX's draws injected (the stopgrad and the
EMA target), the student's construction, the distillation round, and
``cli.consistency`` then ``cli.sample sampler=consistency`` end to end.

Tolerances: a denoiser through the small UNet within 1e-4 (relative to its
largest value; test_torch_families.py's engine chains); a CD step at the
train steps' tolerances of test_torch_families.py (loss 1e-5, grad_norm
1e-4 relative, each gradient within 1e-4 of its largest element, the loss
history within 1e-5), and the EMA weights after it within 2 * lr (Adam's
first update is about lr * sign(g), test_torch_train.py); the lookup
exactly.
"""

import json
import pathlib
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from probabilisticdeepdiffusionmodels_torch.cli import consistency as cli_consistency
from probabilisticdeepdiffusionmodels_torch.cli import sample as cli_sample
from probabilisticdeepdiffusionmodels_torch.convert import load_flax_params, params_from_flax
from probabilisticdeepdiffusionmodels_torch.core import (
    ConsistencyConfig,
    DiffusionTables,
    NoiseSchedule,
)
from probabilisticdeepdiffusionmodels_torch.engine import DiffusionEngine
from probabilisticdeepdiffusionmodels_torch.train.consistency import (
    _nearest_t_by_sigma,
    _sigma_table,
    consistency_distill_round,
    consistency_student,
    make_cd_step,
    make_teacher_denoiser,
)
from test_torch_cli import write_run

# test_torch_families.py's train-step UNet and schedule: 64 channels, one
# level, no attention; cosine T = 100
RES, T = 8, 100
TRAIN_CFG = dict(name="unet", in_channels=3, model_channels=64, num_res_blocks=1,
                 attention_resolutions=[], channel_mult=[1], num_heads=2)
ENGINE_KW = dict(diffusion_steps=T, mode="cosine", resolution=RES, device="cpu")
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
def jx():
    """The JAX side, which needs Flax and optax (the card's machine has JAX
    alone; the module's card test runs there): JAX's consistency module, its
    EDM config and v view, and test_torch_families.py's helpers."""
    pytest.importorskip("flax")
    pytest.importorskip("optax")
    import test_torch_families as fam
    from probabilisticdeepdiffusionmodels_tpu.core import consistency as JC
    from probabilisticdeepdiffusionmodels_tpu.core import edm as JE
    from probabilisticdeepdiffusionmodels_tpu.sample.sampler import make_v_to_eps_apply_fn
    from probabilisticdeepdiffusionmodels_tpu.train import consistency as J
    from test_torch_unet import _random_flax_params

    assert (fam.RES, fam.T, fam.TRAIN_CFG) == (RES, T, TRAIN_CFG)
    return types.SimpleNamespace(J=J, JC=JC, JE=JE, v_view=make_v_to_eps_apply_fn, fam=fam,
                                 random_params=_random_flax_params)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _teachers(jx, kind, params, jt, jax_apply):
    """The port's teacher engine on ``params`` and a JAX stand-in with the
    attributes JAX's ``make_teacher_denoiser`` reads."""
    engine = DiffusionEngine(dict(TRAIN_CFG), {"lr": 2e-4}, prediction_type=kind, **ENGINE_KW)
    load_flax_params(engine.state.model, params)
    view = jx.v_view(jax_apply, jt) if kind == "v" else jax_apply
    stand_in = types.SimpleNamespace(prediction_type=kind, _apply_raw=jax_apply, _apply=view,
                                     edm=jx.JE.EDMConfig(), tables=jt)
    return engine, stand_in


@pytest.mark.parametrize("kind", ["edm", "flow", "epsilon", "v"])
def test_teacher_denoiser_matches_jax(jx, kind):
    """D(x; sigma) per sample, from near sigma_min to near sigma_max: the
    EDM teacher at the exact sigma, the flow teacher in its own frame, the
    table teachers through their eps view at the nearest timestep."""
    x0, _, params, _, apply_fn = jx.fam._jax_setup(80)
    jt, _ = jx.fam._tables()
    engine, stand_in = _teachers(jx, kind, params, jt, apply_fn)
    sigma = np.array([0.003, 0.4, 2.5, 60.0], np.float32)
    x = x0 + sigma[:, None, None, None] * np.random.RandomState(81).randn(*x0.shape).astype(
        np.float32)
    jden = jx.J.make_teacher_denoiser(stand_in)
    want = np.asarray(jax.jit(lambda p, xx, s: jden(p, xx, s, None))(
        params, jnp.asarray(x), jnp.asarray(sigma)))
    with torch.no_grad():
        got = make_teacher_denoiser(engine)(engine.state.model, _t(x), _t(sigma), None).numpy()
    assert got.shape == want.shape and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_nearest_t_by_sigma(jx):
    """JAX's cases (tests/test_consistency.py): a sigma just above the
    table's t = k + 1 stays there, the upper part of a log-interval goes up,
    sigmas outside the table clamp; and random sigmas as JAX looks them up."""
    jt, tables = jx.fam._tables()
    sig = _sigma_table(tables).numpy()
    k = T // 2

    def look(s):
        return int(_nearest_t_by_sigma(tables, torch.tensor([s], dtype=torch.float32))[0])

    assert look(float(sig[k]) * 1.0001) == k + 1
    assert look(float(np.exp(0.9 * np.log(sig[k + 1]) + 0.1 * np.log(sig[k])))) == k + 2
    assert look(float(sig[0]) / 10) == 1 and look(float(sig[-1]) * 10) == T
    s = np.exp(np.random.RandomState(82).uniform(np.log(sig[0]) - 1, np.log(sig[-1]) + 1, 256)
               ).astype(np.float32)
    want = np.asarray(jx.J._nearest_t_by_sigma(jt, jnp.asarray(s)))
    np.testing.assert_array_equal(_nearest_t_by_sigma(tables, _t(s)).numpy(), want)


@pytest.mark.parametrize("teacher_kind,config", [
    ("epsilon", dict(grid_size=12)),
    ("edm", dict(target="ema", metric="l2", grid_size=12)),
], ids=["eps_teacher_stopgrad", "edm_teacher_ema"])
def test_cd_step_matches_jax(jx, teacher_kind, config):
    """One CD step on JAX's pair index and z: the teacher's Heun step, the
    student's loss and gradients, the loss history; with the EMA target
    (other weights than the live ones) the EMA after the update too."""
    ema = 0.99 if config.get("target") == "ema" else None
    x0, jm, params, jstate, apply_fn = jx.fam._jax_setup(83, ema=ema)
    jt, tables = jx.fam._tables()
    shapes = (jm, jnp.asarray(x0), jnp.ones((4,), jnp.int32))
    teacher_params = jx.random_params(*shapes, seed=84)
    engine, stand_in = _teachers(jx, teacher_kind, teacher_params, jt, apply_fn)
    state = jx.fam._port_state(params, 83, ema=ema)
    if ema:
        ema_params = jx.random_params(*shapes, seed=85)
        jstate = jstate.replace(ema_params=ema_params)
        load_flax_params(state.ema_model, ema_params)
    cfg = ConsistencyConfig(**config)
    key_i, key_z = jax.random.split(jax.random.fold_in(jstate.rng, jstate.step))
    index = np.asarray(jax.random.randint(key_i, (4,), 0, cfg.grid_size - 1))
    z = np.asarray(jax.random.normal(key_z, x0.shape, jnp.float32))
    jstep = jax.jit(jx.J.make_cd_step(apply_fn, jx.J.make_teacher_denoiser(stand_in),
                                      jx.JC.ConsistencyConfig(**config), jt))
    jstate, jmetrics = jstep(jstate, teacher_params, jnp.asarray(x0))
    step = make_cd_step(make_teacher_denoiser(engine), cfg, tables)
    metrics = step(state, engine.state.model, _t(x0), index=_t(index), z=_t(z))
    jx.fam._hold_step(metrics, jmetrics, state, jstate)
    if ema:
        got = state.ema_model.state_dict()
        for k, w in params_from_flax(jax.tree.map(np.asarray, jstate.ema_params)).items():
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0, atol=2 * 2e-4,
                                       err_msg=k)
    # the teacher took no gradient
    assert all(p.grad is None for p in engine.state.model.parameters())


def _tables():
    return DiffusionTables.from_schedule(NoiseSchedule.create(T, "cosine"), "cpu")


def test_cd_step_refuses_grid_annealing():
    tables = _tables()
    with pytest.raises(ValueError, match="grid_init"):
        make_cd_step(None, ConsistencyConfig(grid_init=4, anneal_steps=2), tables)


def test_consistency_student_and_round():
    """The student: the teacher's config, betas and (EMA) weights, an EDM
    teacher's sigma frame, a consistency engine; a learned-sigma teacher
    raises.  The round runs its steps, logs from step 0 and returns floats;
    no batch raises."""
    teacher = DiffusionEngine(dict(TRAIN_CFG), {"lr": 2e-4}, prediction_type="edm", ema=0.9,
                              edm_config=dict(sigma_max=40.0), **ENGINE_KW)
    student = consistency_student(teacher, lr=1e-4)
    assert student.prediction_type == "consistency" and student.device == teacher.device
    assert (student.cm.sigma_max, student.cm.sigma_data) == (40.0, teacher.edm.sigma_data)
    np.testing.assert_array_equal(student.schedule.betas, teacher.schedule.betas)
    assert student.hparams["optimizer_config"]["lr"] == 1e-4
    src = teacher.state.ema_model.state_dict()
    for model in (student.state.model, student.state.ema_model):
        assert all(torch.equal(v, src[k]) for k, v in model.state_dict().items())
    logged = []
    x = np.random.RandomState(86).uniform(-1, 1, (2, RES, RES, 3)).astype(np.float32)
    out = consistency_distill_round(student, teacher, [x, (x, None), x], log_every=2,
                                    log=logged.append)
    assert set(out) == {"loss", "grad_norm"} and all(np.isfinite(v) for v in out.values())
    assert student.state.step == 3 and len(logged) == 2
    with pytest.raises(ValueError, match="zero batches"):
        consistency_distill_round(student, teacher, [])
    hybrid = DiffusionEngine(dict(TRAIN_CFG), {"lr": 2e-4}, loss_type="hybrid", **ENGINE_KW)
    with pytest.raises(NotImplementedError, match="learned-sigma"):
        consistency_student(hybrid)


def test_consistency_cli_then_sample(tmp_path):
    """``cli.consistency`` on a trained eps run writes a run ``<teacher>_cd``
    (config, checkpoint, metrics, ``final_test.json`` with the CT
    validation loss) that ``cli.sample sampler=consistency`` reads."""
    teacher = write_run(tmp_path, name="teacher")
    out = cli_consistency.main([f"run_dir={teacher}", "epochs=1",
                                f"out_dir={tmp_path}", "limit_test_batches=1", "grid_size=8",
                                "log_every=1"] + CPU)
    run_dir = pathlib.Path(out["run_dir"])
    assert run_dir.name == "teacher_cd"
    assert set(out) == {"loss", "grad_norm", "test_ct_loss", "run_dir"}
    assert all(np.isfinite(out[k]) for k in ("loss", "grad_norm", "test_ct_loss"))
    final = json.loads((run_dir / "final_test.json").read_text())
    assert final == {k: v for k, v in out.items() if k != "run_dir"}
    assert [p.name for p in (run_dir / "checkpoints").iterdir()] == ["2"]
    engine, cfg = cli_sample.load_engine_from_run(run_dir, device="cpu")
    assert engine.prediction_type == "consistency" and engine.cm.grid_size == 8
    sampled = cli_sample.main([f"run_dir={run_dir}", "sampler=consistency", "n_random=2"]
                              + CPU)
    assert sampled["images"].shape == (2, RES, RES, 1) and np.isfinite(sampled["images"]).all()
    assert pathlib.Path(sampled["path"]).read_bytes()[:4] == b"\x89PNG"


@pytest.mark.gpu
def test_card_cd_step_kernels_match_plain():
    """One float32 CD step on the kernels (teacher, student, target, and
    ``gn_affine``'s backward) against the plain versions, the same draws:
    gradients within 1e-3 relative of their largest value."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from probabilisticdeepdiffusionmodels_torch import ops
    from probabilisticdeepdiffusionmodels_torch.evals.inception import true_float32
    from probabilisticdeepdiffusionmodels_torch.models import layers, unet

    kw = dict(ENGINE_KW, device="cuda")
    teacher = DiffusionEngine(dict(TRAIN_CFG), {"lr": 2e-4}, prediction_type="edm", **kw)
    students = [consistency_student(teacher) for _ in range(2)]
    step = make_cd_step(make_teacher_denoiser(teacher), students[0].cm, students[0].tables)
    x0 = torch.rand(4, RES, RES, 3, device="cuda") * 2 - 1
    index = torch.tensor([0, 5, 11, 30], device="cuda")
    z = torch.randn(x0.shape, device="cuda")
    sites = [(unet, "gn_affine"), (unet, "gn_silu_conv3x3"), (unet, "qkv_attention"),
             (layers, "group_norm_silu")]
    with true_float32():
        step(students[0].state, teacher.state.model, x0, index=index, z=z)
        saved = [getattr(m, n) for m, n in sites]
        try:
            for m, n in sites:
                setattr(m, n, getattr(ops, n + "_plain"))
            step(students[1].state, teacher.state.model, x0, index=index, z=z)
        finally:
            for (m, n), f in zip(sites, saved):
                setattr(m, n, f)
    plain = dict(students[1].state.model.named_parameters())
    for name, p in students[0].state.model.named_parameters():
        g = plain[name].grad
        assert float((p.grad - g).abs().max()) <= 1e-3 * max(1e-6, float(g.abs().max())), name
