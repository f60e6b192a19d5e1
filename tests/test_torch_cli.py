"""The port's command-line entry points on the CPU: ``cli.train`` ->
``cont_run`` -> ``cli.sample`` -> ``cli.eval`` on ``test_cli.py``'s tiny
config, the artifacts and keys the JAX CLIs give, the engine's endpoints,
the Trainer's validation limit and visualization cadence, the options the
port refuses, and the port's imports (no JAX, nothing of the JAX package, no
matplotlib, which the card's Python lacks), ``viz/`` among them."""

import ast
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from probabilisticdeepdiffusionmodels_torch.cli import eval as cli_eval
from probabilisticdeepdiffusionmodels_torch.cli import sample as cli_sample
from probabilisticdeepdiffusionmodels_torch.cli import train as cli_train
from probabilisticdeepdiffusionmodels_torch.config import load_config
from probabilisticdeepdiffusionmodels_torch.engine import DiffusionEngine
from probabilisticdeepdiffusionmodels_torch.logging.sink import RunDir
from probabilisticdeepdiffusionmodels_torch.train.checkpoint import CheckpointManager
from probabilisticdeepdiffusionmodels_torch.train.loop import Trainer
from test_cli import TINY
from test_torch_threads import one_torch_thread  # noqa: E402,F401

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "probabilisticdeepdiffusionmodels_torch"
CPU = ["device=cpu"]
TEST_KEYS = {"test_L_0", "test_L_intermediate", "test_L_T", "test_nll", "test_mse"}


def write_run(out_dir, overrides=(), name="run") -> str:
    """A run directory as ``cli.train`` leaves one (the config snapshot and
    a checkpoint with its ``val_loss``) for a fresh engine of ``TINY`` and
    ``overrides`` on the CPU, untrained: what the sample, eval, FID and
    consistency CLIs read, without the cost of training."""
    cfg = load_config("default", TINY + CPU + [f"out_dir={out_dir}", f"run_name={name}",
                                               *overrides])
    engine = cli_train.build_engine(cfg)
    run = RunDir(str(out_dir), name)
    run.save_config(cfg)
    CheckpointManager(run.checkpoint_dir()).save(engine.state, 0, metrics={"val_loss": 1.0})
    return str(run.path)


@pytest.fixture(scope="module")
def trained_run(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("runs")
    return out_dir, cli_train.main(TINY + CPU + [f"out_dir={out_dir}"])


# ------------------------------------------------------------- train


def test_train_cli_end_to_end(trained_run):
    """The artifacts and keys of the JAX CLI's run (``test_cli.py``)."""
    out_dir, result = trained_run
    run_dir = pathlib.Path(result["run_dir"])
    assert result["steps"] == 4
    assert np.isfinite(result["best_val_loss"])
    assert set(result) == {"best_val_loss", "steps", "run_dir"} | TEST_KEYS
    assert all(np.isfinite(result[k]) for k in TEST_KEYS)
    assert (run_dir / "experiment_config.yaml").exists()
    assert (run_dir / "metrics.jsonl").exists()
    # one checkpoint a validation, the two best kept
    assert sorted(int(p.name) for p in (run_dir / "checkpoints").iterdir()) == [2, 4]
    final = json.loads((run_dir / "final_test.json").read_text())
    assert final == {k: v for k, v in result.items() if k != "run_dir"}
    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    logged = set().union(*rows)
    assert {"val_loss", "val_loss_no_ema", "epoch_time_s", "loss_q1", "loss_q4"} <= logged
    assert TEST_KEYS <= logged
    assert (run_dir / "media" / "loss_per_step_epoch1.npy").exists()


def test_config_snapshot_reads_as_yaml(trained_run):
    """``yaml.safe_load`` of the snapshot gives the composed config back,
    ``2e-4``-style strings included, as the JAX package's snapshot does."""
    import yaml

    _, result = trained_run
    text = (pathlib.Path(result["run_dir"]) / "experiment_config.yaml").read_text()
    cfg = yaml.safe_load(text)
    want = load_config("default", TINY + CPU + [f"out_dir={cfg['out_dir']}"])
    assert cfg == want
    assert cfg["device"] == "cpu" and cfg["engine"]["optimizer_config"]["lr"] == "1e-4"


def test_limit_test_batches_honored(tmp_path, monkeypatch):
    """The final NLL loop runs ``limit_test_batches`` val batches."""
    calls = []
    orig = DiffusionEngine.test_step

    def counting(self, x, **kw):
        calls.append(kw["seed"])
        return orig(self, x, **kw)

    monkeypatch.setattr(DiffusionEngine, "test_step", counting)
    cli_train.main(TINY + CPU + [f"out_dir={tmp_path}", "trainer.max_epochs=1",
                                 "trainer.limit_test_batches=2", "run_name=limit_test"])
    assert calls == [0, 1]  # batch i with seed i, as in JAX


def test_class_conditional_cli_smoke(tmp_path):
    """Labels flow from the loader through ``Trainer.fit`` into a
    class-conditional UNet."""
    result = cli_train.main(TINY + CPU + [f"out_dir={tmp_path}", "model.num_classes=10",
                                          "trainer.max_epochs=1", "run_name=cond_smoke"])
    assert np.isfinite(result["best_val_loss"]) and np.isfinite(result["test_nll"])


def test_cont_run_resumes_the_step_count(trained_run):
    out_dir, result = trained_run
    resumed = cli_train.main(TINY + CPU + [f"out_dir={out_dir}", "cont_run=cli_e2e",
                                           "run_name=cli_e2e_resumed",
                                           "trainer.limit_test_batches=0"])
    assert resumed["steps"] == 8
    ckpts = pathlib.Path(resumed["run_dir"]) / "checkpoints"
    assert sorted(int(p.name) for p in ckpts.iterdir()) == [6, 8]
    assert not TEST_KEYS & set(resumed)


def test_auto_resume_continues_its_own_run(tmp_path):
    args = TINY + CPU + [f"out_dir={tmp_path}", "trainer.max_epochs=1",
                         "trainer.limit_test_batches=0", "run_name=auto", "auto_resume=true"]
    assert cli_train.main(args)["steps"] == 2
    assert cli_train.main(args)["steps"] == 4


# ------------------------------------------------------------- sample, eval


def test_sample_cli_writes_the_ancestral_grid(trained_run):
    _, result = trained_run
    out = cli_sample.main([f"run_dir={result['run_dir']}", "regular_viz=false",
                           "num_sample_steps=5", "n_random=3"] + CPU)
    path = pathlib.Path(out["path"])
    assert path == pathlib.Path(result["run_dir"]) / "media" / "fast_ancestral_5.png"
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    # 3 grey 8x8 images, 2 pixels apart
    assert int.from_bytes(data[16:20], "big") == 3 * 8 + 2 * 2
    assert int.from_bytes(data[20:24], "big") == 8
    images = out["images"]
    assert images.shape == (3, 8, 8, 1) and images.dtype == np.float32
    assert np.isfinite(images).all() and np.abs(images).max() <= 1.0


def test_png_matches_its_pixels(tmp_path):
    """The grid PNG decodes back to its 8-bit pixels (zlib, no image library)."""
    import zlib

    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, size=(2, 3, 4, 3)).astype(np.float32)
    cli_sample.write_png(tmp_path / "g.png", images, pad=1)
    data = (tmp_path / "g.png").read_bytes()
    length = int.from_bytes(data[33:37], "big")
    assert data[37:41] == b"IDAT"
    raw = zlib.decompress(data[41:41 + length])
    width = 2 * 4 + 1
    rows = np.frombuffer(raw, np.uint8).reshape(3, 1 + width * 3)
    assert (rows[:, 0] == 0).all()
    pixels = rows[:, 1:].reshape(3, width, 3)
    np.testing.assert_array_equal(pixels[:, :4], np.round(images[0] * 255).astype(np.uint8))
    np.testing.assert_array_equal(pixels[:, 5:], np.round(images[1] * 255).astype(np.uint8))
    assert (pixels[:, 4] == 255).all()


def test_eval_cli_equals_the_final_test(trained_run):
    """Same best checkpoint, same val batch, same seed: the eval CLI reads
    the train CLI's final test bit for bit."""
    _, result = trained_run
    metrics = cli_eval.run_eval(load_config("eval", [
        f"run_dir={result['run_dir']}", "use_train_data=false",
        "trainer.limit_test_batches=1"] + CPU))
    assert set(metrics) == TEST_KEYS
    for k in TEST_KEYS:
        assert metrics[k] == result[k], k


def test_load_engine_from_run_picks_the_best(trained_run):
    _, result = trained_run
    engine, cfg = cli_sample.load_engine_from_run(result["run_dir"], device="cpu")
    latest, _ = cli_sample.load_engine_from_run(result["run_dir"], use_best=False, device="cpu")
    metrics = {int(p.parent.name): json.loads(p.read_text())["val_loss"]
               for p in (pathlib.Path(result["run_dir"]) / "checkpoints").glob("*/metrics.json")}
    assert engine.state.step == min(metrics, key=metrics.get)
    assert latest.state.step == 4
    assert cfg["device"] == "cpu" and cfg["trainer"]["devices"] == 1


# ------------------------------------------------------------- engine endpoints

_UNET = dict(name="unet", in_channels=3, model_channels=32, num_res_blocks=1,
             attention_resolutions=[4], channel_mult=[1, 2], num_heads=1)


def _engine(ema=0.9, **kw):
    return DiffusionEngine(_UNET, {"lr": "2e-4"}, diffusion_steps=12, mode="cosine",
                           resolution=8, ema=ema, device="cpu", seed=1, **kw)


@pytest.mark.parametrize("steps", [None, 4, "ddim4", "trailing3", "karras3", "2,3", [2, 3]],
                         ids=["full", "int", "ddim", "trailing", "karras", "sections",
                              "section_list"])
def test_generate_images_is_the_ancestral_chain(steps):
    """Each chunk draws its x_T from the seeded generator and then its steps'
    noise from the same one, on the EMA weights, respaced as asked."""
    from probabilisticdeepdiffusionmodels_torch.sample import p_sample_loop

    engine = _engine(clip_while_generating=True)
    images = engine.generate_images(n=3, minibatch=2, seed=4, num_sample_steps=steps)
    assert isinstance(images, np.ndarray) and images.shape == (3, 8, 8, 3)
    tables, tmap, n_steps = engine._sample_tables(steps)
    assert n_steps == (12 if steps is None else tables.diffusion_steps)
    gen = torch.Generator().manual_seed(4)
    chunks = []
    for _ in range(2):
        x_T = torch.randn((2, 8, 8, 3), generator=gen)
        chunks.append(p_sample_loop(engine.state.ema_model, tables, x_T, gen, clip=True,
                                    timestep_map=tmap))
    np.testing.assert_array_equal(images, torch.cat(chunks)[:3].numpy())
    assert np.abs(images).max() <= 1.0


def test_generate_images_takes_x_T_and_refuses_unported():
    engine = _engine()
    x_T = np.random.default_rng(0).normal(size=(3, 8, 8, 3)).astype(np.float32)
    a = engine.generate_images(n=3, minibatch=2, x_T=x_T, num_sample_steps=3, use_ema=False)
    b = engine.generate_images(n=2, minibatch=2, x_T=x_T[:2], num_sample_steps=3,
                               use_ema=False)
    np.testing.assert_array_equal(a[:2], b)
    # DDIM runs; the native EDM sampler needs an EDM engine; spatial
    # sharding without a mesh runs the whole image, as JAX's does
    ddim = engine.generate_images(n=1, minibatch=1, num_sample_steps=3, ddim=True)
    assert ddim.shape == (1, 8, 8, 3) and np.isfinite(ddim).all()
    with pytest.raises(ValueError, match='prediction_type="edm"'):
        engine.generate_images(n=1, edm=True)
    np.testing.assert_array_equal(
        engine.generate_images(n=1, minibatch=1, num_sample_steps=3, ddim=True,
                               shard_mode="spatial"), ddim)
    with pytest.raises(TypeError, match="unexpected"):
        engine.generate_images(n=1, bogus=1)
    # the values that leave an option off pass
    assert engine.generate_images(n=1, minibatch=1, num_sample_steps=2, ddim=False,
                                  guidance_scale=None).shape == (1, 8, 8, 3)


def test_validation_step_shares_t_and_noise():
    """``val_loss`` (EMA) and ``val_loss_no_ema`` on one draw of t and noise;
    without an EMA, ``val_loss`` alone, from the live weights."""
    from probabilisticdeepdiffusionmodels_torch.train import sample_uniform

    x = np.random.default_rng(1).uniform(-1, 1, size=(4, 8, 8, 3)).astype(np.float32)
    engine = _engine()
    engine.training_step(x)
    out = engine.validation_step(x, torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    t, _ = sample_uniform(gen, 4, 12)
    noise = torch.randn(x.shape, generator=gen)
    for key, model in (("val_loss", engine.state.ema_model),
                       ("val_loss_no_ema", engine.state.model)):
        want = engine._eval_step(model, gen, torch.from_numpy(x), None, t=t, noise=noise)
        assert torch.equal(out[key], want), key
    assert not torch.equal(out["val_loss"], out["val_loss_no_ema"])
    plain = _engine(ema=None)
    assert set(plain.validation_step(x, torch.Generator().manual_seed(5))) == {"val_loss"}
    # without a generator: one seeded from a call counter, 0, 1, ...
    first = plain.validation_step(x)["val_loss"]
    assert torch.equal(first, plain.validation_step(x, torch.Generator().manual_seed(0))[
        "val_loss"])


def test_get_noised_representation():
    from probabilisticdeepdiffusionmodels_torch.core import q_sample

    engine = _engine()
    x0 = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, size=(2, 8, 8, 3))
                          .astype(np.float32))
    noise = torch.randn(x0.shape, generator=torch.Generator().manual_seed(7))
    want = q_sample(engine.tables, x0, noise, torch.full((2,), 5))
    assert torch.equal(engine.get_noised_representation(x0, t=5, seed=7), want)
    x_T = engine.get_noised_representation(x0)
    assert x_T.abs().mean() > 0.5  # t = T: almost all noise


def test_prefetch_and_weight_histograms(tmp_path):
    """``prefetch_to_device`` yields the loader's batches in order as
    tensors; ``watch_every_steps`` writes one npz of 64-bin histograms a
    top-level module and logs each module's std and largest weight."""
    from probabilisticdeepdiffusionmodels_torch.logging import MetricLogger, RunDir
    from probabilisticdeepdiffusionmodels_torch.train.loop import prefetch_to_device

    rng = np.random.default_rng(3)
    batches = [(rng.uniform(-1, 1, size=(2, 8, 8, 3)).astype(np.float32), None)
               for _ in range(3)]
    got = list(prefetch_to_device(batches, "cpu", size=2))
    assert len(got) == 3 and all(y is None for _, y in got)
    for (x, _), (xr, _) in zip(got, batches):
        assert isinstance(x, torch.Tensor) and np.array_equal(x.numpy(), xr)

    engine = _engine()
    run_dir = RunDir(str(tmp_path), "watch")
    logger = MetricLogger(run_dir)
    trainer = Trainer(engine, run_dir, logger=logger, max_epochs=1, check_val_every_n_epoch=1,
                      watch_every_steps=3, log_every_steps=1)
    result = trainer.fit(batches, batches[:1])
    logger.close()
    assert result["steps"] == 3
    hist = np.load(run_dir.media_path("weights_hist_step3.npz"))
    top = {name.split(".")[0] for name, _ in engine.state.model.named_parameters()}
    assert set(hist.files) == {f"{m}/{k}" for m in top for k in ("counts", "edges")}
    assert all(hist[f"{m}/counts"].shape == (64,) for m in top)
    rows = [json.loads(line) for line in (run_dir.path / "metrics.jsonl").read_text()
            .splitlines()]
    assert [r["step"] for r in rows if "loss" in r] == [1, 2, 3]
    assert any(f"weights/{next(iter(top))}/std" in r for r in rows)


def test_limit_val_batches_stops_validation(tmp_path):
    """``Trainer(limit_val_batches=1)`` consumes one batch of a 3-batch
    validation loader, and ``val_loss`` is that batch's loss with t and
    noise from a generator seeded with the step, as JAX's ``_validate``."""
    from probabilisticdeepdiffusionmodels_torch.logging import MetricLogger, RunDir

    rng = np.random.default_rng(4)
    val = [(rng.uniform(-1, 1, size=(2, 8, 8, 3)).astype(np.float32), None) for _ in range(3)]
    consumed = []

    def loader():
        for batch in val:
            consumed.append(batch)
            yield batch

    engine = _engine()
    run_dir = RunDir(str(tmp_path), "limit_val")
    trainer = Trainer(engine, run_dir, logger=MetricLogger(run_dir), max_epochs=1,
                      check_val_every_n_epoch=1, limit_val_batches=1)
    out = trainer._validate(loader(), step=7)
    assert len(consumed) == 1
    want = engine.validation_step(val[0][0], torch.Generator().manual_seed(7))
    assert out["val_loss"] == float(want["val_loss"])
    assert out["val_loss_no_ema"] == float(want["val_loss_no_ema"])
    consumed.clear()
    Trainer(engine, run_dir, logger=MetricLogger(run_dir))._validate(loader(), step=7)
    assert len(consumed) == 3


def test_trainer_runs_the_callback_every_n_epochs(tmp_path):
    """The callback runs after every ``vis_run_every``-th epoch and once more
    at the end of training (epoch -1), as JAX's ``Trainer.fit``."""
    from probabilisticdeepdiffusionmodels_torch.logging import MetricLogger, RunDir

    x = np.random.default_rng(5).uniform(-1, 1, size=(2, 8, 8, 3)).astype(np.float32)
    seen = []
    run_dir = RunDir(str(tmp_path), "vis_cadence")
    trainer = Trainer(_engine(), run_dir, logger=MetricLogger(run_dir), max_epochs=4,
                      check_val_every_n_epoch=4,
                      visualization_callback=lambda engine, epoch: seen.append(epoch),
                      vis_run_every=2)
    trainer.fit([(x, None)], [(x, None)])
    assert seen == [1, 3, -1]


# ------------------------------------------------------------- refusals


def test_entry_points_need_a_card_unless_asked(tmp_path, monkeypatch, trained_run):
    """Without ``device=cpu`` each entry point resolves to ``cuda`` and
    raises where there is no card, before it writes anything."""
    _, result = trained_run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_train.main(TINY + [f"out_dir={tmp_path}"])
    assert not any(tmp_path.iterdir())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_sample.main([f"run_dir={result['run_dir']}", "regular_viz=false",
                         "num_sample_steps=5"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_eval.main([f"run_dir={result['run_dir']}"])


@pytest.mark.parametrize("argv,match", [
    (["engine.prediction_type=edm"], None),
    (["trainer.devices=2x1"], None),
    (["trainer.fused_steps=2"], None),
    (["data.device_resident=true"], None),
    (["model.name=superres", "data.superres_factor=2"], None),
    (["engine.prediction_type=consistency"], None),
    (["engine.prediction_type=flow"], None),
    (["engine.encoder_reuse=2"], None),
], ids=["edm", "devices", "fused_steps", "device_resident", "superres", "consistency", "flow",
        "encoder_reuse"])
def test_train_cli_refuses_what_is_not_ported(argv, match, tmp_path):
    """Nothing here is refused any more: a data x model mesh (item 21,
    ported: two spawned ranks), the EDM, consistency and flow objectives,
    the engine's encoder reuse, fused steps, the device-resident loader and
    super-resolution (item 16, ported) run at the tiny size (match None): a
    consistency run records its CT loss where the others record the NLL
    test."""
    args = TINY + CPU + [f"out_dir={tmp_path}", "trainer.max_epochs=1"] + argv
    if match is not None:
        with pytest.raises(NotImplementedError, match=match):
            cli_train.main(args)
        return
    result = cli_train.main(args)
    assert result["steps"] == 2 and np.isfinite(result["best_val_loss"])
    keys = {"test_ct_loss"} if "consistency" in argv[0] else TEST_KEYS
    assert keys <= set(result) and all(np.isfinite(result[k]) for k in keys)


@pytest.fixture(scope="module")
def edm_run(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("edm_runs")
    return cli_train.main(TINY + CPU + [f"out_dir={out_dir}", "trainer.max_epochs=1",
                                        "engine.prediction_type=edm", "run_name=edm"])


@pytest.mark.parametrize("argv,match", [
    (["regular_viz=false", "sampler=heun", "num_sample_steps=4"], None),
    (["regular_viz=false", "devices=2x1", "num_sample_steps=4"], None),
    (["regular_viz=false", "inpaint=true", "n_images=2"], None),
    (["regular_viz=false", "sampler=ddim", "num_sample_steps=4"], None),
    (["regular_viz=false", "sampler=edm", "num_sample_steps=3"], None),
    (["regular_viz=false", "guidance_scale=2.0"], "class-conditional"),
], ids=["heun", "devices", "inpaint", "ddim", "edm", "guidance"])
def test_sample_cli_refuses_what_is_not_ported(argv, match, trained_run, request):
    """``devices=DxM`` (item 21, ported: the grid batch-sharded over two
    spawned ranks), the Heun and DDIM grids, the inpainting panel and the
    native EDM grid (on an EDM run) run and write their PNG; guidance on the
    unconditional run raises JAX's error."""
    run_dir = (request.getfixturevalue("edm_run") if "sampler=edm" in argv
               else trained_run[1])["run_dir"]
    args = [f"run_dir={run_dir}"] + argv + CPU
    if match == "item 21":
        with pytest.raises(NotImplementedError, match=match):
            cli_sample.main(args)
        return
    if match is not None:
        with pytest.raises(ValueError, match=match):
            cli_sample.main(args)
        return
    out = cli_sample.main(args)
    paths = out["viz"] + ([out["path"]] if "path" in out else [])
    assert len(paths) == 1 and pathlib.Path(paths[0]).read_bytes()[:4] == b"\x89PNG"
    if "images" in out:
        assert out["images"].shape == (4, 8, 8, 1) and np.isfinite(out["images"]).all()


def test_eval_and_fused_trainer_refuse(trained_run, tmp_path):
    """``ode_nll=true`` on an eps run raises JAX's error (the ODE likelihood
    is the flow and EDM families', tests/test_torch_ode_nll.py); a Trainer
    with fused steps no longer refuses (item 17 is ported:
    tests/test_torch_fused.py)."""
    _, result = trained_run
    with pytest.raises(ValueError, match='prediction_type="flow" or "edm"'):
        cli_eval.main([f"run_dir={result['run_dir']}", "ode_nll=true"] + CPU)
    trainer = Trainer(None, RunDir(str(tmp_path), "fused"), logger=object(), fused_steps=4)
    assert trainer.fused_steps == 4


# ------------------------------------------------------------- imports

# what the port may not import: JAX and its libraries, the JAX package, and
# matplotlib, which the card's Python lacks
BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "probabilisticdeepdiffusionmodels_tpu",
          "matplotlib"}
SOURCES = sorted(str(p.relative_to(REPO)) for p in PKG.rglob("*.py")) + ["chip_smoke.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(node.args[0].value.split(".")[0])
    return roots


@pytest.mark.parametrize("source", SOURCES)
def test_port_imports_no_jax(source):
    """Every import statement of the module, those inside functions too."""
    assert not _imported_roots(REPO / source) & BANNED


def test_every_module_imports_with_jax_blocked():
    """Each module of the package imports in a process where the banned
    packages cannot be imported; the visualization suite among them."""
    modules = sorted(".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
                     for p in PKG.rglob("*.py"))
    viz = {f"probabilisticdeepdiffusionmodels_torch.viz{m}" for m in ("", ".hooks", ".image")}
    assert viz <= set(modules)
    assert {f"{PKG.name}/viz/{m}.py" for m in ("__init__", "hooks", "image")} <= set(SOURCES)
    code = (f"import sys\nfor name in {sorted(BANNED)!r}:\n    sys.modules[name] = None\n"
            f"import importlib\nfor m in {modules!r}:\n    importlib.import_module(m)\n"
            "print(len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(modules) >= 30
