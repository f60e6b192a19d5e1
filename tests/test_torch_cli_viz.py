"""The port's command-line entry points with the reference's defaults, on
the CPU and ``test_cli.py``'s tiny config: ``cli.train`` with the default
visualization (``more``) writes the four views, ``cli.sample`` with its
default ``regular_viz`` and with ``detailed_viz=true`` writes its views and
panels, an ``engine=cifar10_iddpm`` run (learned sigma, hybrid loss) trains,
saves, resumes and evaluates, and the mixed schedule, v / x0, min-SNR and
zero-terminal-SNR engines train."""

import json
import pathlib

import numpy as np
import pytest

from probabilisticdeepdiffusionmodels_torch.cli import eval as cli_eval
from probabilisticdeepdiffusionmodels_torch.cli import sample as cli_sample
from probabilisticdeepdiffusionmodels_torch.cli import train as cli_train
from probabilisticdeepdiffusionmodels_torch.config import load_config
from test_cli import TINY
from test_torch_threads import one_torch_thread  # noqa: E402,F401

CPU = ["device=cpu"]
# TINY with the composed default visualization (more) and one epoch
DEFAULT_VIZ = [a for a in TINY if not a.startswith(("visualization=", "run_name="))] + CPU + [
    "trainer.max_epochs=1"]
VIEWS = ["random_grid", "interpolation_t6", "reconstructions", "single_recon_std"]
TEST_KEYS = {"test_L_0", "test_L_intermediate", "test_L_T", "test_nll", "test_mse"}


def _png_size(path):
    data = pathlib.Path(path).read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    return int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24], "big")


@pytest.fixture(scope="module")
def viz_run(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("viz_runs")
    return cli_train.main(DEFAULT_VIZ + [f"out_dir={out_dir}", "run_name=viz",
                                         "trainer.limit_test_batches=0"])


def test_train_cli_writes_the_views(viz_run):
    """The callback's train-end pass (``final``) on the first validation
    batch, at T=12's five timesteps; one epoch under ``run_every: 5`` runs
    no epoch pass."""
    media = pathlib.Path(viz_run["run_dir"]) / "media"
    assert sorted(p.name for p in media.glob("*.png")) == sorted(f"{v}_final.png" for v in VIEWS)
    # rows of 4 samples; x_T and the 5 timesteps 1, 3, 6, 8, 11; 8x8 tiles
    # 16 pixels apart (a 3-pixel frame each side, 2 between frames)
    assert _png_size(media / "random_grid_final.png") == (6 * 16 - 2, 4 * 16 - 2)
    cfg = load_config("default", DEFAULT_VIZ)
    assert cfg["visualization"]["run_every"] == 5


def test_sample_cli_writes_the_views_and_panels(viz_run):
    """The default ``regular_viz`` and ``detailed_viz=true``: the four views
    and four panels (t0 of 12, 10, 9, 6), no grid without
    ``num_sample_steps``."""
    out = cli_sample.main([f"run_dir={viz_run['run_dir']}", "detailed_viz=true",
                           "n_images=2"] + CPU)
    names = [pathlib.Path(p).name for p in out["viz"]]
    assert names == [f"{v}_final.png" for v in VIEWS] + [
        f"detailed_t0_{t}.png" for t in (12, 10, 9, 6)]
    assert "path" not in out
    for path in out["viz"]:
        w, h = _png_size(path)
        assert w > 8 and h > 8
    # two images a panel: x0 and four chains
    assert _png_size(out["viz"][-1]) == (5 * 16 - 2, 2 * 16 - 2)


def test_iddpm_run_trains_resumes_and_evaluates(tmp_path):
    """``engine=cifar10_iddpm`` (cosine, learned sigma, hybrid loss) on the
    tiny model: a 2C-channel head, a checkpoint, a resume that continues the
    step count, and ``cli.eval`` equal to the run's final test."""
    args = [a for a in TINY if not a.startswith(("engine=", "engine.mode", "run_name="))] + [
        "engine=cifar10_iddpm", f"out_dir={tmp_path}", "trainer.max_epochs=1"] + CPU
    first = cli_train.main(args + ["run_name=iddpm"])
    assert first["steps"] == 2 and all(np.isfinite(first[k]) for k in TEST_KEYS)
    run_dir = pathlib.Path(first["run_dir"])
    engine, cfg = cli_sample.load_engine_from_run(run_dir, device="cpu")
    assert cfg["engine"]["loss_type"] == "hybrid"
    assert engine.model.out_conv.weight.shape[2] == 2  # learn_sigma: 2C for C = 1
    resumed = cli_train.main(args + ["run_name=iddpm_resumed", "cont_run=iddpm",
                                     "trainer.limit_test_batches=0"])
    assert resumed["steps"] == 4
    metrics = cli_eval.run_eval(load_config("eval", [
        f"run_dir={run_dir}", "use_train_data=false", "trainer.limit_test_batches=1"] + CPU))
    final = json.loads((run_dir / "final_test.json").read_text())
    for k in TEST_KEYS:
        assert metrics[k] == final[k], k


@pytest.mark.parametrize("argv", [
    # T=12 would take the linear ramp's 1000/T-scaled betas past 1
    ["engine.mode=mixed", "engine.diffusion_steps=100"],
    ["engine.prediction_type=v", "engine.loss_weighting=min_snr",
     "engine.zero_terminal_snr=true", "engine.mode=linear", "engine.beta_start=1e-4",
     "engine.beta_end=0.2"],
    ["engine.prediction_type=x0"],
], ids=["mixed", "v_min_snr_ztsnr", "x0"])
def test_objective_and_schedule_options_train(argv, tmp_path):
    """Each option trains a tiny run to a finite validation loss."""
    result = cli_train.main(TINY + CPU + [f"out_dir={tmp_path}", "trainer.max_epochs=1",
                                          "trainer.limit_test_batches=0"] + argv)
    assert result["steps"] == 2 and np.isfinite(result["best_val_loss"])
