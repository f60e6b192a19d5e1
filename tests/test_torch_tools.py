"""The port's tools on the CPU: ``utils.profiling`` (``unet_flops`` against
JAX's, ``trace``, ``step_timer``), ``cli.runs`` over a port run directory,
``logging.remote.fetch_run`` against a fake W&B client (no network), the
schedule panels of ``cli.schedules`` with matplotlib unimportable, and
``cli.profile`` on a tiny run."""

import json
import pathlib
import sys

import numpy as np
import pytest
import yaml

from probabilisticdeepdiffusionmodels_torch.cli import profile as cli_profile
from probabilisticdeepdiffusionmodels_torch.cli import runs as cli_runs
from probabilisticdeepdiffusionmodels_torch.cli import train as cli_train
from probabilisticdeepdiffusionmodels_torch.config import load_config
from probabilisticdeepdiffusionmodels_torch.logging import remote
from probabilisticdeepdiffusionmodels_torch.logging.remote import fetch_run
from probabilisticdeepdiffusionmodels_torch.logging.sink import MetricLogger, RunDir
from probabilisticdeepdiffusionmodels_torch.train.checkpoint import CheckpointManager
from probabilisticdeepdiffusionmodels_torch.utils.profiling import step_timer, trace, unet_flops
from test_cli import TINY
from test_remote_fetch import _FakeApi, _FakeFile, _FakeRun, _mirrored_run
from test_torch_threads import one_torch_thread  # noqa: E402,F401

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG_DIR = REPO / "probabilisticdeepdiffusionmodels_tpu" / "config" / "model"
CPU = ["device=cpu"]


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """A run directory as ``cli.train`` leaves one, without the cost of
    training: the config snapshot of an untrained TINY engine, checkpoints
    at steps 2 and 4 with their ``val_loss``, and the metric log."""
    out_dir = tmp_path_factory.mktemp("runs")
    cfg = load_config("default", TINY + CPU + [f"out_dir={out_dir}", "run_name=tools"])
    engine = cli_train.build_engine(cfg)
    run = RunDir(str(out_dir), "tools")
    run.save_config(cfg)
    logger, ckpt = MetricLogger(run), CheckpointManager(run.checkpoint_dir())
    for step, val in ((2, 1.25), (4, 1.0)):
        engine.state.step = step
        ckpt.save(engine.state, step, metrics={"val_loss": val})
        logger.log({"val_loss": val}, step=step)
    logger.log({"test_nll": 7.5}, step=4)
    logger.close()
    return out_dir, {"run_dir": str(run.path), "test_nll": 7.5}


# ------------------------------------------------------------- profiling


@pytest.mark.parametrize("config,resolution,extra", [
    ("unet", 32, {}), ("unet_small_grey", 28, {}), ("unet_celebahq64", 64, {}),
    ("unet", 32, {"learn_sigma": True})], ids=["unet", "unet_small_grey", "celebahq64",
                                               "learn_sigma"])
def test_unet_flops_equal_jax(config, resolution, extra):
    pytest.importorskip("flax")
    from probabilisticdeepdiffusionmodels_tpu.utils.profiling import unet_flops as jax_flops

    cfg = yaml.safe_load((CONFIG_DIR / f"{config}.yaml").read_text())
    args = (resolution, cfg["in_channels"], cfg["model_channels"], cfg["num_res_blocks"],
            cfg["attention_resolutions"], cfg["channel_mult"], cfg["num_heads"])
    got = unet_flops(*args, **extra)
    assert got == jax_flops(*args, **extra) and got > 0


def test_trace_and_step_timer(tmp_path):
    import torch

    with step_timer() as timer, trace(str(tmp_path / "t")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert timer.seconds > 0 and prof is not None
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


# ------------------------------------------------------------- runs


def test_runs_list_and_show(tiny_run, capsys):
    out_dir, result = tiny_run
    run = pathlib.Path(result["run_dir"]).name
    (pathlib.Path(out_dir) / "not_a_run").mkdir()
    assert cli_runs.list_runs(str(out_dir)) == [run]
    steps = cli_runs.list_checkpoints(run, str(out_dir))
    assert steps == [2, 4] and cli_runs.latest_checkpoint(run, str(out_dir)) == 4
    assert cli_runs.list_runs(str(out_dir / "missing")) == []
    assert cli_runs.latest_checkpoint("missing", str(out_dir)) is None
    capsys.readouterr()
    assert cli_runs.main(["list", str(out_dir)]) == 0
    line = capsys.readouterr().out.strip()
    last_val = cli_runs.last_metrics(run, str(out_dir))["val_loss"]
    assert line.startswith(run) and line.endswith(f"ckpts=[2, 4] val_loss={last_val}")
    assert cli_runs.main(["show", run, str(out_dir)]) == 0
    shown = json.loads(capsys.readouterr().out)
    assert shown["test_nll"] == pytest.approx(result["test_nll"])
    assert cli_runs.main(["nonsense"]) == 1


def test_runs_skip_an_incomplete_checkpoint(tmp_path):
    """A step directory without its ``state.pt`` (a save cut short) is not
    a checkpoint."""
    ckpts = tmp_path / "r" / "checkpoints"
    (ckpts / "3").mkdir(parents=True)
    (ckpts / "3" / "state.pt").write_bytes(b"")
    (ckpts / "7").mkdir()
    (ckpts / "9.tmp").mkdir()
    assert cli_runs.list_checkpoints("r", str(tmp_path)) == [3]


# ------------------------------------------------------------- remote


def test_fetch_run_restores_files_and_newest_checkpoint(tmp_path):
    api = _FakeApi(_mirrored_run())
    dest = fetch_run("me/proj/abc123", str(tmp_path), _api=api, log=lambda *_: None)
    assert api.requested == "me/proj/abc123" and dest == tmp_path / "abc123"
    assert (dest / "experiment_config.yaml").read_text().startswith("engine:")
    assert (dest / "media" / "samples_epoch0.png").exists()
    assert not (dest / "wandb-metadata.json").exists() and not (dest / "config.yaml").exists()
    assert (dest / "checkpoints" / "best.ckpt").read_text() == "v2"
    assert not (dest / "checkpoints" / "old.ckpt").exists()


def test_fetch_run_warns_and_names(tmp_path):
    msgs = []
    run = _FakeRun([_FakeFile("metrics.jsonl", "{}\n")], [])
    fetch_run("e/p/r1", str(tmp_path), _api=_FakeApi(run), log=msgs.append)
    assert any("no checkpoint artifact" in m for m in msgs)
    assert any("experiment_config.yaml" in m for m in msgs)
    dest = fetch_run("e/p/r2", str(tmp_path), name="restored", _api=_FakeApi(_FakeRun([], [])),
                     log=lambda *_: None)
    assert dest == tmp_path / "restored"


def test_fetch_run_without_wandb_raises(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)
    with pytest.raises(RuntimeError, match="wandb"):
        fetch_run("e/p/r3", str(tmp_path))


def test_runs_pull_cli(tmp_path, monkeypatch, capsys):
    called = {}

    def fake_fetch(spec, root="./runs"):
        called["spec"], called["root"] = spec, root
        return pathlib.Path(root) / "abc"

    monkeypatch.setattr(remote, "fetch_run", fake_fetch)
    assert cli_runs.main(["pull", "e/p/abc", str(tmp_path)]) == 0
    assert called == {"spec": "e/p/abc", "root": str(tmp_path)}
    assert "pulled" in capsys.readouterr().out


def test_pulled_run_loads(tiny_run, tmp_path):
    """A run pulled from a mirror of a port run (its config, metrics and
    checkpoint directory) is a run directory the CLIs read."""
    from probabilisticdeepdiffusionmodels_torch.cli.sample import load_engine_from_run

    _, result = tiny_run
    src = pathlib.Path(result["run_dir"])

    class _DirArtifact:
        type = "checkpoint"

        def download(self, root):
            import shutil
            shutil.copytree(src / "checkpoints", root, dirs_exist_ok=True)

    files = [_FakeFile(n, (src / n).read_text()) for n in ("experiment_config.yaml",
                                                            "metrics.jsonl")]
    dest = fetch_run("e/p/mirror", str(tmp_path), _api=_FakeApi(_FakeRun(files, [_DirArtifact()])),
                     log=lambda *_: None)
    assert cli_runs.list_checkpoints("mirror", str(tmp_path)) == [2, 4]
    engine, _ = load_engine_from_run(dest, device="cpu")
    assert engine.state.step == 4  # the best val_loss


# ------------------------------------------------------------- schedules


def test_schedules_cli_writes_a_png_without_matplotlib(tmp_path, monkeypatch, capsys):
    """With matplotlib unimportable: the PNG decodes to three panels with
    the three schedules' colours, and the NLL table prints."""
    from PIL import Image

    from probabilisticdeepdiffusionmodels_torch.cli import schedules

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    out = tmp_path / "schedules.png"
    assert schedules.main(["--steps", "200", "--out", str(out)]) == 0
    printed = capsys.readouterr().out
    assert "cifar10  cosine" in printed and "T=4000: 3.496" in printed
    img = np.asarray(Image.open(out).convert("RGB"))
    assert img.shape[0] == schedules.PANEL_H + 6 and img.shape[1] >= 3 * schedules.PANEL_W
    pixels = img.reshape(-1, img.shape[-1]).astype(int)
    for color in schedules.MODES.values():
        assert (np.abs(pixels - np.round(np.array(color) * 255)).sum(1) == 0).any(), color


def test_schedules_panels_follow_the_curves():
    """alpha-bar falls from the top-left to the bottom-right of its panel."""
    from probabilisticdeepdiffusionmodels_torch.cli.schedules import MODES, PANEL_W, panels
    from probabilisticdeepdiffusionmodels_torch.viz.image import tile_origin

    view = panels(100)
    y, x = tile_origin(0, 1, view.shape[0] - 6, PANEL_W)
    tile = view[y:y + view.shape[0] - 6, x:x + PANEL_W]
    blue = np.argwhere((tile == np.array(MODES["mixed"], np.float32)).all(-1))
    first, last = blue[blue[:, 1].argmin()], blue[blue[:, 1].argmax()]
    assert first[0] < 5 and last[0] > tile.shape[0] - 8


# ------------------------------------------------------------- profile


def test_profile_cli_on_a_tiny_run(tiny_run):
    _, result = tiny_run
    timings = cli_profile.main([f"run_dir={result['run_dir']}", "steps=1", "sample_steps=2",
                                "batch_size=2"] + CPU)
    prof = pathlib.Path(result["run_dir"]) / "profile"
    assert json.loads((prof / "timings.json").read_text()) == timings
    assert set(timings) == {"batch_size", "fwd_gflops", "train_step_ms", "train_img_per_sec",
                            "sample_chain_s", "sample_img_per_sec"}
    assert all(v > 0 for v in timings.values())
    for name in ("train_trace", "sample_trace"):
        events = json.loads((prof / name / "trace.json").read_text())["traceEvents"]
        assert len(events) > 10
    with pytest.raises(ValueError, match="run_dir"):
        cli_profile.main(CPU)
