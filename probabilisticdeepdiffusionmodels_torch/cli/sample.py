"""Sampling and visualization entry point.

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/cli/sample.py``:
load a trained run directory (its config snapshot and best checkpoint),
override ``clip_while_generating``, then into the run's ``media/``:

  * ``regular_viz`` (on by default): the four views of the visualization
    suite (``viz.hooks.VisualizationCallback``) at ``num_vis_steps``
    timesteps (default 10, 5 when T <= 30);
  * with ``num_sample_steps`` set, ``n_random`` images from the ancestral
    sampler respaced to that many steps, ``fast_ancestral_<steps>.png``;
  * ``detailed_viz``: for t0 in (T, 0.9T, 0.8T, 0.5T), the first val images
    reconstructed from t0 by the mean chain and the sampled chain, without
    and with x0 clipping, ``detailed_t0_<t0>.png``.

    python -m probabilisticdeepdiffusionmodels_torch.cli.sample \\
        run_dir=runs/run-xyz detailed_viz=true

``device`` (null: cuda) places the engine.  Not ported yet, and raising:
``inpaint``, the other samplers and guidance (ROADMAP.md Queue 1 item 10;
``sampler=edm|flow|consistency``: item 12), and ``devices`` (item 18).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import yaml

from ..config import load_config
from ..data.transforms import unnormalize
from ..train.checkpoint import CheckpointManager
from ..viz.hooks import VisualizationCallback, _to_img
from ..viz.image import compose, write_png
from .train import build_engine, build_loaders, check_devices

__all__ = ["run_sampling", "run_detailed_viz", "main", "load_engine_from_run", "write_png"]


def load_engine_from_run(run_path, clip_while_generating=None, use_best=True, devices=None,
                         device=None):
    """The engine of a run directory, rebuilt from its config snapshot on
    ``device`` (the caller's choice, not the training run's), with its best
    checkpoint (``use_best``) or its latest loaded; returns (engine, config)."""
    run_path = Path(run_path)
    with open(run_path / "experiment_config.yaml") as f:
        cfg = yaml.safe_load(f)
    if clip_while_generating is not None:
        cfg["engine"]["clip_while_generating"] = bool(clip_while_generating)
    check_devices(devices)
    cfg.setdefault("trainer", {})["devices"] = 1
    cfg["device"] = device
    engine = build_engine(cfg)
    ckpt = CheckpointManager(run_path / "checkpoints")
    ckpt.restore(engine.state, ckpt.best_step() if use_best else None)
    return engine, cfg


def run_detailed_viz(engine, cfg, media_dir: Path, normalize, n_images: int = 4) -> list:
    """For t0 in (T, 0.9T, 0.8T, 0.5T), one view of the first ``n_images``
    val images (column 0) and their reconstructions from t0 with the
    generator seeded t0: the mean chain, then the sampled chain, without
    x0 clipping (columns 1, 2) and with it (3, 4).  The engine's
    ``clip_while_generating`` is restored afterwards; returns the paths."""
    _, val_loader = build_loaders(cfg)
    x0 = next(iter(val_loader))[0][:n_images]
    T = engine.diffusion_steps
    orig_clip = engine.clip_while_generating
    paths = []
    try:
        for t0 in (T, int(0.9 * T), int(0.8 * T), int(0.5 * T)):
            rows = [[(_to_img(x0[i], normalize), None)] for i in range(len(x0))]
            for clip in (False, True):
                engine.clip_while_generating = clip
                for mean_only in (True, False):
                    recon, _ = engine.diffuse_and_reconstruct(x0, t0, seed=t0,
                                                              mean_only=mean_only)
                    recon = recon.float().cpu().numpy()
                    for i, row in enumerate(rows):
                        row.append((_to_img(recon[i], normalize), None))
            path = media_dir / f"detailed_t0_{t0}.png"
            write_png(path, compose(rows)[None], pad=0)
            print(f"[sample] wrote {path}")
            paths.append(path)
    finally:
        engine.clip_while_generating = orig_clip
    return paths


def _refuse(cfg) -> None:
    """Raise for every option the port does not run yet."""
    later = "is not ported yet (ROADMAP.md Queue 1 item"
    if cfg.get("inpaint"):
        raise NotImplementedError(f"inpaint=true {later} 10)")
    sampler = cfg.get("sampler") or "ancestral"
    if sampler != "ancestral":
        item = 12 if sampler in ("edm", "flow", "consistency") else 10
        raise NotImplementedError(f"sampler={sampler} {later} {item})")
    for key in ("guidance_scale", "guidance_interval", "guidance_rescale"):
        if cfg.get(key) is not None:
            raise NotImplementedError(f"{key} {later} 10)")


def run_sampling(cfg) -> dict:
    """Returns ``viz``, the paths of the views written, and where the grid
    was drawn its ``path`` and ``images`` ([-1, 1] model space)."""
    if not cfg.get("run_dir"):
        raise ValueError("pass run_dir=<path to a training run>")
    _refuse(cfg)
    engine, run_cfg = load_engine_from_run(cfg["run_dir"], cfg.get("clip_while_generating"),
                                           devices=cfg.get("devices"), device=cfg.get("device"))
    media_dir = Path(cfg["run_dir"]) / "media"
    media_dir.mkdir(exist_ok=True)
    normalize = (run_cfg["data"].get("transformation_kwargs") or {}).get("normalize")
    result = {"viz": []}

    if cfg.get("regular_viz", True):
        T = engine.diffusion_steps
        n_vis = cfg.get("num_vis_steps") or (5 if T <= 30 else 10)
        ts = sorted(set(int(t) for t in np.linspace(1, T - 1, n_vis)))
        _, val_loader = build_loaders(run_cfg)
        vis = VisualizationCallback(
            val_batch=next(iter(val_loader))[0], ts=ts, media_dir=media_dir,
            normalize=normalize, n_images=cfg.get("n_images", 4),
            n_random=cfg.get("n_random", 4),
            n_interpolation_steps=cfg.get("n_interpolation_steps", 10),
            n_interpolation_pairs=cfg.get("n_interpolation_pairs", 4),
            use_ema=cfg.get("use_ema", True))
        result["viz"] += vis(engine, -1)
        print(f"[sample] regular viz written to {media_dir}")

    steps = cfg.get("num_sample_steps")
    if steps:
        n = int(cfg.get("n_random", 4))
        images = engine.generate_images(n=n, minibatch=n, seed=0,
                                        use_ema=cfg.get("use_ema", True),
                                        num_sample_steps=steps)
        path = media_dir / f"fast_ancestral_{steps}.png"
        write_png(path, unnormalize(images, normalize=normalize, clip=True))
        print(f"[sample] wrote {path}")
        result.update(path=str(path), images=images)

    if cfg.get("detailed_viz", False):
        result["viz"] += run_detailed_viz(engine, run_cfg, media_dir, normalize,
                                          n_images=cfg.get("n_images", 4))
    return result


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    return run_sampling(load_config("sample", argv))


if __name__ == "__main__":
    main()
