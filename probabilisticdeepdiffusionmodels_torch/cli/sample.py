"""Sampling and visualization entry point.

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/cli/sample.py``:
load a trained run directory (its config snapshot and best checkpoint),
override ``clip_while_generating``, then into the run's ``media/``:

  * ``regular_viz`` (on by default): the four views of the visualization
    suite (``viz.hooks.VisualizationCallback``) at ``num_vis_steps``
    timesteps (default 10, 5 when T <= 30);
  * with ``num_sample_steps``, a ``sampler`` other than ancestral, or
    ``guidance_scale`` set: ``n_random`` images from the engine's
    ``generate_images``, ``fast_<sampler>_<steps>[_cfg<scale>].png``.
    ``sampler`` is ancestral | ddim | dpmpp (``dpm_order``) | heun
    (``heun_churn``) | edm (``edm_churn``) | flow (``flow_shift``,
    ``flow_heun``) | consistency, the last three for runs trained with the
    matching ``engine.prediction_type``.  Under guidance each image is one
    class, cycling (``guidance_interval`` "lo,hi", ``guidance_rescale``);
  * ``inpaint``: the first val images, masked (``inpaint_mask``:
    right_half | bottom_half | center_box) and filled by RePaint
    (``resample_steps``), ``inpaint_<mask>.png``: original, masked and
    inpainted rows;
  * ``detailed_viz``: for t0 in (T, 0.9T, 0.8T, 0.5T), the first val images
    reconstructed from t0 by the sampled chain, twice without and twice with
    x0 clipping (JAX's panels), ``detailed_t0_<t0>.png``.

A consistency run has no eps view: its views, inpainting and detailed
panels are skipped with a notice.

    python -m probabilisticdeepdiffusionmodels_torch.cli.sample \\
        run_dir=runs/run-xyz sampler=dpmpp num_sample_steps=20

``device`` (null: cuda) places the engine; ``devices`` (a mesh) is not
ported yet and raises (ROADMAP.md Queue 1 item 18).
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

__all__ = ["run_sampling", "run_detailed_viz", "run_inpaint_panel", "main",
           "load_engine_from_run", "write_png"]


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
    generator seeded t0: the sampled chain twice without x0 clipping
    (columns 1, 2) and twice with it (3, 4).  The JAX panels label columns
    1 and 3 "mean" but never pass ``mean_only``, so they draw the sampled
    chain there too; the port draws what JAX draws.  The engine's
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
                for _ in range(2):
                    recon, _ = engine.diffuse_and_reconstruct(x0, t0, seed=t0)
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


def _interval(spec):
    """A guidance interval from "lo,hi" (a dotted override) or a pair."""
    if spec is None:
        return None
    lo, hi = (int(v) for v in spec.split(",")) if isinstance(spec, str) else spec
    return int(lo), int(hi)


def inpaint_mask(spec: str, res: int) -> np.ndarray:
    """[res, res, 1], 1 = keep: the left half (``right_half`` fills the
    right), the top half (``bottom_half``), or all but the central square of
    half the side (``center_box``)."""
    mask = np.zeros((res, res, 1), np.float32)
    if spec == "right_half":
        mask[:, : res // 2] = 1.0
    elif spec == "bottom_half":
        mask[: res // 2] = 1.0
    elif spec == "center_box":
        q = res // 4
        mask[:] = 1.0
        mask[q: res - q, q: res - q] = 0.0
    else:
        raise ValueError(f"unknown inpaint_mask: {spec!r} (right_half | bottom_half | "
                         "center_box)")
    return mask


def run_inpaint_panel(engine, cfg, run_cfg, media_dir: Path, normalize) -> Path:
    """RePaint on the first ``n_images`` val images (guided by their labels
    under ``guidance_scale``): original, masked and inpainted rows."""
    _, val_loader = build_loaders(run_cfg)
    batch = next(iter(val_loader))
    x0 = np.asarray(batch[0][: int(cfg.get("n_images", 4))])
    kwargs = {}
    gs = cfg.get("guidance_scale")
    if gs is not None:
        if not engine.model.num_classes:
            raise ValueError("guidance_scale needs a class-conditional model")
        if len(batch) < 2 or batch[1] is None:
            raise ValueError("guidance_scale inpainting needs labeled val data")
        kwargs = dict(guidance_scale=float(gs), y=np.asarray(batch[1][: len(x0)]),
                      guidance_interval=_interval(cfg.get("guidance_interval")))
    spec = cfg.get("inpaint_mask", "right_half")
    mask = inpaint_mask(spec, x0.shape[1])
    out = engine.inpaint(x0, mask, seed=int(cfg.get("seed", 0) or 0),
                         use_ema=cfg.get("use_ema", True),
                         num_sample_steps=cfg.get("num_sample_steps"),
                         resample_steps=int(cfg.get("resample_steps", 1)), **kwargs)
    masked = x0 * mask + (-1.0) * (1 - mask)
    rows = [[(_to_img(img, normalize), None) for img in imgs]
            for imgs in (x0, masked, out.float().cpu().numpy())]
    path = media_dir / f"inpaint_{spec}.png"
    write_png(path, compose(rows)[None], pad=0)
    print(f"[sample] wrote {path}")
    return path


def run_sampling(cfg) -> dict:
    """Returns ``viz``, the paths of the views and panels written, and where
    the grid was drawn its ``path`` and ``images`` ([-1, 1] model space)."""
    if not cfg.get("run_dir"):
        raise ValueError("pass run_dir=<path to a training run>")
    if cfg.get("guidance_rescale") is not None and cfg.get("guidance_scale") is None:
        raise ValueError("guidance_rescale needs guidance_scale")
    engine, run_cfg = load_engine_from_run(cfg["run_dir"], cfg.get("clip_while_generating"),
                                           devices=cfg.get("devices"), device=cfg.get("device"))
    media_dir = Path(cfg["run_dir"]) / "media"
    media_dir.mkdir(exist_ok=True)
    normalize = (run_cfg["data"].get("transformation_kwargs") or {}).get("normalize")
    result = {"viz": []}
    # the views, inpainting and detailed panels run table-driven chains
    # through the eps view, which a consistency model has not
    no_eps_view = engine.prediction_type == "consistency"

    if cfg.get("regular_viz", True) and no_eps_view:
        print('[sample] regular viz needs the eps-view; skipped for prediction_type='
              '"consistency" (use sampler=consistency)')
    elif cfg.get("regular_viz", True):
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

    sampler = cfg.get("sampler") or "ancestral"
    steps = cfg.get("num_sample_steps")
    gs = cfg.get("guidance_scale")
    if steps or sampler != "ancestral" or gs is not None:
        n = int(cfg.get("n_random", 4))
        kwargs = {}
        if gs is not None:
            # one image a class, cycling
            nc = int(engine.model.num_classes or 0)
            if not nc:
                raise ValueError("guidance_scale needs a class-conditional model")
            kwargs = dict(guidance_scale=float(gs), y=np.arange(n) % nc,
                          guidance_interval=_interval(cfg.get("guidance_interval")))
            if cfg.get("guidance_rescale") is not None:
                kwargs["guidance_rescale"] = float(cfg["guidance_rescale"])
        images = engine.generate_images(
            n=n, minibatch=n, seed=0, use_ema=cfg.get("use_ema", True), num_sample_steps=steps,
            ddim=sampler == "ddim", dpm_solver=sampler == "dpmpp",
            dpm_order=int(cfg.get("dpm_order", 2)), heun=sampler == "heun",
            heun_churn=float(cfg.get("heun_churn", 0.0)), edm=sampler == "edm",
            edm_churn=float(cfg.get("edm_churn", 0.0)), flow=sampler == "flow",
            flow_shift=cfg.get("flow_shift"), flow_heun=bool(cfg.get("flow_heun", False)),
            consistency=sampler == "consistency", **kwargs)
        name = f"fast_{sampler}_{steps or 'full'}" + (f"_cfg{float(gs):g}" if gs is not None
                                                      else "")
        path = media_dir / f"{name}.png"
        write_png(path, unnormalize(images, normalize=normalize, clip=True))
        print(f"[sample] wrote {path}")
        result.update(path=str(path), images=images)

    if (cfg.get("inpaint", False) or cfg.get("detailed_viz", False)) and no_eps_view:
        print('[sample] inpaint/detailed_viz need the eps-view; skipped for prediction_type='
              '"consistency"')
    else:
        if cfg.get("inpaint", False):
            result["viz"].append(run_inpaint_panel(engine, cfg, run_cfg, media_dir, normalize))
        if cfg.get("detailed_viz", False):
            result["viz"] += run_detailed_viz(engine, run_cfg, media_dir, normalize,
                                              n_images=cfg.get("n_images", 4))
    return result


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    return run_sampling(load_config("sample", argv))


if __name__ == "__main__":
    main()
