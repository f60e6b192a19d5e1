"""Sampling entry point.

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/cli/sample.py``
for its ancestral grid: load a trained run directory (its config snapshot
and best checkpoint), override ``clip_while_generating``, and with
``num_sample_steps`` set draw ``n_random`` images with the ancestral sampler
respaced to that many steps into ``media/fast_ancestral_<steps>.png``:

    python -m probabilisticdeepdiffusionmodels_torch.cli.sample \\
        run_dir=runs/run-xyz regular_viz=false num_sample_steps=250

``device`` (null: cuda) places the engine.  Not ported yet, and raising:
``regular_viz`` (true in ``sample.yaml``: pass ``regular_viz=false``) and
``detailed_viz`` (ROADMAP.md Queue 1 item 15), ``inpaint``, the other
samplers and guidance (item 10; ``sampler=edm|flow|consistency``: item 12),
and ``devices`` (item 18).
"""

from __future__ import annotations

import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import yaml

from ..config import load_config
from ..data.transforms import unnormalize
from ..train.checkpoint import CheckpointManager
from .train import build_engine, check_devices

__all__ = ["run_sampling", "main", "load_engine_from_run", "write_png"]


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


def write_png(path, images: np.ndarray, pad: int = 2) -> None:
    """Write [N, H, W, C] images in [0, 1] side by side, ``pad`` white
    pixels apart, as one 8-bit grey (C = 1) or RGB PNG."""
    n, h, w, c = images.shape
    grid = np.ones((h, n * w + (n - 1) * pad, c), np.float32)
    for i, img in enumerate(images):
        grid[:, i * (w + pad):i * (w + pad) + w] = img
    pixels = np.round(np.clip(grid, 0.0, 1.0) * 255.0).astype(np.uint8)
    rows = b"".join(b"\x00" + row.tobytes() for row in pixels)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", grid.shape[1], h, 8, 0 if c == 1 else 2, 0, 0, 0)
    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                           + chunk(b"IDAT", zlib.compress(rows, 9)) + chunk(b"IEND", b""))


def _refuse(cfg) -> None:
    """Raise for every option the port does not run yet."""
    later = "is not ported yet (ROADMAP.md Queue 1 item"
    for key, item, hint in (("regular_viz", 15, ": pass regular_viz=false"),
                            ("detailed_viz", 15, ""), ("inpaint", 10, "")):
        if cfg.get(key, key == "regular_viz"):
            raise NotImplementedError(f"{key}=true {later} {item}){hint}")
    sampler = cfg.get("sampler") or "ancestral"
    if sampler != "ancestral":
        item = 12 if sampler in ("edm", "flow", "consistency") else 10
        raise NotImplementedError(f"sampler={sampler} {later} {item})")
    for key in ("guidance_scale", "guidance_interval", "guidance_rescale"):
        if cfg.get(key) is not None:
            raise NotImplementedError(f"{key} {later} 10)")


def run_sampling(cfg) -> dict:
    """Returns the path of the grid written and its images, [-1, 1] model
    space ({} when ``num_sample_steps`` is null: nothing to draw)."""
    if not cfg.get("run_dir"):
        raise ValueError("pass run_dir=<path to a training run>")
    _refuse(cfg)
    engine, run_cfg = load_engine_from_run(cfg["run_dir"], cfg.get("clip_while_generating"),
                                           devices=cfg.get("devices"), device=cfg.get("device"))
    media_dir = Path(cfg["run_dir"]) / "media"
    media_dir.mkdir(exist_ok=True)
    normalize = (run_cfg["data"].get("transformation_kwargs") or {}).get("normalize")
    steps = cfg.get("num_sample_steps")
    if not steps:
        return {}
    n = int(cfg.get("n_random", 4))
    images = engine.generate_images(n=n, minibatch=n, seed=0,
                                    use_ema=cfg.get("use_ema", True), num_sample_steps=steps)
    path = media_dir / f"fast_ancestral_{steps}.png"
    write_png(path, unnormalize(images, normalize=normalize, clip=True))
    print(f"[sample] wrote {path}")
    return {"path": str(path), "images": images}


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    return run_sampling(load_config("sample", argv))


if __name__ == "__main__":
    main()
