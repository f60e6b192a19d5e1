"""The noise schedules' shapes as one PNG, and the reference NLL table.

PyTorch-port counterpart of ``probabilisticdeepdiffusionmodels_tpu/cli/schedules.py``:

    python -m probabilisticdeepdiffusionmodels_torch.cli.schedules \\
        --steps 1000 --out schedules.png

Three panels side by side: beta_t, alpha-bar_t and sqrt(posterior
variance) over t, each with the linear (red), cosine (green) and mixed
(blue) schedules on one y range.  The panels are drawn into an image array
and written with ``zlib`` (``viz.image``): no matplotlib.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..core.schedules import NoiseSchedule
from ..viz.image import compose, curve_tile, write_png

__all__ = ["REFERENCE_NLL", "MODES", "PANELS", "panels", "main"]

REFERENCE_NLL = {
    # bits/dim from the reference's results notebook
    ("cifar10", "cosine"): {50: 5.431, 200: 4.34, 1000: 3.869, 4000: 3.496},
    ("cifar10", "linear"): {50: 5.623, 200: 4.641, 1000: 3.924, 4000: 3.568},
    ("mnist", "cosine"): {50: 2.39, 200: 2.024, 1000: 1.605, 4000: 1.39},
    ("mnist", "linear"): {50: 2.796, 200: 2.229, 1000: 1.74, 4000: 1.399},
}
MODES = {"linear": (1.0, 0.0, 0.0), "cosine": (0.0, 0.6, 0.0), "mixed": (0.0, 0.0, 1.0)}
PANELS = ("beta_t", "alpha-bar_t", "sqrt(posterior variance)")
PANEL_H, PANEL_W = 240, 320


def panels(steps: int) -> np.ndarray:
    """The three panels as one RGB image array [H, W, 3] in [0, 1]."""
    curves = {name: [] for name in PANELS}
    for mode in MODES:
        s = NoiseSchedule.create(diffusion_steps=steps, mode=mode)
        for name, v in zip(PANELS, (s.betas, s.alphas_hat, np.sqrt(s.posterior_variance))):
            curves[name].append(np.asarray(v, np.float64))
    tiles = []
    for name in PANELS:
        span = (min(v.min() for v in curves[name]), max(v.max() for v in curves[name]))
        tile = None
        for v, color in zip(curves[name], MODES.values()):
            tile = curve_tile(v, PANEL_H, PANEL_W, color=color, tile=tile, span=span)
        tiles.append((tile, None))
    return compose([tiles])


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--out", type=str, default="schedules.png")
    args = p.parse_args(argv)

    write_png(args.out, panels(args.steps)[None])
    print(f"[schedules] wrote {args.out}: panels {', '.join(PANELS)}; "
          + ", ".join(f"{m} {'rgb'[int(np.argmax(c))]}" for m, c in MODES.items()))

    print("\nReference NLL (bits/dim) to beat (the reference's results notebook):")
    for (ds, mode), vals in REFERENCE_NLL.items():
        print(f"  {ds:8s} {mode:7s} " + "  ".join(f"T={k}: {v}" for k, v in vals.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
