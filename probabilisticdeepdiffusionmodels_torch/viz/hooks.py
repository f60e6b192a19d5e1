"""The visualization suite: sample grids, interpolations, reconstructions.

PyTorch-port counterpart of ``probabilisticdeepdiffusionmodels_tpu/viz/hooks.py``,
with the same constructor, views, t lists, seeds, EMA use and file names:
  * the random grid: samples with their trajectory at the chosen timesteps;
  * the interpolation: two images noised to t, lerped in x_t space, each
    lerp point denoised; the endpoints framed in red;
  * the reconstruction grid: the first images reconstructed from each t;
  * the single reconstruction: one row of the chain's steps and the std of
    x at each step.
Where the JAX hooks draw each view with matplotlib, one tile per ``_grid``
call, the port composes the same tiles in the same rows and columns into
one image array (``viz.image.compose``), frames drawn as 3-pixel borders and
the std curve rasterised into the row's last tile, and writes it as a PNG
into the run's ``media/`` folder.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..data.transforms import unnormalize
from .image import compose, curve_tile, write_png

__all__ = ["VisualizationCallback"]


def _numpy(x) -> np.ndarray:
    """An endpoint's result (a tensor on any device, or numpy) as numpy."""
    if hasattr(x, "detach"):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def _to_img(x: np.ndarray, normalize) -> np.ndarray:
    """NHWC model-space floats -> [0, 1] displayable."""
    x = unnormalize(x, normalize=normalize, clip=True, channel_dim=-1)
    return np.clip(x, 0, 1)


class VisualizationCallback:
    def __init__(
        self,
        val_batch: np.ndarray,
        ts: Sequence[int],
        media_dir: Path,
        normalize=None,
        n_images: int = 4,
        n_random: int = 4,
        n_interpolation_steps: int = 10,
        n_interpolation_pairs: int = 4,
        run_every: int = 5,
        use_ema: bool = True,
        logger=None,
        labels: Optional[np.ndarray] = None,
    ):
        self.val_batch = _numpy(val_batch)
        self.ts = sorted(set(int(t) for t in ts))
        self.media_dir = Path(media_dir)
        self.normalize = normalize
        self.n_images = n_images
        self.n_random = n_random
        self.n_interpolation_steps = n_interpolation_steps
        self.n_interpolation_pairs = n_interpolation_pairs
        self.run_every = run_every
        self.use_ema = use_ema
        self.logger = logger
        self.labels = labels
        self._writes = True

    def __call__(self, engine, epoch: int) -> list:
        """The four views, tagged ``epoch<N>`` (``final`` for -1); returns
        the paths written."""
        tag = f"epoch{epoch}" if epoch >= 0 else "final"
        # on a data mesh every rank draws the views (the engine's calls are
        # collective there) and the main rank writes them
        self._writes = getattr(engine, "is_main", True)
        paths = [self.visualize_random_grid(engine, tag),
                 self.visualize_interpolation(engine, tag),
                 self.visualize_reconstructions_grid(engine, tag),
                 self.visualize_single_reconstructions(engine, tag)]
        return [p for p in paths if p is not None]

    def _img(self, x) -> np.ndarray:
        return _to_img(_numpy(x), self.normalize)

    def _save(self, view: np.ndarray, name: str) -> Path:
        path = self.media_dir / f"{name}.png"
        if not self._writes:
            return path
        write_png(path, view[None], pad=0)
        if self.logger is not None:
            self.logger.log_image(name.rsplit("_", 1)[0], path)
        return path

    def visualize_random_grid(self, engine, tag: str):
        """Rows: samples; columns: x_T, then the recorded steps (descending t)."""
        steps = [t for t in self.ts if t < engine.diffusion_steps] or [1]
        noise, imgs = engine.generate_images_grid(
            steps_to_return=steps, n=self.n_random, minibatch=self.n_random,
            use_ema=self.use_ema, seed=0,
        )
        noise, imgs = _numpy(noise), _numpy(imgs)
        rows = [[(self._img(noise[i]), None)]
                + [(self._img(imgs[i, j]), None) for j in range(imgs.shape[1])]
                for i in range(imgs.shape[0])]
        return self._save(compose(rows), f"random_grid_{tag}")

    def _interpolation_pairs(self, n_pairs: int):
        """Index pairs to interpolate: with labels, pairs of one class, else
        consecutive images."""
        if self.labels is not None:
            labels = np.asarray(self.labels)
            pairs = []
            for cls in np.unique(labels):
                idx = np.nonzero(labels == cls)[0]
                for i in range(0, len(idx) - 1, 2):
                    pairs.append((idx[i], idx[i + 1]))
                    if len(pairs) >= n_pairs:
                        return pairs
            return pairs
        return [(2 * p, 2 * p + 1) for p in range(n_pairs)]

    def visualize_interpolation(self, engine, tag: str, t: Optional[int] = None):
        """Rows: pairs; columns: image a (red), the denoised lerps, image b (red)."""
        t = t if t is not None else engine.diffusion_steps // 2
        pairs = min(self.n_interpolation_pairs, len(self.val_batch) // 2)
        if pairs == 0:
            return None
        k = self.n_interpolation_steps
        rows = []
        for p, (ia, ib) in enumerate(self._interpolation_pairs(pairs)):
            x0a = self.val_batch[ia: ia + 1]
            x0b = self.val_batch[ib: ib + 1]
            xa = _numpy(engine.get_noised_representation(x0a, t, seed=p))
            xb = _numpy(engine.get_noised_representation(x0b, t, seed=p + 1))
            x_t = np.concatenate([(1 - w) * xa + w * xb for w in np.linspace(0.0, 1.0, k)],
                                 axis=0)
            recon = _numpy(engine.sample_from_step(x_t, t, use_ema=self.use_ema, seed=p))
            rows.append([(self._img(x0a[0]), "red")]
                        + [(self._img(recon[j]), None) for j in range(k)]
                        + [(self._img(x0b[0]), "red")])
        if not rows:
            return None
        return self._save(compose(rows), f"interpolation_t{t}_{tag}")

    def visualize_reconstructions_grid(self, engine, tag: str):
        """Rows: images; columns: x0 (green), then its reconstruction from
        each t."""
        n = min(self.n_images, len(self.val_batch))
        x0 = self.val_batch[:n]
        t_starts = [t for t in self.ts if 1 < t <= engine.diffusion_steps]
        if not t_starts:
            return None
        rows = [[(self._img(x0[i]), "green")] for i in range(n)]
        for j, t in enumerate(t_starts):
            recon, _ = engine.diffuse_and_reconstruct(x0, t, seed=j, use_ema=self.use_ema)
            recon = _numpy(recon)
            for i in range(n):
                rows[i].append((self._img(recon[i]), None))
        return self._save(compose(rows), f"reconstructions_{tag}")

    def visualize_single_reconstructions(self, engine, tag: str):
        """One row: x0 (green), the chain's recorded steps from T, and the
        std of x before the chain and after each step."""
        x0 = self.val_batch[:1]
        t_start = engine.diffusion_steps
        steps = [t for t in self.ts if t < t_start] or [1]
        (step_imgs, stds), _ = engine.diffuse_and_reconstruct_grid(
            x0, t_start, steps_to_return=steps, return_stds=True,
            use_ema=self.use_ema, seed=0,
        )
        step_imgs, stds = _numpy(step_imgs), _numpy(stds)
        h, w = x0.shape[1:3]
        row = ([(self._img(x0[0]), "green")]
               + [(self._img(step_imgs[0, j]), None) for j in range(step_imgs.shape[1])]
               + [(curve_tile(stds, h, w), None)])
        return self._save(compose([row]), f"single_recon_std_{tag}")
