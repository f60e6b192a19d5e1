"""Image transforms with the reference's semantics, NHWC numpy.

PyTorch-port copy of ``probabilisticdeepdiffusionmodels_tpu/data/transforms.py``
with both of its executors: the one-pass C++ one of ``data/native/`` (the
default for uint8 images) and numpy (``use_native=False``, or float
images), which give the same bits.  The random draws are made here, before
either runs, in JAX's order, so a seeded loader yields the same batches in
both packages:
  * RandomHorizontalFlip (p=0.5) when flip and train;
  * RandomCrop(crop_size, padding) when crop; the reference applies a
    *random* crop at eval time too, kept behind ``eval_random_crop=True``
    (the default, for parity);
  * ToTensor: uint8 -> float32 / 255;
  * Normalize(mean, std) from the named table {cifar, mnist, oneone} or an
    explicit (mean, std) pair.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np

NORMALIZATIONS = {
    "cifar": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
    "mnist": ((0.5,), (0.5,)),
    "oneone": ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),
}


def resolve_normalization(normalize) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    if normalize is None:
        return None
    if isinstance(normalize, str):
        if normalize not in NORMALIZATIONS:
            raise ValueError(f"Wrong normalization: {normalize}")
        mean, std = NORMALIZATIONS[normalize]
    elif isinstance(normalize, Iterable):
        mean, std = normalize
    else:
        raise ValueError(f"Wrong normalization: {normalize}")
    return np.asarray(mean, np.float32), np.asarray(std, np.float32)


class Transform:
    """Batched NHWC uint8 -> normalized float32 pipeline."""

    def __init__(
        self,
        train: bool = True,
        flip: bool = False,
        crop: bool = False,
        crop_size: int = 32,
        crop_padding: int = 4,
        normalize=None,
        eval_random_crop: bool = True,
    ):
        self.train = train
        self.flip = flip and train
        # reference applies RandomCrop at eval too (data.py:89-90 TODO)
        self.crop = crop and (train or eval_random_crop)
        self.crop_size = crop_size
        self.crop_padding = crop_padding
        self.norm = resolve_normalization(normalize)
        self.executor = None

    def __call__(self, images: np.ndarray, rng: np.random.Generator,
                 use_native: bool = True) -> np.ndarray:
        """images: [B, H, W, C] uint8 (or float in [0,255]).  The flip flags
        are drawn first, then the crop rows, then the crop columns.  uint8
        images go through the native executor unless ``use_native`` is
        False (a failed build raises); ``executor`` names the one that ran
        last."""
        assert images.ndim == 4, images.shape
        b = images.shape[0]

        flip_flags = (rng.random(b) < 0.5) if self.flip else None
        ys = xs = None
        if self.crop:
            pad = self.crop_padding
            h = images.shape[1] + 2 * pad
            w = images.shape[2] + 2 * pad
            cs = self.crop_size
            ys = rng.integers(0, h - cs + 1, size=b).astype(np.int32)
            xs = rng.integers(0, w - cs + 1, size=b).astype(np.int32)

        if use_native and images.dtype == np.uint8:
            from .native import transform_batch_native

            mean, std = self.norm if self.norm is not None else (
                np.zeros(1, np.float32), np.ones(1, np.float32))
            self.executor = "native"
            return transform_batch_native(
                images, None if flip_flags is None else flip_flags.astype(np.int32),
                self.crop, self.crop_padding, self.crop_size, ys, xs, mean, std)
        self.executor = "numpy"
        return self._apply_numpy(images, flip_flags, ys, xs)

    def _apply_numpy(self, images, flip_flags, ys, xs) -> np.ndarray:
        """Apply the drawn flips and crops, then scale and normalize."""
        b = images.shape[0]
        if flip_flags is not None:
            images = np.where(
                flip_flags[:, None, None, None], images[:, :, ::-1, :], images
            )
        if self.crop:
            pad = self.crop_padding
            if pad:
                images = np.pad(
                    images, ((0, 0), (pad, pad), (pad, pad), (0, 0)), mode="constant"
                )
            cs = self.crop_size
            out = np.empty((b, cs, cs, images.shape[3]), images.dtype)
            for i in range(b):
                out[i] = images[i, ys[i] : ys[i] + cs, xs[i] : xs[i] + cs]
            images = out

        x = images.astype(np.float32) / 255.0
        if self.norm is not None:
            mean, std = self.norm
            x = (x - mean.reshape(1, 1, 1, -1)) / std.reshape(1, 1, 1, -1)
        return x


def unnormalize(
    x: np.ndarray, normalize=None, clip: bool = False, channel_dim: int = -1
) -> np.ndarray:
    """Invert Normalize and optionally clip to [0,1]."""
    if normalize is not None:
        mean, std = resolve_normalization(normalize)
        shape = [1] * x.ndim
        shape[channel_dim] = x.shape[channel_dim]
        x = x * std.reshape(shape) + mean.reshape(shape)
    if clip:
        return np.clip(x, 0, 1)
    return x
