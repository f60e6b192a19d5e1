"""Device-resident data loading: the dataset lives on the device once, and a
batch ships bytes of random decisions instead of megabytes of pixels.

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/data/device_loader.py``.
The uint8 images and their labels are copied to the loader's device once.
Per batch the host draws what ``DataLoader`` draws, from the same
``np.random.default_rng(seed)`` in the same order (the epoch's order, then
each batch's flip flags, crop rows and crop columns), and ships only those:
indices, flips and crop offsets.  The gather, flip, pad + crop and
normalisation run as torch ops on the device, so for one seed the loader
yields the host loader's sample stream, already on the device (labels
gathered there too).  ``device`` (None: ``cuda``, which raises without a
card) places it.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..models import resolve_device
from .transforms import resolve_normalization

__all__ = ["DeviceDataLoader"]

_TRANSFORM_KEYS = {"flip", "crop", "crop_size", "crop_padding", "normalize", "eval_random_crop"}


class DeviceDataLoader:
    """``DataLoader``'s constructor surface for in-memory uint8 datasets,
    yielding (x, y) device tensors: x float32 [B, H, W, C], y int64 [B].

    Raises for what needs host work per sample: a file-backed dataset (one
    with ``.load``), super-resolution pairs, non-uint8 images, and unknown
    ``transformation_kwargs`` keys (as the host ``Transform`` would).
    ``shard_id`` / ``num_shards`` take the host loader's shard of every
    epoch, ``order[shard_id::num_shards]``."""

    def __init__(self, dataset, batch_size: int, train: bool = True,
                 transformation_kwargs: Optional[dict] = None,
                 num_samples_per_epoch: Optional[int] = None, shuffle: Optional[bool] = None,
                 seed: int = 0, drop_last: bool = True, shard_id: int = 0, num_shards: int = 1,
                 superres_factor: Optional[int] = None, device=None):
        if superres_factor:
            raise ValueError("DeviceDataLoader does not build superres pairs; use the host "
                             "DataLoader for SuperResModel training")
        if hasattr(dataset, "load"):
            raise ValueError("DeviceDataLoader needs an in-memory ArrayDataset (file-backed "
                             "datasets stream through the host DataLoader)")
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard_id {shard_id} outside [0, num_shards={num_shards})")
        tk = dict(transformation_kwargs or {})
        unknown = set(tk) - _TRANSFORM_KEYS
        if unknown:
            raise TypeError(f"DeviceDataLoader got unsupported transformation_kwargs "
                            f"{sorted(unknown)}")
        images = np.asarray(dataset.images)
        if images.dtype != np.uint8:
            raise ValueError(f"DeviceDataLoader expects uint8 images, got {images.dtype}")
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.train = train
        self.num_samples_per_epoch = num_samples_per_epoch
        self.shuffle = train if shuffle is None else shuffle
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last
        self.shard_id = shard_id
        self.num_shards = num_shards
        # Transform's flag resolution
        self.flip = bool(tk.get("flip", False)) and train
        self.crop = bool(tk.get("crop", False)) and (train or bool(tk.get("eval_random_crop",
                                                                            True)))
        self.crop_size = int(tk.get("crop_size", 32))
        self.crop_padding = int(tk.get("crop_padding", 4))
        norm = resolve_normalization(tk.get("normalize"))
        self._norm = None if norm is None else tuple(
            torch.as_tensor(v, device=self.device).reshape(1, 1, 1, -1) for v in norm)
        self._data = torch.as_tensor(images, device=self.device)  # resident, once
        self._labels = torch.as_tensor(np.asarray(dataset.labels), device=self.device).long()
        self._n = len(images)

    def __len__(self):
        n = self.num_samples_per_epoch or self._n
        n = (n - self.shard_id + self.num_shards - 1) // self.num_shards
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batch(self, idx: torch.Tensor, flips: Optional[np.ndarray], rows: Optional[np.ndarray],
               cols: Optional[np.ndarray]) -> torch.Tensor:
        """Gather and transform one batch on the device, step for step as
        ``Transform._apply_numpy``."""
        imgs = self._data[idx]
        if flips is not None:
            imgs = torch.where(self._put(flips)[:, None, None, None], imgs.flip(2), imgs)
        if self.crop:
            pad, cs = self.crop_padding, self.crop_size
            if pad:
                imgs = torch.nn.functional.pad(imgs, (0, 0, pad, pad, pad, pad))
            ar = torch.arange(cs, device=self.device)
            r = (self._put(rows)[:, None] + ar)[:, :, None]
            c = (self._put(cols)[:, None] + ar)[:, None, :]
            b = torch.arange(imgs.shape[0], device=self.device)[:, None, None]
            imgs = imgs[b, r, c]
        x = imgs.to(torch.float32) / 255.0
        if self._norm is not None:
            mean, std = self._norm
            x = (x - mean) / std
        return x

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device, non_blocking=True)

    def epoch(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        # DataLoader.epoch's and Transform.__call__'s draws, in their order
        if self.num_samples_per_epoch is not None:
            order = self.rng.integers(0, self._n, size=self.num_samples_per_epoch)
        elif self.shuffle:
            order = self.rng.permutation(self._n)
        else:
            order = np.arange(self._n)
        if self.num_shards > 1:
            order = order[self.shard_id::self.num_shards]
        bs = self.batch_size
        stop = len(order) - (len(order) % bs if self.drop_last else 0)
        h = self._data.shape[1] + 2 * self.crop_padding
        w = self._data.shape[2] + 2 * self.crop_padding
        cs = self.crop_size
        for i in range(0, stop, bs):
            idx = order[i:i + bs]
            b = len(idx)
            flips = (self.rng.random(b) < 0.5) if self.flip else None
            rows = cols = None
            if self.crop:
                rows = self.rng.integers(0, h - cs + 1, size=b)
                cols = self.rng.integers(0, w - cs + 1, size=b)
            idx = self._put(idx)
            yield self._batch(idx, flips, rows, cols), self._labels[idx]

    def __iter__(self):
        return self.epoch()
