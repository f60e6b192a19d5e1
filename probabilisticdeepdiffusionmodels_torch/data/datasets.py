"""Dataset readers and the batched loader, NHWC, host-side numpy.

PyTorch-port copy of ``probabilisticdeepdiffusionmodels_tpu/data/datasets.py``:
the same readers of the raw on-disk formats, the same procedural dataset and
the same loader, so one seed gives the same batches in both packages:
  * MNIST: IDX ubyte files (optionally .gz)
  * CIFAR-10: python pickle batches
  * CelebA: image directory + list_eval_partition.txt
  * CelebA-HQ: metadata.csv + img256/ or CelebA-HQ-img/
  * SVHN (.mat) and ImageNet-style folders
  * synthetic: procedurally generated images for tests and benchmarks

Loader semantics kept from the reference:
  * split-name handling per dataset
  * fixed-size epochs via with-replacement sampling when
    ``num_samples_per_epoch`` is set
  * shuffle defaults to the train flag

Batches are numpy; the train loop moves them to the device
(``train/loop.py::prefetch_to_device``).
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

from .transforms import Transform

__all__ = ["DATA_DIR", "get_dataset", "DataLoader", "ArrayDataset"]

DATA_DIR = Path(os.environ.get("PDDM_DATA_DIR", "./data"))

SPLIT_NAMES = {
    "CelebA": {True: "train", False: "valid"},
    "Cifar10": {True: "train", False: "valid"},
    "ImageNet": {True: "train", False: "val"},
    "SVHN": {True: "train", False: "test"},
}


class ArrayDataset:
    """In-memory dataset of NHWC uint8 images + integer labels."""

    def __init__(self, images: np.ndarray, labels: Optional[np.ndarray] = None):
        assert images.ndim == 4
        self.images = images
        self.labels = (
            labels if labels is not None else np.zeros(len(images), np.int32)
        )

    def __len__(self):
        return len(self.images)


def _read_idx(path: Path) -> np.ndarray:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _find(root: Path, names) -> Path:
    for n in names:
        for cand in (root / n, root / (n + ".gz")):
            if cand.exists():
                return cand
    raise FileNotFoundError(f"none of {names} under {root}")


def load_mnist(root: Path, train: bool) -> ArrayDataset:
    sub = root / "MNIST" / "raw" if (root / "MNIST").exists() else root
    prefix = "train" if train else "t10k"
    images = _read_idx(_find(sub, [f"{prefix}-images-idx3-ubyte"]))
    labels = _read_idx(_find(sub, [f"{prefix}-labels-idx1-ubyte"]))
    return ArrayDataset(images[..., None], labels.astype(np.int32))


def load_cifar10(root: Path, train: bool) -> ArrayDataset:
    sub = root / "cifar-10-batches-py" if (root / "cifar-10-batches-py").exists() else root
    names = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
    imgs, labels = [], []
    for n in names:
        with open(sub / n, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        imgs.append(d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        labels.extend(d[b"labels"])
    return ArrayDataset(
        np.concatenate(imgs).astype(np.uint8), np.asarray(labels, np.int32)
    )


def _load_image_file(path: Path, resolution: Optional[int] = None) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if resolution is not None and img.size != (resolution, resolution):
        img = img.resize((resolution, resolution), Image.BILINEAR)
    return np.asarray(img, dtype=np.uint8)


class ImageFolderDataset:
    """Lazy image-directory dataset (CelebA / CelebA-HQ style)."""

    def __init__(self, files, labels=None, resolution: Optional[int] = None):
        self.files = list(files)
        self.labels = (
            labels if labels is not None else np.zeros(len(self.files), np.int32)
        )
        self.resolution = resolution

    def __len__(self):
        return len(self.files)

    def load(self, indices) -> np.ndarray:
        return np.stack(
            [_load_image_file(self.files[i], self.resolution) for i in indices]
        )


def load_celeba(root: Path, train: bool, resolution: Optional[int] = None):
    """CelebA via img_align_celeba/ + list_eval_partition.txt
    (split 0=train, 1=valid, 2=test; the reference maps train->'train',
    eval->'valid', data.py:17-22)."""
    base = root / "celeba" if (root / "celeba").exists() else root
    img_dir = base / "img_align_celeba"
    part = base / "list_eval_partition.txt"
    wanted = {0} if train else {1}
    files = []
    with open(part) as f:
        for line in f:
            name, split = line.split()
            if int(split) in wanted:
                files.append(img_dir / name)
    return ImageFolderDataset(files, resolution=resolution)


def load_celebahq(root: Path, train: bool, resolution: int = 256):
    """CelebA-HQ via metadata.csv (reference src/datasets/celebahq.py:10-56):
    split column train={0,3}, val={1,2}; img256/ for 256, CelebA-HQ-img/ for
    1024."""
    import csv

    resize_to = None
    if resolution == 256:
        img_dir = root / "img256"
    elif resolution == 1024:
        img_dir = root / "CelebA-HQ-img"
    elif (root / f"img{resolution}").exists():
        img_dir = root / f"img{resolution}"
    else:
        # downsample on the fly from the 256px set (e.g. the 64x64
        # BASELINE config #4); run prep_celebahq resize for a cached dir
        img_dir = root / "img256"
        resize_to = resolution
    wanted = {0, 3} if train else {1, 2}
    files = []
    with open(root / "metadata.csv") as f:
        for row in csv.DictReader(f):
            if int(row["split"]) in wanted:
                files.append(img_dir / row["file_name"])
    return ImageFolderDataset(files, resolution=resize_to)


def load_svhn(root: Path, train: bool) -> ArrayDataset:
    """SVHN from the cropped-digits .mat files (train->train_32x32.mat,
    eval->test_32x32.mat per the reference split table, data.py:17-22)."""
    from scipy.io import loadmat

    name = "train_32x32.mat" if train else "test_32x32.mat"
    mat = loadmat(str(root / name))
    # X: (32, 32, 3, N) -> (N, 32, 32, 3)
    images = np.ascontiguousarray(mat["X"].transpose(3, 0, 1, 2))
    labels = mat["y"].reshape(-1).astype(np.int32) % 10  # '10' means digit 0
    return ArrayDataset(images.astype(np.uint8), labels)


def load_imagefolder(root: Path, train: bool, resolution: Optional[int] = None):
    """ImageNet-style directory tree: <root>/<split>/<class>/<img> with
    split names train/val (reference SPLIT_NAMES, data.py:17-22)."""
    split = "train" if train else "val"
    base = root / split if (root / split).exists() else root
    classes = sorted(p.name for p in base.iterdir() if p.is_dir())
    files, labels = [], []
    for ci, cls in enumerate(classes):
        for f in sorted((base / cls).iterdir()):
            if f.suffix.lower() in (".jpg", ".jpeg", ".png"):
                files.append(f)
                labels.append(ci)
    return ImageFolderDataset(
        files, np.asarray(labels, np.int32), resolution=resolution
    )


def make_synthetic(
    resolution: int = 32, channels: int = 3, n: int = 256, seed: int = 0
) -> ArrayDataset:
    """Procedural dataset (smooth random blobs) for tests and benchmarks;
    the label is the horizontal-frequency band of channel 0 in 10 bins."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:resolution, 0:resolution].astype(np.float32) / resolution
    imgs = np.empty((n, resolution, resolution, channels), np.uint8)
    labels = np.empty((n,), np.int32)
    for i in range(n):
        f = rng.uniform(1, 4, size=(channels, 2))
        ph = rng.uniform(0, 2 * np.pi, size=(channels, 2))
        for c in range(channels):
            v = 0.5 + 0.5 * np.sin(2 * np.pi * f[c, 0] * xx + ph[c, 0]) * np.sin(
                2 * np.pi * f[c, 1] * yy + ph[c, 1]
            )
            imgs[i, :, :, c] = (v * 255).astype(np.uint8)
        labels[i] = min(9, int((f[0, 0] - 1.0) / 3.0 * 10.0))
    return ArrayDataset(imgs, labels)


def get_dataset(name: str, train: bool = True, root: Optional[Path] = None,
                resolution: Optional[int] = None, **kwargs):
    root = Path(root) if root is not None else DATA_DIR / f"{name.lower()}_data"
    lname = name.lower()
    # fail loudly on kwargs no dataset consumes — a silently dropped
    # `data.normalize=...` surfaces later as an opaque channel-broadcast
    # error inside the transform (normalization lives under
    # data.transformation_kwargs, which DataLoader owns)
    known = {"n", "channels", "seed"} if lname == "synthetic" else set()
    unknown = set(kwargs) - known
    if unknown:
        hint = (
            " (normalization belongs under data.transformation_kwargs"
            ".normalize)" if "normalize" in unknown else ""
        )
        raise TypeError(
            f"get_dataset({name!r}) got unsupported kwargs "
            f"{sorted(unknown)}{hint}"
        )
    if lname == "mnist":
        return load_mnist(root, train)
    if lname in ("cifar10", "cifar-10"):
        return load_cifar10(root, train)
    if lname == "celeba":
        return load_celeba(root, train, resolution)
    if lname == "celebahq":
        return load_celebahq(root, train, resolution or 256)
    if lname == "svhn":
        return load_svhn(root, train)
    if lname == "imagenet":
        return load_imagefolder(root, train, resolution)
    if lname == "synthetic":
        return make_synthetic(
            resolution=resolution or 32, n=kwargs.get("n", 256),
            channels=kwargs.get("channels", 3), seed=kwargs.get("seed", 0),
        )
    raise ValueError(f"Unknown dataset: {name}")


class DataLoader:
    """Batched iterator: shuffle defaults to train; optional fixed-size
    with-replacement epochs via num_samples_per_epoch."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        train: bool = True,
        transformation_kwargs: Optional[dict] = None,
        num_samples_per_epoch: Optional[int] = None,
        shuffle: Optional[bool] = None,
        seed: int = 0,
        drop_last: bool = True,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.train = train
        self.transform = Transform(train=train, **(transformation_kwargs or {}))
        self.num_samples_per_epoch = num_samples_per_epoch
        self.shuffle = train if shuffle is None else shuffle
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last

    def __len__(self):
        n = self.num_samples_per_epoch or len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def epoch(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = len(self.dataset)
        if self.num_samples_per_epoch is not None:
            order = self.rng.integers(0, n, size=self.num_samples_per_epoch)
        elif self.shuffle:
            order = self.rng.permutation(n)
        else:
            order = np.arange(n)

        bs = self.batch_size
        stop = len(order) - (len(order) % bs if self.drop_last else 0)
        for i in range(0, stop, bs):
            idx = order[i : i + bs]
            if hasattr(self.dataset, "load"):
                raw = self.dataset.load(idx)
                labels = np.asarray(self.dataset.labels)[idx]
            else:
                raw = self.dataset.images[idx]
                labels = self.dataset.labels[idx]
            yield self.transform(raw, self.rng), labels

    def __iter__(self):
        return self.epoch()
