"""The port's device-resident loader (``data.DeviceDataLoader``) on the CPU:
the same sample stream as the port's host ``DataLoader`` (which keeps JAX's
loader's draws) and as JAX's ``DeviceDataLoader``, over two epochs, the eval
split, fixed-size epochs and every transform; and its refusals.

Tolerances: against the port's host loader bit for bit (the same float32
operations in the same order); against JAX's, whose jitted gather and
normalisation XLA may reassociate, indices and labels exactly and pixels
within 2e-6, as JAX's own parity test holds its loader to the host one.
"""

import numpy as np
import pytest
import torch

from probabilisticdeepdiffusionmodels_torch.cli import train as cli_train
from probabilisticdeepdiffusionmodels_torch.config import load_config
from probabilisticdeepdiffusionmodels_torch.data import (
    ArrayDataset,
    DataLoader,
    DeviceDataLoader,
    get_dataset,
)
from test_cli import TINY
from test_torch_threads import one_torch_thread  # noqa: E402,F401

TRANSFORMS = [
    dict(normalize="cifar"),
    dict(normalize="oneone", flip=True),
    dict(normalize="mnist", flip=True, crop=True, crop_size=16, crop_padding=2),
    dict(crop=True, crop_size=12, crop_padding=0),
]


def _pairs(host, dev):
    h, d = list(host), list(dev)
    assert len(h) == len(d) == len(host) == len(dev) and h
    return zip(h, d)


@pytest.mark.parametrize("tk", TRANSFORMS, ids=["cifar", "flip", "flip_crop_pad", "crop"])
@pytest.mark.parametrize("train,extra", [
    (True, dict(num_samples_per_epoch=40)),
    (True, dict()),
    (False, dict(drop_last=False)),
], ids=["fixed_size", "shuffled", "eval_split"])
def test_stream_matches_host_loader_bit_for_bit(tk, train, extra):
    """Two epochs of batches (x, y) equal the host loader's bit for bit: the
    decisions (order, flips, crops) come from one seeded rng in one order,
    and the pixel work is the same float32 arithmetic."""
    ds = get_dataset("synthetic", resolution=16, n=36, channels=3)
    kw = dict(batch_size=8, train=train, seed=7, transformation_kwargs=tk, **extra)
    host = DataLoader(ds, **kw)
    dev = DeviceDataLoader(ds, device="cpu", **kw)
    for _ in range(2):
        for (xh, yh), (xd, yd) in _pairs(host, dev):
            assert xd.dtype == torch.float32 and xd.device.type == "cpu"
            np.testing.assert_array_equal(xd.numpy(), xh)
            np.testing.assert_array_equal(yd.numpy(), yh)


@pytest.mark.parametrize("tk", TRANSFORMS[1:3], ids=["flip", "flip_crop_pad"])
def test_stream_matches_jax_device_loader(tk):
    """Two epochs against JAX's ``DeviceDataLoader`` of the same seed."""
    pytest.importorskip("flax")
    from probabilisticdeepdiffusionmodels_tpu.data import DeviceDataLoader as JaxDeviceLoader

    ds = get_dataset("synthetic", resolution=16, n=32, channels=3)
    kw = dict(batch_size=8, train=True, seed=3, transformation_kwargs=tk,
              num_samples_per_epoch=24)
    jdev, dev = JaxDeviceLoader(ds, **kw), DeviceDataLoader(ds, device="cpu", **kw)
    for _ in range(2):
        for (xj, yj), (xd, yd) in _pairs(jdev, dev):
            np.testing.assert_allclose(xd.numpy(), np.asarray(xj), rtol=0, atol=2e-6)
            np.testing.assert_array_equal(yd.numpy(), np.asarray(yj))


def test_rejections():
    """JAX's refusals (superres pairs, a file-backed dataset, non-uint8
    images, an unknown transform key), and sharding, which the host loader
    has not yet."""
    ds = get_dataset("synthetic", resolution=8, n=8, channels=1)
    with pytest.raises(ValueError, match="superres"):
        DeviceDataLoader(ds, batch_size=4, superres_factor=2, device="cpu")

    class FileBacked(ArrayDataset):
        def load(self, idx):
            return self.images[idx]

    with pytest.raises(ValueError, match="in-memory"):
        DeviceDataLoader(FileBacked(ds.images), batch_size=4, device="cpu")
    floats = ArrayDataset(np.zeros((8, 8, 8, 1), np.float32))
    with pytest.raises(ValueError, match="uint8"):
        DeviceDataLoader(floats, batch_size=4, device="cpu")
    with pytest.raises(TypeError, match="normalise"):
        DeviceDataLoader(ds, batch_size=4, transformation_kwargs={"normalise": "mnist"},
                         device="cpu")
    with pytest.raises(ValueError, match="shard_id"):
        DeviceDataLoader(ds, batch_size=4, shard_id=2, num_shards=2, device="cpu")


def test_cli_builds_device_loaders():
    """``data.device_resident=true`` gives both loaders on the run's device,
    with the seeds the host loaders take (run seed, + 1 for validation)."""
    cfg = load_config("default", TINY + ["device=cpu", "data.device_resident=true"])
    train, val = cli_train.build_loaders(cfg)
    assert isinstance(train, DeviceDataLoader) and isinstance(val, DeviceDataLoader)
    assert train.device == torch.device("cpu") and (train.train, val.train) == (True, False)
    host_train, host_val = cli_train.build_loaders(load_config("default", TINY + ["device=cpu"]))
    for (xh, _), (xd, _) in _pairs(host_val, val):
        np.testing.assert_array_equal(xd.numpy(), xh)
    for (xh, _), (xd, _) in _pairs(host_train, train):
        np.testing.assert_array_equal(xd.numpy(), xh)
