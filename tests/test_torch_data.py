"""The port's config tree, data layer and checkpoints against the JAX
package: every YAML file composes to JAX's dict, the loaders give the same
batches for the same seed, ``CheckpointManager`` keeps and picks the steps
Orbax does, and a restored run continues bit for bit."""

import gzip
import pathlib
import pickle
import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from probabilisticdeepdiffusionmodels_tpu.config import load_config as jax_load_config
from probabilisticdeepdiffusionmodels_tpu.data import datasets as jax_datasets
from probabilisticdeepdiffusionmodels_tpu.data import native as jax_native
from probabilisticdeepdiffusionmodels_tpu.data.transforms import unnormalize as jax_unnormalize
from probabilisticdeepdiffusionmodels_torch.config import CONFIG_DIR, load_config
from probabilisticdeepdiffusionmodels_torch.data import DataLoader, get_dataset, unnormalize
from probabilisticdeepdiffusionmodels_torch.engine import AdamChain, DiffusionEngine
from probabilisticdeepdiffusionmodels_torch.train import CheckpointManager, TrainState
from test_torch_threads import one_torch_thread  # noqa: E402,F401

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_CONFIG_DIR = REPO / "probabilisticdeepdiffusionmodels_tpu" / "config"
ROOTS = sorted(p.stem for p in CONFIG_DIR.glob("*.yaml"))
GROUP_FILES = sorted(f"{p.parent.name}={p.stem}" for p in CONFIG_DIR.glob("*/*.yaml"))
# the port's only addition to the tree
PORT_KEYS = {"device"}


# ------------------------------------------------------------- config


def test_tree_is_a_copy_plus_device():
    """The port's tree holds every JAX file; the CLI roots add ``device``."""
    jax_files = sorted(p.relative_to(JAX_CONFIG_DIR) for p in JAX_CONFIG_DIR.rglob("*.yaml"))
    port_files = sorted(p.relative_to(CONFIG_DIR) for p in CONFIG_DIR.rglob("*.yaml"))
    assert port_files == jax_files and len(jax_files) == 32
    for root in ("default", "sample", "eval"):
        assert load_config(root)["device"] is None


def _without_port_keys(cfg):
    return {k: v for k, v in cfg.items() if k not in PORT_KEYS}


@pytest.mark.parametrize("root", ROOTS)
def test_root_composes_like_jax(root):
    assert _without_port_keys(load_config(root)) == jax_load_config(root)


@pytest.mark.parametrize("choice", GROUP_FILES)
def test_group_file_composes_like_jax(choice):
    assert _without_port_keys(load_config("default", [choice])) == jax_load_config(
        "default", [choice])


_OVERRIDES = [
    ["model=unet", "data=synthetic", "engine=cifar10", "model.compute_dtype=bfloat16",
     "data.n=1280", "data.batch_size=128", "engine.ema=0.9999", "trainer.max_epochs=1",
     "visualization=none", "out_dir=/tmp/x y", "run_name=smoke"],
    ["engine.optimizer_config.lr=2e-4", "engine.optimizer_config.b1=0.95",
     "model.attention_resolutions=[16,8]", "trainer.limit_test_batches=null",
     "scheduler=cosine_annealing", "scheduler.scheduler_kwargs.T_0=10", "cont_run=smoke"],
    ["engine.mode=cosine", "engine.diffusion_steps=12", "trainer.devices=all",
     "data.transformation_kwargs.flip=false", "new.deep.key={}", "seed=0x10", "patience=~"],
]


@pytest.mark.parametrize("overrides", _OVERRIDES, ids=["cli", "nested", "yaml_values"])
def test_overrides_like_jax(overrides):
    got = load_config("default", overrides + ["device=cpu"])
    assert got.pop("device") == "cpu"
    assert got == jax_load_config("default", overrides)


# ------------------------------------------------------------- data


@pytest.fixture
def numpy_transforms(monkeypatch):
    """JAX's transform on its numpy executor, the one the port copies (its
    C++ executor agrees to 1e-6, not bit for bit)."""
    monkeypatch.setattr(jax_native, "transform_batch_native", lambda *a, **k: None)


def _write_cifar(root: pathlib.Path, rng) -> None:
    sub = root / "cifar-10-batches-py"
    sub.mkdir(parents=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        d = {b"data": rng.integers(0, 256, size=(10, 3072), dtype=np.uint8),
             b"labels": list(rng.integers(0, 10, size=10))}
        (sub / name).write_bytes(pickle.dumps(d))


def _write_mnist(root: pathlib.Path, rng) -> None:
    sub = root / "MNIST" / "raw"
    sub.mkdir(parents=True)
    for prefix, n in (("train", 20), ("t10k", 10)):
        images = rng.integers(0, 256, size=(n, 28, 28), dtype=np.uint8)
        labels = rng.integers(0, 10, size=n, dtype=np.uint8)
        with gzip.open(sub / f"{prefix}-images-idx3-ubyte.gz", "wb") as f:
            f.write(struct.pack(">IIII", 0x0803, n, 28, 28) + images.tobytes())
        (sub / f"{prefix}-labels-idx1-ubyte").write_bytes(
            struct.pack(">II", 0x0801, n) + labels.tobytes())


_LOADERS = [
    ("synthetic", dict(normalize="oneone", flip=True), None),
    ("synthetic", dict(normalize="cifar", flip=True, crop=True, crop_size=32, crop_padding=4),
     40),
    ("cifar10", dict(normalize="oneone", flip=True), None),
    ("mnist", dict(normalize="mnist", crop=True), None),
    ("mnist", dict(normalize="mnist", crop=True, crop_size=24, crop_padding=0), 16),
]


@pytest.mark.parametrize("name,tf,per_epoch", _LOADERS,
                         ids=["synthetic_flip", "synthetic_crop_per_epoch", "cifar10_pickle",
                              "mnist_idx", "mnist_crop_per_epoch"])
def test_loader_batches_equal_jax(name, tf, per_epoch, tmp_path, numpy_transforms):
    """Two epochs of the train loader (shuffled, with flips and crops) and
    one of the val loader (random crop at eval too, as the reference),
    batch for batch, labels included."""
    rng = np.random.default_rng(0)
    if name == "cifar10":
        _write_cifar(tmp_path, rng)
    elif name == "mnist":
        _write_mnist(tmp_path, rng)
    kw = dict(n=48, seed=3) if name == "synthetic" else dict(root=tmp_path)
    for train in (True, False):
        ds = get_dataset(name, train=train, **kw)
        ref_ds = jax_datasets.get_dataset(name, train=train, **kw)
        np.testing.assert_array_equal(ds.images, ref_ds.images)
        opts = dict(batch_size=8, train=train, transformation_kwargs=tf,
                    num_samples_per_epoch=per_epoch, seed=5)
        loader, ref = DataLoader(ds, **opts), jax_datasets.DataLoader(ref_ds, **opts)
        assert len(loader) == len(ref) > 0
        for _ in range(2 if train else 1):
            got, want = list(loader), list(ref)
            assert len(got) == len(want) == len(loader)
            for (x, y), (xr, yr) in zip(got, want):
                assert x.dtype == np.float32
                np.testing.assert_array_equal(x, xr)
                np.testing.assert_array_equal(y, yr)


def test_unnormalize_matches_jax():
    x = np.random.default_rng(1).normal(size=(2, 4, 4, 3)).astype(np.float32)
    for norm in ("cifar", "oneone", None, ((0.1, 0.2, 0.3), (0.5, 0.5, 0.5))):
        np.testing.assert_array_equal(unnormalize(x, norm, clip=True),
                                      jax_unnormalize(x, norm, clip=True))


# ------------------------------------------------------------- checkpoints

# (step, metrics): saves with and without a val_loss, a tie, metrics without
# val_loss, and a step at or below the latest (not saved again)
_SAVES = [(1, None), (2, {"val_loss": 0.5}), (3, {"val_loss": 0.3}), (4, None),
          (5, {"val_loss": 0.4}), (5, {"val_loss": 0.1}), (6, {"val_loss": 0.3}),
          (7, {"other": 1.0}), (3, None), (8, {"val_loss": 0.2}), (9, {"val_loss": 0.9})]


def _tiny_state(seed=0):
    model = torch.nn.Linear(3, 2)
    torch.nn.init.normal_(model.weight, generator=torch.Generator().manual_seed(seed))
    return TrainState(model, AdamChain(model.parameters(), 1e-3), 4, torch.Generator(),
                      ema_decay=0.9)


def test_checkpoint_retention_matches_orbax(tmp_path):
    pytest.importorskip("orbax.checkpoint")
    import optax

    from probabilisticdeepdiffusionmodels_tpu.train.checkpoint import (
        CheckpointManager as OrbaxManager,
    )
    from probabilisticdeepdiffusionmodels_tpu.train.state import TrainState as JaxTrainState

    jstate = JaxTrainState.create({"w": jnp.zeros(3)}, optax.adam(1e-3), 4,
                                  jnp.zeros(2, jnp.uint32), ema_decay=0.9)
    ref = OrbaxManager(tmp_path / "orbax")
    mine = CheckpointManager(tmp_path / "torch")
    state = _tiny_state()
    for step, metrics in _SAVES:
        ref.save(jstate, step, metrics=metrics)
        mine.save(state, step, metrics=metrics)
        kept = sorted(int(p.name) for p in (tmp_path / "torch").iterdir())
        assert kept == sorted(ref._mgr.all_steps()), (step, metrics)
        assert mine.latest_step() == ref.latest_step()
        assert mine.best_step() == ref.best_step()
    assert mine.best_step() == 8 and 1 in kept and 4 in kept
    ref.close()
    # a new manager on the directory reads the same steps and metrics back
    again = CheckpointManager(tmp_path / "torch")
    assert (again.latest_step(), again.best_step()) == (mine.latest_step(), mine.best_step())


def test_restore_lands_every_tensor_in_place(tmp_path):
    state = _tiny_state(seed=1)
    state.loss_history.ring += 1.5
    state.generator.manual_seed(9)
    state.step = 3
    CheckpointManager(tmp_path).save(state, 3)
    fresh = _tiny_state(seed=2)
    CheckpointManager(tmp_path).restore(fresh)
    assert fresh.step == 3
    assert torch.equal(fresh.model.weight, state.model.weight)
    assert torch.equal(fresh.loss_history.ring, state.loss_history.ring)
    assert torch.equal(fresh.generator.get_state(), state.generator.get_state())
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(fresh)


_TINY_UNET = dict(name="unet", in_channels=3, model_channels=32, num_res_blocks=1,
                  attention_resolutions=[4], channel_mult=[1, 2], num_heads=1)


def _engine(**kw):
    return DiffusionEngine(_TINY_UNET, {"lr": 1e-3}, diffusion_steps=20, mode="cosine",
                           resolution=8, ema=0.9, device="cpu", seed=3, **kw)


def _engine_state(engine):
    s = engine.state
    out = {f"model.{k}": v for k, v in s.model.state_dict().items()}
    out.update({f"ema.{k}": v for k, v in s.ema_model.state_dict().items()})
    for i, st in s.optimizer.adam.state.items():
        out.update({f"adam.{i}.{k}": v for k, v in st.items()})
    for i, a in enumerate(s.optimizer.acc or []):
        out[f"acc.{i}"] = a
    for name in ("ring", "ring_pos", "count", "epoch_sum", "epoch_count"):
        out[f"history.{name}"] = getattr(s.loss_history, name)
    out["generator"] = s.generator.get_state()
    return out, (s.step, s.optimizer.updates, s.optimizer.mini_step)


@pytest.mark.parametrize("before,after,kw", [
    (2, 2, {}),
    (3, 3, dict(accumulate_grad_batches=2, grad_clip=0.5, sampling="importance",
                scheduler_name="StepLR", scheduler_kwargs=dict(step_size=1, gamma=0.5))),
], ids=["plain", "accumulating_clipped_importance_scheduled"])
def test_resume_continues_bit_for_bit(before, after, kw, tmp_path):
    """``before`` steps, a checkpoint, a fresh engine restored from it and
    ``after`` more steps give the same bits as ``before + after`` steps
    straight: weights, EMA, Adam's moments and counts, the lr schedule's
    place, the accumulation buffer (saved mid-accumulation in the second
    case), the loss history and the generator."""
    rng = np.random.default_rng(0)
    batches = [rng.uniform(-1, 1, size=(4, 8, 8, 3)).astype(np.float32)
               for _ in range(before + after)]
    straight = _engine(**kw)
    for x in batches:
        straight.training_step(x)
    first = _engine(**kw)
    for x in batches[:before]:
        first.training_step(x)
    CheckpointManager(tmp_path).save(first.state, first.state.step)
    resumed = _engine(**kw)
    CheckpointManager(tmp_path).restore(resumed.state)
    for x in batches[before:]:
        resumed.training_step(x)
    want, want_counts = _engine_state(straight)
    got, got_counts = _engine_state(resumed)
    assert got_counts == want_counts
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert not torch.equal(got["model.in_conv.weight"], _engine_state(_engine(**kw))[0][
        "model.in_conv.weight"])
