"""Super-resolution through the port's run loop against the JAX package: the
loader's (x, low) pairs, the engine's train step and its sampled chain
conditioned on the low-res image, and the device loader's refusal.  The
``cli.train`` smoke of ``test_cli.py`` (``model.name=superres
data.superres_factor=2``) is a case of ``test_torch_cli.py``'s
``test_train_cli_refuses_what_is_not_ported``."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

nn = pytest.importorskip("flax.linen")
pytest.importorskip("optax")

from probabilisticdeepdiffusionmodels_tpu.data import native as jax_native  # noqa: E402
from probabilisticdeepdiffusionmodels_tpu.data.datasets import (  # noqa: E402
    DataLoader as JaxDataLoader,
    make_synthetic as jax_make_synthetic,
)
from probabilisticdeepdiffusionmodels_tpu.engine import (  # noqa: E402
    DiffusionEngine as JaxEngine,
)
from probabilisticdeepdiffusionmodels_tpu.models.unet import (  # noqa: E402
    SuperResModel as JaxSuperResModel,
)
from probabilisticdeepdiffusionmodels_torch.convert import load_flax_params  # noqa: E402
from probabilisticdeepdiffusionmodels_torch.data import DataLoader, DeviceDataLoader  # noqa: E402
from probabilisticdeepdiffusionmodels_torch.data.datasets import make_synthetic  # noqa: E402
from probabilisticdeepdiffusionmodels_torch.engine import DiffusionEngine  # noqa: E402
from test_torch_fast_samplers import _fold_noise, _loop_key  # noqa: E402
from test_torch_train import _jax_draws  # noqa: E402
from test_torch_unet import SMALL, _random_flax_params  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401

RES, T = 8, 24
# one level, 64 channels: GroupNorm's groups of two keep the emb add
CFG = dict(SMALL, name="superres", in_channels=1, channel_mult=[1], attention_resolutions=[8])
ENGINE_KW = dict(diffusion_steps=T, resolution=RES, mode="linear", beta_start=1e-4,
                 beta_end=0.2, clip_while_generating=True)


def _pairs(loader):
    return [(np.asarray(x), np.asarray(low)) for x, low in loader]


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_loader_pairs_equal_jax(train, monkeypatch):
    """The area mean over 2x2 after the transform (flip, crop, normalize),
    bit for bit on one seed, against JAX's numpy transform (the one the port
    copies; its C++ executor agrees to 1e-6, test_torch_data.py)."""
    monkeypatch.setattr(jax_native, "transform_batch_native", lambda *a, **k: None)
    kw = dict(batch_size=4, train=train, seed=3, superres_factor=2,
              transformation_kwargs=dict(normalize="oneone", flip=True, crop=True,
                                         crop_size=8, crop_padding=1))
    want = _pairs(JaxDataLoader(jax_make_synthetic(8, 3, 12, seed=1), **kw))
    got = _pairs(DataLoader(make_synthetic(8, 3, 12, seed=1), **kw))
    assert len(got) == len(want) == 3
    for (x, low), (jx, jlow) in zip(got, want):
        assert low.shape == (4, 4, 4, 3) and low.dtype == jlow.dtype
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(low, jlow)


def test_device_loader_refuses_superres_pairs():
    with pytest.raises(ValueError, match="superres"):
        DeviceDataLoader(make_synthetic(8, 1, 8), batch_size=4, superres_factor=2,
                         device="cpu")


def _shapes_init(self, key, *args, **kwargs):
    """Zeros of the parameters' shapes in place of Flax's eager init, which
    compiles op by op; the fixture draws the weights itself."""
    shapes = jax.eval_shape(functools.partial(nn.Module.init, self), key, *args, **kwargs)
    return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)


@pytest.fixture(scope="module")
def engines():
    """The JAX engine and the port's, superres, on the same random Flax weights."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxSuperResModel, "init", _shapes_init)
        jengine = JaxEngine(dict(CFG), {"lr": 2e-4}, **ENGINE_KW)
    low0 = jnp.zeros((1, RES // 2, RES // 2, 1))
    params = _random_flax_params(jengine.model, jnp.zeros((1, RES, RES, 1)),
                                 jnp.ones((1,), jnp.int32), low0, seed=20)
    jengine.state = jengine.state.replace(params=params)
    engine = DiffusionEngine(dict(CFG), {"lr": 2e-4}, device="cpu", **ENGINE_KW)
    load_flax_params(engine.state.model, params)
    assert jengine.cond_kind == engine.cond_kind == "superres"
    return jengine, engine


def _batch(seed):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, size=(4, RES, RES, 1)).astype(np.float32)
    return x, x.reshape(4, RES // 2, 2, RES // 2, 2, 1).mean(axis=(2, 4))


def test_training_step_matches_jax(engines):
    """One step's loss and gradient norm on JAX's t and noise (the engine's
    own draws, read off its state), ``y`` reaching the ``low_res`` slot:
    loss 1e-5 and grad_norm 1e-4 relative, as test_torch_train.py holds
    the bare step."""
    jengine, engine = engines
    x, low = _batch(21)
    t, noise = _jax_draws(jengine.state, 4, T, x.shape, "uniform", 10)
    t, noise = torch.from_numpy(t.copy()).long(), torch.from_numpy(noise.copy())
    jstate = jengine.state
    weights = {k: v.clone() for k, v in engine.state.model.state_dict().items()}
    try:
        want = jengine.training_step(jnp.asarray(x), jnp.asarray(low))
        got = engine._train_step(engine.state, engine._batch(x), engine._cond(low), t=t,
                                 noise=noise)
    finally:  # the chain test reads the same weights
        jengine.state = jstate
        engine.state.model.load_state_dict(weights)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]), rtol=1e-4)
    # the low-res image reaches the model: another one gives another output
    model = engine.state.model.eval()
    with torch.no_grad():
        out = [model(engine._batch(x), t, engine._cond(v)) for v in (low, low + 1.0)]
    assert float((out[0] - out[1]).abs().max()) > 1e-3


def test_generate_images_matches_jax(engines):
    """The ancestral chain respaced to 4 steps from one x_T, conditioned on
    the low-res images, JAX's draws injected; at the engine endpoints'
    1e-4 (test_torch_fast_samplers.py)."""
    jengine, engine = engines
    x, low = _batch(22)
    x_T = np.random.RandomState(23).randn(2, RES, RES, 1).astype(np.float32)
    want = jengine.generate_images(n=2, minibatch=2, seed=3, use_ema=False,
                                   num_sample_steps=4, x_T=x_T, y=jnp.asarray(low[:2]))
    n_steps = engine._sample_tables(4)[2]
    noise = _fold_noise(_loop_key(3), range(n_steps, 0, -1), x_T.shape)
    got = engine.generate_images(n=2, minibatch=2, use_ema=False, num_sample_steps=4,
                                 x_T=x_T, noise=noise, y=low[:2])
    assert got.shape == (2, RES, RES, 1) and np.isfinite(want).all()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="low_res"):
        engine.generate_images(n=2, minibatch=2, num_sample_steps=2)
