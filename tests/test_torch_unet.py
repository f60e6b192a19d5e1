"""The port's UNet against the JAX model, with Flax weights carried over by
``convert``; plus the port's import and device rules."""

import ast
import pathlib

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

# The JAX model needs Flax; where it is missing (a machine set up for the
# card), the module skips and ``-m gpu`` over tests/test_torch_*.py still runs.
pytest.importorskip("flax")

from probabilisticdeepdiffusionmodels_tpu.models import get_model as jax_get_model
from probabilisticdeepdiffusionmodels_tpu.models.layers import Conv as JaxConv
from probabilisticdeepdiffusionmodels_torch.convert import (
    load_flax_params,
    params_from_flax,
)
from probabilisticdeepdiffusionmodels_torch.models import get_model
from probabilisticdeepdiffusionmodels_torch.models.layers import Conv
from test_torch_threads import one_torch_thread  # noqa: E402,F401

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG_DIR = REPO / "probabilisticdeepdiffusionmodels_tpu" / "config" / "model"

# model_channels 64: with C=32 per-channel groups would normalise the emb add away
SMALL = dict(name="unet", in_channels=3, model_channels=64, num_res_blocks=1,
             attention_resolutions=[4], channel_mult=[1, 2], num_heads=2)


def _random_flax_params(model, x, t, y=None, seed=0):
    """Flax params of ``model`` drawn from numpy, zero-init points included
    (torch-like scales), from the shapes alone: no ``model.init``."""
    args = (x, t) if y is None else (x, t, y)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)["params"]
    rng = np.random.RandomState(seed)

    def draw(path, s):
        leaf = path[-1].key
        if leaf == "scale":
            return (1.0 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        if leaf == "bias":
            return (0.1 * rng.randn(*s.shape)).astype(np.float32)
        if leaf == "embedding":
            return rng.randn(*s.shape).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _inputs(batch, res, channels, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, res, res, channels).astype(np.float32)
    t = rng.randint(1, 1001, size=batch).astype(np.int32)
    return x, t


def _count(tree):
    return sum(int(np.prod(l.shape)) for l in jax.tree.leaves(tree))


@pytest.mark.parametrize("config,resolution", [("unet", 32), ("unet_small_grey", 28)])
def test_param_count_matches_jax(config, resolution):
    cfg = yaml.safe_load((CONFIG_DIR / f"{config}.yaml").read_text())
    jm = jax_get_model(resolution, cfg)
    x = jnp.zeros((1, resolution, resolution, cfg["in_channels"]))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, jnp.ones((1,), jnp.int32))
    model = get_model(resolution, cfg, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == _count(shapes["params"])


@pytest.mark.parametrize("extra", [
    dict(),
    dict(use_scale_shift_norm=True),
    dict(num_classes=5, cfg_null_class=True),
    dict(learn_sigma=True, use_scale_shift_norm=True),
], ids=["emb", "film", "class_cond", "learned_sigma"])
def test_forward_matches_jax_f32(extra):
    cfg = dict(SMALL, **extra)
    x, t = _inputs(2, 8, 3)
    y = np.array([1, 5], np.int32) if "num_classes" in extra else None
    jm = jax_get_model(8, cfg)
    params = _random_flax_params(jm, jnp.asarray(x), jnp.asarray(t),
                                 None if y is None else jnp.asarray(y))
    ref = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x),
                                       jnp.asarray(t), None if y is None else jnp.asarray(y)))
    model = load_flax_params(get_model(8, cfg, device="cpu"), params)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t).long(),
                    None if y is None else torch.from_numpy(y).long()).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=5e-4, atol=5e-4)


def test_forward_matches_jax_bf16():
    """bfloat16 compute (float32 output head) through the same weights: the
    two frameworks round at other places, so the bound is bf16-sized."""
    cfg = dict(SMALL, compute_dtype="bfloat16")
    x, t = _inputs(2, 8, 3, seed=1)
    jm = jax_get_model(8, cfg)
    params = _random_flax_params(jm, jnp.asarray(x), jnp.asarray(t), seed=1)
    ref = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    model = load_flax_params(get_model(8, cfg, device="cpu"), params)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t).long())
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0.1, atol=0.1)


def test_downsample_pads_like_jax_same():
    """Stride-2 3x3 SAME pads (0, 1), not torch's (1, 1)."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    jconv = JaxConv(4, (3, 3), strides=(2, 2))
    params = jax.tree.map(
        lambda s: rng.randn(*s.shape).astype(np.float32),
        jax.eval_shape(jconv.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    ref = np.asarray(jconv.apply({"params": params}, jnp.asarray(x)))
    conv = Conv(4, 4, 3, stride=2)
    conv.load_state_dict({
        "weight": torch.from_numpy(np.asarray(params["conv"]["kernel"]).transpose(3, 2, 0, 1).copy()),
        "bias": torch.from_numpy(np.asarray(params["conv"]["bias"]).copy()),
    })
    with torch.no_grad():
        out = conv(torch.from_numpy(x)).numpy()
    assert out.shape == (2, 4, 4, 4)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_converter_names_leftover_keys():
    cfg = dict(SMALL)
    x, t = _inputs(1, 8, 3)
    params = _random_flax_params(jax_get_model(8, cfg), jnp.asarray(x), jnp.asarray(t))
    params = jax.tree.map(np.asarray, params)
    params["extra_block"] = {"dense": {"kernel": np.zeros((2, 2), np.float32)}}
    with pytest.raises(ValueError, match="extra_block"):
        load_flax_params(get_model(8, cfg, device="cpu"), params)
    del params["extra_block"]
    del params["out_norm"]
    with pytest.raises(ValueError, match="out_norm.weight"):
        load_flax_params(get_model(8, cfg, device="cpu"), params)
    with pytest.raises(KeyError, match="mystery"):
        params_from_flax({"mystery": {"kernel": np.zeros(3, np.float32)}})


def test_get_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card error cannot occur")
    with pytest.raises(RuntimeError, match="CUDA"):
        get_model(8, dict(SMALL))


def test_port_imports_nothing_of_jax():
    """No file of the port, nor chip_smoke.py, imports jax, flax or the
    JAX package."""
    banned = ("jax", "jaxlib", "flax", "probabilisticdeepdiffusionmodels_tpu")
    files = sorted((REPO / "probabilisticdeepdiffusionmodels_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path}: imports {name}"
