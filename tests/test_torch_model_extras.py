"""The port's model extras against the JAX package, with Flax weights carried
over by ``convert``: the SuperResModel and its bilinear resize, the 1-D and
3-D UNets, the dense model, ``use_checkpoint`` (the port's gradients equal
its plain model's bit for bit with dropout on, and JAX's remat gradients),
and every model config's parameter count against JAX's.  Forwards are held
at the 2-D UNet's tolerance (``test_torch_unet.py``: 5e-4)."""

import pathlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

pytest.importorskip("flax")

from probabilisticdeepdiffusionmodels_tpu.models import get_model as jax_get_model  # noqa: E402
from probabilisticdeepdiffusionmodels_torch.convert import (  # noqa: E402
    load_flax_params,
    params_from_flax,
)
from probabilisticdeepdiffusionmodels_torch.models import get_model, layers  # noqa: E402
from probabilisticdeepdiffusionmodels_torch.models.layers import bilinear_resize  # noqa: E402
from test_torch_unet import _count, _random_flax_params  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG_DIR = REPO / "probabilisticdeepdiffusionmodels_tpu" / "config" / "model"
FWD_TOL = 5e-4
# test_unet.py's unet_small_grey widths
SMALL_GREY = dict(name="unet", in_channels=1, model_channels=32, num_res_blocks=1,
                  attention_resolutions=[], channel_mult=[1, 2, 2], num_heads=1)
SMALL_GREY_RES = 16


def _apply(jm, params, *args):
    return np.asarray(jax.jit(jm.apply)({"params": params}, *map(jnp.asarray, args)))


def _port(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


# ------------------------------------------------------------- superres


@pytest.mark.parametrize("classes", [None, 5], ids=["plain", "class_cond"])
def test_superres_matches_jax(classes):
    """test_unet.py's superres inputs: x at 16x16, the low-res image at 8x8;
    a class-conditional model takes its labels by ``y=``."""
    cfg = dict(SMALL_GREY, name="superres", num_classes=classes)
    rng = np.random.RandomState(0)
    x = rng.randn(2, SMALL_GREY_RES, SMALL_GREY_RES, 1).astype(np.float32)
    low = rng.randn(2, SMALL_GREY_RES // 2, SMALL_GREY_RES // 2, 1).astype(np.float32)
    t = np.array([1, 2], np.int32)
    y = None if classes is None else np.array([0, 4], np.int32)
    jm = jax_get_model(SMALL_GREY_RES, cfg)
    args = (x, t, low) + (() if y is None else (y,))
    # the shapes of init with every argument (the helper passes three)
    shapes_of = SimpleNamespace(init=lambda key, *a: jm.init(key, *a, *args[3:]))
    params = _random_flax_params(shapes_of, *map(jnp.asarray, args[:3]))
    ref = _apply(jm, params, *args)
    model = load_flax_params(get_model(SMALL_GREY_RES, cfg, device="cpu"), params)
    assert all(k.startswith("unet.") for k in model.state_dict())
    xt, tt, lowt = _port((x, t, low))
    yt = None if y is None else torch.from_numpy(y).long()
    with torch.no_grad():
        out = model(xt, tt.long(), lowt, yt).numpy()
    assert out.shape == x.shape
    np.testing.assert_allclose(out, ref, rtol=FWD_TOL, atol=FWD_TOL)
    with pytest.raises(ValueError, match="low_res"):
        model(xt, tt.long())


@pytest.mark.parametrize("factor", [2, 4])
def test_bilinear_resize_matches_jax(factor):
    """Growing by 2 and 4: JAX's half-pixel bilinear weights, edges included."""
    low = np.random.RandomState(factor).randn(2, 5, 3, 2).astype(np.float32)
    size = (5 * factor, 3 * factor)
    want = np.asarray(jax.image.resize(jnp.asarray(low), (2, *size, 2), "bilinear"))
    got = bilinear_resize(torch.from_numpy(low), *size)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------- dims 1 and 3

# test_unet.py:216-239's shapes; the 64-channel FiLM cases keep GroupNorm's
# groups wider than one channel, so the embedding is not normalised away
_ND = {
    "1d": (1, (16,), dict(model_channels=8)),
    "3d": (3, (8, 8, 8), dict(model_channels=8)),
    "1d_film_c64": (1, (16,), dict(model_channels=64, use_scale_shift_norm=True)),
    "3d_c64_avgpool": (3, (4, 4, 4), dict(model_channels=64, conv_resample=False)),
}


def _nd_cfg(dims, spatial, extra):
    return dict(name="unet", in_channels=2, num_res_blocks=1,
                attention_resolutions=[spatial[0] // 2], channel_mult=[1, 2], num_heads=2,
                dims=dims, **extra)


@pytest.mark.parametrize("case", sorted(_ND))
def test_unet_nd_matches_jax(case):
    dims, spatial, extra = _ND[case]
    cfg = _nd_cfg(dims, spatial, extra)
    rng = np.random.RandomState(3)
    x = rng.randn(2, *spatial, 2).astype(np.float32)
    t = np.array([7, 500], np.int32)
    jm = jax_get_model(spatial[0], cfg)
    params = _random_flax_params(jm, jnp.asarray(x), jnp.asarray(t), seed=3)
    ref = _apply(jm, params, x, t)
    model = load_flax_params(get_model(spatial[0], cfg, device="cpu"), params)
    with torch.no_grad():
        out = model(*_port((x,)), torch.from_numpy(t).long()).numpy()
    assert out.shape == x.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=FWD_TOL, atol=FWD_TOL)


def test_nd_refusals():
    """JAX's errors: dims outside 1-3, and a super-resolution model off 2-D."""
    with pytest.raises(ValueError, match="dims"):
        get_model(8, dict(SMALL_GREY, dims=4), device="cpu")
    with pytest.raises(NotImplementedError, match="2-D"):
        get_model(8, dict(SMALL_GREY, name="superres", dims=3), device="cpu")


# ------------------------------------------------------------- dense


def test_dense_matches_jax():
    cfg = dict(name="dense", resolution=8, in_channels=1, num_hidden=[32, 16, 32],
               compute_dtype="bfloat16")  # dropped, as JAX drops it
    rng = np.random.RandomState(5)
    x = rng.randn(3, 8, 8, 1).astype(np.float32)
    t = np.array([1, 40, 999], np.int32)
    jm = jax_get_model(8, cfg)
    params = _random_flax_params(jm, jnp.asarray(x), jnp.asarray(t), seed=5)
    ref = _apply(jm, params, x, t)
    model = load_flax_params(get_model(8, cfg, device="cpu"), params)
    with torch.no_grad():
        out = model(*_port((x,)), torch.from_numpy(t).long())
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=FWD_TOL, atol=FWD_TOL)


# ------------------------------------------------------------- use_checkpoint

# test_unet.py:242-268's model
REMAT = dict(name="unet", in_channels=1, model_channels=16, num_res_blocks=1,
             attention_resolutions=[8], channel_mult=[1, 2], num_heads=1)


def _grads(model, x, t, seed=None):
    model.zero_grad(set_to_none=True)
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    loss = model(x, t, generator=gen).square().mean()
    loss.backward()
    return {k: p.grad.clone() for k, p in model.named_parameters()}, gen


@pytest.mark.parametrize("dims,spatial", [(2, (8, 8)), (1, (16,)), (3, (4, 4, 4))],
                         ids=["2d", "1d", "3d"])
def test_checkpoint_grads_equal_plain_with_dropout(dims, spatial):
    """Train mode, dropout 0.3, the masks from a generator: the checkpointed
    model's gradients and the generator's state after the step equal the
    plain model's bit for bit (the recompute reads the masks drawn for the
    first forward), and the masks were drawn (the generator moved)."""
    cfg = dict(REMAT, dims=dims, dropout=0.3, attention_resolutions=[spatial[0] // 2])
    plain = get_model(spatial[0], cfg, device="cpu", seed=1)
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for p in plain.parameters():  # no zero-init output: every gradient non-zero
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    remat = get_model(spatial[0], dict(cfg, use_checkpoint=True), device="cpu", seed=1)
    remat.load_state_dict(plain.state_dict())
    x = torch.randn(2, *spatial, 1, generator=gen)
    t = torch.tensor([1, 9])
    want, gen_p = _grads(plain.train(), x, t, seed=3)
    got, gen_r = _grads(remat.train(), x, t, seed=3)
    assert torch.equal(gen_p.get_state(), gen_r.get_state())
    assert not torch.equal(gen_r.get_state(), torch.Generator().manual_seed(3).get_state())
    for k, w in want.items():
        assert torch.equal(got[k], w), k
        assert w.abs().max() > 0, k


def test_checkpoint_grads_match_jax_remat():
    """The checkpointed port model's gradients against JAX's ``nn.remat``
    model's, test_unet.py's model and tolerance (rtol 1e-5, atol 1e-7) on
    random weights (JAX's test draws its init, whose zero-init head makes
    every gradient zero) and seeded inputs."""
    cfg = dict(REMAT, use_checkpoint=True, channel_mult=[1])  # one level: a short compile
    rng = np.random.RandomState(6)
    x = rng.randn(2, 8, 8, 1).astype(np.float32)
    t = np.array([1, 9], np.int32)
    jr = jax_get_model(8, cfg)
    params = _random_flax_params(jr, jnp.asarray(x), jnp.asarray(t), seed=6)

    def loss(p):
        return jnp.mean(jnp.square(jr.apply({"params": p}, jnp.asarray(x), jnp.asarray(t))))

    want = params_from_flax(jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(params)))
    model = load_flax_params(get_model(8, cfg, device="cpu"), params)
    got, _ = _grads(model.train(), torch.from_numpy(x), torch.from_numpy(t).long())
    assert set(got) == set(want)
    assert max(float(w.abs().max()) for w in want.values()) > 0.1
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-5, atol=1e-7, err_msg=k)


# ------------------------------------------------------------- parameter counts

_COUNTS = [("unet", 32), ("unet_grey", 32), ("unet_small", 32), ("unet_small_grey", 28),
           ("unet_celeba", 64), ("unet_celebahq", 256), ("unet_celebahq64", 64), ("dense", 32)]


@pytest.mark.parametrize("config,resolution", _COUNTS + [("superres:unet", 32)],
                         ids=[c for c, _ in _COUNTS] + ["superres_of_unet"])
def test_param_count_matches_jax(config, resolution, monkeypatch):
    """Every model config's parameter count against JAX's, from
    ``jax.eval_shape`` of its init; the port's weights are not drawn either
    (the count does not depend on them)."""
    monkeypatch.setattr(layers, "_uniform_", lambda p, fan_in, generator: None)
    name, _, base = config.rpartition(":")
    cfg = yaml.safe_load((CONFIG_DIR / f"{base}.yaml").read_text())
    if name:
        cfg["name"] = name
    jm = jax_get_model(resolution, cfg)
    side = cfg.get("resolution", resolution)
    x = jnp.zeros((1, side, side, cfg["in_channels"]))
    args = (x, jnp.ones((1,), jnp.int32))
    if name == "superres":
        args += (jnp.zeros((1, side // 2, side // 2, cfg["in_channels"])),)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args)["params"]
    model = get_model(resolution, cfg, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == _count(shapes)
