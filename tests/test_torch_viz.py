"""The port's visualization suite against the JAX package: the engine's five
visualization endpoints on converted weights (JAX's own draws injected), the
four views' tiles (a stub engine drives both callbacks; the JAX ``_grid``
records each tile), the composed image and its PNG, and the detailed panels
of ``cli.sample``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# The JAX engine needs Flax and optax, and the JAX hooks matplotlib; where
# they are missing (a machine set up for the card) the module skips.
pytest.importorskip("flax")
pytest.importorskip("optax")
pytest.importorskip("matplotlib")

from probabilisticdeepdiffusionmodels_tpu.engine import (  # noqa: E402
    DiffusionEngine as JaxEngine,
)
from probabilisticdeepdiffusionmodels_tpu.viz import hooks as jax_hooks  # noqa: E402
from probabilisticdeepdiffusionmodels_torch.cli import sample as cli_sample  # noqa: E402
from probabilisticdeepdiffusionmodels_torch.convert import load_flax_params  # noqa: E402
from probabilisticdeepdiffusionmodels_torch.engine import DiffusionEngine  # noqa: E402
from probabilisticdeepdiffusionmodels_torch.viz import (  # noqa: E402
    VisualizationCallback,
    compose,
    curve_tile,
    tile_origin,
    write_png,
)
from probabilisticdeepdiffusionmodels_torch.viz import image as viz_image  # noqa: E402
from test_torch_unet import SMALL, _random_flax_params  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401

T = 6
RES = 8
# one level, attention at full resolution, a learned-sigma head: the JAX
# scans compile fast, and the sampled chains take the learned variance
CFG = dict(SMALL, channel_mult=[1], attention_resolutions=[8], use_scale_shift_norm=True)
# a linear ramp to 0.2: at the cosine schedule's t = T (alpha-bar ~1e-4)
# the clipped x0 magnifies the UNets' float32 differences by 1/sqrt(ab_T)
ENGINE_KW = dict(diffusion_steps=T, mode="linear", beta_start=1e-4, beta_end=0.2,
                 resolution=RES, loss_type="hybrid", sigma_mode="beta_tilde",
                 clip_while_generating=True, ema=0.9)
# the two UNets sum in other orders; a chain of at most T steps (as
# test_torch_sampler.py's UNet chain)
TOL = 1e-4


@pytest.fixture(scope="module")
def engines():
    """The JAX engine and the port's, both with the same random Flax weights
    as their live and EMA parameters."""
    jengine = JaxEngine(dict(CFG), {"lr": 2e-4}, **ENGINE_KW)
    x = jnp.zeros((1, RES, RES, 3))
    params = _random_flax_params(jengine.model, x, jnp.ones((1,), jnp.int32), seed=30)
    jengine.state = jengine.state.replace(params=params, ema_params=params)
    engine = DiffusionEngine(dict(CFG), {"lr": 2e-4}, device="cpu", **ENGINE_KW)
    load_flax_params(engine.state.model, params)
    load_flax_params(engine.state.ema_model, params)
    return jengine, engine


def _images(n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, size=(n, RES, RES, 3)) / 127.5 - 1.0).astype(np.float32)


def _chain_noise(key, t_start, shape):
    """The JAX loop's z stack: z_t = normal(fold_in(key, t)), t = t_start..1."""
    return np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, t), shape))
                     for t in range(t_start, 0, -1)])


def _close(got, want):
    got = got.numpy() if hasattr(got, "numpy") else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


# ------------------------------------------------------------- endpoints


def test_sample_from_step_matches_jax(engines):
    """From x_t at t = 4: the mean chain, and the sampled chain on JAX's z."""
    jengine, engine = engines
    x_t = np.random.RandomState(31).randn(3, RES, RES, 3).astype(np.float32)
    _close(engine.sample_from_step(x_t, 4, mean_only=True),
           jengine.sample_from_step(x_t, 4, mean_only=True))
    z = _chain_noise(jax.random.PRNGKey(7), 4, x_t.shape)
    _close(engine.sample_from_step(x_t, 4, noise=z), jengine.sample_from_step(x_t, 4, seed=7))


def test_sample_and_return_steps_matches_jax(engines):
    """The recorded steps [B, STEPS, H, W, C] in descending t, and the std
    trace [t_start + 1]."""
    jengine, engine = engines
    x_t = np.random.RandomState(32).randn(2, RES, RES, 3).astype(np.float32)
    steps, stds = engine.sample_and_return_steps(x_t, None, (1, 4, 2), mean_only=True,
                                                 return_stds=True)
    jsteps, jstds = jengine.sample_and_return_steps(x_t, None, (1, 4, 2), mean_only=True,
                                                    return_stds=True)
    assert steps.shape == (2, 3, RES, RES, 3) and stds.shape == (T + 1,)
    _close(steps, jsteps)
    _close(stds, jstds)
    # without stds, the steps alone
    assert engine.sample_and_return_steps(x_t, 3, (1,), mean_only=True).shape == (2, 1, RES,
                                                                                    RES, 3)


def test_generate_images_grid_matches_jax(engines):
    """Chunks of 2 for n = 3: JAX's starting noise (split per chunk)
    injected, the mean chain of each, truncated to n."""
    jengine, engine = engines
    jnoise, jsteps = jengine.generate_images_grid((4, 1), n=3, minibatch=2, mean_only=True,
                                                  seed=5, use_ema=False)
    noise, steps = engine.generate_images_grid((4, 1), n=3, minibatch=2, mean_only=True,
                                               use_ema=False, x_T=jnoise)
    assert isinstance(steps, np.ndarray) and steps.shape == (3, 2, RES, RES, 3)
    np.testing.assert_array_equal(noise, jnoise)
    _close(steps, jsteps)
    # drawn: each chunk's x_T from the seeded generator, then its steps' z
    drawn, _ = engine.generate_images_grid((1,), n=3, minibatch=2, seed=5)
    gen = torch.Generator().manual_seed(5)
    first = torch.randn((2, RES, RES, 3), generator=gen)
    np.testing.assert_array_equal(drawn[:2], first.numpy())


def test_diffuse_and_reconstruct_matches_jax(engines):
    """x0 noised to t = 4 and the sampled chain back, on JAX's split keys."""
    jengine, engine = engines
    x0 = _images(2, 33)
    knoise, kloop = jax.random.split(jax.random.PRNGKey(2))
    q = np.asarray(jax.random.normal(knoise, x0.shape))
    recon, x_t = engine.diffuse_and_reconstruct(x0, 4, q_noise=q,
                                                noise=_chain_noise(kloop, 4, x0.shape))
    jrecon, jx_t = jengine.diffuse_and_reconstruct(x0, 4, seed=2)
    _close(x_t, jx_t)
    _close(recon, jrecon)


def test_diffuse_and_reconstruct_grid_matches_jax(engines):
    """((steps, stds), x_t) from t = 5, sampled and mean chains."""
    jengine, engine = engines
    x0 = _images(1, 34)
    knoise, kloop = jax.random.split(jax.random.PRNGKey(3))
    q = np.asarray(jax.random.normal(knoise, x0.shape))
    (steps, stds), x_t = engine.diffuse_and_reconstruct_grid(
        x0, 5, (3, 1), return_stds=True, q_noise=q, noise=_chain_noise(kloop, 5, x0.shape))
    (jsteps, jstds), jx_t = jengine.diffuse_and_reconstruct_grid(x0, 5, (3, 1), seed=3,
                                                                 return_stds=True)
    assert steps.shape == (1, 2, RES, RES, 3) and stds.shape == (6,)
    _close(x_t, jx_t)
    _close(steps, jsteps)
    _close(stds, jstds)
    msteps, _ = engine.diffuse_and_reconstruct_grid(x0, 5, (3, 1), mean_only=True, q_noise=q)
    jmsteps, _ = jengine.diffuse_and_reconstruct_grid(x0, 5, (3, 1), mean_only=True, seed=3)
    _close(msteps, jmsteps)


# ------------------------------------------------------------- the views


class StubEngine:
    """Deterministic numpy in and out, the endpoints' signatures of both
    engines; values run past [-1, 1] so clipping shows."""

    diffusion_steps = 12

    def __init__(self, channels):
        self.c = channels

    def generate_images_grid(self, steps_to_return, n=1, minibatch=4, mean_only=False,
                             seed=None, use_ema=True):
        noise = 1.5 * np.random.RandomState(seed or 0).randn(n, RES, RES, self.c)
        steps = np.stack([np.tanh(noise * (1.0 + 0.1 * t)) * 1.3 for t in steps_to_return], 1)
        return noise.astype(np.float32), steps.astype(np.float32)

    def get_noised_representation(self, x0, t, seed=None):
        rng = np.random.RandomState(seed or 0)
        return (x0 * (1 - t / 12) + rng.randn(*x0.shape)).astype(np.float32)

    def sample_from_step(self, x_t, t_start, mean_only=False, seed=None, use_ema=True):
        return np.tanh(np.asarray(x_t) * 0.9 + 0.01 * (seed or 0)) * 1.2

    def diffuse_and_reconstruct(self, x0, t=None, seed=None, use_ema=True):
        return np.tanh(x0 + 0.05 * t + 0.01 * (seed or 0)) * 1.1, None

    def diffuse_and_reconstruct_grid(self, x0, t_start=None, steps_to_return=(1,), seed=None,
                                     mean_only=False, return_stds=False, use_ema=True):
        steps = np.stack([np.tanh(x0 * (0.5 + 0.1 * t)) for t in steps_to_return], 1)
        stds = np.linspace(1.0, 0.4, t_start + 1) ** 2
        return (steps, stds), None


def _jax_tiles(monkeypatch, view, channels, normalize):
    """Run one JAX view on the stub: {(row, col): (tile, border)} and the name."""
    tiles, saved = {}, []

    def record(ax, img, border_color=None):
        spec = ax.get_subplotspec()
        tiles[(spec.rowspan.start, spec.colspan.start)] = (np.array(img), border_color)

    def save(self, fig, name):
        jax_hooks.plt.close(fig)
        saved.append(name)

    monkeypatch.setattr(jax_hooks, "_grid", record)
    monkeypatch.setattr(jax_hooks.VisualizationCallback, "_save", save)
    cb = jax_hooks.VisualizationCallback(_val(channels), ts=[1, 3, 7, 11], media_dir=".",
                                         normalize=normalize, n_interpolation_steps=3,
                                         n_interpolation_pairs=2)
    getattr(cb, view)(StubEngine(channels), "epoch4")
    return tiles, saved[0]


def _val(channels):
    rng = np.random.RandomState(35)
    return rng.uniform(-1.2, 1.2, size=(6, RES, RES, channels)).astype(np.float32)


_VIEWS = ["visualize_random_grid", "visualize_interpolation", "visualize_reconstructions_grid",
          "visualize_single_reconstructions"]


@pytest.mark.parametrize("channels,normalize", [(3, "cifar"), (1, "mnist")], ids=["rgb", "grey"])
@pytest.mark.parametrize("view", _VIEWS)
def test_view_tiles_equal_jax(view, channels, normalize, monkeypatch, tmp_path):
    """Every tile the JAX view draws sits, exactly (in the image's float32),
    at the same row and column of the port's image, inside a red or green frame where JAX draws
    one and a white one elsewhere; the same file name.  The single
    reconstruction's last tile is the std curve."""
    tiles, jname = _jax_tiles(monkeypatch, view, channels, normalize)
    saved = []
    monkeypatch.setattr(VisualizationCallback, "_save",
                        lambda self, v, name: saved.append((v, name)))
    cb = VisualizationCallback(_val(channels), ts=[1, 3, 7, 11], media_dir=tmp_path,
                               normalize=normalize, n_interpolation_steps=3,
                               n_interpolation_pairs=2)
    getattr(cb, view)(StubEngine(channels), "epoch4")
    (image, name), = saved
    assert name == jname
    rows = 1 + max(r for r, _ in tiles)
    cols = 1 + max(c for _, c in tiles) + (view == "visualize_single_reconstructions")
    b, pad = viz_image.BORDER, viz_image.PAD
    assert image.shape == (rows * (RES + 2 * b + pad) - pad, cols * (RES + 2 * b + pad) - pad, 3)
    colors = {None: (1.0, 1.0, 1.0), **viz_image.COLORS}
    for (r, c), (tile, border) in tiles.items():
        y, x = tile_origin(r, c, RES, RES)
        np.testing.assert_array_equal(image[y:y + RES, x:x + RES],
                                      np.broadcast_to(tile.astype(np.float32), (RES, RES, 3)))
        frame = image[y - b:y + RES + b, x - b:x + RES + b].copy()
        frame[b:-b, b:-b] = colors[border]
        assert (frame == np.asarray(colors[border], np.float32)).all(), (r, c, border)
    if view == "visualize_single_reconstructions":
        y, x = tile_origin(0, cols - 1, RES, RES)
        assert (image[y:y + RES, x:x + RES] == np.asarray(viz_image.CURVE, np.float32)).all(
            -1).sum() >= RES


def test_callback_writes_its_views_and_logs_them(tmp_path):
    """The four files of a pass (``final`` for epoch -1), decoded to their
    RGB pixels, each mirrored through the logger under its name's stem."""
    import zlib

    logged = []

    class Logger:
        def log_image(self, name, path):
            logged.append((name, path.name))

    cb = VisualizationCallback(_val(1), ts=[1, 3, 7, 11], media_dir=tmp_path,
                               normalize="mnist", logger=Logger())
    paths = cb(StubEngine(1), -1)
    assert [p.name for p in paths] == ["random_grid_final.png", "interpolation_t6_final.png",
                                       "reconstructions_final.png",
                                       "single_recon_std_final.png"]
    assert logged == [("random_grid", "random_grid_final.png"),
                      ("interpolation_t6", "interpolation_t6_final.png"),
                      ("reconstructions", "reconstructions_final.png"),
                      ("single_recon_std", "single_recon_std_final.png")]
    data = paths[0].read_bytes()
    w, h = int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24], "big")
    assert data[25] == 2  # RGB
    length = int.from_bytes(data[33:37], "big")
    assert len(zlib.decompress(data[41:41 + length])) == h * (1 + 3 * w)


def test_compose_and_curve():
    """Frames sit outside the tiles, a grey tile fills three channels, and
    the curve runs from the top left (the largest value) down to the right."""
    grey = np.full((4, 5, 1), 0.25, np.float32)
    view = compose([[(grey, "green"), (grey, None)], [(grey, None), (grey, "red")]])
    assert view.shape == (2 * (4 + 6 + 2) - 2, 2 * (5 + 6 + 2) - 2, 3)
    y, x = tile_origin(1, 1, 4, 5)
    assert (view[y:y + 4, x:x + 5] == 0.25).all()
    assert (view[y - 3:y, x] == (1.0, 0.0, 0.0)).all()
    assert (view[tile_origin(0, 0, 4, 5)[0] - 1, 1] == (0.0, 1.0, 0.0)).all()
    curve = curve_tile(np.linspace(2.0, 1.0, 9), 16, 16)
    blue = (curve == np.asarray(viz_image.CURVE, np.float32)).all(-1)
    assert blue[0, 1] and blue[14, 15] and not blue[14, 1]
    flat = curve_tile(np.ones(4), 8, 8)
    assert (flat == np.asarray(viz_image.CURVE, np.float32)).all(-1).any()


def test_detailed_viz_panels(tmp_path, monkeypatch):
    """Four panels, t0 in (T, 0.9T, 0.8T, 0.5T); columns x0, then the
    sampled chain twice without and twice with x0 clipping (as JAX's
    panels, which never pass ``mean_only``), each seeded t0; the engine's
    clipping restored."""
    engine = StubEngine(3)
    seen = []

    def recon(x0, t=None, seed=None, use_ema=True):
        seen.append((t, seed, engine.clip_while_generating))
        return torch.as_tensor(np.full(x0.shape, 0.2 * len(seen) - 1.0, np.float32)), None

    engine.clip_while_generating = "unchanged"
    engine.diffuse_and_reconstruct = recon
    val = _val(3)
    monkeypatch.setattr(cli_sample, "build_loaders", lambda cfg: (None, [(val, None)]))
    written = {}
    monkeypatch.setattr(cli_sample, "write_png",
                        lambda path, v, pad=2: written.setdefault(path.name, v))
    paths = cli_sample.run_detailed_viz(engine, {}, tmp_path, "oneone", n_images=2)
    assert [p.name for p in paths] == [f"detailed_t0_{t}.png" for t in (12, 10, 9, 6)]
    assert seen[:4] == [(12, 12, False), (12, 12, False), (12, 12, True), (12, 12, True)]
    assert engine.clip_while_generating == "unchanged"
    view = written["detailed_t0_12.png"][0]
    for col, k in enumerate(range(1, 5), start=1):
        y, x = tile_origin(1, col, RES, RES)
        np.testing.assert_allclose(view[y, x], 0.5 * (0.2 * k - 1.0) + 0.5, rtol=1e-6)
    y, x = tile_origin(0, 0, RES, RES)
    np.testing.assert_allclose(view[y:y + RES, x:x + RES],
                               np.clip(0.5 * val[0] + 0.5, 0, 1), rtol=1e-6)


def test_detailed_viz_panels_equal_jax(engines, tmp_path, monkeypatch):
    """The port's detailed panel at t0 = T against JAX's ``run_detailed_viz``
    on the same weights and val images, JAX's draws for the seed t0
    injected: every tile of its five columns.  Columns 1 and 2 hold the
    same unclipped chain, 3 and 4 the same clipped one.  The other panels
    differ only in t0 (``test_detailed_viz_panels``); both engines return
    zeros there, which keeps JAX to two compiled chains."""
    import matplotlib.figure

    from probabilisticdeepdiffusionmodels_tpu.cli import sample as jax_cli_sample

    jengine, engine = engines
    val = _images(2, 36)
    tiles = {}

    def record(ax, img, border_color=None):
        spec = ax.get_subplotspec()
        tiles.setdefault(len(saved), {})[(spec.rowspan.start, spec.colspan.start)] = \
            np.array(img)

    saved = []
    monkeypatch.setattr(jax_cli_sample, "_grid", record)
    monkeypatch.setattr(jax_cli_sample, "build_loaders", lambda cfg: (None, [(val, None)]))
    monkeypatch.setattr(matplotlib.figure.Figure, "savefig",
                        lambda fig, path, **kw: saved.append(path.name))
    jax_original = jengine.diffuse_and_reconstruct

    def jax_panel(x0, t=None, seed=None, use_ema=True):
        if t != T:
            return np.zeros(np.shape(x0), np.float32), None
        return jax_original(x0, t, seed=seed, use_ema=use_ema)

    monkeypatch.setattr(jengine, "diffuse_and_reconstruct", jax_panel)
    jax_cli_sample.run_detailed_viz(jengine, {}, tmp_path, "oneone", n_images=2)

    original = engine.diffuse_and_reconstruct

    def with_jax_draws(x0, t=None, seed=None, use_ema=True):
        if t != T:
            return torch.zeros(np.shape(x0)), None
        knoise, kloop = jax.random.split(jax.random.PRNGKey(seed))
        q = np.asarray(jax.random.normal(knoise, np.shape(x0)))
        return original(x0, t, use_ema=use_ema, q_noise=q,
                        noise=_chain_noise(kloop, t, np.shape(x0)))

    monkeypatch.setattr(engine, "diffuse_and_reconstruct", with_jax_draws)
    monkeypatch.setattr(cli_sample, "build_loaders", lambda cfg: (None, [(val, None)]))
    written = {}
    monkeypatch.setattr(cli_sample, "write_png",
                        lambda path, v, pad=2: written.setdefault(path.name, v))
    paths = cli_sample.run_detailed_viz(engine, {}, tmp_path, "oneone", n_images=2)
    assert [p.name for p in paths] == saved == [f"detailed_t0_{t}.png" for t in (6, 5, 4, 3)]
    view = written[saved[0]][0]
    assert len(tiles[0]) == 2 * 5
    for (row, col), tile in tiles[0].items():
        y, x = tile_origin(row, col, RES, RES)
        _close(view[y:y + RES, x:x + RES], np.broadcast_to(tile, (RES, RES, 3)))
    for a, b in ((1, 2), (3, 4)):
        (ya, xa), (yb, xb) = tile_origin(0, a, RES, RES), tile_origin(0, b, RES, RES)
        np.testing.assert_array_equal(view[ya:ya + RES, xa:xa + RES],
                                      view[yb:yb + RES, xb:xb + RES])


def test_write_png_is_importable_from_the_sample_cli():
    assert cli_sample.write_png is write_png
