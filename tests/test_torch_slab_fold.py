"""The spatially sharded forward's fold, moved into the kernels that consume
it: ``gn_fold_apply`` (the slab's GroupNorm: fold + apply) and
``gn_silu_conv3x3_fold`` (the fused conv folding the ranks' summed
statistics itself), fed by ``spatial.total`` (the ranks' moments summed in
place, no copy and no divide).  On the CPU the wrappers run their plain
versions: the fold (``gn_fold_plain`` of ``moments / ranks``), then the
apply or ``gn_silu_conv3x3_plain``.

Tolerances:

  * the plain versions on whole images (one rank: ``total`` the identity)
    and on an image cut into two slabs whose moments are summed by hand
    (two ranks), against JAX's ``gn_affine`` followed by
    ``gn_silu_conv3x3_xla`` and against ``group_norm_silu_xla``: 1e-5 of
    the largest output element (float32; XLA and torch sum in other
    orders), (a, off) 1e-5 relative;
  * the summed-then-divided mean against ``spatial.average``: bit for bit,
    and so the fold and the normalised output;
  * a one-rank slab forward of a small UNet (the collectives of a world of
    one) against its unsharded forward: 1e-5 of the largest output.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probabilisticdeepdiffusionmodels_tpu.ops.gn_conv_pallas import (
    gn_affine as jax_gn_affine,
    gn_silu_conv3x3_xla,
)
from probabilisticdeepdiffusionmodels_tpu.ops.groupnorm_pallas import group_norm_silu_xla
from probabilisticdeepdiffusionmodels_torch.models import get_model
from probabilisticdeepdiffusionmodels_torch.ops import gn_conv as _gc
from probabilisticdeepdiffusionmodels_torch.ops import groupnorm as _gn
from probabilisticdeepdiffusionmodels_torch.parallel import spatial
from test_torch_threads import one_torch_thread  # noqa: E402,F401

TOL = 1e-5
MODES = ["plain", "emb", "film"]
# (channels, groups): the CIFAR UNet's 2 a group, unet_celebahq64's 384 in 12s
WIDTHS = [(64, 32), (384, 32)]


def _inputs(seed, b, h, w, c, cout=8):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.normal(0.5, 1.5, size=(b, h, w, c)).astype(np.float32),
        gamma=(1.0 + 0.1 * rng.normal(size=c)).astype(np.float32),
        beta=(0.1 * rng.normal(size=c)).astype(np.float32),
        conds=[(0.3 * rng.normal(size=(b, c))).astype(np.float32) for _ in range(2)],
        w=(rng.normal(size=(3, 3, c, cout)) / (3 * np.sqrt(c))).astype(np.float32),  # HWIO
        bias=(0.1 * rng.normal(size=cout)).astype(np.float32))


def _cond(mode, conds, t=torch.as_tensor):
    return {"plain": {}, "emb": {"emb": t(conds[0])},
            "film": {"film": (t(conds[0]), t(conds[1]))}}[mode]


def _slab_moments(x, ranks):
    """The moments of ``x`` cut into ``ranks`` slabs along the height, each
    slab's E[x], E[x^2] summed (rank order) as the all-reduce sums them."""
    parts = [_gn.moments_plain(s) for s in torch.chunk(x, ranks, dim=1)]
    out = parts[0].clone()
    for p in parts[1:]:
        out += p
    return out


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=TOL * float(np.abs(want).max()), err_msg=what)


@pytest.mark.parametrize("ranks", [1, 2])
@pytest.mark.parametrize("width", WIDTHS, ids=["64", "384"])
@pytest.mark.parametrize("mode", MODES)
def test_fold_conv_plain_matches_jax(mode, width, ranks):
    """The folding conv's plain version (``gn_fold_plain`` of the ranks'
    mean, then ``gn_silu_conv3x3_plain``) against JAX's ``gn_affine`` and
    ``gn_silu_conv3x3_xla`` on the whole image: 1e-5."""
    c, groups = width
    d = _inputs(c + ranks, 2, 8, 8, c)
    x = torch.as_tensor(d["x"])
    gamma, beta = torch.as_tensor(d["gamma"]), torch.as_tensor(d["beta"])
    w = torch.as_tensor(d["w"]).permute(0, 1, 3, 2).contiguous()  # HWOI
    mom = _slab_moments(x, ranks)
    got = _gc.gn_silu_conv3x3_fold(x, mom, ranks, gamma, beta, groups, 1e-5, w,
                                   torch.as_tensor(d["bias"]), **_cond(mode, d["conds"]))
    jkw = _cond(mode, d["conds"], jnp.asarray)
    want = gn_silu_conv3x3_xla(jnp.asarray(d["x"]), jnp.asarray(d["gamma"]),
                               jnp.asarray(d["beta"]), jnp.asarray(d["w"]),
                               jnp.asarray(d["bias"]), num_groups=groups, eps=1e-5, **jkw)
    _close(got, want, "conv")
    # the fold it runs, against JAX's gn_affine
    ao = _gn.gn_fold_plain(mom / ranks, gamma, beta, groups, 1e-5, **_cond(mode, d["conds"]))
    a, off = jax_gn_affine(jnp.asarray(d["x"]), jnp.asarray(d["gamma"]), jnp.asarray(d["beta"]),
                           groups, 1e-5, **jkw)
    np.testing.assert_allclose(ao[0].numpy(), np.asarray(a), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ao[1].numpy(), np.asarray(off), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("ranks", [1, 2])
@pytest.mark.parametrize("width", WIDTHS, ids=["64", "384"])
@pytest.mark.parametrize("silu", [True, False], ids=["silu", "none"])
def test_fold_apply_plain_matches_jax(silu, width, ranks):
    """The slab GroupNorm's fold + apply, plain, against
    ``group_norm_silu_xla`` on the whole image: 1e-5."""
    c, groups = width
    d = _inputs(2 * c + ranks, 2, 8, 8, c)
    x = torch.as_tensor(d["x"])
    gamma, beta = torch.as_tensor(d["gamma"]), torch.as_tensor(d["beta"])
    got = _gn.gn_fold_apply(x, _slab_moments(x, ranks), ranks, gamma, beta, groups, 1e-5, silu)
    want = group_norm_silu_xla(jnp.asarray(d["x"]), jnp.asarray(d["gamma"]),
                               jnp.asarray(d["beta"]), groups, 1e-5, silu)
    _close(got, want, "fold + apply")
    # the apply of the fold gn_fold gives for the ranks' mean, to the bit
    ao = _gn.gn_fold(_slab_moments(x, ranks) / ranks, gamma, beta, groups, 1e-5)
    torch.testing.assert_close(got, _gn._apply_plain(x, ao, silu), rtol=0, atol=0)


@contextlib.contextmanager
def _two_rank_sum(monkeypatch, other):
    """``spatial``'s all-reduce as rank 0 of two sees it: ``other`` (rank
    1's moments) added in place; no ranks are spawned."""
    def all_reduce(t, group=None):
        t += other

    monkeypatch.setattr(spatial.dist, "all_reduce", all_reduce)
    yield spatial.Rows(0, 2, None)


@pytest.mark.parametrize("mode", MODES)
def test_summed_then_divided_is_average_bit_for_bit(monkeypatch, mode):
    """Two slabs of one image: ``spatial.total`` (the sum in place) then the
    divide by the rank count inside the fold give ``spatial.average``'s
    mean, the fold and the normalised output bit for bit."""
    d = _inputs(7, 2, 8, 8, 64)
    x = torch.as_tensor(d["x"])
    gamma, beta = torch.as_tensor(d["gamma"]), torch.as_tensor(d["beta"])
    top, bottom = torch.chunk(x, 2, dim=1)
    mine, other = _gn.moments_plain(top), _gn.moments_plain(bottom)
    with _two_rank_sum(monkeypatch, other) as r:
        averaged = spatial.average(mine, r)
        summed = spatial.total(mine.clone(), r)
        kw = _cond(mode, d["conds"])
        torch.testing.assert_close(summed / r.count, averaged, rtol=0, atol=0)
        assert summed.data_ptr() != mine.data_ptr()
        # the fold of the mean, and the slab GroupNorm's output, as before
        torch.testing.assert_close(_gn.gn_fold_plain(summed / 2, gamma, beta, 32, 1e-5, **kw),
                                   _gn.gn_fold_plain(averaged, gamma, beta, 32, 1e-5, **kw),
                                   rtol=0, atol=0)
        before = _gn._apply_plain(top, _gn.gn_fold_plain(averaged, gamma, beta, 32, 1e-5), True)
        got = _gn.group_norm_silu_slab(top, gamma, beta, 32, 1e-5, True,
                                       lambda m: spatial.total(m, r), r.count)
        torch.testing.assert_close(got, before, rtol=0, atol=0)
        # the conv fed gn_fold's (a, off) of the mean, and the folding conv
        w = torch.as_tensor(d["w"]).permute(0, 1, 3, 2).contiguous()
        bias = torch.as_tensor(d["bias"])
        ao = _gn.gn_fold(averaged, gamma, beta, 32, 1e-5, **kw)
        torch.testing.assert_close(
            _gc.gn_silu_conv3x3_fold(top, summed, 2, gamma, beta, 32, 1e-5, w, bias, **kw),
            _gc.gn_silu_conv3x3(top, ao[0], ao[1], w, bias), rtol=0, atol=0)


def test_slab_convs_cover_the_whole_conv():
    """Two slabs with their halo rows, each folding the summed moments in
    the conv: the rows they keep are the whole image's fused conv."""
    d = _inputs(9, 2, 8, 6, 64, cout=16)
    x = torch.as_tensor(d["x"])
    gamma, beta = torch.as_tensor(d["gamma"]), torch.as_tensor(d["beta"])
    emb = torch.as_tensor(d["conds"][0])
    w = torch.as_tensor(d["w"]).permute(0, 1, 3, 2).contiguous()
    bias = torch.as_tensor(d["bias"])
    a, off = _gc.gn_affine_plain(x, gamma, beta, 32, 1e-5, emb=emb)
    want = _gc.gn_silu_conv3x3_plain(x, a, off, w, bias)
    mom = _slab_moments(x, 2)
    halves = [x[:, :5], x[:, 3:]]  # rows 0-3 with row 4 below, rows 4-7 with row 3 above
    got = [_gc.gn_silu_conv3x3_fold(s, mom, 2, gamma, beta, 32, 1e-5, w, bias, emb=emb)
           for s in halves]
    _close(torch.cat([got[0][:, :4], got[1][:, 1:]], dim=1), want, "slabs")


def test_moments_slab_sums_in_place():
    """``gn_moments_slab``'s plain version: the moments of the rows, then
    ``total`` on them (here doubling in place, as a sum over two equal
    ranks would)."""
    x = torch.as_tensor(_inputs(3, 2, 4, 4, 64)["x"])

    def total(m):
        m += m
        return m

    got = _gc.gn_moments_slab(x, torch.ones(64), torch.zeros(64), 32, 1e-5, total)
    torch.testing.assert_close(got, 2 * _gn.moments_plain(x), rtol=0, atol=0)


def test_conv_design_counts_the_fold():
    """The folding head keeps (a, off) and the groups' statistics in shared
    memory too: ``conv_design`` still takes narrow_f32 at the CIFAR head
    and the 256-wide rows, and the C entry point's lengths of a FiLM half
    reach the end of its (B, 2C) storage."""
    x = torch.zeros(1, 32, 32, 128)
    w = torch.zeros(3, 3, 3, 128)
    assert _gc.conv_design(x, w, 32) == _gc.conv_design(x, w) == "narrow_f32"
    xr = torch.zeros(1, 130, 256, 128)
    assert _gc.conv_design(xr, w, 32) == "narrow_f32"
    film = torch.zeros(4, 256).chunk(2, dim=1)
    assert [_gc._elements_from(t) for t in film] == [4 * 256, 4 * 256 - 128]


SMALL_UNET = dict(name="unet", in_channels=3, model_channels=32, num_res_blocks=1,
                  attention_resolutions=[8], channel_mult=[1, 2], num_heads=2,
                  use_scale_shift_norm=True)


def small_unet(device, dtype="float32"):
    model = get_model(16, dict(SMALL_UNET, compute_dtype=dtype), device=device, seed=0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():  # the zero-initialised convs too
            p.add_((0.05 * torch.randn(p.shape, generator=gen)).to(p.device, p.dtype))
    return model


def test_one_rank_slab_forward_is_the_forward():
    """A small UNet (FiLM, attention at 8x8) through the slab path on a world
    of one rank (moments, the sum, the folding conv and fold + apply)
    against its plain forward: 1e-5 of the largest output."""
    model = small_unet("cpu")
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(2, 16, 16, 3, generator=gen)
    t = torch.tensor([10, 700])
    with torch.no_grad():
        want = model(x, t)
        with spatial.one_rank():
            got = model(x, t)
    _close(got, want, "slab forward")
