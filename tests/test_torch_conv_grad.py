"""The gradient of the fused GN + SiLU + conv3x3 (``gn_silu_conv3x3_grad``).

On the CPU: the plain version's formulas against autograd through the
reference the kernels' backward differentiates (``_grad_reference``), with
each mask of wanted gradients; the composition with ``gn_affine``'s backward
against ``jax.vjp`` of the JAX op on the same numpy inputs; the launch plans
of the kernels (each sample's partials of the scale's and offset's gradients
and each split of the weight product cover every pixel exactly once, in a
fixed order; each split's weight-product blocks every (tap, Cin slice, Cout
slice) once; the narrow head's and tiled_f32's index arithmetic, emulated,
against the plain version); the design by shape; the buffers' sizes.  On the card
(``gpu``): the kernels in each design by name against the plain version at
the main path's gradient sites and the visualization batches, two runs bit
for bit; the activation buffer against the plain activation; short
workspaces and buffers refused.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from probabilisticdeepdiffusionmodels_tpu.ops.gn_conv_pallas import (
    gn_silu_conv3x3 as jax_gn_silu_conv3x3,
)
from probabilisticdeepdiffusionmodels_torch.ops import gn_conv as _gc
from probabilisticdeepdiffusionmodels_torch.ops.gn_conv import (
    _grad_reference,
    conv_grad_design,
    gn_affine_grad_plain,
    gn_affine_plain,
    gn_silu_conv3x3,
    gn_silu_conv3x3_grad,
    gn_silu_conv3x3_grad_plain,
    grad_plan,
)
from test_torch_ops import _F32_CONV_SHAPES, _GRAD_CONV_SHAPES, _VIZ_CONV, card  # noqa: F401
from test_torch_threads import one_torch_thread  # noqa: E402,F401

_NEEDS = {"all": (True,) * 5, "x_only": (True, False, False, False, False),
          "affine_only": (False, True, True, False, False), "weights_only": (False,) * 3 + (True,) * 2}
# float32: the same math in another order of sums; bf16: the conv's input
# gradient rounded to bf16 by both, each in its own order of float32 sums
_PLAIN_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _case(b, h, w, cin, cout, dtype, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, h, w, cin).astype(np.float32)).to(dtype)
    a = torch.from_numpy((1 + 0.1 * rng.randn(b, cin)).astype(np.float32))
    off = torch.from_numpy((0.5 * rng.randn(b, cin)).astype(np.float32))
    wt = torch.from_numpy((rng.randn(3, 3, cout, cin) / (3 * cin ** 0.5)).astype(np.float32))
    g = torch.from_numpy(rng.randn(b, h, w, cout).astype(np.float32)).to(dtype)
    bias = torch.from_numpy((0.1 * rng.randn(cout)).astype(np.float32))
    return x, a, off, wt.to(dtype), bias, g


@pytest.mark.parametrize("needs", sorted(_NEEDS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 4, 4, 16, 24), (2, 8, 8, 24, 8), (2, 8, 8, 16, 3)])
def test_plain_grad_matches_autograd_through_the_reference(shape, dtype, needs):
    x, a, off, w, bias, g = _case(*shape, dtype, seed=sum(shape))
    mask = _NEEDS[needs]
    got = gn_silu_conv3x3_grad_plain(x, a, off, w, g, mask)
    leaves = [t.detach().clone().requires_grad_(n) for t, n in zip((x, a, off, w, bias), mask)]
    want = iter(torch.autograd.grad(_grad_reference(*leaves),
                                    [t for t in leaves if t.requires_grad], g))
    for i, (p, need) in enumerate(zip(got, mask)):
        if not need:
            assert p is None, i
            continue
        q = next(want)
        assert p.dtype == q.dtype and p.shape == q.shape, (i, p.dtype, q.dtype)
        err = float((p.float() - q.float()).abs().max())
        assert err <= _PLAIN_TOL[dtype] * float(q.float().abs().max()), (i, err)


def test_cpu_grad_is_the_plain_version():
    x, a, off, w, _, g = _case(2, 4, 4, 16, 8, torch.float32, seed=1)
    gn_silu_conv3x3_grad.launches = 0
    got = gn_silu_conv3x3_grad(x, a, off, w, g)
    want = gn_silu_conv3x3_grad_plain(x, a, off, w, g)
    assert gn_silu_conv3x3_grad.launches == 0
    assert all(torch.equal(p, q) for p, q in zip(got, want))


@pytest.mark.parametrize("mode", ["none", "emb", "film"])
@pytest.mark.parametrize("shape", [(2, 4, 4, 128, 128), (2, 8, 8, 64, 3)])
def test_composition_with_gn_affine_grad_matches_jax(shape, mode):
    """The conv's gradient (plain version) followed by ``gn_affine``'s
    backward (plain version) against ``jax.vjp`` of the JAX op, whose
    forward is the interpret-mode Pallas kernel where it fits (channels of
    128) and XLA otherwise; each gradient within 1e-5 of its largest."""
    b, h, w, c, cout = shape
    rng = np.random.RandomState(7 + c)
    x = rng.randn(b, h, w, c).astype(np.float32)
    gamma = (1 + 0.1 * rng.randn(c)).astype(np.float32)
    beta = (0.1 * rng.randn(c)).astype(np.float32)
    w_hwio = (rng.randn(3, 3, c, cout) / np.sqrt(9 * c)).astype(np.float32)
    bias = (0.1 * rng.randn(cout)).astype(np.float32)
    cond = [rng.randn(b, c).astype(np.float32) for _ in range({"none": 0, "emb": 1, "film": 2}[mode])]
    g = rng.randn(b, h, w, cout).astype(np.float32)

    def named(cond):
        return (dict(emb=cond[0]) if mode == "emb" else dict(film=tuple(cond)) if mode == "film"
                else {})

    def jax_op(x, gamma, beta, w, bias, *cond):
        return jax_gn_silu_conv3x3(x, gamma, beta, w, bias, num_groups=32, interpret=True,
                                   **named(cond))

    _, vjp = jax.vjp(jax_op, *map(jnp.asarray, [x, gamma, beta, w_hwio, bias, *cond]))
    want = vjp(jnp.asarray(g))

    t = [torch.from_numpy(v) for v in (x, gamma, beta, *cond)]
    a, off = gn_affine_plain(t[0], t[1], t[2], 32, 1e-5, **named(t[3:]))
    w_hwoi = torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(0, 1, 3, 2)))
    dx, da, doff, dw, dbias = gn_silu_conv3x3_grad(t[0], a, off, w_hwoi, torch.from_numpy(g))
    gx, ggamma, gbeta, *gcond = gn_affine_grad_plain(t[0], t[1], t[2], 32, 1e-5, da, doff,
                                                     **named(t[3:]))
    got = [dx + gx, ggamma, gbeta, dw.permute(0, 1, 3, 2), dbias, *gcond]
    names = ["x", "gamma", "beta", "w", "bias"] + [f"cond{i}" for i in range(len(cond))]
    for name, p, q in zip(names, got, want):
        q = np.asarray(q)
        np.testing.assert_allclose(p.numpy(), q, rtol=0, atol=1e-5 * np.abs(q).max(),
                                   err_msg=name)


# (B, H, W, Cin, Cout): the CIFAR UNet's gradient sites, the visualization
# batches, CelebA's 64x64, 256-wide rows (row segments), MNIST's 28x28 and
# 7x7 (49 pixels: general), ragged channels, the float32 head
_H100_SMS = 132
_PLAN_SHAPES = [(128, 32, 32, 128, 128), (128, 32, 32, 384, 128), (128, 16, 16, 384, 256),
                (128, 8, 8, 512, 256), (128, 4, 4, 256, 256), (10, 4, 4, 512, 256),
                (1, 32, 32, 128, 128), (8, 64, 64, 128, 128), (2, 8, 256, 128, 128),
                (16, 28, 28, 32, 64), (16, 7, 7, 64, 64), (3, 28, 28, 36, 24),
                (128, 32, 32, 128, 3), (2, 70, 70, 16, 8)]


def _wgmma_takes(b, h, w, cin, cout):
    return conv_grad_design(torch.empty(b, h, w, cin, dtype=torch.bfloat16),
                            torch.empty(3, 3, cout, cin, dtype=torch.bfloat16)) == "wgmma"


def _narrow_takes(b, h, w, cin, cout):
    return conv_grad_design(torch.empty(b, h, w, cin),
                            torch.empty(3, 3, cout, cin)) == "narrow_f32"


def _tiled_takes(b, h, w, cin, cout):
    return conv_grad_design(torch.empty(b, h, w, cin),
                            torch.empty(3, 3, cout, cin)) == "tiled_f32"


_TC_DESIGNS = ("wgmma", "wgmma_sync_epilogue", "wgmma_taprow")
_PLAN_CASES = [(s, "general") for s in _PLAN_SHAPES] + [
    (s, d) for d in _TC_DESIGNS for s in _PLAN_SHAPES if _wgmma_takes(*s)] + [
    (s, "narrow_f32") for s in _PLAN_SHAPES if _narrow_takes(*s)] + [
    (s, "tiled_f32") for s in _PLAN_SHAPES if _tiled_takes(*s)]


@pytest.mark.parametrize("shape,design", _PLAN_CASES)
def test_grad_plan_covers_every_pixel_once(shape, design):
    """Each sample's (tile, image) partials of da and doff hold each of its
    pixels once, every written partial belongs to one sample and lies in the
    workspace; the weight product's splits take each pixel once, each in
    increasing order; the same plan every time."""
    b, h, w, cin, cout = shape
    plan = grad_plan(b, h, w, cin, cout, design, _H100_SMS)
    assert plan == grad_plan(b, h, w, cin, cout, design, _H100_SMS)
    n_a, n_w, n_b = plan.workspace(b, cin, cout)
    parts = 3 * -(-cin // 64) if design == "wgmma_taprow" else 1
    assert (n_w, n_b) == (plan.splits * 9 * cout * cin, plan.splits * parts * cout)
    tile, per_img = plan.dgrad, plan.dgrad.th * plan.dgrad.tw
    owners = {}
    for s, slots in enumerate(plan.dgrad_slots(b)):
        seen = []
        for k, i in slots:
            assert (k, i) not in owners and ((k * tile.ni + i) * 2 + 1) * cin < n_a + cin
            owners[(k, i)] = s
            seen += [(y, x) for p, bb, y, x in tile.pixels(b, h, w, k)
                     if p // per_img == i and bb == s]
        assert sorted(seen) == [(y, x) for y in range(h) for x in range(w)], s
    written = {(k, i) for k in range(tile.count(b)) for i in range(tile.ni)
               if k // (tile.tiles_y * tile.tiles_x) * tile.ni + i < b}
    assert set(owners) == written
    units = plan.wgrad_units(b, h, w)
    assert len(units) == plan.splits and all(u == sorted(u) and u for u in units)
    if plan.wgrad is not None:
        px = [(bb, y, x) for u in units for k in u for _, bb, y, x in plan.wgrad.pixels(b, h, w, k)]
    else:
        px = [p for u in units for k in u for p in range(k * 64, min(b * h * w, k * 64 + 64))]
        px = [(p // (h * w), p // w % h, p % w) for p in px]
    assert sorted(px) == [(s, y, x) for s in range(b) for y in range(h) for x in range(w)]


# the bf16 sites of the CIFAR-10 UNet at batch 128 and of unet_celebahq64 at
# batch 8 (B, H, W, Cin, Cout)
_SITE_SHAPES = [(128, 32, 32, 128, 128), (128, 32, 32, 256, 128), (128, 32, 32, 384, 128),
                (128, 16, 16, 128, 256), (128, 16, 16, 256, 256), (128, 16, 16, 384, 256),
                (128, 16, 16, 512, 256), (128, 8, 8, 256, 256), (128, 8, 8, 512, 256),
                (128, 4, 4, 256, 256), (128, 4, 4, 512, 256), (8, 64, 64, 128, 128),
                (8, 64, 64, 256, 128), (8, 32, 32, 128, 256), (8, 32, 32, 256, 256),
                (8, 32, 32, 512, 256), (8, 16, 16, 256, 384), (8, 16, 16, 384, 384),
                (8, 16, 16, 768, 384), (8, 8, 8, 384, 512), (8, 8, 8, 512, 512),
                (8, 8, 8, 1024, 512)]


@pytest.mark.parametrize("shape,design", [c for c in _PLAN_CASES if c[1] in _TC_DESIGNS] + [
    (s, d) for d in _TC_DESIGNS for s in _SITE_SHAPES])
def test_wgmma_plans_fit_and_fill_the_card(shape, design):
    """Shared memory within a block's 227 KB: wgmma's ping-pong dgrad with a
    weight ring of 3 to 16 stages, four g halo buffers and an x tile a
    consumer warpgroup that holds the TMA box of the tile's pixels x 64
    channels for each 64 of the block (the box that brings x in and takes h
    and dx out, each side at most 256, its bytes what the tile's barrier
    expects), the earlier designs' dgrad, wgrad9 with a ring of at least two
    stages or wgmma_taprow's wgrad; the tiles of 64 or 128 pixels; the
    weight product's tiles of 128 pixels."""
    b, h, w, cin, cout = shape
    plan = grad_plan(*shape, design, _H100_SMS)
    tile = plan.dgrad
    assert plan.nwg in (1, 2) and plan.bn in (64, 128)
    assert tile == _gc.conv_tile(h, w, 64 * plan.nwg)
    assert tile.ni * tile.th * tile.tw <= 64 * plan.nwg
    if design == "wgmma":
        stages = _gc._pingpong_stages(h, w, plan.nwg, plan.bn)
        smem = _gc._pingpong_smem(h, w, plan.nwg, plan.bn, stages)
        assert 3 <= stages <= 16 and smem <= 227 * 1024
        assert stages == 16 or _gc._pingpong_smem(h, w, plan.nwg, plan.bn, stages + 1) > 227 * 1024
        box = (64, tile.tw, tile.th, tile.ni)
        assert max(box) <= 256 and box[0] * 2 == 128  # one swizzled 128-byte row a pixel
        x_tile = plan.bn // 64 * 64 * plan.nwg * 128
        assert plan.bn // 64 * tile.ni * tile.th * tile.tw * 128 <= x_tile
        halo = -(-tile.ni * (tile.th + 2) * (tile.tw + 2) * 128 // 1024) * 1024
        # the scale and offset of the tile's images for each warpgroup
        assert smem >= (1024 + stages * plan.bn * 128 + 4 * halo + 2 * x_tile
                        + 2 * tile.ni * 2 * plan.bn * 4)
        # 128 pixels x 64 channels or 64 x 128 (128 x 128 would serialise the products)
        assert plan.nwg * plan.bn <= 128 and (plan.bn == 64 or cin > 64)
    else:
        assert _gc._dgrad_smem(h, w, plan.nwg, plan.bn) <= 227 * 1024
    if design in ("wgmma", "wgmma_sync_epilogue"):
        stages = _gc._wgrad9_stages(h, w)
        assert stages >= 2 and _gc._wgrad9_smem(h, w, stages) <= 227 * 1024
    else:
        assert _gc._wgrad_smem(h, w) <= 227 * 1024
    assert plan.wgrad == _gc.conv_tile(h, w, 128)


@pytest.mark.parametrize("design,want", [("wgmma", (1, 128, 33)),
                                         ("wgmma_sync_epilogue", (2, 128, 33)),
                                         ("wgmma_taprow", (2, 128, 11))])
def test_wgmma_plans_at_the_32x32_site(design, want):
    """At the CIFAR 32x32 128 -> 128 site, dgrad tiles of 128 channels
    (wgmma: 64 pixels, one a consumer warpgroup, at least two a block on 132
    SMs; the earlier designs: 128 pixels, both warpgroups on one tile);
    wgrad9's blocks fill the 132 SMs, one block an SM."""
    plan = grad_plan(128, 32, 32, 128, 128, design, _H100_SMS)
    assert (plan.nwg, plan.bn, plan.splits) == want
    if design != "wgmma_taprow":
        assert len(plan.weight_blocks(128, 128)) == 132
    if design == "wgmma":
        assert plan.dgrad.count(128) * 128 // plan.bn // _H100_SMS >= 2


@pytest.mark.parametrize("shape,design", _PLAN_CASES)
def test_weight_blocks_take_every_tap_and_slice_once(shape, design):
    """Each split's weight-product blocks hold each (tap, Cin slice, Cout
    slice) exactly once (wgmma: all nine taps in one block, three a
    warpgroup); each split's dbias partials come from one block a Cout slice
    (wgmma: the block of Cin slice 0), or, in wgmma_taprow, from every block of
    the slice, as many as the workspace holds; the finish adds the splits in
    the order of the list."""
    b, h, w, cin, cout = shape
    plan = grad_plan(b, h, w, cin, cout, design, _H100_SMS)
    blocks = plan.weight_blocks(cin, cout)
    _, n_w, n_b = plan.workspace(b, cin, cout)
    for z in range(plan.splits):
        mine = [blk for blk in blocks if blk[0] == z]
        units = [(tap, ci, co) for _, ci, co, taps, _ in mine for tap in taps]
        if design == "narrow_f32":
            want = [(tap, 0, 0) for tap in range(9)]
        else:
            step_co = 16 if design == "general" and cout <= 16 else 64
            want = [(tap, ci, co) for tap in range(9) for ci in range(0, cin, 64)
                    for co in range(0, cout, step_co)]
        assert sorted(units) == sorted(want) and len(units) == len(set(units)), z
        bias = [blk for blk in mine if blk[4]]
        if design in ("wgmma", "wgmma_sync_epilogue"):
            assert all(len(blk[3]) == 9 for blk in mine)
            assert sorted(blk[2] for blk in bias) == list(range(0, cout, 64))
            assert all(blk[1] == 0 for blk in bias)
        if design == "wgmma_taprow":
            assert len(bias) == -(-cout // 64) * n_b // (plan.splits * cout)
    assert [blk[0] for blk in blocks] == sorted(blk[0] for blk in blocks)
    assert n_w == plan.splits * 9 * cout * cin


def _narrow_emulated(x, a, off, w, g, plan):
    """narrow_f32's arithmetic as the kernel orders it, in float64: per
    tile, the halo of g zero outside the image, each pixel's 9 Cout
    neighbouring g values read at (row + 2 - tap // 3, column + 2 - tap % 3)
    of the halo and used against the weight (dh) and against h (the tile's
    partial of dw); the partials in the workspaces' layouts, then added in
    the finish's order."""
    b, h, wd, cin = x.shape
    cout = w.shape[2]
    t = plan.dgrad
    x, a, off, w, g = (v.double() for v in (x, a, off, w, g))
    wk = w.reshape(9 * cout, cin)
    n_a, n_w, n_b = plan.workspace(b, cin, cout)
    ws_a, ws_w, ws_b = (torch.zeros(n, dtype=torch.float64) for n in (n_a, n_w, n_b))
    dx = torch.zeros_like(x)
    for tile in range(t.count(b)):
        bb, y0 = tile // t.tiles_y, tile % t.tiles_y * t.th
        rows = min(t.th, h - y0)
        halo = torch.zeros(t.th + 2, wd + 2, cout, dtype=torch.float64)
        lo, hi = max(0, y0 - 1), min(h, y0 + t.th + 1)
        halo[lo - (y0 - 1):hi - (y0 - 1), 1:wd + 1] = g[bb, lo:hi]
        r = torch.arange(rows)[:, None].expand(rows, wd).reshape(-1)
        c = torch.arange(wd)[None, :].expand(rows, wd).reshape(-1)
        gwin = torch.stack([halo[r + 2 - tap // 3, c + 2 - tap % 3] for tap in range(9)], 1)
        gwin = gwin.reshape(-1, 9 * cout)                       # (pixels, 9 Cout)
        xv = x[bb, y0:y0 + rows].reshape(-1, cin)
        p = xv * a[bb] + off[bb]
        s = torch.sigmoid(p)
        dh = gwin @ wk
        dp = dh * s * (1 + p * (1 - s))
        dx[bb, y0:y0 + rows] = (dp * a[bb]).reshape(rows, wd, cin)
        ws_w[tile * 9 * cout * cin:(tile + 1) * 9 * cout * cin] = (gwin.T @ (p * s)).reshape(-1)
        ws_b[tile * cout:(tile + 1) * cout] = halo[1:rows + 1, 1:wd + 1].reshape(-1, cout).sum(0)
        ws_a[tile * 2 * cin:(tile * 2 + 1) * cin] = (dp * xv).sum(0)
        ws_a[(tile * 2 + 1) * cin:(tile * 2 + 2) * cin] = dp.sum(0)
    slots = plan.dgrad_slots(b)
    da = torch.stack([sum(ws_a[(k * 2) * cin:(k * 2 + 1) * cin] for k, _ in sl) for sl in slots])
    doff = torch.stack([sum(ws_a[(k * 2 + 1) * cin:(k * 2 + 2) * cin] for k, _ in sl)
                        for sl in slots])
    units = plan.wgrad_units(b, h, wd)
    dw = sum(ws_w[z * 9 * cout * cin:(z + 1) * 9 * cout * cin] for z in range(len(units)))
    dbias = sum(ws_b[z * cout:(z + 1) * cout] for z in range(len(units)))
    return dx, da, doff, dw.reshape(3, 3, cout, cin), dbias


@pytest.mark.parametrize("shape", [(2, 32, 32, 16, 3), (2, 8, 8, 8, 6), (1, 40, 36, 12, 5)])
def test_narrow_f32_arithmetic_matches_plain(shape):
    """The narrow head's index arithmetic (halo offsets, the tiles of whole
    rows, the partials' layouts and the finish's order), emulated, against
    the plain version's formulas: within 1e-5 of each gradient's largest
    element (float64 against the plain version's float32 sums), as the
    float32 plain version is held to autograd above."""
    b, h, w, cin, cout = shape
    x, a, off, wt, _, g = _case(b, h, w, cin, cout, torch.float32, seed=sum(shape))
    plan = grad_plan(b, h, w, cin, cout, "narrow_f32", _H100_SMS)
    got = _narrow_emulated(x, a, off, wt, g, plan)
    want = gn_silu_conv3x3_grad_plain(x, a, off, wt, g)
    for i, (p, q) in enumerate(zip(got, want)):
        assert p.shape == q.shape, i
        assert float((p - q.double()).abs().max()) <= 1e-5 * float(q.abs().max()), i


def _tiled_emulated(src, w, a, off, bias, x, dgrad):
    """tiled_f32's index arithmetic as the kernel orders it (tiled_f32.cuh),
    in float64: per (pixel tile, 128 output channels), the halo of ``src``
    (x, or g) in rows of TW + 4 and padded rows + 2 an image, zero outside
    the image after the activation (forward); thread m's 8 pixels (thread
    row m // (TW / PC), column group m % (TW / PC)) read at (row + dy,
    column + dx) of it against the weight as the products read it ([k][tap]
    [n]: the forward's transposed, the input gradient's flipped); the K
    channels cut into the cluster's splits and their partials added in rank
    order; the epilogue's validity, bias or the activation's backward, and
    the input gradient's (tile, image, channel) partials over the thread
    rows of each image.  Returns y, or (dx, ws_a)."""
    b, h, wd, k = src.shape
    cout, cin = w.shape[2:]
    n = cin if dgrad else cout
    t = _gc.tiled_tile(h, wd)
    pc = 8 if t.tw >= 8 else 4
    pr, cg = 8 // pc, t.tw // pc
    hp = _gc._tiled_rows(t.th, t.tw)
    splits = _gc.tiled_splits(b, h, wd, k, n, _H100_SMS)
    assert k % (4 * splits) == 0
    src, w, a, off, bias, x = (None if v is None else v.double()
                               for v in (src, w, a, off, bias, x))
    w9 = w.reshape(9, cout, cin)
    wt = w9.flip(0).permute(1, 0, 2) if dgrad else w9.permute(2, 0, 1)  # [k][tap][n]
    m = torch.arange(16)
    trow = m // cg * pr
    row_ok = trow < t.ni * hp
    img, yin = torch.where(row_ok, trow // hp, 0), torch.where(row_ok, trow % hp, 0)
    col0 = m % cg * pc
    r, c = torch.arange(8) // pc, torch.arange(8) % pc
    dy, dx = torch.arange(9) // 3, torch.arange(9) % 3
    hi = img[:, None, None].expand(16, 8, 9)
    hy = yin[:, None, None] + r[None, :, None] + dy[None, None, :]
    hx = col0[:, None, None] + c[None, :, None] + dx[None, None, :]
    assert int(hy.max()) < hp + 2 and int(hx.max()) < t.tw + 4
    out = torch.zeros(b, h, wd, n, dtype=torch.float64)
    ws_a = torch.zeros(t.count(b) * t.ni * 2 * cin, dtype=torch.float64)
    for tile in range(t.count(b)):
        b0 = tile // (t.tiles_y * t.tiles_x) * t.ni
        y0 = tile // t.tiles_x % t.tiles_y * t.th
        x0 = tile % t.tiles_x * t.tw
        halo = torch.zeros(k, t.ni, hp + 2, t.tw + 4, dtype=torch.float64)
        for i in range(min(t.ni, b - b0)):
            for yy in range(max(0, y0 - 1), min(h, y0 - 1 + hp + 2)):
                for xx in range(max(0, x0 - 1), min(wd, x0 + t.tw + 1)):
                    v = src[b0 + i, yy, xx]
                    if not dgrad:
                        p = v * a[b0 + i] + off[b0 + i]
                        v = p * torch.sigmoid(p)
                    halo[:, i, yy - y0 + 1, xx - x0 + 1] = v
        gathered = halo[:, hi, hy, hx]                         # (k, m, pixel, tap)
        yy = y0 + yin[:, None] + r[None, :]
        xx = x0 + col0[:, None] + c[None, :]
        bb = b0 + img[:, None].expand(16, 8)
        valid = (row_ok[:, None] & (yin[:, None] + r[None, :] < t.th) & (yy < h) & (xx < wd)
                 & (bb < b))
        for n0 in range(0, n, 128):
            cols = torch.arange(n0, min(n, n0 + 128))
            kper = k // splits
            parts = [torch.einsum("kmpt,ktn->mpn", gathered[z * kper:(z + 1) * kper],
                                  wt[z * kper:(z + 1) * kper][:, :, cols]) for z in range(splits)]
            acc = sum(parts[1:], parts[0])
            red = torch.zeros(2, 16, len(cols), dtype=torch.float64)
            for mi in range(16):
                for pi in range(8):
                    if not valid[mi, pi]:
                        continue
                    at = (int(bb[mi, pi]), int(yy[mi, pi]), int(xx[mi, pi]))
                    if dgrad:
                        xv, av, ov = x[at][cols], a[at[0]][cols], off[at[0]][cols]
                        p = xv * av + ov
                        s = torch.sigmoid(p)
                        dp = acc[mi, pi] * s * (1 + p * (1 - s))
                        out[at][cols] = dp * av
                        red[0, mi] += dp * xv
                        red[1, mi] += dp
                    else:
                        out[at][cols] = acc[mi, pi] + bias[cols]
            if dgrad:
                for i in range(t.ni):
                    if b0 + i >= b:
                        continue
                    mine = [mi for mi in range(16) if row_ok[mi] and int(img[mi]) == i]
                    for q in range(2):
                        at = ((tile * t.ni + i) * 2 + q) * cin
                        ws_a[at + cols] = sum(red[q, mi] for mi in mine)
    return (out, ws_a) if dgrad else out


# (B, H, W, Cin, Cout): 8-column threads over 4 rows of 32; 2 whole 8x8
# images a tile with a ragged batch; 4-wide images (two rows a thread, 8 a
# tile) with a batch of 5 and two 128-channel blocks of the output, the
# second ragged; 6x6 and 3x3 images (padded columns and rows); 28 columns
# in 32; 200 columns in two row segments of 128
_TILED_SHAPES = [(2, 32, 32, 8, 12), (3, 8, 8, 12, 16), (5, 4, 4, 16, 132), (2, 6, 6, 8, 12),
                 (2, 3, 3, 4, 8), (2, 28, 28, 8, 12), (1, 2, 200, 4, 12)]


@pytest.mark.parametrize("shape", _TILED_SHAPES)
def test_tiled_f32_forward_arithmetic_matches_plain(shape):
    """tiled_f32's forward index arithmetic (the tiles, the halo's rows and
    pitch, the threads' pixels and register shifts, the transposed weight,
    the split of Cin, the epilogue's validity), emulated, against the plain
    version within 1e-5 of its largest output (float64 against float32)."""
    b, h, w, cin, cout = shape
    x, a, off, wt, bias, _ = _case(b, h, w, cin, cout, torch.float32, seed=sum(shape))
    got = _tiled_emulated(x, wt, a, off, bias, None, dgrad=False)
    want = _gc.gn_silu_conv3x3_plain(x, a, off, wt, bias)
    assert float((got - want.double()).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("shape", _TILED_SHAPES)
def test_tiled_f32_dgrad_arithmetic_matches_plain(shape):
    """tiled_f32's input gradient (g's halo, the flipped weight, the split
    of Cout, dx and the (tile, image, channel) partials), emulated, then
    the partials added in ``grad_plan``'s order: dx, da and doff within
    1e-5 of the plain gradient's largest element; every partial the plan
    adds is written and no other."""
    b, h, w, cin, cout = shape
    x, a, off, wt, _, g = _case(b, h, w, cin, cout, torch.float32, seed=sum(shape) + 1)
    dx, ws_a = _tiled_emulated(g, wt, a, off, None, x, dgrad=True)
    plan = grad_plan(b, h, w, cin, cout, "tiled_f32", _H100_SMS)
    assert ws_a.numel() == plan.workspace(b, cin, cout)[0]
    slots = plan.dgrad_slots(b)
    da = torch.stack([sum(ws_a[(k * plan.dgrad.ni + i) * 2 * cin:][:cin] for k, i in sl)
                      for sl in slots])
    doff = torch.stack([sum(ws_a[((k * plan.dgrad.ni + i) * 2 + 1) * cin:][:cin]
                            for k, i in sl) for sl in slots])
    want = gn_silu_conv3x3_grad_plain(x, a, off, wt, g, needs=(True, True, True, False, False))
    for i, (p, q) in enumerate(zip((dx, da, doff), want[:3])):
        assert p.shape == q.shape, i
        assert float((p - q.double()).abs().max()) <= 1e-5 * float(q.abs().max()), i


def test_narrow_f32_plan_and_buffers():
    """The head's tiles are whole rows of one image, 1,024 pixels at most,
    every pixel once; the whole weight and the g halo fit shared memory at
    Cout 3 and 6 (the learned-sigma head), and so do the threads' partials;
    the workspaces hold one partial of (da, doff) a (tile, channel) and one
    of dw and dbias a tile; no activation buffer."""
    for cout in (3, 6):
        plan = grad_plan(128, 32, 32, 128, cout, "narrow_f32", _H100_SMS)
        assert plan.dgrad == _gc.ConvTile(1, 32, 32, 1, 1) and plan.splits == 128
        run = _gc._narrow_run(cout)
        groups = 256 // (128 // run)
        smem = _gc._narrow_grad_smem(32, 32, 128, cout)
        assert smem >= 4 * (34 * 34 * cout + 9 * cout * 128) and smem <= 227 * 1024
        assert smem == 4 * (groups * (9 * cout + 2) * 128 + groups * cout)
        assert 9 * cout * run <= 108  # the thread's partials of dw in registers
        assert plan.workspace(128, 128, cout) == (128 * 2 * 128, 128 * 9 * cout * 128,
                                                  128 * cout)
        assert plan.activation(128, 32, 32, 128) == 0
    tile = _gc._narrow_tile(256, 256)
    assert (tile.th, tile.tw, tile.tiles_y) == (4, 256, 64)


@pytest.mark.parametrize("design", ["wgmma", "wgmma_sync_epilogue"])
@pytest.mark.parametrize("shape", [(128, 32, 32, 128, 128), (128, 32, 32, 384, 128),
                                   (128, 16, 16, 256, 256), (128, 8, 8, 512, 256),
                                   (128, 4, 4, 256, 256), (8, 64, 64, 128, 128)])
def test_wgmma_buffer_sizes(shape, design):
    """The activation buffer holds all of x in bf16 where the weight product
    runs (none where only dx is wanted, none in wgmma_taprow); wgrad9's partials
    of dw stay within 32 MB at the CIFAR sites and its dbias partials are one
    a split; the partials of da and doff one a (tile, image, channel)."""
    b, h, w, cin, cout = shape
    plan = grad_plan(*shape, design, _H100_SMS)
    assert plan.activation(b, h, w, cin) == b * h * w * cin
    assert plan.activation(b, h, w, cin, want_w=False) == 0
    assert grad_plan(*shape, "wgmma_taprow", _H100_SMS).activation(b, h, w, cin) == 0
    n_a, n_w, n_b = plan.workspace(b, cin, cout)
    assert 4 * n_w <= 32 << 20 and n_b == plan.splits * cout
    assert n_a == plan.dgrad.count(b) * plan.dgrad.ni * 2 * cin


@pytest.mark.parametrize("shape,dtype,design", [
    ((128, 32, 32, 128, 128), torch.bfloat16, "wgmma"),
    ((128, 4, 4, 512, 256), torch.bfloat16, "wgmma"),
    ((8, 64, 64, 128, 128), torch.bfloat16, "wgmma"),
    ((128, 8, 8, 256, 256), torch.bfloat16, "wgmma"),
    ((1, 32, 32, 128, 128), torch.bfloat16, "wgmma"),      # a visualization batch
    ((2, 8, 256, 128, 128), torch.bfloat16, "wgmma"),      # row segments
    ((16, 7, 7, 64, 64), torch.bfloat16, "general"),     # 49 pixels a sample
    ((3, 28, 28, 36, 24), torch.bfloat16, "general"),    # Cin % 8
    ((128, 32, 32, 128, 3), torch.float32, "narrow_f32"),  # the output head
    ((128, 32, 32, 128, 128), torch.float32, "tiled_f32"),  # float32, the configs' default
    ((128, 4, 4, 512, 256), torch.float32, "tiled_f32"),
    ((10, 32, 32, 128, 6), torch.float32, "narrow_f32"),   # learned sigma's head
    ((2, 8, 8, 10, 3), torch.float32, "general"),          # Cin % 4
    ((2, 8, 8, 10, 16), torch.float32, "general"),         # Cin % 4, wider than the head
    ((2, 8, 8, 16, 10), torch.float32, "general"),         # Cout % 4
])
def test_conv_grad_design_by_shape(shape, dtype, design):
    b, h, w, cin, cout = shape
    x = torch.empty(b, h, w, cin, dtype=dtype)
    assert conv_grad_design(x, torch.empty(3, 3, cout, cin, dtype=dtype)) == design


def test_cpu_backward_through_the_op_is_the_plain_versions():
    """On the CPU the op is the plain version under autograd, its gradient
    the plain gradient's, and no counter moves."""
    x, a, off, w, bias, g = _case(2, 4, 4, 16, 8, torch.float32, seed=3)
    leaves = [t.clone().requires_grad_(True) for t in (x, a, off, w, bias)]
    gn_silu_conv3x3.launches = gn_silu_conv3x3_grad.launches = 0
    got = torch.autograd.grad(gn_silu_conv3x3(*leaves), leaves, g)
    want = gn_silu_conv3x3_grad_plain(x, a, off, w, g)
    for i, (p, q) in enumerate(zip(got, want)):
        assert float((p - q).abs().max()) <= 1e-5 * float(q.abs().max()), i
    assert (gn_silu_conv3x3.launches, gn_silu_conv3x3_grad.launches) == (0, 0)


# ------------------------------------------------------------- on the card

# the kernels against the plain version: float32 sums over up to 131,072
# pixels in another order; bf16 where the plain version rounds the conv's
# input gradient to bf16 and the kernel keeps it in float32
_CARD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _card_cases():
    """(B, H, W, Cin, Cout, dtype): the gradient sites in bf16 and float32
    (the head in float32), tiled_f32's float32 signatures of the CIFAR UNet
    and its ragged shapes, the visualization batches 1 and 10 in bf16 with
    the float32 learned-sigma head."""
    cases = []
    for b, h, w, cin, cout in _GRAD_CONV_SHAPES:
        cases += [(b, h, w, cin, cout, torch.float32)]
        if cout != 3:
            cases += [(b, h, w, cin, cout, torch.bfloat16)]
    cases += [(*s, torch.float32) for s in _F32_CONV_SHAPES if s not in _GRAD_CONV_SHAPES]
    for batch in (1, 10):
        cases += [(batch, *s, torch.bfloat16) for s in _VIZ_CONV]
        cases += [(batch, 32, 32, 128, 6, torch.float32)]
    return cases


@pytest.mark.gpu
@pytest.mark.parametrize("case", _card_cases(), ids=lambda c: "x".join(map(str, c[:5])) + str(c[5])[-4:])
def test_card_conv_grad_designs_match_plain(case, card):
    """Each design that takes the shape, by name, twice: the same bits, one
    launch a call, every gradient within its tolerance of the plain
    version's largest element; and the weight-only and input-only masks."""
    b, h, w, cin, cout, dtype = case
    x, a, off, wt, _, g = (t.cuda() for t in _case(b, h, w, cin, cout, dtype, seed=b + cin))
    want = gn_silu_conv3x3_grad_plain(x, a, off, wt, g)
    chosen = conv_grad_design(x, wt)
    assert chosen == "tiled_f32" or dtype != torch.float32 or cout <= 8
    designs = {chosen, "general"} | ({"wgmma_sync_epilogue", "wgmma_taprow"}
                                     if chosen == "wgmma" else set())
    for design in sorted(designs):
        before = gn_silu_conv3x3_grad.launches
        runs = [gn_silu_conv3x3_grad(x, a, off, wt, g, design=design) for _ in range(2)]
        torch.cuda.synchronize()
        assert gn_silu_conv3x3_grad.launches == before + 2
        for i, (p, again, q) in enumerate(zip(*runs, want)):
            assert p.dtype == q.dtype and p.shape == q.shape, (design, i)
            assert torch.equal(p, again), (design, i)
            err = float((p.float() - q.float()).abs().max())
            assert err <= _CARD_TOL[dtype] * float(q.float().abs().max()), (design, i, err)
        if design == chosen:
            kept = runs[0]
    # the masks in the design the shape selects: the same bits as all five
    for mask in (_NEEDS["x_only"], _NEEDS["weights_only"]):
        got = gn_silu_conv3x3_grad(x, a, off, wt, g, needs=mask)
        for p, q, need in zip(got, kept, mask):
            assert (p is None) != need and (p is None or torch.equal(p, q))


@pytest.mark.gpu
def test_card_recompute_counts_no_launch(card):
    """``recompute`` by name is autograd through the plain version: it
    matches the kernels' tolerance and leaves the op's launch count as it
    was, so a launch gate cannot mistake it for the kernels."""
    x, a, off, wt, _, g = (t.cuda() for t in _case(8, 16, 16, 64, 64, torch.bfloat16, seed=3))
    want = gn_silu_conv3x3_grad_plain(x, a, off, wt, g)
    before = gn_silu_conv3x3_grad.launches
    got = gn_silu_conv3x3_grad(x, a, off, wt, g, design="recompute")
    torch.cuda.synchronize()
    assert gn_silu_conv3x3_grad.launches == before
    for p, q in zip(got, want):
        err = float((p.float() - q.float()).abs().max())
        assert err <= _CARD_TOL[torch.bfloat16] * float(q.float().abs().max())


def _plain_activation(x, a, off):
    p = x.float() * a[:, None, None, :] + off[:, None, None, :]
    return (p * torch.sigmoid(p)).to(x.dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("design", ["wgmma", "wgmma_sync_epilogue"])
@pytest.mark.parametrize("needs", ["all", "weights_only"])
@pytest.mark.parametrize("shape", [(128, 32, 32, 128, 128), (128, 4, 4, 256, 256),
                                   (8, 64, 64, 128, 128)])
def test_card_activation_buffer_is_the_plain_activation(shape, needs, design, card):
    """The activation buffer of ``wgmma`` (dgrad's TMA store of h) and of
    ``wgmma_sync_epilogue`` (its plain stores), written by dgrad's epilogue (all) or by
    the elementwise launch (weights only), holds silu(x*a + off) in bf16:
    each element within one bf16 rounding (2^-7 of its size) of the plain
    activation's, the kernel's exponential and division being the fast
    ones the forward uses, plus 1e-6: the kernel forms x*a + off in one
    fused multiply-add as the forward does, the plain version rounds x*a
    first, and where off cancels x*a the two p differ by a float32 rounding
    of x*a (|x*a| < 8 here: under 5e-7, and silu halves it near 0)."""
    x, a, off, wt, _, g = (t.cuda() for t in _case(*shape, torch.bfloat16, seed=5))
    plan = grad_plan(*shape[:5], design, _gc._sm_count(x.device))
    act = torch.full((plan.activation(*shape[:4]),), float("nan"), dtype=torch.bfloat16,
                     device="cuda")
    _gc._launch_grad(x, a, off, wt, g, _NEEDS[needs], design, act=act)
    torch.cuda.synchronize()
    want = _plain_activation(x, a, off).float().reshape(-1)
    got = act.float()
    assert bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= 2.0 ** -7 * want.abs() + 1e-6).all())


@pytest.mark.gpu
def test_card_refuses_a_short_activation_buffer(card):
    """An activation buffer one element short is refused before any launch."""
    x, a, off, wt, _, g = (t.cuda() for t in _case(8, 16, 16, 64, 64, torch.bfloat16, seed=6))
    act = torch.empty(8 * 16 * 16 * 64 - 1, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA error"):
        _gc._launch_grad(x, a, off, wt, g, _NEEDS["all"], "wgmma", act=act)


@pytest.mark.gpu
@pytest.mark.parametrize("design", ["general", "wgmma", "wgmma_sync_epilogue", "wgmma_taprow",
                                    "narrow_f32", "tiled_f32"])
@pytest.mark.parametrize("short", [0, 1, 2])
def test_card_refuses_a_short_workspace(design, short, card, monkeypatch):
    """A workspace one element shorter than the entry point's own tiling
    fills is refused before any launch, so a plan that drifts from the C
    side raises instead of writing past its end."""
    dtype, cout = ((torch.float32, 3) if design == "narrow_f32" else
                   (torch.float32, 64) if design == "tiled_f32" else (torch.bfloat16, 64))
    x, a, off, wt, _, g = (t.cuda() for t in _case(8, 16, 16, 64, cout, dtype, seed=4))
    sized = _gc.GradPlan.workspace

    def workspace(plan, b, cin, cout):
        n = list(sized(plan, b, cin, cout))
        n[short] -= 1
        return tuple(n)

    monkeypatch.setattr(_gc.GradPlan, "workspace", workspace)
    before = gn_silu_conv3x3_grad.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        gn_silu_conv3x3_grad(x, a, off, wt, g, design=design)
    assert gn_silu_conv3x3_grad.launches == before
