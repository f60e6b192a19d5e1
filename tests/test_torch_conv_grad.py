"""The gradient of the fused GN + SiLU + conv3x3 (``gn_silu_conv3x3_grad``).

On the CPU: the plain version's formulas against autograd through the
reference the kernels' backward differentiates (``_grad_reference``), with
each mask of wanted gradients; the composition with ``gn_affine``'s backward
against ``jax.vjp`` of the JAX op on the same numpy inputs; the launch plans
of the kernels (each sample's partials of the scale's and offset's gradients
and each split of the weight product cover every pixel exactly once, in a
fixed order); the design by shape.  On the card (``gpu``): the kernels in
each design by name against the plain version at the main path's gradient
sites and the visualization batches, two runs bit for bit.
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
from test_torch_ops import _GRAD_CONV_SHAPES, _VIZ_CONV, card  # noqa: F401
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


_PLAN_CASES = [(s, "general") for s in _PLAN_SHAPES] + [
    (s, "wgmma") for s in _PLAN_SHAPES if _wgmma_takes(*s)]


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
    parts = 3 * -(-cin // 64) if design == "wgmma" else 1
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
    if design == "wgmma":
        px = [(bb, y, x) for u in units for k in u for _, bb, y, x in plan.wgrad.pixels(b, h, w, k)]
    else:
        px = [p for u in units for k in u for p in range(k * 64, min(b * h * w, k * 64 + 64))]
        px = [(p // (h * w), p // w % h, p % w) for p in px]
    assert sorted(px) == [(s, y, x) for s in range(b) for y in range(h) for x in range(w)]


def test_wgmma_plans_fit_and_fill_the_card():
    """Shared memory within a block's 227 KB; the weight product's blocks
    fill the 132 SMs at the CIFAR 32x32 site."""
    for shape, design in _PLAN_CASES:
        if design != "wgmma":
            continue
        b, h, w, cin, cout = shape
        plan = grad_plan(*shape, design, _H100_SMS)
        assert _gc._dgrad_smem(h, w, plan.nwg, plan.bn) <= 227 * 1024
        assert _gc._wgrad_smem(h, w) <= 227 * 1024
        tile = plan.dgrad
        assert plan.wgrad == _gc.conv_tile(h, w, 128) and tile.ni * tile.th * tile.tw <= 128
    plan = grad_plan(128, 32, 32, 128, 128, "wgmma", _H100_SMS)
    assert (plan.nwg, plan.bn, plan.splits) == (2, 128, 11)


@pytest.mark.parametrize("shape,dtype,design", [
    ((128, 32, 32, 128, 128), torch.bfloat16, "wgmma"),
    ((128, 4, 4, 512, 256), torch.bfloat16, "wgmma"),
    ((8, 64, 64, 128, 128), torch.bfloat16, "wgmma"),
    ((16, 7, 7, 64, 64), torch.bfloat16, "general"),     # 49 pixels a sample
    ((3, 28, 28, 36, 24), torch.bfloat16, "general"),    # Cin % 8
    ((128, 32, 32, 128, 3), torch.float32, "general"),   # the output head
    ((128, 32, 32, 128, 128), torch.float32, "general"),
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
    (the head in float32), the visualization batches 1 and 10 in bf16 with
    the float32 learned-sigma head."""
    cases = []
    for b, h, w, cin, cout in _GRAD_CONV_SHAPES:
        cases += [(b, h, w, cin, cout, torch.float32)]
        if cout != 3:
            cases += [(b, h, w, cin, cout, torch.bfloat16)]
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
    designs = {conv_grad_design(x, wt), "general"}
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
    for mask in (_NEEDS["x_only"], _NEEDS["weights_only"]):
        got = gn_silu_conv3x3_grad(x, a, off, wt, g, needs=mask)
        for p, q, need in zip(got, runs[0], mask):
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


@pytest.mark.gpu
@pytest.mark.parametrize("design", ["general", "wgmma"])
@pytest.mark.parametrize("short", [0, 1, 2])
def test_card_refuses_a_short_workspace(design, short, card, monkeypatch):
    """A workspace one element shorter than the entry point's own tiling
    fills is refused before any launch, so a plan that drifts from the C
    side raises instead of writing past its end."""
    x, a, off, wt, _, g = (t.cuda() for t in _case(8, 16, 16, 64, 64, torch.bfloat16, seed=4))
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
