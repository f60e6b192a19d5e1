"""The gradient of GroupNorm (+ SiLU): ``group_norm_silu_grad``, its plain
version and its launch plans, on the CPU, and the kernels on the card
(``gpu``).

The plain backward (``group_norm_silu_grad_plain``, the kernels' arithmetic:
the fold of one-pass moments, g' = g silu'(p), the fold's backward) is held
against autograd through the op's plain version, against ``jax.vjp`` of
``group_norm_silu_xla`` and of the custom-VJP ``group_norm_silu`` of
``ops/groupnorm_pallas.py`` (its forward the interpret-mode Pallas kernel),
with SiLU on and off and one-channel groups.  The op's Function is held
with the plain versions standing in for the launches, and the plans' blocks
are checked to cover every element once with the groups each block folds.
Tolerances, of the reference's largest element: float32 1e-5 (one-pass
against two-pass statistics, sums in another order); bf16 inputs 1e-2 for
dx, which each side rounds to bf16 once from float32 values that differ in
their last bits (one bf16 step is 2^-8 of the value).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from probabilisticdeepdiffusionmodels_tpu.ops import groupnorm_pallas
from probabilisticdeepdiffusionmodels_torch.ops import groupnorm as _gn
from probabilisticdeepdiffusionmodels_torch.ops import (
    group_norm_silu,
    group_norm_silu_grad,
    group_norm_silu_grad_plain,
    group_norm_silu_plain,
)
from test_torch_ops import card  # noqa: F401
from test_torch_threads import one_torch_thread  # noqa: E402,F401

F32_TOL = 1e-5
BF16_TOL = 1e-2


def _inputs(shape, dtype, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) + 0.5).astype(np.float32)
    gamma = (1 + 0.3 * rng.randn(shape[-1])).astype(np.float32)
    beta = (0.3 * rng.randn(shape[-1])).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(gamma), torch.from_numpy(beta),
            torch.from_numpy(g).to(dtype))


def _close(got, want, tol, what=""):
    if not isinstance(want, torch.Tensor):
        want = torch.from_numpy(np.array(want, dtype=np.float32))
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    assert err <= tol * float(want.abs().max()), (what, err, float(want.abs().max()))


# (shape, groups): the UNet's attention norm at 4x4, one-channel groups,
# groups of 3 channels, a 1-D input with a ragged length, an n-D input
_SHAPES = [((2, 4, 4, 64), 32), ((2, 8, 8, 32), 32), ((3, 9, 96), 32), ((2, 37, 64), 4),
           ((2, 3, 4, 5, 32), 8)]


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("shape,groups", _SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_grad_matches_autograd(dtype, shape, groups, silu):
    x, gamma, beta, g = _inputs(shape, dtype, seed=len(shape) + groups)
    leaves = [t.clone().requires_grad_(True) for t in (x, gamma, beta)]
    want = torch.autograd.grad(group_norm_silu_plain(*leaves, groups, 1e-5, silu), leaves, g)
    got = group_norm_silu_grad_plain(x, gamma, beta, g, groups, 1e-5, silu)
    assert [t.dtype for t in got] == [dtype, torch.float32, torch.float32]
    for name, p, q in zip(("dx", "dgamma", "dbeta"), got, want):
        tol = BF16_TOL if name == "dx" and dtype == torch.bfloat16 else F32_TOL
        _close(p, q, tol, name)


@pytest.fixture(scope="module")
def jax_vjps():
    """jax.vjp of group_norm_silu_xla and of the custom-VJP op (forward on
    the interpret-mode Pallas kernel), compiled once a (silu, which)."""
    cache = {}

    def get(silu, which, x, gamma, beta):
        key = (silu, which, x.shape)
        if key not in cache:
            if which == "xla":
                fn = lambda x, gm, bt: groupnorm_pallas.group_norm_silu_xla(  # noqa: E731
                    x, gm, bt, 32, 1e-5, silu)
            else:
                def fn(x, gm, bt):
                    orig = groupnorm_pallas.group_norm_silu_pallas
                    groupnorm_pallas.group_norm_silu_pallas = (
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
                    try:
                        return groupnorm_pallas.group_norm_silu(x, gm, bt, 32, 1e-5, silu)
                    finally:
                        groupnorm_pallas.group_norm_silu_pallas = orig
            cache[key] = jax.jit(lambda x, gm, bt, g: jax.vjp(fn, x, gm, bt)[1](g))
        return cache[key]
    return get


@pytest.mark.parametrize("which", ["xla", "custom_vjp"])
@pytest.mark.parametrize("silu", [True, False])
def test_plain_grad_matches_jax_vjp(silu, which, jax_vjps):
    x, gamma, beta, g = _inputs((2, 4, 4, 128), torch.float32, seed=7)
    fn = jax_vjps(silu, which, x.numpy(), gamma.numpy(), beta.numpy())
    want = fn(*map(jnp.asarray, (x.numpy(), gamma.numpy(), beta.numpy(), g.numpy())))
    got = group_norm_silu_grad_plain(x, gamma, beta, g, 32, 1e-5, silu)
    for name, p, q in zip(("dx", "dgamma", "dbeta"), got, want):
        _close(p, q, F32_TOL, name)


@pytest.mark.parametrize("needs", [(True, True, True), (True, False, False),
                                   (False, True, True)])
def test_function_wiring_on_cpu(needs):
    """The op's Function with the plain versions standing in for the
    launches: the plain forward, the plain backward's gradients in each
    input's dtype, None where an input needs none and for the three
    settings."""
    x, gamma, beta, g = _inputs((2, 4, 4, 32), torch.bfloat16, seed=8)
    leaves = [t.clone().requires_grad_(n) for t, n in zip((x, gamma, beta), needs)]
    out = _gn._GroupNormSilu.apply(*leaves, 8, 1e-5, True)
    assert torch.equal(out, group_norm_silu_plain(x, gamma, beta, 8, 1e-5, True))
    out.backward(g)
    want = group_norm_silu_grad_plain(x, gamma, beta, g, 8, 1e-5, True)
    for leaf, need, w in zip(leaves, needs, want):
        if need:
            assert leaf.grad.dtype == leaf.dtype and torch.equal(leaf.grad, w)
        else:
            assert leaf.grad is None
    # the wrapper on CPU tensors: the plain version under plain autograd
    leaves2 = [t.clone().requires_grad_(n) for t, n in zip((x, gamma, beta), needs)]
    group_norm_silu(*leaves2, 8, 1e-5, True).backward(g)
    for leaf, leaf2 in zip(leaves, leaves2):
        if leaf.grad is not None:
            _close(leaf2.grad, leaf.grad, BF16_TOL if leaf.dtype == torch.bfloat16 else F32_TOL)


def test_grad_on_cpu_takes_the_plain_version():
    x, gamma, beta, g = _inputs((2, 6, 64), torch.float32, seed=9)
    got = group_norm_silu_grad(x, gamma, beta, g, 32, 1e-5, False, needs=(True, False, True))
    want = group_norm_silu_grad_plain(x, gamma, beta, g, 32, 1e-5, False)
    assert torch.equal(got[0], want[0]) and got[1] is None and torch.equal(got[2], want[2])


# (B, N, C, groups, itemsize, address low bits): the attention norms of the
# CIFAR-10 UNet at batch 128 and unet_celebahq64's, the 1-D UNet's long
# rows, 64x64 and 256x256 images (split), groups wider than a block (one
# group of 4,096 and 8,192 channels), a misaligned address
_PLAN_CASES = [(128, 256, 256, 32, 2, 0), (128, 64, 256, 32, 2, 0), (128, 16, 256, 32, 2, 0),
               (8, 256, 384, 32, 2, 0), (8, 64, 512, 32, 2, 0), (16, 1024, 64, 32, 2, 0),
               (2, 4096, 128, 32, 2, 0), (2, 65536, 128, 32, 4, 0), (2, 40, 4096, 1, 2, 0),
               (1, 8, 8192, 1, 4, 0), (4, 100, 96, 32, 2, 2)]


@pytest.mark.parametrize("b,n,c,groups,itemsize,addr", _PLAN_CASES)
def test_grad_plan_covers_every_element_once(b, n, c, groups, itemsize, addr):
    """Each design's blocks (splits x channel chunks x samples) take every
    (row, channel) of a sample once; a fused block holds whole groups over
    all rows; a split block's fold region (the groups its chunk touches, as
    ``gn_silu_bwd_kernel`` computes it) holds whole groups, covers its
    chunk and fits the shared memory ``launch_silu_bwd`` sizes."""
    design, plan = _gn.silu_grad_plan(b, n, c, groups, itemsize, addr)
    cg = c // groups
    chb = plan.cvb * plan.v
    assert c % plan.v == 0 and addr % (plan.v * itemsize) == 0 and 1 <= plan.cvb <= 256
    assert plan.splits * plan.rows >= n > (plan.splits - 1) * plan.rows
    seen = np.zeros((n, c), dtype=np.int64)
    height = 256 // plan.cvb
    for s in range(plan.splits):
        r0, r1 = s * plan.rows, min(n, (s + 1) * plan.rows)
        for chunk in range(plan.chunks(c)):
            c0 = chunk * chb
            nch = min(chb, c - c0)
            for ty in range(height):  # each thread row walks its rows in steps of `height`
                seen[r0 + ty:r1:height, c0:c0 + nch] += 1
            if design == "fused":
                assert plan.splits == 1 and c0 % cg == 0 and nch % cg == 0
            f0 = c0 // cg * cg
            f1 = min(c, -(-(c0 + nch) // cg) * cg)
            span = (-(-chb // cg) + 1) * cg
            assert f0 <= c0 and c0 + nch <= f1 and (f1 - f0) % cg == 0
            assert f1 - f0 <= min(c, span) and 6 * 4 * min(c, span) <= 227 * 1024
    assert (seen == 1).all()
    assert design == ("fused" if _gn._fused_plan(n, c, groups, itemsize, addr) else "split")


# ------------------------------------------------------------- on the card

# (shape, groups): the CIFAR-10 UNet's attention norms at batch 128,
# unet_celebahq64's at batch 8, the 1-D UNet's 1,024-long rows, a 64x64
# image (split), groups of 3, one group of 4,096 channels (a group wider
# than a block)
_CARD_SHAPES = [((128, 256, 256), 32), ((128, 64, 256), 32), ((128, 16, 256), 32),
                ((8, 256, 384), 32), ((8, 64, 512), 32), ((16, 1024, 64), 32),
                ((4, 64, 64, 128), 32), ((8, 16, 16, 96), 32), ((2, 40, 4096), 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_groupnorm_grad_matches_plain(dtype, card):  # noqa: F811
    """At every shape and design that takes it, SiLU on and off: the kernels
    within bf16 1e-2 / float32 1e-4 of the plain backward's largest element
    (the chip check's tolerances), the same bits twice, one count a call;
    the fused forward's statistics against the plain fold; ``recompute``
    counts nothing."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    for shape, groups in _CARD_SHAPES:
        x = (torch.randn(shape, device="cuda", generator=gen) + 0.5).to(dtype)
        gamma = 1 + 0.3 * torch.randn(shape[-1], device="cuda", generator=gen)
        beta = 0.3 * torch.randn(shape[-1], device="cuda", generator=gen)
        g = torch.randn(shape, device="cuda", generator=gen).to(dtype)
        for silu in (True, False):
            out, ao = _gn._launch(x, gamma, beta, groups, 1e-5, silu, want_ao=True)
            ao_ref = _gn.gn_fold_plain(_gn.moments_plain(x), gamma, beta, groups, 1e-5)
            torch.testing.assert_close(ao, ao_ref, rtol=1e-4, atol=1e-4)
            ref = group_norm_silu_grad_plain(x, gamma, beta, g, groups, 1e-5, silu, ao=ao)
            designs = {_gn.groupnorm_grad_design(x, groups), "split"}
            tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
            for design in sorted(designs):
                before = group_norm_silu_grad.launches
                runs = [group_norm_silu_grad(x, gamma, beta, g, groups, 1e-5, silu, ao=ao,
                                             design=design) for _ in range(2)]
                torch.cuda.synchronize()
                assert group_norm_silu_grad.launches - before == 2
                for p, q, name in zip(runs[0], ref, ("dx", "dgamma", "dbeta")):
                    assert p.dtype == q.dtype, name
                    err = float((p.float() - q.float()).abs().max())
                    assert err <= tol * float(q.float().abs().max()), (shape, design, name, err)
                assert all(torch.equal(p, q) for p, q in zip(*runs)), (shape, design)
            before = group_norm_silu_grad.launches
            group_norm_silu_grad(x, gamma, beta, g, groups, 1e-5, silu, design="recompute")
            assert group_norm_silu_grad.launches == before


@pytest.mark.gpu
def test_card_groupnorm_autograd_uses_the_kernels(card):  # noqa: F811
    """Under autograd the op launches the forward and the backward kernels
    once each, no plain version."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(16, 64, 256, device="cuda", generator=gen).to(torch.bfloat16)
    g = torch.randn(x.shape, device="cuda", generator=gen).to(torch.bfloat16)
    gamma = torch.ones(256, device="cuda", requires_grad=True)
    beta = torch.zeros(256, device="cuda", requires_grad=True)
    leaf = x.clone().requires_grad_(True)
    before = (_gn.group_norm_silu.launches, group_norm_silu_grad.launches)
    group_norm_silu(leaf, gamma, beta, 32, 1e-5, False).backward(g)
    torch.cuda.synchronize()
    assert (_gn.group_norm_silu.launches - before[0],
            group_norm_silu_grad.launches - before[1]) == (1, 1)
    _, ao = _gn._launch(x, gamma.detach(), beta.detach(), 32, 1e-5, False, want_ao=True)
    want = group_norm_silu_grad(x, gamma.detach(), beta.detach(), g, 32, 1e-5, False, ao=ao)
    assert torch.equal(leaf.grad, want[0]) and torch.equal(gamma.grad, want[1])
