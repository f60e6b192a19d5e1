"""The launch plans and the arithmetic of ``gn_affine``'s two designs and of
its one-launch gradient, on the CPU.

The kernels themselves run only on the card (``tests/test_torch_ops.py``,
``gpu``); what is held here is what they are built from: each plan covers
every element once with chunks of whole groups, a cluster stays within its
limit and its blocks fold whole groups, and the fold's backward, written
chunk by chunk as each block computes it (``fold_backward_plain``), agrees
with autograd through the plain version and with ``jax.vjp`` of the JAX
``gn_affine`` on the same numpy inputs.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from probabilisticdeepdiffusionmodels_tpu.ops.gn_conv_pallas import gn_affine as jax_gn_affine
from probabilisticdeepdiffusionmodels_torch.ops import affine_design, grad_design
from probabilisticdeepdiffusionmodels_torch.ops import groupnorm as _gn
from probabilisticdeepdiffusionmodels_torch.ops.gn_conv import gn_affine_grad_plain
from test_torch_ops import _PLAN_SHAPES
from test_torch_threads import one_torch_thread  # noqa: E402,F401


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _fold_slices(nch, cg, splits):
    """The channels [lo, hi) of a chunk of ``nch`` channels that each block
    of a cluster of ``splits`` folds, in rank order, by the rule of
    ``cluster_fold`` in csrc/groupnorm.cu: ceil(groups / splits) whole
    groups of ``cg`` a block, the last ones short or empty."""
    groups = nch // cg
    per = -(-groups // splits)
    out = []
    for rank in range(splits):
        g_lo = min(groups, rank * per)
        out.append((g_lo * cg, min(groups, g_lo + per) * cg))
    return out


def _blocks_sum(x, plan, c):
    """The per-channel sums of a (N, C) float64 sample as the plan's blocks
    take them: a thread per vector and row, rows in steps of the block's
    height, the splits added in order."""
    n = x.shape[0]
    total = torch.zeros(c, dtype=torch.float64)
    height, chb = 256 // plan.cvb, plan.cvb * plan.v
    for s in range(plan.splits):
        rows = x[s * plan.rows:min(n, (s + 1) * plan.rows)]
        for chunk in range(plan.chunks(c)):
            part = rows[:, chunk * chb:(chunk + 1) * chb]
            total[chunk * chb:(chunk + 1) * chb] += sum(part[ty::height].sum(0)
                                                        for ty in range(height))
    return total


@pytest.mark.parametrize("b,n,c,itemsize,addr", _PLAN_SHAPES)
def test_affine_plan_covers_every_element_once(b, n, c, itemsize, addr):
    """The forward's plan (gcd(32, C) groups, as the UNet's norms): every
    element summed once; ``cluster`` chunks are whole groups, a cluster
    holds 2 to 8 blocks and its blocks fold whole groups that cover the
    chunk once; a sample longer than a cluster takes ``moments_plan``'s
    geometry (design ``workspace``)."""
    groups = math.gcd(32, c)
    cg = c // groups
    plan = _gn.affine_plan(b, n, c, groups, itemsize, addr)
    assert c % plan.v == 0 and addr % (plan.v * itemsize) == 0 and 1 <= plan.cvb <= 256
    assert plan.splits * plan.rows >= n > (plan.splits - 1) * plan.rows
    if plan.fold == "workspace":
        assert plan == _gn.moments_plan(b, n, c, itemsize, addr)
    else:
        assert (plan.cvb * plan.v) % cg == 0
        assert (plan.splits == 1) == (plan.fold == "local") and plan.splits <= 8
        for k in range(plan.chunks(c)):
            nch = min(plan.cvb * plan.v, c - k * plan.cvb * plan.v)
            slices = _fold_slices(nch, cg, plan.splits)
            assert len(slices) == plan.splits
            assert all(lo % cg == 0 and hi % cg == 0 and lo <= hi for lo, hi in slices)
            assert [i for lo, hi in slices for i in range(lo, hi)] == list(range(nch))
    rng = np.random.RandomState(n + c)
    x = _t(rng.randn(n, c).astype(np.float32)).double()
    torch.testing.assert_close(_blocks_sum(x, plan, c), x.sum(0), rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("n,c", [(16, 256), (16, 512), (64, 256), (64, 512)])
def test_affine_plan_puts_several_blocks_on_a_small_sample(n, c):
    """The 4x4 and 8x8 sites at batch 128, one block a sample before: now
    chunks of whole groups, each folded by its own block (no cross-block
    step), at least 64 bytes of a row a block."""
    plan = _gn.affine_plan(128, n, c, 32, 2, 0)
    assert plan.fold == "local" and plan.splits == 1
    assert plan.chunks(c) > 1 and plan.cvb * plan.v * 2 >= 64
    assert _gn.moments_plan(128, n, c, 2, 0).chunks(c) == 1  # the workspace design's


@pytest.mark.parametrize("b,n,c,itemsize,addr", _PLAN_SHAPES)
def test_grad_plan_chunks_are_whole_groups(b, n, c, itemsize, addr):
    """The one-launch backward's plan: chunks of whole groups (each block
    folds its own groups backward), every element of dL/dx written once;
    None only where one group is wider than a block."""
    groups = math.gcd(32, c)
    cg = c // groups
    plan = _gn.grad_plan(b, n, c, groups, itemsize, addr)
    if plan is None:
        v = _gn.moments_plan(b, n, c, itemsize, addr).v
        assert math.lcm(cg, v) // v > 256
        return
    assert (plan.cvb * plan.v) % cg == 0 and 1 <= plan.cvb <= 256
    assert plan.splits * plan.rows >= n > (plan.splits - 1) * plan.rows
    rng = np.random.RandomState(n + c + 1)
    x = _t(rng.randn(n, c).astype(np.float32)).double()
    torch.testing.assert_close(_blocks_sum(x, plan, c), x.sum(0), rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("shape,groups,dtype,design,grad", [
    ((128, 4, 4, 256), 32, torch.bfloat16, "cluster", "fused_bwd"),
    ((8, 64, 64, 128), 32, torch.bfloat16, "cluster", "fused_bwd"),
    ((2, 256, 256, 128), 32, torch.bfloat16, "workspace", "fused_bwd"),
    ((2, 8, 8, 4096), 1, torch.float32, "workspace", "fold_bwd+apply"),
])
def test_designs_by_shape(shape, groups, dtype, design, grad):
    x = torch.empty(shape, dtype=dtype)
    assert affine_design(x, groups) == design and grad_design(x, groups) == grad


def _case(mode, shape, seed):
    rng = np.random.RandomState(seed)
    b, c = shape[0], shape[-1]
    x = (rng.randn(*shape) + 0.3).astype(np.float32)
    gamma, beta = rng.randn(c).astype(np.float32), rng.randn(c).astype(np.float32)
    emb = rng.randn(b, c).astype(np.float32) if mode == "emb" else None
    film = ((rng.randn(b, c).astype(np.float32), rng.randn(b, c).astype(np.float32))
            if mode == "film" else None)
    ga, goff = rng.randn(b, c).astype(np.float32), rng.randn(b, c).astype(np.float32)
    return x, gamma, beta, emb, film, ga, goff


def _grads_from_fold(x, gamma, beta, groups, emb, film, ga, goff, chunk):
    """The gradients of (x, gamma, beta, emb | FiLM pair) composed from
    ``fold_backward_plain`` as the kernel composes them: dL/dx = x g0 + g1,
    the shares summed over the batch, the conditioning's rows as they are."""
    b, c = x.shape[0], x.shape[-1]
    ao = _gn.gn_fold_plain(_gn.moments_plain(x), gamma, beta, groups, 1e-5, emb=emb, film=film)
    n = x.numel() // (b * c)
    g = _gn.fold_backward_plain(ao, gamma, beta, n, groups, 1e-5, ga, goff, emb=emb, film=film,
                                chunk=chunk)
    shape = (b,) + (1,) * (x.dim() - 2) + (c,)
    out = [x * g[0].reshape(shape) + g[1].reshape(shape), g[2].sum(0), g[3].sum(0)]
    return out + ([g[4]] if emb is not None else [g[4], g[5]] if film is not None else [])


@pytest.mark.parametrize("mode", ["plain", "emb", "film"])
@pytest.mark.parametrize("shape,groups,chunk", [
    ((2, 4, 4, 64), 32, None), ((2, 4, 4, 64), 32, 16), ((3, 5, 5, 96), 32, 24),
    ((2, 6, 6, 36), 4, 18)])
def test_fold_backward_plain_matches_autograd(mode, shape, groups, chunk):
    """The per-block formulas, chunk by chunk, against autograd through
    ``gn_affine_plain``: 1e-6 of each gradient's largest element (float32,
    the same sums in another order)."""
    x, gamma, beta, emb, film, ga, goff = map(
        lambda a: a if a is None or isinstance(a, tuple) else _t(a),
        _case(mode, shape, len(shape) + shape[-1]))
    film = None if film is None else tuple(map(_t, film))
    got = _grads_from_fold(x, gamma, beta, groups, emb, film, ga, goff, chunk)
    want = gn_affine_grad_plain(x, gamma, beta, groups, 1e-5, ga, goff, emb, film)
    assert len(got) == len(want)
    for p, q in zip(got, want):
        assert p.shape == q.shape
        assert float((p - q).abs().max()) <= 1e-6 * float(q.abs().max())


@pytest.mark.parametrize("mode", ["plain", "emb", "film"])
def test_fold_backward_plain_matches_jax_vjp(mode):
    """The same composition against ``jax.vjp`` of the JAX package's
    ``gn_affine`` on the same numpy inputs: 1e-5 of each gradient's largest
    element (float32; the sums run in another order)."""
    shape, groups = (2, 8, 8, 64), 32
    x, gamma, beta, emb, film, ga, goff = _case(mode, shape, 17)
    conds = (emb,) if emb is not None else film or ()

    def f(x, gamma, beta, *conds):
        kw = (dict(emb=conds[0]) if mode == "emb" else dict(film=tuple(conds))
              if mode == "film" else {})
        return jax_gn_affine(x, gamma, beta, groups, 1e-5, **kw)

    _, vjp = jax.vjp(f, *map(jnp.asarray, (x, gamma, beta, *conds)))
    want = [np.asarray(v) for v in vjp((jnp.asarray(ga), jnp.asarray(goff)))]
    got = _grads_from_fold(_t(x), _t(gamma), _t(beta), groups,
                           None if emb is None else _t(emb),
                           None if film is None else tuple(map(_t, film)),
                           _t(ga), _t(goff), 16)
    assert len(got) == len(want)
    for p, q in zip(got, want):
        assert p.shape == q.shape
        assert float(np.abs(p.numpy() - q).max()) <= 1e-5 * float(np.abs(q).max())
