"""The gradient of GroupNorm (+ SiLU): ``group_norm_silu_grad``, its plain
version and its launch plans, on the CPU, and the kernels on the card
(``gpu``).

The plain backward (``group_norm_silu_grad_plain``, the kernels' arithmetic:
the fold of one-pass moments, g' = g silu'(p), the fold's backward) is held
against autograd through the op's plain version, against ``jax.vjp`` of
``group_norm_silu_xla`` and of the custom-VJP ``group_norm_silu`` of
``ops/groupnorm_pallas.py`` (its forward the interpret-mode Pallas kernel),
with SiLU on and off and one-channel groups.  The op's Function is held
with the plain versions standing in for the launches, the plans' blocks
are checked to cover every element once with the groups each block folds,
the design is checked by shape and dtype, and the ``tma_resident`` kernel's
index arithmetic is emulated in numpy against the plain backward.
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


def _resident_threads(plan):
    """(thread, sample of the item, thread row, channel vector) of a
    ``tma_resident`` block's consumers, as ``gn_silu_bwd_resident_kernel``
    lays them out (a thread past the item's samples has none)."""
    per = plan.cvb * plan.thread_rows
    return [(t, t // per, t % per // plan.cvb, t % plan.cvb)
            for t in range(_gn._RESIDENT_CONSUMERS)]


def _first_row(lo, ty, rows):
    return ty if lo <= ty else ty + (lo - ty + rows - 1) // rows * rows


def _check_resident_plan(b, n, c, groups, plan):
    """A ``tma_resident`` plan: chunks of whole groups tile C and groups of
    samples tile B; each item's threads take every (sample, row, channel)
    of it once, walking the stages in order; the boxes are TMA's (at most
    256 a dimension, 16-byte rows); the grid's blocks take every item once
    (block i the items i, i + grid, ...), with two buffers where a block
    takes more than one; a block's stages, the dx staging (over g's stages)
    and the fold's floats fit 227 KB, and the blocks an SM the grid assumes
    fit its 228 KB."""
    cg = c // groups
    assert plan.chb % cg == 0 and plan.chb % 8 == 0 and c % plan.chb == 0
    assert 1 <= plan.spb <= 8 and plan.cvb * plan.spb <= _gn._RESIDENT_CONSUMERS
    assert plan.thread_rows >= 1
    assert 1 <= plan.srows <= 256 and plan.stages * plan.srows >= n > (plan.stages - 1) * plan.srows
    smem = _gn.resident_smem(plan)
    items = plan.items(b, c)
    assert smem <= 227 * 1024 and -(-plan.grid // 132) * (smem + 1024) <= 228 * 1024
    assert 1 <= plan.grid <= items and (plan.bufs == 1) == (plan.grid == items)
    assert plan.bufs <= min(3, -(-items // plan.grid))
    taken = sorted(it for blk in range(plan.grid) for it in range(blk, items, plan.grid))
    assert taken == list(range(items))
    seen = np.zeros((plan.spb, n, plan.chb), dtype=np.int64)
    for _, j, ty, tx in _resident_threads(plan):
        if j >= plan.spb:
            continue
        last = -1
        for q in range(plan.stages):
            r = _first_row(q * plan.srows, ty, plan.thread_rows)
            for r in range(r, min(n, (q + 1) * plan.srows), plan.thread_rows):
                assert r > last and r // plan.srows == q
                last = r
                seen[j, r, tx * 8:tx * 8 + 8] += 1
    assert (seen == 1).all()
    groups_of_samples = -(-b // plan.spb)
    assert groups_of_samples * plan.spb >= b > (groups_of_samples - 1) * plan.spb


@pytest.mark.parametrize("b,n,c,groups,itemsize,addr", _PLAN_CASES)
def test_grad_plan_covers_every_element_once(b, n, c, groups, itemsize, addr):
    """Each design's blocks (splits x channel chunks x samples) take every
    (row, channel) of a sample once; a fused block holds whole groups over
    all rows; a split block's fold region (the groups its chunk touches, as
    ``gn_silu_bwd_kernel`` computes it) holds whole groups, covers its
    chunk and fits the shared memory ``launch_silu_bwd`` sizes; a
    ``tma_resident`` plan as ``_check_resident_plan`` says, and the fused
    plan ``fused`` by name runs beside it covers the same way."""
    design, plan = _gn.silu_grad_plan(b, n, c, groups, itemsize, addr)
    if design == "tma_resident":
        _check_resident_plan(b, n, c, groups, plan)
        design, plan = "fused", _gn._fused_plan(n, c, groups, itemsize, addr)
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


# (B, N, C, groups, dtype, address low bits, design): the CIFAR-10 UNet's
# 15 attention norms at batch 128 (three shapes) in bf16 and in float32,
# unet_celebahq64's two, a 4x4 norm of 64 channels (two samples a block),
# groups of 3, a misaligned address, long inputs (a 64x64 image, the 1-D
# UNet's rows) and a group wider than a block
_DESIGN_CASES = [
    (128, 256, 256, 32, torch.bfloat16, 0, "tma_resident"),
    (128, 64, 256, 32, torch.bfloat16, 0, "tma_resident"),
    (128, 16, 256, 32, torch.bfloat16, 0, "tma_resident"),
    (128, 256, 256, 32, torch.float32, 0, "fused"),
    (128, 16, 256, 32, torch.float32, 0, "fused"),
    (8, 256, 384, 32, torch.bfloat16, 0, "tma_resident"),
    (8, 64, 512, 32, torch.bfloat16, 0, "tma_resident"),
    (128, 16, 64, 32, torch.bfloat16, 0, "tma_resident"),
    (8, 256, 96, 32, torch.bfloat16, 0, "tma_resident"),
    (4, 100, 96, 32, torch.bfloat16, 2, "fused"),
    (4, 4096, 128, 32, torch.bfloat16, 0, "split"),
    (16, 1024, 64, 32, torch.bfloat16, 0, "split"),
    (2, 40, 4096, 1, torch.bfloat16, 0, "split"),
]


@pytest.mark.parametrize("b,n,c,groups,dtype,addr,want", _DESIGN_CASES)
def test_grad_design_by_shape_and_dtype(b, n, c, groups, dtype, addr, want):
    """The design chosen by shape and dtype: ``tma_resident`` where the
    fused design applies in bf16 with 16-byte rows and addresses, ``fused``
    in float32 or where an address is misaligned, ``split`` for long inputs
    and groups wider than a block; where ``tma_resident`` is chosen the
    fused plan is still there for ``fused`` by name; the wrapper's choice
    on a tensor is the plan's."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    design, plan = _gn.silu_grad_plan(b, n, c, groups, itemsize, addr)
    assert design == want
    fused = _gn._fused_plan(n, c, groups, itemsize, addr)
    assert (fused is not None) == (want != "split")
    assert (_gn.resident_plan(b, n, c, groups, itemsize, addr) is not None) == (
        want == "tma_resident")
    if addr == 0:
        x = torch.empty((b, n, c), dtype=dtype)
        assert _gn.groupnorm_grad_design(x, groups) == want


# (B, N, C, groups, plan): the CIFAR-10 UNet's 4x4 norm as planned; groups
# of 3 with a ragged last stage; two samples an item with a ragged last
# group of samples, one block over both items (two buffers); a chunk of 6
# channel vectors (no shuffles), one block over four items (three
# buffers); eight samples an item
_EMULATED = [
    (3, 16, 256, 32, None),
    (2, 37, 96, 32, None),
    (3, 16, 64, 32, _gn.ResidentPlan(64, 2, 4, 4, 1, 2)),
    (2, 21, 96, 32, _gn.ResidentPlan(48, 1, 6, 4, 1, 3)),
    (9, 3, 32, 8, _gn.ResidentPlan(32, 8, 1, 3, 2, 1)),
]


def _group_tree(v, cg):
    """Each of 8 neighbouring entries' values replaced by its group's sum,
    by the kernel's xor tree of shuffles over an entry a lane
    (``group_sum``), in float32."""
    for o in (1, 2, 4):
        if o < cg:
            v = v + v[np.arange(8) ^ o]
    return v


def _fold_by_shuffles(sda, sdo, mu, m2, gamma, shares, b0, c0, nsb, chb, cg, eps, n):
    """The fold's backward where the kernel sums a group's entries by
    shuffles (an entry a lane; here groups of at most 8): from the entries'
    sums (sda, sdo) to 2 dL/dS2 and dL/dS1 in place, and the samples'
    shares."""
    for jj in range(nsb):
        for cl in range(0, chb, 8):
            e = slice(jj * chb + cl, jj * chb + cl + 8)
            mg, qg = _group_tree(mu[e], cg) / cg, _group_tree(m2[e], cg) / cg
            rstd = 1 / np.sqrt(qg - mg * mg + eps)
            gam, doff = gamma[cl:cl + 8], sdo[e].copy()
            da = sda[e] - doff * mg
            shares[b0 + jj, 0, c0 + cl:c0 + cl + 8] = da * rstd
            shares[b0 + jj, 1, c0 + cl:c0 + cl + 8] = doff
            sm, sr = _group_tree(-rstd * gam * doff, cg), _group_tree(da * gam, cg)
            r3 = rstd ** 3
            sda[e] = 2 * (-0.5 * r3 * sr / cg) / n
            sdo[e] = (sm + r3 * mg * sr) / cg / n


def _emulate_resident(x, g, ao, gamma, plan, groups, eps, silu):
    """``gn_silu_bwd_resident_kernel`` and the batch sums written out in
    numpy: each block's items in turn, each in its buffer (k % bufs), the
    stage buffers as TMA fills them (boxes of srows rows, zero past N, each
    padded to 128 bytes), each thread's rows and channels, the
    partial sums' slots and the order they are added in, the fold's
    backward by entry index (the groups' sums by a tree of shuffles where a
    group is at most 8 channels, else in order), dx over g's stage and the
    TMA store of each stage (clipped at N and B).  float32 throughout (the
    kernel's bf16 inputs are exact in float32, its dx rounded to bf16
    after)."""
    x, g = x.float().numpy(), g.float().numpy()
    ao, gamma = ao.numpy(), gamma.numpy()
    b, n, c = x.shape
    cg = c // groups
    cvb, rows = plan.cvb, plan.thread_rows
    per, nst = cvb * rows, plan.spb * plan.stages
    sbe = -(-plan.srows * plan.chb * 2 // 128) * 128 // 2
    shfl = 32 % cvb == 0 and per % 32 == 0
    dx = np.full_like(x, np.nan)
    shares = np.full((b, 2, c), np.nan, dtype=np.float32)
    threads = _resident_threads(plan)
    chunks, items = c // plan.chb, plan.items(b, c)
    for blk in range(plan.grid):
        smem = np.full(plan.bufs * 2 * nst * sbe, np.nan, dtype=np.float32)
        for k, it in enumerate(range(blk, items, plan.grid)):
            b0, c0 = it // chunks * plan.spb, it % chunks * plan.chb
            nsb = min(plan.spb, b - b0)
            u = k % plan.bufs
            xs = smem[u * 2 * nst * sbe:][:nst * sbe]  # views: the buffer's x, then g, stages
            gs = smem[(u * 2 + 1) * nst * sbe:][:nst * sbe]
            for s in range(nsb * plan.stages):
                j, r0 = divmod(s, plan.stages)
                r0 *= plan.srows
                for buf, src in ((xs, x), (gs, g)):
                    box = np.zeros((plan.srows, plan.chb), dtype=np.float32)
                    part = src[b0 + j, r0:r0 + plan.srows, c0:c0 + plan.chb]
                    box[:len(part)] = part
                    buf[s * sbe:s * sbe + box.size] = box.ravel()

            def at(j, r, tx):
                return ((j * plan.stages + r // plan.srows) * sbe + r % plan.srows * plan.chb
                        + tx * 8)

            def thread_rows(j, ty, q):
                r = _first_row(q * plan.srows, ty, rows)
                return range(r, min(n, (q + 1) * plan.srows), rows)

            partial = np.zeros((_gn._RESIDENT_CONSUMERS, 16), dtype=np.float32)
            coef = {}
            for t, j, ty, tx in threads:
                if j >= nsb:
                    continue
                ch = slice(c0 + tx * 8, c0 + tx * 8 + 8)
                a, off = ao[0, b0 + j, ch], ao[1, b0 + j, ch]
                coef[t] = (a, off)
                for q in range(plan.stages):
                    for r in thread_rows(j, ty, q):
                        xf, gf = xs[at(j, r, tx):][:8], gs[at(j, r, tx):][:8]
                        if silu:
                            p_ = xf * a + off
                            s_ = 1 / (1 + np.exp(-p_))
                            gf = gf * s_ * (1 + p_ * (1 - s_))
                        partial[t, 8:] += gf
                        partial[t, :8] += gf * xf
            if shfl:  # lanes of one channel vector meet in their warp
                red = np.zeros((_gn._RESIDENT_CONSUMERS // 32 * cvb, 16), dtype=np.float32)
                for t in range(_gn._RESIDENT_CONSUMERS):
                    red[t // 32 * cvb + t % 32 % cvb] += partial[t]
                slots = [[jj * (per // 32) * cvb + w * cvb for w in range(per // 32)]
                         for jj in range(nsb)]
            else:
                red = partial
                slots = [[jj * per + y * cvb for y in range(rows)] for jj in range(nsb)]
            m = nsb * plan.chb
            sda, sdo = np.zeros(m, np.float32), np.zeros(m, np.float32)
            mu, m2 = np.zeros(m, np.float32), np.zeros(m, np.float32)
            for i in range(m):
                jj, cc = divmod(i, plan.chb)
                for slot in slots[jj]:
                    sda[i] += red[slot + cc // 8, cc % 8]
                    sdo[i] += red[slot + cc // 8, 8 + cc % 8]
                mu[i], m2[i] = ao[2, b0 + jj, c0 + cc], ao[3, b0 + jj, c0 + cc]
            if 8 % cg == 0:  # the groups' sums by shuffles
                _fold_by_shuffles(sda, sdo, mu, m2, gamma[c0:c0 + plan.chb], shares, b0, c0,
                                 nsb, plan.chb, cg, eps, n)
            else:  # an entry a thread, the groups in shared memory
                tm, tr = np.zeros(m, np.float32), np.zeros(m, np.float32)
                for i in range(m):
                    jj, cc = divmod(i, plan.chb)
                    gi = i - cc + cc // cg * cg
                    mg, qg = mu[gi:gi + cg].mean(), m2[gi:gi + cg].mean()
                    rstd = 1 / np.sqrt(qg - mg * mg + eps)
                    gam = gamma[c0 + cc]
                    doff, da = sdo[i], sda[i] - sdo[i] * mg
                    shares[b0 + jj, 0, c0 + cc], shares[b0 + jj, 1, c0 + cc] = da * rstd, doff
                    tm[i], tr[i] = -rstd * gam * doff, da * gam
                for i in range(m):
                    cc = i % plan.chb
                    gi = i - cc + cc // cg * cg
                    mg, qg = mu[gi:gi + cg].mean(), m2[gi:gi + cg].mean()
                    rstd = 1 / np.sqrt(qg - mg * mg + eps)
                    r3 = rstd ** 3
                    sr = tr[gi:gi + cg].sum()
                    dmu = (tm[gi:gi + cg].sum() + r3 * mg * sr) / cg
                    sda[i], sdo[i] = 2 * (-0.5 * r3 * sr / cg) / n, dmu / n
            for q in range(plan.stages):
                for t, j, ty, tx in threads:
                    if j >= nsb:
                        continue
                    a, off = coef[t]
                    k = slice(j * plan.chb + tx * 8, j * plan.chb + tx * 8 + 8)
                    for r in thread_rows(j, ty, q):
                        xf, gf = xs[at(j, r, tx):][:8], gs[at(j, r, tx):][:8].copy()
                        if silu:
                            p_ = xf * a + off
                            s_ = 1 / (1 + np.exp(-p_))
                            gf = gf * s_ * (1 + p_ * (1 - s_))
                        gs[at(j, r, tx):at(j, r, tx) + 8] = gf * a + (xf * sda[k] + sdo[k])
                for jj in range(nsb):  # the stage's TMA store, clipped at N
                    s = jj * plan.stages + q
                    box = gs[s * sbe:s * sbe + plan.srows * plan.chb].reshape(plan.srows, -1)
                    r0 = q * plan.srows
                    dx[b0 + jj, r0:r0 + plan.srows, c0:c0 + plan.chb] = box[:max(0, n - r0)]
    return dx, shares[:, 0].sum(0), shares[:, 1].sum(0)


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("b,n,c,groups,plan", _EMULATED)
def test_resident_kernel_arithmetic_emulated(b, n, c, groups, plan, silu):
    """The ``tma_resident`` kernel's index arithmetic and reduction order,
    emulated in numpy on bf16 inputs, against the plain backward: every dx
    element written, dx within bf16 1e-2 and dgamma, dbeta within float32
    1e-5 of the largest element (sums in another order)."""
    if plan is None:
        design, plan = _gn.silu_grad_plan(b, n, c, groups, 2, 0)
        assert design == "tma_resident"
    _check_resident_plan(b, n, c, groups, plan)
    x, gamma, beta, g = _inputs((b, n, c), torch.bfloat16, seed=b + n + c)
    ao = _gn.gn_fold_plain(_gn.moments_plain(x), gamma, beta, groups, 1e-5)
    want = group_norm_silu_grad_plain(x, gamma, beta, g, groups, 1e-5, silu, ao=ao)
    got = _emulate_resident(x, g, ao, gamma, plan, groups, 1e-5, silu)
    assert not np.isnan(got[0]).any()
    _close(torch.from_numpy(got[0]).to(torch.bfloat16), want[0], BF16_TOL, "dx")
    _close(torch.from_numpy(got[1]), want[1], F32_TOL, "dgamma")
    _close(torch.from_numpy(got[2]), want[2], F32_TOL, "dbeta")


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
    """At every shape and design that takes it (``tma_resident`` at the bf16
    attention norms, with ``fused`` by name beside it), SiLU on and off: the kernels
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
            chosen = _gn.groupnorm_grad_design(x, groups)
            # the selected design, fused by name where tma_resident
            # is selected, and split
            designs = {chosen, "split"} | ({"fused"} if chosen == "tma_resident" else set())
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
    once each, no plain version; the backward is ``tma_resident``'s (the
    same bits as that design by name)."""
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
    assert _gn.groupnorm_grad_design(x, 32) == "tma_resident"
    want = group_norm_silu_grad(x, gamma.detach(), beta.detach(), g, 32, 1e-5, False, ao=ao,
                                design="tma_resident")
    assert torch.equal(leaf.grad, want[0]) and torch.equal(gamma.grad, want[1])
    assert torch.equal(beta.grad, want[2])


@pytest.mark.gpu
def test_card_resident_entry_point_refuses_overruns(card):  # noqa: F811
    """The C entry point of ``tma_resident`` refuses a plan whose tiling
    would overrun: stages that do not reach N, a chunk of no whole groups,
    more samples than a block's threads take, a misaligned dx, more blocks
    than items, one buffer for several items, four buffers; a grid of fewer
    blocks than items, with two buffers or three, gives the plan's bits."""
    from probabilisticdeepdiffusionmodels_torch.ops import _build

    b, n, c = 4, 64, 256
    x = torch.randn(b, n, c, device="cuda").to(torch.bfloat16)
    g = torch.randn_like(x)
    gamma, beta = torch.ones(c, device="cuda"), torch.zeros(c, device="cuda")
    _, ao = _gn._launch(x, gamma, beta, 32, 1e-5, True, want_ao=True)
    f32 = dict(dtype=torch.float32, device="cuda")
    shares = torch.empty(b, 2, c, **f32)
    dgamma, dbeta = torch.empty(c, **f32), torch.empty(c, **f32)
    spare = torch.empty(x.numel() + 8, dtype=x.dtype, device="cuda")

    def launch(dx, chb, spb, srows, stages, grid, bufs):
        _build.launch("pddm_group_norm_silu_grad_resident", x.data_ptr(), g.data_ptr(),
                      ao.data_ptr(), gamma.data_ptr(), dx, shares.data_ptr(), dgamma.data_ptr(),
                      dbeta.data_ptr(), b, n, c, 32, 1e-5, 1, chb, spb, srows, stages, grid, bufs)

    plan = _gn.resident_plan(b, n, c, 32, 2, x.data_ptr())
    assert plan.items(b, c) == plan.grid == 16 and plan.bufs == 1
    launch(spare.data_ptr(), *plan)  # the plan's own geometry launches
    want = spare[:x.numel()].clone()
    for grid, bufs in ((5, 2), (5, 3), (1, 2), (1, 3)):
        spare.zero_()
        launch(spare.data_ptr(), *plan._replace(grid=grid, bufs=bufs))
        assert torch.equal(spare[:x.numel()], want), (grid, bufs)
    bad = [plan._replace(srows=plan.srows - 1), plan._replace(chb=60), plan._replace(spb=16),
           plan._replace(grid=17), plan._replace(grid=8, bufs=1), plan._replace(grid=8, bufs=4)]
    for geometry in bad:
        with pytest.raises(RuntimeError):
            launch(spare.data_ptr(), *geometry)
    with pytest.raises(RuntimeError):
        launch(spare.data_ptr() + 2, *plan)
    torch.cuda.synchronize()
