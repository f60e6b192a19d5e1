"""The port's kernel-bearing ops against the JAX package.

Each op's CPU path (its plain version) is held against the JAX ``*_xla``
reference and against the Pallas kernel run in interpret mode, on the same
numpy inputs, at the tolerances of tests/test_pallas_ops.py.  Tests marked
``gpu`` hold each CUDA kernel against its plain version at the UNet's
main-path shapes and skip without a card.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from probabilisticdeepdiffusionmodels_tpu.ops.attention import qkv_attention_xla
from probabilisticdeepdiffusionmodels_tpu.ops.attention_pallas import (
    qkv_attention_pallas,
)
from probabilisticdeepdiffusionmodels_tpu.ops.gn_conv_pallas import (
    gn_affine as jax_gn_affine,
    gn_silu_conv3x3_pallas,
    gn_silu_conv3x3_xla,
)
from probabilisticdeepdiffusionmodels_tpu.ops.groupnorm_pallas import (
    group_norm_silu_pallas,
    group_norm_silu_xla,
)
from probabilisticdeepdiffusionmodels_torch.ops import (
    conv_design,
    gn_affine,
    gn_affine_grad,
    gn_affine_grad_plain,
    gn_affine_plain,
    gn_silu_conv3x3,
    gn_silu_conv3x3_plain,
    group_norm_silu,
    group_norm_silu_plain,
    groupnorm_design,
    qkv_attention,
    qkv_attention_plain,
)
from probabilisticdeepdiffusionmodels_torch.ops.groupnorm import (
    _launch as groupnorm_launch,
    fused_plan,
    moments_plan,
)
from probabilisticdeepdiffusionmodels_torch.ops import gn_conv as _gc
from probabilisticdeepdiffusionmodels_torch.ops import groupnorm as _gn
from test_torch_threads import one_torch_thread  # noqa: E402,F401


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------- attention


# (heads, width): head width 64, then 96 (unet_celeba / unet_celebahq64's
# 384 channels over 4 heads at 16x16)
_ATTN_CASES = [(1, 64), (2, 64), (4, 64), (1, 96), (4, 384)]


@pytest.mark.parametrize("num_heads,width", _ATTN_CASES)
@pytest.mark.parametrize("tokens", [16, 64])
def test_attention_matches_jax_f32(num_heads, width, tokens):
    rng = np.random.RandomState(tokens + num_heads + width)
    qkv = rng.randn(2, tokens, 3 * width).astype(np.float32)
    ref = np.asarray(qkv_attention_xla(jnp.asarray(qkv), num_heads))
    pallas = np.asarray(qkv_attention_pallas(jnp.asarray(qkv), num_heads, interpret=True))
    out = qkv_attention(_t(qkv), num_heads).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out, pallas, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("num_heads,width", _ATTN_CASES)
@pytest.mark.parametrize("tokens", [16, 64])
def test_attention_matches_jax_bf16(num_heads, width, tokens):
    rng = np.random.RandomState(100 + tokens + num_heads + width)
    qkv = rng.randn(2, tokens, 3 * width).astype(np.float32)
    qkv_j = jnp.asarray(qkv, jnp.bfloat16)
    ref = np.asarray(qkv_attention_xla(qkv_j, num_heads), np.float32)
    pallas = np.asarray(qkv_attention_pallas(qkv_j, num_heads, interpret=True), np.float32)
    out = qkv_attention(_t(qkv).to(torch.bfloat16), num_heads)
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    np.testing.assert_allclose(out, ref, rtol=0.05, atol=0.05)
    np.testing.assert_allclose(out, pallas, rtol=0.05, atol=0.05)


# ------------------------------------------------------------- groupnorm


@pytest.mark.parametrize("silu", [True, False])
def test_groupnorm_matches_jax(silu):
    rng = np.random.RandomState(int(silu))
    x = rng.randn(2, 8, 8, 64).astype(np.float32)
    gamma = rng.randn(64).astype(np.float32)
    beta = rng.randn(64).astype(np.float32)
    ref = np.asarray(group_norm_silu_xla(jnp.asarray(x), gamma, beta, num_groups=32,
                                         silu=silu))
    pallas = np.asarray(group_norm_silu_pallas(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), num_groups=32,
        silu=silu, interpret=True))
    out = group_norm_silu(_t(x), _t(gamma), _t(beta), 32, silu=silu).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(out, pallas, rtol=2e-4, atol=2e-5)


def test_groupnorm_tokens_layout():
    """The attention norm runs on (B, T, C) tokens: same result as the
    (B, H, W, C) image it was flattened from."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 4, 4, 32).astype(np.float32)
    gamma = rng.randn(32).astype(np.float32)
    beta = rng.randn(32).astype(np.float32)
    ref = np.asarray(group_norm_silu_xla(jnp.asarray(x), gamma, beta, num_groups=8,
                                         silu=False))
    out = group_norm_silu(_t(x).reshape(2, 16, 32), _t(gamma), _t(beta), 8, silu=False)
    np.testing.assert_allclose(out.reshape(2, 4, 4, 32).numpy(), ref, rtol=2e-4, atol=2e-5)


# ------------------------------------------------------------- gn + conv


def _conv_case(mode, cout, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 8, 8, 64).astype(np.float32)
    gamma = rng.randn(64).astype(np.float32)
    beta = rng.randn(64).astype(np.float32)
    w = (0.1 * rng.randn(3, 3, 64, cout)).astype(np.float32)  # HWIO
    bias = rng.randn(cout).astype(np.float32)
    emb = rng.randn(2, 64).astype(np.float32) if mode == "emb" else None
    film = ((rng.randn(2, 64).astype(np.float32), rng.randn(2, 64).astype(np.float32))
            if mode == "film" else None)
    return x, gamma, beta, w, bias, emb, film


_CONV_CASES = [("plain", 32), ("emb", 32), ("film", 32), ("plain", 3)]


@pytest.mark.parametrize("mode,cout", _CONV_CASES)
def test_gn_affine_matches_jax(mode, cout):
    x, gamma, beta, _, _, emb, film = _conv_case(mode, cout, 0)
    a_j, off_j = jax_gn_affine(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), 32, 1e-5,
        emb=None if emb is None else jnp.asarray(emb),
        film=None if film is None else tuple(map(jnp.asarray, film)))
    a, off = gn_affine(_t(x), _t(gamma), _t(beta), 32, 1e-5,
                       emb=None if emb is None else _t(emb),
                       film=None if film is None else tuple(map(_t, film)))
    np.testing.assert_allclose(a.numpy(), np.asarray(a_j), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(off.numpy(), np.asarray(off_j), rtol=2e-5, atol=2e-5)


def _affine_case(mode, shape, seed, dtype=np.float32):
    """x (B, *spatial, C), gamma, beta and the mode's conditioning; the FiLM
    pair is the two halves of one (B, 2C) tensor, as the ResBlock chunks it."""
    rng = np.random.RandomState(seed)
    b, c = shape[0], shape[-1]
    x = (rng.randn(*shape) + 0.3).astype(dtype)
    gamma, beta = rng.randn(c).astype(np.float32), rng.randn(c).astype(np.float32)
    emb = rng.randn(b, c).astype(dtype) if mode == "emb" else None
    both = rng.randn(b, 2 * c).astype(dtype) if mode == "film" else None
    return x, gamma, beta, emb, both


def _affine_kwargs(emb, both, to):
    """emb= / film= for the JAX function or the port's (``to`` converts)."""
    if both is not None:
        half = both.shape[1] // 2
        both = to(both)
        return dict(film=(both[:, :half], both[:, half:]))
    return dict(emb=None if emb is None else to(emb))


@pytest.mark.parametrize("mode", ["plain", "emb", "film"])
def test_gn_affine_cpu_is_the_plain_version(mode):
    """On a CPU tensor the wrapper is the plain version, bit for bit, and
    counts no launch."""
    x, gamma, beta, emb, both = _affine_case(mode, (2, 6, 6, 64), 4)
    kw = _affine_kwargs(emb, both, _t)
    gn_affine.launches = 0
    got = gn_affine(_t(x), _t(gamma), _t(beta), 32, 1e-5, **kw)
    want = gn_affine_plain(_t(x), _t(gamma), _t(beta), 32, 1e-5, **kw)
    assert gn_affine.launches == 0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_gn_affine_strided_film_matches_jax():
    """The FiLM pair as the ResBlock hands it over: two strided views of one
    ``chunk(2, dim=-1)``, not contiguous."""
    x, gamma, beta, _, both = _affine_case("film", (2, 8, 8, 64), 5)
    film = _t(both).chunk(2, dim=-1)
    assert not film[0].is_contiguous() and not film[1].is_contiguous()
    a_j, off_j = jax_gn_affine(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), 32, 1e-5,
                               **_affine_kwargs(None, both, jnp.asarray))
    a, off = gn_affine(_t(x), _t(gamma), _t(beta), 32, 1e-5, film=film)
    np.testing.assert_allclose(a.numpy(), np.asarray(a_j), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(off.numpy(), np.asarray(off_j), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("mode", ["plain", "emb", "film"])
def test_gn_affine_three_channel_groups_matches_jax(mode):
    """C = 96 in gcd(32, 96) = 32 groups of 3 channels: a group is no whole
    number of 16-byte vectors."""
    x, gamma, beta, emb, both = _affine_case(mode, (2, 4, 4, 96), 6)
    a_j, off_j = jax_gn_affine(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), 32, 1e-5,
                               **_affine_kwargs(emb, both, jnp.asarray))
    a, off = gn_affine(_t(x), _t(gamma), _t(beta), 32, 1e-5, **_affine_kwargs(emb, both, _t))
    np.testing.assert_allclose(a.numpy(), np.asarray(a_j), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(off.numpy(), np.asarray(off_j), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("mode", ["plain", "emb", "film"])
def test_gn_affine_grad_cpu_is_autograd_through_the_plain_version(mode):
    """On CPU tensors ``gn_affine_grad`` is its plain version, which is what
    ``backward`` through ``gn_affine`` gives; no launch is counted."""
    x, gamma, beta, emb, both = _affine_case(mode, (2, 4, 4, 64), 9)
    kw = _affine_kwargs(emb, both, _t)
    rng = np.random.RandomState(10)
    ga, goff = (_t(rng.randn(2, 64).astype(np.float32)) for _ in range(2))
    gn_affine_grad.launches = 0
    got = gn_affine_grad(_t(x), _t(gamma), _t(beta), 32, 1e-5, ga, goff, None, **kw)
    want = gn_affine_grad_plain(_t(x), _t(gamma), _t(beta), 32, 1e-5, ga, goff, **kw)
    assert gn_affine_grad.launches == 0 and len(got) == 3 + (mode == "emb") + 2 * (mode == "film")
    leaves = [_t(x).requires_grad_(True), _t(gamma).requires_grad_(True),
              _t(beta).requires_grad_(True)]
    conds = ([kw["emb"]] if mode == "emb" else list(kw["film"]) if mode == "film" else [])
    conds = [t.clone().requires_grad_(True) for t in conds]
    kw_leaves = (dict(emb=conds[0]) if mode == "emb" else dict(film=tuple(conds))
                 if mode == "film" else {})
    a, off = gn_affine(*leaves, 32, 1e-5, **kw_leaves)
    auto = torch.autograd.grad((a, off), leaves + conds, (ga, goff))
    for p, q, r in zip(got, want, auto):
        assert torch.equal(p, q)
        torch.testing.assert_close(p, r, rtol=1e-6, atol=1e-7)


# (B, N, C, itemsize, address): the CIFAR UNet's conv sites at batch 128,
# its float32 head, a 64x64 and a 256x256 image, C = 96 and 36 (no multiple
# of 8), a 2-byte aligned bf16 tensor, a batch of one
_PLAN_SHAPES = [(128, 1024, 128, 2, 0), (128, 1024, 384, 2, 0), (128, 256, 512, 2, 0),
                (128, 64, 256, 2, 0), (128, 16, 512, 2, 0), (128, 1024, 128, 4, 0),
                (8, 4096, 128, 2, 0), (2, 65536, 128, 2, 0), (8, 256, 96, 2, 0),
                (16, 784, 36, 2, 0), (4, 100, 64, 2, 2), (1, 50, 4100, 4, 16)]


@pytest.mark.parametrize("b,n,c,itemsize,addr", _PLAN_SHAPES)
def test_moments_plan_covers_every_element_once(b, n, c, itemsize, addr):
    """The blocks of a plan, summed as the kernel sums them (a thread per
    vector and row, rows in steps of the block's height, then the splits in
    order), give the plain sums; vectors divide C and the address."""
    plan = moments_plan(b, n, c, itemsize, addr)
    assert c % plan.v == 0 and addr % (plan.v * itemsize) == 0 and 1 <= plan.cvb <= 256
    assert plan.v == 16 // itemsize or c % (2 * plan.v) or addr % (2 * plan.v * itemsize)
    assert plan.splits * plan.rows >= n > (plan.splits - 1) * plan.rows
    rng = np.random.RandomState(n + c)
    x = _t(rng.randn(n, c).astype(np.float32)).double()
    total = torch.zeros(c, dtype=torch.float64)
    height, chb = 256 // plan.cvb, plan.cvb * plan.v
    for s in range(plan.splits):
        rows = x[s * plan.rows:min(n, (s + 1) * plan.rows)]
        for chunk in range(plan.chunks(c)):
            part = rows[:, chunk * chb:(chunk + 1) * chb]
            total[chunk * chb:(chunk + 1) * chb] += sum(part[ty::height].sum(0)
                                                        for ty in range(height))
    torch.testing.assert_close(total, x.sum(0), rtol=1e-12, atol=1e-9)


def test_moments_plan_leaves_small_sites_whole():
    """The 4x4 and 8x8 sites at batch 128 are one block a sample (no
    workspace, no counter); the 32x32 ones are split to fill the card."""
    for n, c in [(16, 256), (16, 512), (64, 256), (64, 512)]:
        plan = moments_plan(128, n, c, 2, 0)
        assert (plan.splits, plan.chunks(c)) == (1, 1)
    plan = moments_plan(128, 1024, 128, 2, 0)
    assert plan.splits > 1 and 128 * plan.splits >= 3 * 132  # three blocks an SM and more


@pytest.mark.parametrize("n,c,groups,itemsize,fused", [
    (256, 256, 32, 2, True), (64, 256, 32, 2, True), (16, 256, 32, 2, True),  # CIFAR norms
    (256, 256, 32, 4, True), (256, 384, 32, 2, True), (256, 96, 32, 2, True),
    (4096, 128, 32, 2, False), (65536, 128, 32, 2, False), (784, 36, 4, 2, False),
])
def test_fused_groupnorm_plan_owns_whole_groups(n, c, groups, itemsize, fused):
    plan = fused_plan(n, c, groups, itemsize, 0)
    assert (plan is not None) == fused
    x = torch.empty(2, n, c, dtype=torch.bfloat16 if itemsize == 2 else torch.float32)
    assert groupnorm_design(x, groups) == ("fused" if fused else "split")
    if fused:
        chunk = plan.cvb * plan.v
        assert chunk % (c // groups) == 0 and c % plan.v == 0 and plan.cvb <= 256
        assert (plan.splits, plan.rows) == (1, n) and n * chunk * itemsize <= 48 * 1024


@pytest.mark.parametrize("mode,cout", _CONV_CASES)
def test_gn_silu_conv_matches_jax(mode, cout):
    """Plain, emb and FiLM modes plus the Cout=3 output head, against the
    XLA reference and the interpret-mode Pallas kernel fed JAX's own fold."""
    x, gamma, beta, w, bias, emb, film = _conv_case(mode, cout, 1)
    emb_j = None if emb is None else jnp.asarray(emb)
    film_j = None if film is None else tuple(map(jnp.asarray, film))
    ref = np.asarray(gn_silu_conv3x3_xla(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), jnp.asarray(w),
        jnp.asarray(bias), num_groups=32, emb=emb_j, film=film_j))
    a_j, off_j = jax_gn_affine(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
                               32, 1e-5, emb=emb_j, film=film_j)
    pallas = np.asarray(gn_silu_conv3x3_pallas(
        jnp.asarray(x), a_j, off_j, jnp.asarray(w), jnp.asarray(bias), interpret=True))

    a, off = gn_affine(_t(x), _t(gamma), _t(beta), 32, 1e-5,
                       emb=None if emb is None else _t(emb),
                       film=None if film is None else tuple(map(_t, film)))
    w_hwoi = _t(w.transpose(0, 1, 3, 2))
    out = gn_silu_conv3x3(_t(x), a, off, w_hwoi, _t(bias)).numpy()
    assert out.shape == (2, 8, 8, cout)
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out, pallas, rtol=2e-4, atol=2e-4)


def test_gn_silu_conv_halo_is_zero_after_activation():
    """silu(0*a + off) != 0, so padding before the activation would differ
    at the border: with a large offset the border pixels must still see
    zero taps outside the image."""
    x = torch.zeros(1, 4, 4, 2)
    a = torch.ones(1, 2)
    off = torch.full((1, 2), 3.0)  # silu(3) ~ 2.86 everywhere inside
    w = torch.ones(3, 3, 1, 2)
    out = gn_silu_conv3x3(x, a, off, w, torch.zeros(1))[0, :, :, 0]
    v = 2 * float(torch.nn.functional.silu(torch.tensor(3.0)))
    assert torch.allclose(out[1, 1], torch.tensor(9 * v))   # interior: 9 taps
    assert torch.allclose(out[0, 0], torch.tensor(4 * v))   # corner: 4 taps
    assert torch.allclose(out[0, 1], torch.tensor(6 * v))   # edge: 6 taps


# ------------------------------------------------------------- dispatch rules


@pytest.mark.parametrize("shape,dtype,design", [
    ((128, 32, 32, 128, 128), torch.bfloat16, "wgmma"),   # CIFAR 32x32 ResBlock
    ((128, 4, 4, 512, 256), torch.bfloat16, "wgmma"),     # CIFAR middle, 4x4
    ((2, 8, 256, 128, 128), torch.bfloat16, "wgmma"),     # CelebA-HQ 256-wide rows
    ((8, 28, 28, 32, 64), torch.bfloat16, "wgmma"),       # MNIST
    ((128, 32, 32, 128, 3), torch.float32, "narrow_f32"),  # the output head
    ((8, 32, 32, 128, 6), torch.float32, "narrow_f32"),   # learned-sigma head
    ((3, 28, 28, 36, 24), torch.bfloat16, "general"),     # Cin % 8 != 0
    ((2, 8, 8, 64, 32), torch.float32, "general"),        # a wide float32 conv
])
def test_conv_design_by_shape(shape, dtype, design):
    """The design each conv call runs: every bf16 shape of the shipped
    configs takes wgmma, the float32 head the narrow path."""
    b, h, w, cin, cout = shape
    x = torch.empty(b, h, w, cin, dtype=dtype)
    assert conv_design(x, torch.empty(3, 3, cout, cin, dtype=dtype)) == design


def test_conv_weight_cast_is_reused_until_changed():
    """Outside autograd the conv keeps each weight's cast and reuses it
    until the weight changes in place; a recorded cast is never reused."""
    from probabilisticdeepdiffusionmodels_torch.ops.gn_conv import _weight_in
    x = torch.zeros(1, 4, 4, 8, dtype=torch.bfloat16)
    w = torch.randn(3, 3, 8, 8)
    with torch.no_grad():
        first = _weight_in(w, x)
        assert _weight_in(w, x) is first
        w.mul_(2.0)
        again = _weight_in(w, x)
    assert again is not first and torch.equal(again, w.to(torch.bfloat16))
    p = torch.nn.Parameter(torch.randn(3, 3, 8, 8))
    assert _weight_in(p, x).grad_fn is not None


def test_cpu_calls_leave_launch_counters_at_zero():
    for fn in (qkv_attention, group_norm_silu, gn_silu_conv3x3, gn_affine):
        fn.launches = 0
    x = torch.randn(1, 4, 4, 32)
    qkv_attention(torch.randn(1, 16, 96), 1)
    group_norm_silu(x, torch.ones(32), torch.zeros(32), 32)
    a, off = gn_affine(x, torch.ones(32), torch.zeros(32), 32, 1e-5)
    gn_silu_conv3x3(x, a, off, torch.randn(3, 3, 8, 32), torch.zeros(8))
    assert (qkv_attention.launches, group_norm_silu.launches,
            gn_silu_conv3x3.launches, gn_affine.launches) == (0, 0, 0, 0)


# ------------------------------------------------------------- on the card

# (B, T, 3C) with 4 heads of 64: the CIFAR UNet's three attention sizes;
# 4 heads of 96 and of 128 (CelebA's 16x16 and 8x8 attention); then 4 heads
# of 128 over T=1024, the widest head and longest sequence the kernel serves
# (a ring of K/V tiles, a ragged last query tile at T=1000)
_ATTN_SHAPES = [(128, 256, 768), (128, 64, 768), (128, 16, 768), (128, 256, 1152),
                (128, 64, 1536), (2, 1024, 1536), (2, 1000, 1536)]
# (B, H, W, Cin, Cout): the 11 bf16 conv signatures of the CIFAR UNet's
# forward and its output head; a 64x64 image (CelebA) and 256-wide rows
# (CelebA-HQ, row segments); MNIST's 28x28; the learned-sigma head (Cout 6);
# then Cin % 8 != 0 at 28x28 and a width over 64 with Cin 16, Cout 8
_CONV_SHAPES = [(128, 32, 32, 128, 128), (128, 32, 32, 256, 128), (128, 32, 32, 384, 128),
                (128, 16, 16, 128, 256), (128, 16, 16, 256, 256), (128, 16, 16, 384, 256),
                (128, 16, 16, 512, 256), (128, 8, 8, 256, 256), (128, 8, 8, 512, 256),
                (128, 4, 4, 256, 256), (128, 4, 4, 512, 256), (128, 32, 32, 128, 3),
                (8, 64, 64, 128, 128), (2, 8, 256, 128, 128), (16, 28, 28, 32, 64),
                (8, 32, 32, 128, 6), (3, 28, 28, 36, 24), (2, 70, 70, 16, 8)]
_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}


@contextlib.contextmanager
def true_float32():
    """TF32 off for cuDNN convs and cuBLAS matmuls (the plain versions run
    true float32, as JAX pins it), both flags restored on the way out."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.fixture
def card():
    """A test on the card: skipped without one, run in true float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with true_float32():
        yield


def test_true_float32_restores_the_tf32_flags():
    flags = (torch.backends.cudnn, torch.backends.cuda.matmul)
    saved = tuple(f.allow_tf32 for f in flags)
    try:
        for f in flags:
            f.allow_tf32 = True
        with pytest.raises(KeyError), true_float32():
            assert not any(f.allow_tf32 for f in flags)
            raise KeyError
        assert all(f.allow_tf32 for f in flags)
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_attention_kernel_matches_plain(dtype, card):
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in _ATTN_SHAPES:
        qkv = torch.randn(shape, device="cuda", generator=gen).to(dtype)
        out = qkv_attention(qkv, 4)
        torch.cuda.synchronize()
        ref = qkv_attention_plain(qkv, 4)
        torch.testing.assert_close(out.float(), ref.float(), rtol=_TOL[dtype],
                                   atol=_TOL[dtype])


# (shape, groups): the CIFAR UNet's three attention norms; unet_celebahq64's
# (384 and 512 channels at 16x16 and 8x8); 96 channels in groups of 3 and
# MNIST's 28x28 with 36 channels in groups of 9; then the split design: a
# 64x64 and a 256x256 image of 128 channels
_GN_SHAPES = [((128, 256, 256), 32), ((128, 64, 256), 32), ((128, 16, 256), 32),
              ((8, 256, 384), 32), ((8, 64, 512), 32), ((8, 16, 16, 96), 32),
              ((16, 28, 28, 36), 4), ((2, 4096, 128), 32), ((2, 256, 256, 128), 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_groupnorm_kernel_matches_plain(dtype, card):
    """Both designs where both apply, with two runs of each compared bit
    for bit."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    for shape, groups in _GN_SHAPES:
        x = (torch.randn(shape, device="cuda", generator=gen) + 0.5).to(dtype)
        gamma = torch.randn(shape[-1], device="cuda", generator=gen)
        beta = torch.randn(shape[-1], device="cuda", generator=gen)
        designs = {groupnorm_design(x, groups), "split"}
        for silu in (False, True):
            ref = group_norm_silu_plain(x, gamma, beta, groups, silu=silu)
            out = group_norm_silu(x, gamma, beta, groups, silu=silu)
            torch.cuda.synchronize()
            torch.testing.assert_close(out.float(), ref.float(), rtol=_TOL[dtype],
                                       atol=_TOL[dtype])
            for design in designs:
                runs = [groupnorm_launch(x, gamma, beta, groups, 1e-5, silu, design)
                        for _ in range(2)]
                torch.cuda.synchronize()
                assert torch.equal(runs[0], runs[1]), (shape, design)
                torch.testing.assert_close(runs[0].float(), ref.float(), rtol=_TOL[dtype],
                                           atol=_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_gn_conv_kernel_matches_plain(dtype, card):
    gen = torch.Generator(device="cuda").manual_seed(2)
    for b, h, w, cin, cout in _CONV_SHAPES:
        x = torch.randn(b, h, w, cin, device="cuda", generator=gen).to(dtype)
        a = 1.0 + 0.1 * torch.randn(b, cin, device="cuda", generator=gen)
        off = 0.5 * torch.randn(b, cin, device="cuda", generator=gen)
        wt = torch.randn(3, 3, cout, cin, device="cuda", generator=gen) / (3 * cin ** 0.5)
        bias = torch.randn(cout, device="cuda", generator=gen)
        out = gn_silu_conv3x3(x, a, off, wt, bias)
        torch.cuda.synchronize()
        ref = gn_silu_conv3x3_plain(x, a, off, wt, bias)
        torch.testing.assert_close(out.float(), ref.float(), rtol=_TOL[dtype],
                                   atol=_TOL[dtype])


# (shape, groups): every gn_affine site of the CIFAR UNet's forward at batch
# 128; unet_celebahq64's 64x64 input and widest site; 96 channels in groups
# of 3; MNIST's 28x28 (32 channels, and 36 in groups of 9); a 256x256 image
# (a sample split over 256 blocks); a wide one whose channels take two chunks
_AFFINE_SHAPES = [((128, 32, 32, 128), 32), ((128, 32, 32, 256), 32), ((128, 32, 32, 384), 32),
                  ((128, 16, 16, 128), 32), ((128, 16, 16, 256), 32), ((128, 16, 16, 384), 32),
                  ((128, 16, 16, 512), 32), ((128, 8, 8, 256), 32), ((128, 8, 8, 512), 32),
                  ((128, 4, 4, 256), 32), ((128, 4, 4, 512), 32), ((8, 64, 64, 128), 32),
                  ((8, 8, 8, 1024), 32), ((8, 16, 16, 96), 32), ((16, 28, 28, 32), 32),
                  ((16, 28, 28, 36), 4), ((2, 256, 256, 128), 32), ((4, 8, 8, 4096), 32)]


def _affine_tol(ref):
    # float32 outputs, sums in another order than torch.mean's
    return 1e-4 * max(1.0, float(ref.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_gn_affine_kernel_matches_plain(dtype, card):
    """Moments + fold against the plain version at every site shape, in the
    three modes (the FiLM pair as strided halves of one tensor), with two
    runs compared bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    for shape, groups in _AFFINE_SHAPES:
        b, c = shape[0], shape[-1]
        x = (torch.randn(shape, device="cuda", generator=gen) + 0.5).to(dtype)
        gamma = torch.randn(c, device="cuda", generator=gen)
        beta = torch.randn(c, device="cuda", generator=gen)
        emb = torch.randn(b, c, device="cuda", generator=gen).to(dtype)
        film = torch.randn(b, 2 * c, device="cuda", generator=gen).to(dtype).chunk(2, dim=-1)
        for kw in ({}, {"emb": emb}, {"film": film}):
            before = gn_affine.launches
            runs = [gn_affine(x, gamma, beta, groups, 1e-5, **kw) for _ in range(2)]
            torch.cuda.synchronize()
            assert gn_affine.launches == before + 2
            ref = gn_affine_plain(x, gamma, beta, groups, 1e-5, **kw)
            for got, again, want in zip(runs[0], runs[1], ref):
                assert got.dtype == torch.float32 and got.shape == (b, c)
                assert torch.equal(got, again), (shape, sorted(kw))
                err = float((got - want).abs().max())
                assert err <= _affine_tol(want), (shape, sorted(kw), err)


@pytest.mark.gpu
def test_card_gn_affine_narrow_vectors_and_rules(card):
    """A bf16 tensor whose address is only 2-byte aligned takes scalar
    loads, not the plain version; what the kernel does not take raises."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    flat = torch.randn(1 + 4 * 10 * 10 * 64, device="cuda", generator=gen).to(torch.bfloat16)
    x = flat[1:].view(4, 10, 10, 64)
    assert x.data_ptr() % 4 == 2 and x.is_contiguous()
    gamma, beta = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")
    before = gn_affine.launches
    got = gn_affine(x, gamma, beta, 32, 1e-5)
    torch.cuda.synchronize()
    assert gn_affine.launches == before + 1
    for p, q in zip(got, gn_affine_plain(x, gamma, beta, 32, 1e-5)):
        assert float((p - q).abs().max()) <= _affine_tol(q)
    out = group_norm_silu(x, gamma, beta, 32)
    torch.testing.assert_close(out.float(), group_norm_silu_plain(x, gamma, beta, 32).float(),
                               rtol=5e-2, atol=5e-2)
    with pytest.raises(ValueError, match="contiguous"):
        gn_affine(x.transpose(1, 2), gamma, beta, 32, 1e-5)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        gn_affine(x.double(), gamma, beta, 32, 1e-5)
    with pytest.raises(ValueError, match="not both"):
        gn_affine(x, gamma, beta, 32, 1e-5, emb=torch.zeros(4, 64, device="cuda"),
                  film=(torch.zeros(4, 64, device="cuda"),) * 2)


def _affine_case_on_card(shape, dtype, gen):
    b, c = shape[0], shape[-1]
    x = (torch.randn(shape, device="cuda", generator=gen) + 0.5).to(dtype)
    gamma = torch.randn(c, device="cuda", generator=gen)
    beta = torch.randn(c, device="cuda", generator=gen)
    emb = torch.randn(b, c, device="cuda", generator=gen).to(dtype)
    film = torch.randn(b, 2 * c, device="cuda", generator=gen).to(dtype).chunk(2, dim=-1)
    return x, gamma, beta, ({}, {"emb": emb}, {"film": film})


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_gn_affine_designs_match_plain(dtype, card):
    """``moments_fold`` in each design by name (``cluster`` where the shape
    takes it, ``workspace`` at every shape) at every site shape in the three
    modes, against the plain version, two runs bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    for shape, groups in _AFFINE_SHAPES:
        x, gamma, beta, modes = _affine_case_on_card(shape, dtype, gen)
        for kw in modes:
            g32, b32, mode, conds = _gc.kernel_args(x, gamma, beta, groups, kw.get("emb"),
                                                    kw.get("film"))
            ref = gn_affine_plain(x, gamma, beta, groups, 1e-5, **kw)
            for design in {_gn.affine_design(x, groups), "workspace"}:
                runs = [_gn.moments_fold(x, g32, b32, groups, 1e-5, design=design,
                                         **_gc._named(mode, conds)) for _ in range(2)]
                torch.cuda.synchronize()
                assert torch.equal(runs[0], runs[1]), (shape, design, sorted(kw))
                for got, want in zip(runs[0][:2], ref):
                    err = float((got - want).abs().max())
                    assert err <= _affine_tol(want), (shape, design, sorted(kw), err)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_gn_affine_grad_designs_match_plain(dtype, card):
    """``gn_affine_grad`` in each design by name (``fused_bwd`` where the
    shape takes it, ``fold_bwd+apply`` at every shape) at every site shape
    in the three modes, against autograd through the plain version: 2e-2
    (bf16) or 1e-4 (float32) of each gradient's largest element, as
    ``chip_smoke.py`` holds them; one launch counted a call; two runs bit
    for bit.  The conditioning's gradient is held at the scale of its first
    term, |dL/doff * a|: with one channel a group (C = 32 in 32 groups) it
    is zero in exact arithmetic, and both sides leave round-off."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    for shape, groups in _AFFINE_SHAPES:
        x, gamma, beta, modes = _affine_case_on_card(shape, dtype, gen)
        b, c = shape[0], shape[-1]
        ga, goff = torch.randn(2, b, c, device="cuda", generator=gen)
        for kw in modes:
            g32, b32, mode, conds = _gc.kernel_args(x, gamma, beta, groups, kw.get("emb"),
                                                    kw.get("film"))
            named = _gc._named(mode, conds)
            ao = _gn.moments_fold(x, g32, b32, groups, 1e-5, **named)
            want = gn_affine_grad_plain(x, gamma, beta, groups, 1e-5, ga, goff, **kw)
            floor = float((goff * ao[0]).abs().max())
            for design in {_gc.grad_design(x, groups), "fold_bwd+apply"}:
                before = gn_affine_grad.launches
                runs = [gn_affine_grad(x, g32, b32, groups, 1e-5, ga, goff, ao, design=design,
                                       **named) for _ in range(2)]
                torch.cuda.synchronize()
                assert gn_affine_grad.launches == before + 2, design
                for i, (got, again, ref) in enumerate(zip(*runs, want)):
                    assert got.dtype == ref.dtype and got.shape == ref.shape, (design, i)
                    assert torch.equal(got, again), (shape, design, sorted(kw), i)
                    scale = float(ref.float().abs().max())
                    if i >= 3:
                        scale = max(scale, floor)
                    err = float((got.float() - ref.float()).abs().max())
                    rtol = 2e-2 if ref.dtype == torch.bfloat16 else 1e-4
                    assert err <= rtol * scale, (shape, design, sorted(kw), i, err, scale)


# the backward kernels compute the gradient by its formula, autograd by the
# chain of the plain version's ops: float32 sums in another order
_AFFINE_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_gn_affine_gradients_match_plain(dtype, card):
    """``backward`` through ``gn_affine`` on the card (``gn_affine_grad`` in
    the design the shape selects) against autograd through the plain version,
    at a 32x32, a 16x16 and a 4x4 site and groups of 3 channels, in the three
    modes; the backward counts one launch of ``gn_affine_grad`` and none of
    ``gn_affine``."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    for (b, h, c), mode in [((128, 32, 128), "emb"), ((128, 16, 384), "film"),
                            ((128, 4, 512), "plain"), ((8, 16, 96), "emb"),
                            ((8, 16, 96), "film")]:
        x = (torch.randn(b, h, h, c, device="cuda", generator=gen) + 0.5).to(dtype)
        conds = ([torch.randn(b, c, device="cuda", generator=gen).to(dtype)] if mode == "emb"
                 else list(torch.randn(b, 2 * c, device="cuda", generator=gen).to(dtype)
                           .chunk(2, dim=-1)) if mode == "film" else [])
        leaves = [x, torch.randn(c, device="cuda", generator=gen),
                  torch.randn(c, device="cuda", generator=gen), *conds]
        leaves = [t.detach().requires_grad_(True) for t in leaves]
        g = [torch.randn(b, c, device="cuda", generator=gen) for _ in range(2)]

        def call(fn):
            kw = (dict(emb=leaves[3]) if mode == "emb" else dict(film=tuple(leaves[3:]))
                  if mode == "film" else {})
            return fn(*leaves[:3], 32, 1e-5, **kw)

        out = call(gn_affine)
        launched = (gn_affine.launches, gn_affine_grad.launches)
        got = torch.autograd.grad(out, leaves, g)
        torch.cuda.synchronize()
        assert (gn_affine.launches, gn_affine_grad.launches) == (launched[0], launched[1] + 1)
        want = torch.autograd.grad(call(gn_affine_plain), leaves, g)
        for i, (p, q) in enumerate(zip(got, want)):
            assert p.dtype == q.dtype == leaves[i].dtype and p.shape == q.shape
            scale = float(q.float().abs().max())
            err = float((p.float() - q.float()).abs().max())
            assert err <= _AFFINE_GRAD_TOL[dtype] * scale, (b, h, c, mode, i, err, scale)
        # only the offset used, and x alone wanting a gradient
        x_only = leaves[0].detach().requires_grad_(True)
        kw = (dict(emb=leaves[3].detach()) if mode == "emb"
              else dict(film=tuple(t.detach() for t in leaves[3:])) if mode == "film" else {})
        off = gn_affine(x_only, leaves[1].detach(), leaves[2].detach(), 32, 1e-5, **kw)[1]
        got = torch.autograd.grad(off, x_only, g[1])[0]
        x_ref = leaves[0].detach().requires_grad_(True)
        want = torch.autograd.grad(
            gn_affine_plain(x_ref, leaves[1].detach(), leaves[2].detach(), 32, 1e-5, **kw)[1],
            x_ref, g[1])[0]
        scale = float(want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) <= _AFFINE_GRAD_TOL[dtype] * scale


# the main path's gradient sites: a 32x32 ResBlock conv, a 16x16 one, the
# float32 output head; the widest attention norm and attention
_GRAD_CONV_SHAPES = [(128, 32, 32, 128, 128), (128, 16, 16, 384, 256), (128, 32, 32, 128, 3)]
# float32: the backward is the plain version's own, recomputed from the same
# inputs; bf16: the conv's recompute takes bf16 operands where the plain
# version takes float32 ones, and every gradient is rounded to bf16 once on
# both sides, so they differ by the order of the float32 sums and a bf16 ulp
_GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _grads_match(fn, plain, leaves, g, dtype, counter):
    out = fn(*leaves)
    assert out.grad_fn is not None
    launched = counter.launches
    got = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert counter.launches == launched  # the backward launches no kernel
    want = torch.autograd.grad(plain(*leaves), leaves, g)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype == leaves[i].dtype
        scale = float(b.float().abs().max())
        err = float((a.float() - b.float()).abs().max())
        assert err <= _GRAD_TOL[dtype] * scale, (i, err, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_kernel_gradients_match_plain(dtype, card):
    """Each op's gradient with the kernel's forward against autograd through
    the plain version, on the same leaves (float32 scale, offset, weight,
    bias and affine, as the model's parameters are)."""
    gen = torch.Generator(device="cuda").manual_seed(3)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, device="cuda", generator=gen)

    for b, h, w, cin, cout in _GRAD_CONV_SHAPES:
        dt = torch.float32 if cout == 3 else dtype
        leaves = [randn(b, h, w, cin).to(dt), 1.0 + randn(b, cin, scale=0.1),
                  randn(b, cin, scale=0.5), randn(3, 3, cout, cin, scale=1 / (3 * cin ** 0.5)),
                  randn(cout)]
        leaves = [t.requires_grad_(True) for t in leaves]
        g = randn(b, h, w, cout).to(dt)
        _grads_match(gn_silu_conv3x3, gn_silu_conv3x3_plain, leaves, g, dt, gn_silu_conv3x3)
    x = (randn(128, 256, 256) + 0.5).to(dtype).requires_grad_(True)
    affine = [randn(256).requires_grad_(True), randn(256).requires_grad_(True)]
    _grads_match(lambda *a: group_norm_silu(*a, 32, silu=False),
                 lambda *a: group_norm_silu_plain(*a, 32, silu=False),
                 [x, *affine], randn(128, 256, 256).to(dtype), dtype, group_norm_silu)
    qkv = randn(128, 256, 768).to(dtype).requires_grad_(True)
    _grads_match(lambda q: qkv_attention(q, 4), lambda q: qkv_attention_plain(q, 4), [qkv],
                 randn(128, 256, 256).to(dtype), dtype, qkv_attention)


# the visualization endpoints' batches: one image (the single
# reconstruction), ten (an interpolation's lerps); each of the CIFAR UNet's
# distinct conv and attention signatures at that batch, and the float32
# learned-sigma head (Cout 6)
_VIZ_CONV = [(32, 32, 128, 128), (32, 32, 384, 128), (16, 16, 256, 256), (16, 16, 512, 256),
             (8, 8, 512, 256), (4, 4, 256, 256), (4, 4, 512, 256)]
_VIZ_ATTN = [(256, 768), (64, 768), (16, 768)]


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 10])
def test_card_viz_batches_match_plain(batch, card):
    gen = torch.Generator(device="cuda").manual_seed(7)
    shapes = [(batch, *s, torch.bfloat16) for s in _VIZ_CONV]
    shapes.append((batch, 32, 32, 128, 6, torch.float32))
    for b, h, w, cin, cout, dtype in shapes:
        x = torch.randn(b, h, w, cin, device="cuda", generator=gen).to(dtype)
        a = 1.0 + 0.1 * torch.randn(b, cin, device="cuda", generator=gen)
        off = 0.5 * torch.randn(b, cin, device="cuda", generator=gen)
        wt = torch.randn(3, 3, cout, cin, device="cuda", generator=gen) / (3 * cin ** 0.5)
        bias = torch.randn(cout, device="cuda", generator=gen)
        before = gn_silu_conv3x3.launches
        out = gn_silu_conv3x3(x, a, off, wt, bias)
        torch.cuda.synchronize()
        assert gn_silu_conv3x3.launches == before + 1
        ref = gn_silu_conv3x3_plain(x, a, off, wt, bias)
        torch.testing.assert_close(out.float(), ref.float(), rtol=_TOL[dtype], atol=_TOL[dtype])
    for t, c3 in _VIZ_ATTN:
        qkv = torch.randn(batch, t, c3, device="cuda", generator=gen).to(torch.bfloat16)
        out = qkv_attention(qkv, 4)
        torch.cuda.synchronize()
        ref = qkv_attention_plain(qkv, 4)
        torch.testing.assert_close(out.float(), ref.float(), rtol=_TOL[torch.bfloat16],
                                   atol=_TOL[torch.bfloat16])


@pytest.mark.gpu
def test_card_learned_sigma_head_at_batch_128(card):
    """The hybrid train step's float32 output head (Cout 6, the narrow
    design) at batch 128, forward and gradients, against the plain version."""
    gen = torch.Generator(device="cuda").manual_seed(8)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, device="cuda", generator=gen)

    leaves = [randn(128, 32, 32, 128), 1.0 + randn(128, 128, scale=0.1),
              randn(128, 128, scale=0.5), randn(3, 3, 6, 128, scale=1 / (3 * 128 ** 0.5)),
              randn(6)]
    assert conv_design(leaves[0], leaves[3]) == "narrow_f32"
    with torch.no_grad():
        out = gn_silu_conv3x3(*leaves)
        torch.cuda.synchronize()
        ref = gn_silu_conv3x3_plain(*leaves)
    torch.testing.assert_close(out, ref, rtol=_TOL[torch.float32], atol=_TOL[torch.float32])
    leaves = [t.requires_grad_(True) for t in leaves]
    _grads_match(gn_silu_conv3x3, gn_silu_conv3x3_plain, leaves, randn(128, 32, 32, 6),
                 torch.float32, gn_silu_conv3x3)


# ------------------------------------------------------------- the fold alone, on the card


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["plain", "emb", "film"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fold_kernel_matches_plain_on_card(card, mode, dtype):
    """The fold kernel against its plain version at the CIFAR UNet's widths
    and a 256x256 UNet's, with float32 or bf16 conditioning: 1e-5 of the
    largest output (float32 sums in another order)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    for b, c in ((2, 128), (8, 256), (1, 512)):
        mom = torch.rand(2, b, c, device="cuda", generator=gen)
        mom[1] += mom[0] ** 2
        gamma, beta = torch.randn(2, c, device="cuda", generator=gen)
        conds = torch.randn(2, b, c, device="cuda", generator=gen).to(dtype)
        kw = {"plain": {}, "emb": {"emb": conds[0]}, "film": {"film": (conds[0], conds[1])}}[mode]
        before = _gn.gn_fold.launches
        got = _gn.gn_fold(mom, gamma, beta, 32, 1e-5, **kw)
        assert _gn.gn_fold.launches == before + 1
        want = _gn.gn_fold_plain(mom, gamma, beta, 32, 1e-5, **kw)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


@pytest.mark.gpu
def test_slab_norms_on_card_match_the_whole_norms(card):
    """With nothing to average, the slab GroupNorm (moments, fold, apply)
    and ``gn_affine_slab`` on the card against the whole-image plain
    versions."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(2, 16, 16, 128, device="cuda", generator=gen)
    gamma, beta = torch.randn(2, 128, device="cuda", generator=gen)
    emb = torch.randn(2, 128, device="cuda", generator=gen)
    same = lambda m: m  # noqa: E731
    torch.testing.assert_close(_gn.group_norm_silu_slab(x, gamma, beta, 32, 1e-5, True, same),
                               _gn.group_norm_silu_plain(x, gamma, beta, 32, 1e-5, True),
                               rtol=1e-5, atol=1e-5)
    for got, want in zip(_gc.gn_affine_slab(x, gamma, beta, 32, 1e-5, same, emb=emb),
                         _gc.gn_affine_plain(x, gamma, beta, 32, 1e-5, emb=emb)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
