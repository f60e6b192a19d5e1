"""The port's kernel-bearing ops against the JAX package.

Each op's CPU path (its plain version) is held against the JAX ``*_xla``
reference and against the Pallas kernel run in interpret mode, on the same
numpy inputs, at the tolerances of tests/test_pallas_ops.py.  Tests marked
``gpu`` hold each CUDA kernel against its plain version at the UNet's
main-path shapes and skip without a card.
"""

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
    gn_silu_conv3x3,
    gn_silu_conv3x3_plain,
    group_norm_silu,
    group_norm_silu_plain,
    qkv_attention,
    qkv_attention_plain,
)


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
    for fn in (qkv_attention, group_norm_silu, gn_silu_conv3x3):
        fn.launches = 0
    x = torch.randn(1, 4, 4, 32)
    qkv_attention(torch.randn(1, 16, 96), 1)
    group_norm_silu(x, torch.ones(32), torch.zeros(32), 32)
    a, off = gn_affine(x, torch.ones(32), torch.zeros(32), 32, 1e-5)
    gn_silu_conv3x3(x, a, off, torch.randn(3, 3, 8, 32), torch.zeros(8))
    assert (qkv_attention.launches, group_norm_silu.launches,
            gn_silu_conv3x3.launches) == (0, 0, 0)


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


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_attention_kernel_matches_plain(dtype):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in _ATTN_SHAPES:
        qkv = torch.randn(shape, device="cuda", generator=gen).to(dtype)
        out = qkv_attention(qkv, 4)
        torch.cuda.synchronize()
        ref = qkv_attention_plain(qkv, 4)
        torch.testing.assert_close(out.float(), ref.float(), rtol=_TOL[dtype],
                                   atol=_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_groupnorm_kernel_matches_plain(dtype):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    # the CIFAR UNet's three attention norms, then a 64x64 image of 128 channels
    for shape in [(128, 256, 256), (128, 64, 256), (128, 16, 256), (2, 4096, 128)]:
        x = (torch.randn(shape, device="cuda", generator=gen) + 0.5).to(dtype)
        gamma = torch.randn(shape[-1], device="cuda", generator=gen)
        beta = torch.randn(shape[-1], device="cuda", generator=gen)
        for silu in (False, True):
            out = group_norm_silu(x, gamma, beta, 32, silu=silu)
            torch.cuda.synchronize()
            ref = group_norm_silu_plain(x, gamma, beta, 32, silu=silu)
            torch.testing.assert_close(out.float(), ref.float(), rtol=_TOL[dtype],
                                       atol=_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_gn_conv_kernel_matches_plain(dtype):
    _need_card()
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
def test_card_kernel_gradients_match_plain(dtype):
    """Each op's gradient with the kernel's forward against autograd through
    the plain version, on the same leaves (float32 scale, offset, weight,
    bias and affine, as the model's parameters are)."""
    _need_card()
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
