"""The gradient of the fused-qkv attention: ``qkv_attention_grad`` and its
plain version, on the CPU, and the kernels on the card (``gpu``).

The plain backward (``qkv_attention_grad_plain``, written with the kernels'
rounding points) is held against autograd through the op's plain version
and against ``jax.vjp`` of ``qkv_attention_xla`` on the same numpy inputs,
at every head-width class (bf16: each multiple of 16 up to 128; float32:
any width up to 128) and ragged T.  The op's Function is held with the plain
versions standing in for the launches.  Tolerances, of the reference's
largest element: float32 1e-5 (the same math, sums in another order);
bf16 2e-2, since each side rounds dS, dq, dk and dv to bf16 (8 bits) at its
own points and the scores carry q and k rounded after scaling.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from probabilisticdeepdiffusionmodels_tpu.ops.attention import qkv_attention_xla
from probabilisticdeepdiffusionmodels_torch.ops import attention as _attn
from probabilisticdeepdiffusionmodels_torch.ops import (
    attention_grad_design,
    qkv_attention,
    qkv_attention_grad,
    qkv_attention_grad_plain,
    qkv_attention_plain,
)
from test_torch_ops import card  # noqa: F401
from test_torch_threads import one_torch_thread  # noqa: E402,F401

F32_TOL = 1e-5
BF16_TOL = 2e-2
_TOL = {torch.float32: F32_TOL, torch.bfloat16: BF16_TOL}
_NP = {torch.float32: np.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(b, t, heads, ch, dtype, seed):
    rng = np.random.RandomState(seed)
    qkv = rng.randn(b, t, 3 * heads * ch).astype(np.float32)
    g = rng.randn(b, t, heads * ch).astype(np.float32)
    return torch.from_numpy(qkv).to(dtype), torch.from_numpy(g).to(dtype)


def _close(got, want, tol):
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    assert err <= tol * float(want.abs().max()), (err, float(want.abs().max()))


def _autograd(qkv, g, heads):
    leaf = qkv.clone().requires_grad_(True)
    return torch.autograd.grad(qkv_attention_plain(leaf, heads), leaf, g)[0]


# (dtype, heads, ch, T): every bf16 head width the kernel takes, float32
# widths that are no multiple of 16, ragged T (not a multiple of 16 or 64)
_CASES = ([(torch.bfloat16, 4 if ch <= 64 else 2, ch, t)
           for ch, t in zip(range(16, 129, 16), (16, 33, 7, 65, 20, 1, 47, 9))]
          + [(torch.float32, 4, 64, 33), (torch.float32, 3, 40, 70),
             (torch.float32, 1, 128, 5), (torch.float32, 2, 9, 17)])


@pytest.mark.parametrize("dtype,heads,ch,t", _CASES)
def test_plain_grad_matches_autograd(dtype, heads, ch, t):
    qkv, g = _inputs(2, t, heads, ch, dtype, seed=ch + t)
    got = qkv_attention_grad_plain(qkv, g, heads)
    assert got.dtype == dtype and got.shape == qkv.shape
    _close(got, _autograd(qkv, g, heads), _TOL[dtype])


@pytest.mark.parametrize("dtype,heads", [(torch.float32, 1), (torch.float32, 4),
                                         (torch.bfloat16, 4)])
def test_plain_grad_matches_jax_vjp(dtype, heads):
    qkv, g = _inputs(2, 24, heads, 32, dtype, seed=heads)
    _, vjp = jax.vjp(lambda q: qkv_attention_xla(q, heads),
                     jnp.asarray(qkv.float().numpy(), dtype=_NP[dtype]))
    (want,) = vjp(jnp.asarray(g.float().numpy(), dtype=_NP[dtype]))
    got = qkv_attention_grad_plain(qkv, g, heads)
    _close(got, torch.from_numpy(np.array(want, dtype=np.float32)), _TOL[dtype])


def test_plain_grad_of_a_key_shift_is_zero():
    """Softmax is invariant to adding one vector to every key, so dk sums to
    zero over the keys: the kernels' D = rowsum(P * dP) keeps that to float32
    round-off (a D from the stored output would not), and so does autograd
    through the plain version."""
    qkv, g = _inputs(2, 40, 2, 32, torch.float32, seed=3)
    for grad in (qkv_attention_grad_plain(qkv, g, 2), _autograd(qkv, g, 2)):
        dk = grad.reshape(2, 40, 2, 96)[..., 32:64]
        assert float(dk.sum(1).abs().max()) <= 1e-5 * float(dk.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_wiring_on_cpu(dtype):
    """The op's Function with the plain versions standing in for the
    launches: its output is the plain forward, its gradient the plain
    backward in qkv's dtype, None for the head count; with no input that
    needs a gradient autograd records nothing."""
    qkv, g = _inputs(2, 10, 2, 32, dtype, seed=5)
    leaf = qkv.clone().requires_grad_(True)
    out = _attn._QkvAttention.apply(leaf, 2)
    assert out.grad_fn is not None and torch.equal(out, qkv_attention_plain(qkv, 2))
    out.backward(g)
    assert leaf.grad.dtype == dtype
    assert torch.equal(leaf.grad, qkv_attention_grad_plain(qkv, g, 2))
    assert _attn._QkvAttention.apply(qkv, 2).grad_fn is None
    # the wrapper on a CPU tensor: the plain version under plain autograd
    leaf2 = qkv.clone().requires_grad_(True)
    qkv_attention(leaf2, 2).backward(g)
    _close(leaf2.grad, leaf.grad, _TOL[dtype])


def test_grad_on_cpu_takes_the_plain_version():
    qkv, g = _inputs(1, 9, 1, 16, torch.float32, seed=6)
    assert torch.equal(qkv_attention_grad(qkv, g, 1), qkv_attention_grad_plain(qkv, g, 1))


@pytest.mark.parametrize("b,t,heads,ch,design", [
    (1, 4, 1, 16, "two_pass"),        # T < 64: no 64-row tile
    (128, 256, 4, 64, "wgmma"),       # the CIFAR-10 UNet's three sites
    (128, 64, 4, 64, "wgmma"),
    (128, 16, 4, 64, "two_pass"),
    (8, 256, 4, 96, "two_pass"),      # unet_celebahq64's: heads wider than 64
    (8, 64, 4, 128, "two_pass"),
    (2, 100, 4, 48, "wgmma"),         # ragged T, a narrow head
    (2, 100, 1, 48, "two_pass"),      # a 64-channel row of dO past the tensor
    (2, 320, 4, 64, "two_pass"),      # the head no longer fits shared memory
])
def test_grad_design_names(b, t, heads, ch, design):
    """``wgmma`` where a head of width 16..64 with 64 <= T fits one block's
    shared memory, ``two_pass`` (the first bf16 design) elsewhere in bf16,
    ``scalar_f32`` in float32; every kernel design has the C entry point's
    number, ``two_pass`` and ``scalar_f32`` the same launches."""
    qkv = torch.empty(b, t, 3 * heads * ch, dtype=torch.bfloat16)
    assert attention_grad_design(qkv, heads) == design
    assert attention_grad_design(qkv.float(), heads) == "scalar_f32"
    assert _attn.GRAD_DESIGNS == {"two_pass": 0, "scalar_f32": 0, "wgmma": 1}
    if design == "wgmma":
        assert _attn._wgmma_smem(t) <= 227 * 1024
    # Q, K, V and dO resident, 64 rows a tile of 128 bytes; dS^T of two key
    # tiles; the float32 dQ sums in rows of 72; L and D
    assert _attn._wgmma_smem(256) == (1024 + 4 * 256 * 128 + 2 * 64 * 128 + 256 * 72 * 4
                                      + 2 * 256 * 4 + 8)
    assert _attn._wgmma_smem(320) > 227 * 1024


# ------------------------------------------------------------- on the card

# (B, T, heads, ch): the CIFAR-10 UNet's three attention sites at batch 128,
# unet_celebahq64's (heads of 96 and 128) at batch 8, ragged T (wgmma at
# (2, 100, 4, 48), (3, 200, 2, 32) and (2, 192, 1, 64): three key tiles, the
# last round's second warpgroup idle)
_CARD_SITES = [(128, 256, 4, 64), (128, 64, 4, 64), (128, 16, 4, 64), (8, 256, 4, 96),
               (8, 64, 4, 128), (3, 33, 2, 16), (2, 100, 1, 48), (2, 7, 2, 112),
               (2, 100, 4, 48), (3, 200, 2, 32), (2, 192, 1, 64)]


def _card_inputs(b, t, heads, ch, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(b, t, 3 * heads * ch, device="cuda", generator=gen).to(dtype)
    g = torch.randn(b, t, heads * ch, device="cuda", generator=gen).to(dtype)
    return qkv, g


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_attention_grad_matches_plain(dtype, card):  # noqa: F811
    """At every site, in the design the shape selects and in bf16 in
    ``two_pass`` by name: the kernels within bf16 1e-2 / float32 1e-4 of the
    plain backward's largest element (the chip check's tolerances), the
    same bits twice, one count a call; the forward's log-sum-exp against
    the plain one; ``recompute`` counts nothing; ``wgmma`` by name where the
    shape does not fit it raises before any launch; in float32 the key
    shift's gradient (dk summed over the keys) stays at round-off."""
    for i, (b, t, heads, ch) in enumerate(_CARD_SITES):
        if dtype == torch.float32:
            b = min(b, 8)
        qkv, g = _card_inputs(b, t, heads, ch, dtype, seed=i)
        out, lse = _attn.attention_forward(qkv, heads)
        scores = torch.einsum("bthc,bshc->bhts", *[
            (z * (1.0 / math.sqrt(math.sqrt(ch)))).float() for z in _attn._split_heads(qkv, heads)[:2]])
        torch.testing.assert_close(lse, torch.logsumexp(scores, -1), rtol=0, atol=1e-4)
        ref = qkv_attention_grad_plain(qkv, g, heads)
        chosen = attention_grad_design(qkv, heads)
        tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
        for design in [chosen] + (["two_pass"] if chosen == "wgmma" else []):
            before = qkv_attention_grad.launches
            runs = [qkv_attention_grad(qkv, g, heads, lse=lse, design=design) for _ in range(2)]
            torch.cuda.synchronize()
            assert qkv_attention_grad.launches - before == 2
            assert torch.equal(runs[0], runs[1]), (b, t, heads, ch, design)
            err = float((runs[0].float() - ref.float()).abs().max())
            assert err <= tol * float(ref.float().abs().max()), ((b, t, heads, ch, design), err)
        if dtype == torch.bfloat16 and chosen != "wgmma":
            before = qkv_attention_grad.launches
            with pytest.raises(RuntimeError, match="CUDA error"):
                qkv_attention_grad(qkv, g, heads, lse=lse, design="wgmma")
            assert qkv_attention_grad.launches == before
        if dtype == torch.float32:
            dk = runs[0].reshape(b, t, heads, 3 * ch)[..., ch:2 * ch]
            assert float(dk.sum(1).abs().max()) <= 1e-5 * t * float(dk.abs().max())
        before = qkv_attention_grad.launches
        rc = qkv_attention_grad(qkv, g, heads, design="recompute")
        assert qkv_attention_grad.launches == before and rc.dtype == dtype


@pytest.mark.gpu
def test_card_attention_autograd_uses_the_kernels(card):  # noqa: F811
    """Under autograd the op launches the forward (with the log-sum-exp) and
    the backward kernels once each, no plain version: the gradient equals
    qkv_attention_grad's on the same forward."""
    qkv, g = _card_inputs(4, 64, 4, 64, torch.bfloat16, seed=9)
    leaf = qkv.clone().requires_grad_(True)
    before = (qkv_attention.launches, qkv_attention_grad.launches)
    out = qkv_attention(leaf, 4)
    out.backward(g)
    torch.cuda.synchronize()
    assert (qkv_attention.launches - before[0], qkv_attention_grad.launches - before[1]) == (1, 1)
    out2, lse = _attn.attention_forward(qkv, 4)
    assert torch.equal(out.detach(), out2)
    assert torch.equal(leaf.grad, qkv_attention_grad(qkv, g, 4, lse=lse))
