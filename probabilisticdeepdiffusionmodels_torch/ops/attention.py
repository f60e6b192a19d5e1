"""Fused-qkv self-attention: plain torch version and the CUDA kernel.

Semantics of ``probabilisticdeepdiffusionmodels_tpu/ops/attention.py``:
heads are contiguous ``[q|k|v]`` chunks of the fused ``(B, T, 3C)`` channel
axis; q and k are each scaled by ch^-1/4 before the product; scores and
softmax are float32; for bf16 inputs the softmax weights are cast to bf16
before the PV product, which accumulates in float32.

Kernel (``csrc/attention.cu``) — replaces ``qkv_attention_pallas`` /
``_attn_kernel`` in ``probabilisticdeepdiffusionmodels_tpu/ops/attention_pallas.py``.
On the H100 it is bound by bytes: each site reads the (B, T, 3C) input once
and writes (B, T, C), and at T <= 1024, ch <= 128 the two products are far
below the bf16 ridge.  The design keeps everything between the read and the
write on chip.  bf16 (design ``mma_ring``, every head width that is a
multiple of 16 up to 128): one block of up to 8 warps covers up to 128
query rows of one (batch, head); q, k and v rows are copied straight from
the fused tensor with 16-byte ``cp.async`` into padded rows, K and V pass
through a ring of up to 4 stages of 64 keys (the whole head at T <= 256),
q and k are scaled in shared memory as they land, fragments come from
``ldmatrix`` (``.trans`` for V), both products are ``mma.sync`` m16n8k16
with the score tile in registers and an online softmax in float32, and the
output leaves in 16-byte stores.  float32 (design ``scalar_f32``): one
block per (batch, head, 64-query tile) with scalar FMAs.

Backward: the Pallas attention kernel has no custom VJP; JAX differentiates
the op through ``qkv_attention_xla``.  So here too there is no backward
kernel: the gradient is that of the plain version, recomputed from the saved
input (``autograd.kernel_op``).
"""

from __future__ import annotations

import math

import torch

from . import _build
from .autograd import kernel_op

__all__ = ["attention_design", "qkv_attention", "qkv_attention_plain"]

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_BF16_HEAD_DIMS = tuple(range(16, 129, 16))


def _split_heads(qkv: torch.Tensor, num_heads: int):
    """(B, T, 3C) -> q, k, v each (B, T, H, C/H), head chunks contiguous."""
    b, t, c3 = qkv.shape
    if c3 % (3 * num_heads):
        raise ValueError(f"fused width {c3} is not 3 * heads ({num_heads}) * ch")
    ch = c3 // (3 * num_heads)
    qkv = qkv.reshape(b, t, num_heads, 3 * ch)
    return qkv[..., :ch], qkv[..., ch:2 * ch], qkv[..., 2 * ch:]


def qkv_attention_plain(qkv: torch.Tensor, num_heads: int = 1) -> torch.Tensor:
    """(B, T, 3C) -> (B, T, C) in plain torch ops (``qkv_attention_xla``)."""
    b, t, c3 = qkv.shape
    q, k, v = _split_heads(qkv, num_heads)
    ch = q.shape[-1]
    scale = 1.0 / math.sqrt(math.sqrt(ch))
    q = (q * scale).float()
    k = (k * scale).float()
    weight = torch.einsum("bthc,bshc->bhts", q, k)
    weight = torch.softmax(weight, dim=-1).to(qkv.dtype).float()
    out = torch.einsum("bhts,bshc->bthc", weight, v.float()).to(qkv.dtype)
    return out.reshape(b, t, c3 // 3)


def qkv_attention(qkv: torch.Tensor, num_heads: int = 1) -> torch.Tensor:
    """(B, T, 3C) -> (B, T, C).  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises.  Differentiable in qkv."""
    if qkv.device.type == "cpu":
        return qkv_attention_plain(qkv, num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"qkv_attention: unsupported device {qkv.device}")
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be (B, T, 3C), got {tuple(qkv.shape)}")
    if qkv.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"qkv_attention kernel takes float32/bfloat16, got {qkv.dtype}")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    b, t, c3 = qkv.shape
    if c3 % (3 * num_heads):
        raise ValueError(f"fused width {c3} is not 3 * heads ({num_heads}) * ch")
    ch = c3 // (3 * num_heads)
    bf16 = qkv.dtype == torch.bfloat16
    if (bf16 and ch not in _BF16_HEAD_DIMS) or ch > 128:
        raise ValueError(f"qkv_attention kernel: head dim {ch} unsupported "
                         f"(bf16: {_BF16_HEAD_DIMS}; float32: <= 128)")
    if bf16 and qkv.data_ptr() % 16:
        raise ValueError("qkv_attention kernel: bf16 qkv must be 16-byte aligned")
    return kernel_op(lambda qkv: _launch(qkv, num_heads),
                                lambda qkv: qkv_attention_plain(qkv, num_heads), qkv)


def attention_design(qkv: torch.Tensor) -> str:
    """The kernel design that a call on ``qkv`` runs."""
    return "mma_ring" if qkv.dtype == torch.bfloat16 else "scalar_f32"


def _launch(qkv, num_heads):
    b, t, c3 = qkv.shape
    ch = c3 // (3 * num_heads)
    out = torch.empty((b, t, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    scale = 1.0 / math.sqrt(math.sqrt(ch))
    _build.launch("pddm_qkv_attention", qkv.data_ptr(), out.data_ptr(),
                  b, t, num_heads, ch, scale, int(qkv.dtype == torch.bfloat16))
    qkv_attention.launches += 1
    return out


qkv_attention.launches = 0
