"""Fused-qkv self-attention: plain torch version and the CUDA kernels.

Semantics of ``probabilisticdeepdiffusionmodels_tpu/ops/attention.py``:
heads are contiguous ``[q|k|v]`` chunks of the fused ``(B, T, 3C)`` channel
axis; q and k are each scaled by ch^-1/4 before the product; scores and
softmax are float32; for bf16 inputs the softmax weights are cast to bf16
before the PV product, which accumulates in float32.

Kernel (``csrc/attention.cu``) — replaces ``qkv_attention_pallas`` /
``_attn_kernel`` in ``probabilisticdeepdiffusionmodels_tpu/ops/attention_pallas.py``.
On the H100 it is bound by bytes: each site reads the (B, T, 3C) input once
and writes (B, T, C).  At the CIFAR-10 UNet's sites (4 heads of 64, batch
128) that is 20.0 us at T = 256, 5.0 us at T = 64 and 1.25 us at T = 16 at
3.35 TB/s, against 8.7 us of bf16 products and 33.5 M exponentials at
T = 256: the products and the softmax have to hide under the copies.
``attention_design`` picks by shape, and ``design=`` names one:

* ``wgmma`` (bf16, head widths 16..64, 64 <= T <= 256, heads x ch >= 64,
  at least half as many (head, sample) items as the card has SMs: every
  CIFAR-10 site at batch 128 but the T = 16 one): a persistent block an SM
  walks over the (head, sample) items.  A landing warpgroup copies each item's
  K, Q and V by TMA (64-token boxes of the fused tensor) into a ring of
  stages, one item ahead or more, and scales k in shared memory as it
  lands; two consumer warpgroups take the 64-query tiles in turn.  A
  tile's whole key row (T <= 256) lies in one accumulator set of
  S = Qs Ks^T (one ``wgmma`` m64nTk16 a k-step, q scaled in registers as
  the A operand, K from shared memory), so the softmax is exact in one
  pass, with ``ex2`` and the scale folded in; P is rounded to bf16 in
  registers as the A operand of O = P V (``wgmma``, V the transposed B
  operand), key tile by key tile, each tile's products issued behind its
  exponentials so that the next tile's exponentials run under them.  The
  two warpgroups run free (taking turns to issue their products,
  FlashAttention-3's ping-pong, measured slower).  O / l leaves through
  shared memory by TMA.
* ``mma_ring`` (every other bf16 shape: T = 16, below ``wgmma``'s 64
  rows; heads of 80..128, whose score row and output do not fit the
  consumers' registers beside each other; T > 256, whose key row does not
  fit one accumulator set; fewer items than half the SMs, where
  ``wgmma``'s grid of one block an item leaves most SMs idle and this
  design's block per 128 query rows fills more of the card; and by name
  wherever ``wgmma`` runs): one block
  of up to 8 warps covers up to 128 query rows of one (batch, head); q, k
  and v rows are copied with 16-byte ``cp.async``, K and V pass through a
  ring of up to 4 stages of 64 keys, fragments come from ``ldmatrix``, both
  products are ``mma.sync`` m16n8k16 with an online softmax in float32.
* ``scalar_f32`` (float32): one block per (batch, head, 64-query tile) with
  scalar FMAs.

Where autograd records the op, the forward also writes each row's
log-sum-exp, (B, H, T) float32, for the backward.

Backward (``qkv_attention_grad``, ``csrc/attention_grad.cu``): the Pallas
kernel has no VJP; JAX differentiates the op through ``qkv_attention_xla``.
Here the gradient has kernels of its own (no float atomics, so a call gives
the same bits twice), from qkv and the log-sum-exp that autograd keeps.
``attention_grad_design`` picks by shape: ``wgmma`` (bf16, head widths
16..64, 64 <= T <= 256, heads x ch >= 64: every attention site of the
CIFAR-10 UNet but its T = 16 one) is one launch a (head, sample) with the
head's Q, K, V and dO resident in shared memory, every product on
``wgmma``: each row's D = rowsum(P * dP) summed over every key first, then
rounds of key tiles that keep dK and dV in registers and add each query
tile's dQ in a fixed order in shared memory (seven products a (query, key)
pair, two exponentials).  ``two_pass`` (every other bf16 shape, and by
name: the first design) is FlashAttention-2's backward with dQ split out:
dQ + D in two passes over the keys, then dK and dV, on ``mma.sync``;
``scalar_f32`` the same in true float32 FMAs.  D is summed from P * dP, not
from the stored output as FlashAttention does, so each row's dS sums to
zero over the keys as in the plain version's softmax backward (the source's
header says why that matters).  ``recompute`` (autograd through the plain
version) runs by name only and counts no launch.
``qkv_attention_grad_plain`` writes the gradient out with the kernels'
rounding points.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from . import _build
from .autograd import forbid_forward_mode
from .gn_conv import _SMEM_BYTES, _aligned

__all__ = ["attention_design", "attention_grad_design", "attention_forward", "qkv_attention",
           "qkv_attention_plain", "qkv_attention_grad", "qkv_attention_grad_plain"]

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


def _check(qkv: torch.Tensor, num_heads: int) -> None:
    """Raise on what the kernels do not take."""
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


def qkv_attention(qkv: torch.Tensor, num_heads: int = 1,
                  design: Optional[str] = None) -> torch.Tensor:
    """(B, T, 3C) -> (B, T, C).  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel (one count a call) or raises.
    ``design``: None for ``attention_design``'s choice, or a design by name
    (``mma_ring`` or ``wgmma`` in bf16, ``scalar_f32`` in float32; one
    that does not take the dtype or shape raises before any launch).
    Differentiable in qkv, on the card by ``qkv_attention_grad``'s kernels,
    in reverse mode only (a forward-mode tangent raises,
    ``autograd.forbid_forward_mode``)."""
    if qkv.device.type == "cpu":
        return qkv_attention_plain(qkv, num_heads)
    forbid_forward_mode("qkv_attention", qkv)
    _check(qkv, num_heads)
    design = _forward_design(qkv, num_heads, design)
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _QkvAttention.apply(qkv, num_heads, design)
    return _launch(qkv, num_heads, design)


# the forward's kernel designs and the C entry point's numbers for them
DESIGNS = {"mma_ring": 0, "scalar_f32": 0, "wgmma": 1}
# the backward's
GRAD_DESIGNS = {"two_pass": 0, "scalar_f32": 0, "wgmma": 1}
_WGMMA_ROWS = 64          # the wgmma designs' tiles: 64 queries or keys
_WGMMA_LDQ = _WGMMA_ROWS + 8  # floats a row of the backward's dQ sums
_FWD_MAX_STAGES = 4       # the wgmma forward's ring: heads in flight
_H100_SMS = 132           # the SMs of an H100 SXM: the grid fill of a tensor not on a card


def _fwd_wgmma_smem(t: int, stages: int) -> int:
    """Shared memory of the wgmma forward at T = ``t`` with ``stages``
    stages (``FwdLayout``): each stage one head's Q, K and V (64-token
    tiles of 128-byte rows), four mbarriers a stage of the most, and the
    slack that aligns the base to 1,024 bytes."""
    nt = -(-t // _WGMMA_ROWS)
    return 1024 + stages * 3 * nt * _WGMMA_ROWS * 128 + 4 * _FWD_MAX_STAGES * 8


@functools.lru_cache(maxsize=None)
def _fwd_wgmma_stages(t: int) -> int:
    """The wgmma forward's stages at T = ``t`` (``fwd_stages``): as many as
    fit, at most 4, 0 where two do not; even at one key tile, where the two
    warpgroups take alternate heads, each in its own stages."""
    nt = -(-t // _WGMMA_ROWS)
    for stages in range(_FWD_MAX_STAGES, 1, -1):
        if (nt > 1 or stages % 2 == 0) and _fwd_wgmma_smem(t, stages) <= _SMEM_BYTES:
            return stages
    return 0


@functools.lru_cache(maxsize=None)
def _fwd_wgmma_takes(t: int, num_heads: int, ch: int) -> bool:
    """Whether the wgmma forward takes a bf16 head of width ``ch`` over
    ``t`` tokens: 64 <= T (wgmma's 64 rows) <= 256 (a whole key row in one
    accumulator set), ch a multiple of 16 up to 64, heads x ch >= 64."""
    return (ch <= 64 and ch % 16 == 0 and _WGMMA_ROWS <= t <= 4 * _WGMMA_ROWS
            and num_heads * ch >= _WGMMA_ROWS and _fwd_wgmma_stages(t) > 0)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    """The SMs of ``device``'s card; an H100 SXM's for a tensor not on one."""
    if device.type != "cuda":
        return _H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def attention_design(qkv: torch.Tensor, num_heads: int = 1) -> str:
    """The forward's design on ``qkv`` split into ``num_heads`` heads:
    ``wgmma`` where it takes the bf16 shape (``_fwd_wgmma_takes``) and its
    grid, one block an SM and at most one an item, covers at least half the
    card's SMs (at T = 256, heads of 64, on an H100 it overtakes
    ``mma_ring`` between 64 and 96 items, ``time_attention.py``),
    ``mma_ring`` for every other bf16 shape, ``scalar_f32`` for float32.  ``mma_ring`` also runs by name wherever
    ``wgmma`` does, and ``wgmma`` by name wherever it takes the shape."""
    if qkv.dtype != torch.bfloat16:
        return "scalar_f32"
    b, t, c3 = qkv.shape
    ch = c3 // (3 * num_heads)
    if _fwd_wgmma_takes(t, num_heads, ch) and 2 * b * num_heads >= _sm_count(qkv.device):
        return "wgmma"
    return "mma_ring"


def _forward_design(qkv: torch.Tensor, num_heads: int, design: Optional[str]) -> str:
    """``design``, or ``attention_design``'s choice where None; raise where
    the name is unknown or the design does not take the dtype or shape."""
    chosen = attention_design(qkv, num_heads) if design is None else design
    bf16 = qkv.dtype == torch.bfloat16
    if chosen not in DESIGNS or (chosen == "scalar_f32") == bf16:
        raise ValueError(f"the qkv_attention design {chosen!r} does not take {qkv.dtype}")
    b, t, c3 = qkv.shape
    if chosen == "wgmma" and not _fwd_wgmma_takes(t, num_heads, c3 // (3 * num_heads)):
        raise ValueError(f"the qkv_attention design {chosen!r} does not take "
                         f"{tuple(qkv.shape)} in {num_heads} heads")
    return chosen


def _wgmma_smem(t: int) -> int:
    """Shared memory of the wgmma backward at T = ``t`` (``ResLayout``): Q,
    K, V and dO resident (128-byte rows, 64 a tile), the dS^T rows of one
    query tile (64 a warpgroup, two where there are two key tiles), the
    float32 dQ sums, each query's L and D, one mbarrier, and the slack that
    aligns the base to 1,024 bytes."""
    nt = -(-t // _WGMMA_ROWS)
    nwg = 2 if nt > 1 else 1
    rows = nt * _WGMMA_ROWS
    return (1024 + 4 * rows * 128 + nwg * _WGMMA_ROWS * 128 + rows * _WGMMA_LDQ * 4
            + 2 * rows * 4 + 8)


def attention_grad_design(qkv: torch.Tensor, num_heads: int = 1) -> str:
    """The design of ``qkv_attention_grad`` on ``qkv`` split into
    ``num_heads`` heads: ``wgmma`` for bf16 with head widths 16..64,
    64 <= T with the head resident in shared memory (T <= 256) and
    heads x ch >= 64 (a 64-channel row of dO lies in the tensor);
    ``two_pass`` for every other bf16 shape; ``scalar_f32`` for float32.
    ``two_pass`` and ``recompute`` also run by name."""
    if qkv.dtype != torch.bfloat16:
        return "scalar_f32"
    b, t, c3 = qkv.shape
    ch = c3 // (3 * num_heads)
    if (ch <= 64 and t >= _WGMMA_ROWS and _wgmma_smem(t) <= _SMEM_BYTES
            and num_heads * ch >= _WGMMA_ROWS):
        return "wgmma"
    return "two_pass"


def _launch(qkv, num_heads, design, lse=None):
    """The forward kernel of ``design`` (checked); ``lse``: a (B, H, T)
    float32 tensor for each row's log-sum-exp, or None (nothing stored)."""
    b, t, c3 = qkv.shape
    ch = c3 // (3 * num_heads)
    out = torch.empty((b, t, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    scale = 1.0 / math.sqrt(math.sqrt(ch))
    _build.launch("pddm_qkv_attention", qkv.data_ptr(), out.data_ptr(),
                  None if lse is None else lse.data_ptr(), b, t, num_heads, ch, scale,
                  int(qkv.dtype == torch.bfloat16), DESIGNS[design])
    qkv_attention.launches += 1
    return out


qkv_attention.launches = 0


def attention_forward(qkv: torch.Tensor, num_heads: int = 1,
                      design: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel on a checked CUDA ``qkv`` (one count), in
    ``design`` (None: ``attention_design``'s choice), returning the output
    and each row's log-sum-exp (B, H, T) float32: what the backward reads."""
    return _launch_with_lse(qkv, num_heads, _forward_design(qkv, num_heads, design))


def _launch_with_lse(qkv, num_heads, design):
    """``_launch`` of a resolved ``design`` with each row's log-sum-exp."""
    b, t, _ = qkv.shape
    lse = torch.empty((b, num_heads, t), dtype=torch.float32, device=qkv.device)
    return _launch(qkv, num_heads, design, lse), lse


class _QkvAttention(torch.autograd.Function):
    """``qkv_attention`` with its gradient from ``qkv_attention_grad``: on
    the card both directions are kernels, and autograd keeps qkv and the
    log-sum-exp.  On CPU tensors (the tests) the plain versions stand in for
    both."""

    @staticmethod
    def forward(ctx, qkv, num_heads, design=None):
        """``design``: as ``qkv_attention`` resolved and checked it, or None
        for ``attention_forward`` to resolve."""
        if qkv.device.type == "cpu":
            out, lse = qkv_attention_plain(qkv, num_heads), None
        elif design is None:
            out, lse = attention_forward(qkv, num_heads)
        else:
            out, lse = _launch_with_lse(qkv, num_heads, design)
        ctx.num_heads = num_heads
        ctx.save_for_backward(qkv, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, lse = ctx.saved_tensors
        return qkv_attention_grad(qkv, g, ctx.num_heads, lse=lse), None, None


def qkv_attention_grad_plain(qkv: torch.Tensor, g: torch.Tensor,
                             num_heads: int = 1) -> torch.Tensor:
    """dqkv (B, T, 3C) in qkv's dtype for the output gradient ``g``
    (B, T, C), written out with the kernel's rounding points: P = softmax of
    the float32 scores of the scaled, rounded q and k; dP = dO V^T,
    D = rowsum(P * dP) and dS = P (dP - D) in float32; dV = bf16(P)^T dO;
    dq = (bf16(dS) ks) ch^-1/4 and dk = (bf16(dS)^T qs) ch^-1/4, each
    accumulated in float32 and rounded once to qkv's dtype."""
    b, t, c3 = qkv.shape
    q, k, v = _split_heads(qkv, num_heads)
    ch = q.shape[-1]
    scale = 1.0 / math.sqrt(math.sqrt(ch))
    dt = qkv.dtype
    qs, ks = (q * scale).float(), (k * scale).float()
    p = torch.softmax(torch.einsum("bthc,bshc->bhts", qs, ks), dim=-1)
    do = g.to(dt).float().reshape(b, t, num_heads, ch)
    dp = torch.einsum("bthc,bshc->bhts", do, v.float())
    ds = (p * (dp - (p * dp).sum(-1, keepdim=True))).to(dt).float()
    dv = torch.einsum("bhts,bthc->bshc", p.to(dt).float(), do)
    dq = torch.einsum("bhts,bshc->bthc", ds, ks) * scale
    dk = torch.einsum("bhts,bthc->bshc", ds, qs) * scale
    return torch.cat([dq, dk, dv], dim=-1).to(dt).reshape(b, t, c3)


def _recompute(qkv, g, num_heads):
    """The parent's path, by name only: autograd through the plain version
    recomputed from qkv."""
    leaf = qkv.detach().requires_grad_(True)
    with torch.enable_grad():
        out = qkv_attention_plain(leaf, num_heads)
    return torch.autograd.grad(out, leaf, g)[0]


def qkv_attention_grad(qkv: torch.Tensor, g: torch.Tensor, num_heads: int = 1,
                       lse: Optional[torch.Tensor] = None,
                       design: Optional[str] = None) -> torch.Tensor:
    """dqkv of ``qkv_attention`` for the output gradient ``g``, in qkv's
    dtype.  A CPU tensor takes the plain version; a CUDA tensor launches the
    kernels (one count a call) or raises; ``lse`` is the forward's
    log-sum-exp (``attention_forward``).  ``design``: None for
    ``attention_grad_design``'s choice, ``two_pass`` or ``wgmma`` by name
    (bf16; ``wgmma`` raises where the shape does not fit it), or
    ``recompute`` (autograd through the plain version, no count)."""
    if qkv.device.type == "cpu":
        return qkv_attention_grad_plain(qkv, g, num_heads)
    design = attention_grad_design(qkv, num_heads) if design is None else design
    if design == "recompute":
        return _recompute(qkv, g, num_heads)
    bf16 = qkv.dtype == torch.bfloat16
    if design not in GRAD_DESIGNS or (design == "scalar_f32") == bf16:
        raise ValueError(f"the qkv_attention_grad design {design!r} does not take {qkv.dtype}")
    _check(qkv, num_heads)
    if lse is None:
        raise ValueError("qkv_attention_grad needs the forward's log-sum-exp")
    b, t, c3 = qkv.shape
    ch = c3 // (3 * num_heads)
    if lse.shape != (b, num_heads, t) or g.shape != (b, t, c3 // 3):
        raise ValueError(f"qkv_attention_grad: g {tuple(g.shape)}, lse {tuple(lse.shape)} do "
                         f"not fit qkv {tuple(qkv.shape)}")
    g = _aligned(g.to(qkv.dtype))
    lse = lse.contiguous()
    dqkv = torch.empty_like(qkv)
    # each row's D between the two launches of two_pass and scalar_f32
    delta = None if design == "wgmma" else torch.empty_like(lse)
    _build.launch("pddm_qkv_attention_grad", qkv.data_ptr(), g.data_ptr(), lse.data_ptr(),
                  None if delta is None else delta.data_ptr(), dqkv.data_ptr(), b, t, num_heads,
                  ch, 1.0 / math.sqrt(math.sqrt(ch)), int(bf16), GRAD_DESIGNS[design])
    qkv_attention_grad.launches += 1
    return dqkv


qkv_attention_grad.launches = 0
