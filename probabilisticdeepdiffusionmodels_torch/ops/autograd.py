"""Gradients through the hand-written kernels: the reverse-mode guard.

No Pallas kernel in the repository has a backward kernel.  The JAX package
differentiates its fused ops through custom VJPs that recompute the plain XLA
math from the saved inputs (``_fused_bwd`` in
``probabilisticdeepdiffusionmodels_tpu/ops/gn_conv_pallas.py``, ``_gns_bwd``
in ``ops/groupnorm_pallas.py``), and its attention through
``qkv_attention_xla``.  Here each op with a kernel has a
``torch.autograd.Function`` whose backward launches kernels of its own: the
folded affine (``gn_conv._GnAffine``, ``gn_affine_grad``), the fused conv
(``gn_conv._GnSiluConv``, ``gn_silu_conv3x3_grad``), GroupNorm
(``groupnorm._GroupNormSilu``, ``group_norm_silu_grad``) and attention
(``attention._QkvAttention``, ``qkv_attention_grad``).

Gradients through the kernels exist in reverse mode only.  A kernel reads
its inputs' memory and would drop a forward-mode tangent without a word, so
``forbid_forward_mode`` raises where one would reach a kernel: an input
that carries a ``torch.autograd.forward_ad`` tangent, or any active
``torch.func`` transform (``jvp``, ``vmap``, ``grad``).
"""

from __future__ import annotations

import torch
from torch.autograd import forward_ad

__all__ = ["forbid_forward_mode"]


def forbid_forward_mode(name: str, *tensors) -> None:
    """Raise if a forward-mode tangent or a ``torch.func`` transform would
    reach the kernel of op ``name``.  Outside both (every call of the
    sampler and the train step) this reads two interpreter globals and
    unpacks no tensor."""
    if torch._C._functorch.peek_interpreter_stack() is not None:
        raise RuntimeError(f"{name}: a torch.func transform (jvp, vmap, grad) cannot pass "
                           "through a hand-written kernel; differentiate in reverse mode "
                           "(torch.autograd.grad)")
    if forward_ad._current_level >= 0 and any(
            t is not None and forward_ad.unpack_dual(t).tangent is not None for t in tensors):
        raise RuntimeError(f"{name}: an input carries a forward-mode tangent "
                           "(torch.autograd.forward_ad), which a hand-written kernel would drop; "
                           "the kernels' gradients are reverse mode only (torch.autograd.grad)")
