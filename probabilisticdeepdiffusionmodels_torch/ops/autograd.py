"""Gradients through the hand-written kernels.

No Pallas kernel in the repository has a backward kernel.  The JAX package
differentiates its fused ops through custom VJPs that recompute the plain XLA
math from the saved inputs (``_fused_bwd`` in
``probabilisticdeepdiffusionmodels_tpu/ops/gn_conv_pallas.py``, ``_gns_bwd``
in ``ops/groupnorm_pallas.py``), and its attention through
``qkv_attention_xla``.  ``KernelFunction`` is the counterpart of those VJPs
for GroupNorm and attention: the forward runs a kernel, the backward
recomputes a plain PyTorch version from the saved inputs and returns that
version's gradient.  The folded affine and the fused conv have backward
kernels of their own instead (``gn_conv._GnAffine`` with ``gn_affine_grad``,
``gn_conv._GnSiluConv`` with ``gn_silu_conv3x3_grad``).

Gradients through the kernels exist in reverse mode only.  A kernel reads
its inputs' memory and would drop a forward-mode tangent without a word, so
``forbid_forward_mode`` raises where one would reach a kernel: an input
that carries a ``torch.autograd.forward_ad`` tangent, or any active
``torch.func`` transform (``jvp``, ``vmap``, ``grad``).
"""

from __future__ import annotations

import torch
from torch.autograd import forward_ad

__all__ = ["KernelFunction", "kernel_op", "forbid_forward_mode"]


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


class KernelFunction(torch.autograd.Function):
    """``KernelFunction.apply(forward, reference, *tensors)``: the output of
    ``forward(*tensors)`` with the gradient of ``reference(*tensors)``.

    ``forward`` (a kernel launch, or in a CPU test the plain version standing
    in for it) and ``reference`` are callables of the tensors alone; bind any
    other argument with a lambda.  The backward runs ``reference`` under
    ``torch.enable_grad()`` on detached copies of the saved inputs and takes
    ``torch.autograd.grad`` of it, so every gradient comes back in its own
    input's dtype.
    """

    @staticmethod
    def forward(ctx, forward, reference, *tensors):
        ctx.reference = reference
        ctx.save_for_backward(*tensors)
        return forward(*tensors)

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[2:]
        inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
        with torch.enable_grad():
            out = ctx.reference(*inputs)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, grad, allow_unused=True))
        return (None, None, *(next(grads) if n else None for n in needs))


def kernel_op(forward, reference, *tensors):
    """``KernelFunction.apply`` where autograd records the op; ``forward``
    alone where it does not (under ``torch.no_grad()``, or when no input
    needs a gradient), so the sampler pays nothing for the Function.  Raises
    where a forward-mode tangent would reach the kernel
    (``forbid_forward_mode``)."""
    forbid_forward_mode("kernel op", *tensors)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return KernelFunction.apply(forward, reference, *tensors)
    return forward(*tensors)
