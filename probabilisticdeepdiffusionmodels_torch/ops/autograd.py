"""Gradients through the hand-written kernels.

No Pallas kernel in the repository has a backward kernel.  The JAX package
differentiates its fused ops through custom VJPs that recompute the plain XLA
math from the saved inputs (``_fused_bwd`` in
``probabilisticdeepdiffusionmodels_tpu/ops/gn_conv_pallas.py``, ``_gns_bwd``
in ``ops/groupnorm_pallas.py``), and its attention through
``qkv_attention_xla``.  ``KernelFunction`` is the counterpart of those VJPs:
the forward runs a kernel, the backward recomputes a plain PyTorch version
from the saved inputs and returns that version's gradient.
"""

from __future__ import annotations

import torch

__all__ = ["KernelFunction", "kernel_op"]


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
    needs a gradient), so the sampler pays nothing for the Function."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return KernelFunction.apply(forward, reference, *tensors)
    return forward(*tensors)
