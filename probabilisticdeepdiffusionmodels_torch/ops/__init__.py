"""The ops that hold hand-written CUDA kernels (``csrc/``): the four of the
UNet forward (the folded GroupNorm affine, the fused conv, GroupNorm and
attention), each differentiable through backward kernels of its own
(``gn_affine_grad``, ``gn_silu_conv3x3_grad``, ``group_norm_silu_grad``,
``qkv_attention_grad``), exported here with the spatially sharded
forward's slab ops, which fold the ranks' summed statistics inside their
kernels (``gn_fold_apply``, ``gn_silu_conv3x3_fold``), the fold alone
(``gn_fold``, their first design, by name only), and the matrix-unit
probe, in its own module ``ops.probe_mma``.

Each wrapper runs its plain PyTorch version for a CPU tensor and launches
its kernel for a CUDA tensor (or raises); each counts its launches in
``<wrapper>.launches``.
"""

from .attention import (
    attention_design,
    attention_grad_design,
    qkv_attention,
    qkv_attention_grad,
    qkv_attention_grad_plain,
    qkv_attention_plain,
)
from .gn_conv import (
    conv_design,
    conv_grad_design,
    gn_affine,
    gn_affine_grad,
    gn_affine_grad_plain,
    gn_affine_plain,
    gn_affine_slab,
    gn_affine_slab_plain,
    gn_moments_slab,
    gn_moments_slab_plain,
    gn_silu_conv3x3,
    gn_silu_conv3x3_fold,
    gn_silu_conv3x3_fold_plain,
    gn_silu_conv3x3_grad,
    gn_silu_conv3x3_grad_plain,
    gn_silu_conv3x3_plain,
    grad_design,
)
from .groupnorm import (
    affine_design,
    gn_fold,
    gn_fold_apply,
    gn_fold_apply_plain,
    gn_fold_plain,
    group_norm_silu,
    group_norm_silu_grad,
    group_norm_silu_grad_plain,
    group_norm_silu_plain,
    group_norm_silu_slab,
    group_norm_silu_slab_plain,
    groupnorm_design,
    groupnorm_grad_design,
)
