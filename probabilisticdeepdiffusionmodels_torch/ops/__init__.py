"""The ops that hold hand-written CUDA kernels (``csrc/``): the four of the
UNet forward (the folded GroupNorm affine, the fused conv, GroupNorm and
attention), differentiable through their plain versions, exported here with
the fold of GroupNorm's statistics alone (``gn_fold``, the spatially
sharded forward's), and the matrix-unit probe, in its own module
``ops.probe_mma``.

Each wrapper runs its plain PyTorch version for a CPU tensor and launches
its kernel for a CUDA tensor (or raises); each counts its launches in
``<wrapper>.launches``.
"""

from .attention import attention_design, qkv_attention, qkv_attention_plain
from .gn_conv import (
    conv_design,
    gn_affine,
    gn_affine_grad,
    gn_affine_grad_plain,
    gn_affine_plain,
    gn_affine_slab,
    gn_affine_slab_plain,
    gn_silu_conv3x3,
    gn_silu_conv3x3_plain,
    grad_design,
)
from .groupnorm import (
    affine_design,
    gn_fold,
    gn_fold_plain,
    group_norm_silu,
    group_norm_silu_plain,
    group_norm_silu_slab,
    group_norm_silu_slab_plain,
    groupnorm_design,
)
