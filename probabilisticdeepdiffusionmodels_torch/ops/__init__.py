"""The ops that hold hand-written CUDA kernels (``csrc/``): the three of the
UNet forward, differentiable through their plain versions, exported here,
and the matrix-unit probe, in its own module ``ops.probe_mma``.

Each wrapper runs its plain PyTorch version for a CPU tensor and launches
its kernel for a CUDA tensor (or raises); each counts its launches in
``<wrapper>.launches``.
"""

from .attention import attention_design, qkv_attention, qkv_attention_plain
from .gn_conv import conv_design, gn_affine, gn_silu_conv3x3, gn_silu_conv3x3_plain
from .groupnorm import group_norm_silu, group_norm_silu_plain
