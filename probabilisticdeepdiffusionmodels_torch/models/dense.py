"""The MLP baseline, counterpart of ``probabilisticdeepdiffusionmodels_tpu/models/dense.py``.

The timestep-embedding MLP, then the embedding concatenated with the
flattened image through a Linear/ReLU stack and a Linear back to the
image's size.  No kernel: its products are plain matmuls in JAX too.
Module names are the Flax ones (``time_embed_1``, ``dense_<i>``,
``dense_out``), so ``convert.params_from_flax`` carries weights over.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..core.diffusion import timestep_embedding
from .layers import Linear, silu

__all__ = ["DenseModel"]


class DenseModel(nn.Module):
    """x: (B, resolution, resolution, in_channels) -> the same shape, float32.
    ``y`` is accepted and ignored, as in JAX; there are no classes."""

    def __init__(self, resolution: int = 32, in_channels: int = 3,
                 num_hidden: Sequence[int] = (256, 256),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.resolution, self.in_channels = resolution, in_channels
        self.num_classes, self.cfg_null_class = None, False
        t = num_hidden[0]
        self.time_embed_1 = Linear(t, t, generator=generator)
        self.time_embed_2 = Linear(t, t, generator=generator)
        self.hidden = []
        width = t + resolution * resolution * in_channels
        for i, n in enumerate(num_hidden):
            self.add_module(f"dense_{i}", Linear(width, n, generator=generator))
            self.hidden.append(f"dense_{i}")
            width = n
        self.dense_out = Linear(width, resolution * resolution * in_channels,
                                generator=generator)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                y: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        emb = timestep_embedding(timesteps, self.time_embed_1.weight.shape[1])
        emb = self.time_embed_2(silu(self.time_embed_1(emb)))
        b = x.shape[0]
        flat = x.reshape(b, -1)
        h = torch.cat([emb.to(flat.dtype), flat], dim=-1)
        for name in self.hidden:
            h = torch.relu(getattr(self, name)(h))
        h = self.dense_out(h)
        return h.reshape(b, self.resolution, self.resolution, self.in_channels)
