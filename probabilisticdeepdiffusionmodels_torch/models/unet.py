"""The UNet with timestep embedding and spatial self-attention, NHWC.

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/models/unet.py``
(2-D ``UNetModel`` and its blocks).  Block plan, naming, zero-init points,
attention head split and dtype handling follow the JAX model; the module
names are the JAX names, so ``convert.params_from_flax`` maps one tree onto
the other key by key.

Every ResBlock conv and the output head run the fused GN(+emb|FiLM)+SiLU+
conv3x3 op (``ops.gn_conv``), as the JAX model does with
``use_pallas_conv=True``; every AttentionBlock norm runs the GroupNorm op
(``ops.groupnorm``) and every attention the fused-qkv op
(``ops.attention``).  On a CUDA tensor each of those is a hand-written
kernel, and so is the fold of the GroupNorm statistics that feeds the fused
conv (``gn_affine``).  The other convs (input conv, 1x1 skip, down/upsample) are
``F.conv2d`` and the qkv/proj products ``F.linear``.  In train mode with
``dropout > 0`` a ResBlock's second conv leaves the fused op, as the JAX
model's does, because the dropout sits between the SiLU and the conv; its
masks come from the ``generator`` passed to the forward (the train state's,
as JAX threads the step's dropout key), never from torch's default one.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..core.diffusion import timestep_embedding
from ..ops.attention import qkv_attention
from ..ops.gn_conv import gn_affine, gn_silu_conv3x3
from .layers import (
    Conv,
    FusedConv3x3,
    GroupNorm32,
    Linear,
    avg_pool_nd,
    nearest_upsample_nd,
    silu,
)

__all__ = ["ResBlock", "AttentionBlock", "Downsample", "Upsample", "UNetModel"]


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: zero each element with probability ``p`` and scale
    the rest by 1/(1-p), the mask drawn from ``generator``."""
    if generator is None:
        raise ValueError("dropout > 0 in train mode needs a generator: pass "
                         "model(..., generator=...) (the train step passes its state's)")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return x * keep.to(x.dtype) / (1.0 - p)


def _gn_silu_conv(x: torch.Tensor, norm: GroupNorm32, conv: FusedConv3x3,
                  emb: Optional[torch.Tensor] = None, film=None) -> torch.Tensor:
    x = x.contiguous()  # the statistics and the conv kernel read one tensor
    a, off = gn_affine(x, norm.weight, norm.bias, norm.groups, norm.eps,
                       emb=emb, film=film)
    return gn_silu_conv3x3(x, a, off, conv.weight, conv.bias)


class ResBlock(nn.Module):
    """GN-SiLU-conv, timestep-embedding add or FiLM, GN-SiLU-(dropout)-zero-
    init conv, plus the identity or a 1x1 (``use_conv_skip``: 3x3) conv skip."""

    def __init__(self, in_ch: int, out_ch: int, emb_dim: int,
                 use_conv_skip: bool = False, use_scale_shift_norm: bool = False,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.use_scale_shift_norm = use_scale_shift_norm
        self.dropout = dropout
        self.in_norm = GroupNorm32(in_ch)
        self.in_conv = FusedConv3x3(in_ch, out_ch, generator=generator)
        self.emb_proj = Linear(emb_dim, 2 * out_ch if use_scale_shift_norm else out_ch,
                               dtype=dtype, generator=generator)
        self.out_norm = GroupNorm32(out_ch)
        self.out_conv = FusedConv3x3(out_ch, out_ch, zero_init=True)
        self.skip_conv = None
        if out_ch != in_ch:
            self.skip_conv = Conv(in_ch, out_ch, 3 if use_conv_skip else 1,
                                  dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = _gn_silu_conv(x, self.in_norm, self.in_conv)
        emb_out = self.emb_proj(silu(emb)).to(h.dtype)
        cond = (dict(film=tuple(emb_out.chunk(2, dim=-1))) if self.use_scale_shift_norm
                else dict(emb=emb_out))
        if self.training and self.dropout > 0:
            # JAX models/unet.py:129-146: the unfused path, dropout after the SiLU
            norm = self.out_norm
            h = h.contiguous()
            a, off = gn_affine(h, norm.weight, norm.bias, norm.groups, norm.eps, **cond)
            act = silu(h.float() * a[:, None, None, :] + off[:, None, None, :]).to(h.dtype)
            h = self.out_conv.conv(dropout(act, self.dropout, generator))
        else:
            h = _gn_silu_conv(h, self.out_norm, self.out_conv, **cond)
        skip = x if self.skip_conv is None else self.skip_conv(x)
        return skip + h


class AttentionBlock(nn.Module):
    """GroupNorm -> 1x1 qkv -> per-head attention -> zero-init 1x1 proj,
    residual, over the flattened H*W tokens."""

    def __init__(self, channels: int, num_heads: int = 1,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads = num_heads
        self.norm = GroupNorm32(channels)
        self.qkv = Linear(channels, 3 * channels, dtype=dtype, generator=generator)
        self.proj = Linear(channels, channels, zero_init=True, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        tokens = x.reshape(b, -1, c)
        qkv = self.qkv(self.norm(tokens))
        out = self.proj(qkv_attention(qkv.contiguous(), self.num_heads))
        return (tokens + out).reshape(x.shape)


class Downsample(nn.Module):
    """Stride-2 3x3 conv (JAX SAME padding) or 2x2 average pool."""

    def __init__(self, channels: int, use_conv: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.op = Conv(channels, channels, 3, stride=2, dtype=dtype,
                       generator=generator) if use_conv else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return avg_pool_nd(x, 2) if self.op is None else self.op(x)


class Upsample(nn.Module):
    """Nearest 2x upsample, then an optional 3x3 conv."""

    def __init__(self, channels: int, use_conv: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = Conv(channels, channels, 3, dtype=dtype,
                         generator=generator) if use_conv else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = nearest_upsample_nd(x)
        return x if self.conv is None else self.conv(x)


class UNetModel(nn.Module):
    """The 2-D UNet.  ``attention_resolutions`` are downsample rates (the
    factory converts image-side lengths).  Input and output are NHWC; the
    output head runs in the input's dtype (float32 for a float32 input even
    when ``dtype`` is bfloat16)."""

    def __init__(self, in_channels: int, model_channels: int, out_channels: int,
                 num_res_blocks: int, attention_resolutions: Sequence[int],
                 channel_mult: Sequence[int] = (1, 2, 4, 8),
                 conv_resample: bool = True, num_classes: Optional[int] = None,
                 cfg_null_class: bool = False, num_heads: int = 1,
                 num_heads_upsample: int = -1, use_scale_shift_norm: bool = False,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        mc = model_channels
        emb_dim = 4 * mc
        self.model_channels, self.num_classes, self.dtype = mc, num_classes, dtype
        gen = generator

        self.time_embed_1 = Linear(mc, emb_dim, dtype=dtype, generator=gen)
        self.time_embed_2 = Linear(emb_dim, emb_dim, dtype=dtype, generator=gen)
        if num_classes is not None:
            self.label_emb = nn.Embedding(num_classes + int(cfg_null_class), emb_dim)
            with torch.no_grad():
                self.label_emb.weight.normal_(0.0, 1.0, generator=gen)
        self.in_conv = Conv(in_channels, mc, 3, dtype=dtype, generator=gen)

        heads_up = num_heads if num_heads_upsample == -1 else num_heads_upsample

        def res(name, cin, cout):
            self.add_module(name, ResBlock(cin, cout, emb_dim,
                                           use_scale_shift_norm=use_scale_shift_norm,
                                           dropout=dropout, dtype=dtype, generator=gen))
            return name

        def attn(name, ch, heads):
            self.add_module(name, AttentionBlock(ch, heads, dtype=dtype, generator=gen))
            return name

        # block plan of the JAX model's _blocks; entries are module names
        self.encoder, self.middle, self.decoder = [], [], []
        input_chans = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                idx = len(self.encoder)
                entry = [res(f"down{idx}_0_res", ch, mult * mc)]
                ch = mult * mc
                if ds in attention_resolutions:
                    entry.append(attn(f"down{idx}_1_attn", ch, num_heads))
                self.encoder.append(entry)
                input_chans.append(ch)
            if level != len(channel_mult) - 1:
                idx = len(self.encoder)
                self.add_module(f"down{idx}_0_down",
                                Downsample(ch, conv_resample, dtype=dtype, generator=gen))
                self.encoder.append([f"down{idx}_0_down"])
                input_chans.append(ch)
                ds *= 2

        self.middle = [res("mid0_0_res", ch, ch), attn("mid1_0_attn", ch, num_heads),
                       res("mid2_0_res", ch, ch)]

        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                idx = len(self.decoder)
                entry = [res(f"up{idx}_0_res", ch + input_chans.pop(), mc * mult)]
                ch = mc * mult
                if ds in attention_resolutions:
                    entry.append(attn(f"up{idx}_{len(entry)}_attn", ch, heads_up))
                if level and i == num_res_blocks:
                    name = f"up{idx}_{len(entry)}_up"
                    self.add_module(name, Upsample(ch, conv_resample, dtype=dtype,
                                                   generator=gen))
                    entry.append(name)
                    ds //= 2
                self.decoder.append(entry)

        self.out_norm = GroupNorm32(ch)
        self.out_conv = FusedConv3x3(ch, out_channels, zero_init=True)

    def _embed(self, timesteps: torch.Tensor, y: Optional[torch.Tensor]) -> torch.Tensor:
        emb = timestep_embedding(timesteps, self.model_channels)
        emb = self.time_embed_2(silu(self.time_embed_1(emb)))
        if self.num_classes is not None:
            if y is None:
                raise ValueError("class-conditional model requires y")
            emb = emb + self.label_emb(y)
        elif y is not None:
            raise ValueError("must not pass y for an unconditional model")
        return emb

    def _run(self, h: torch.Tensor, names, emb: torch.Tensor, generator) -> torch.Tensor:
        for name in names:
            block = getattr(self, name)
            h = block(h, emb, generator) if isinstance(block, ResBlock) else block(h)
        return h

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                y: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (B, H, W, C) -> (B, H, W, out_channels) in x's dtype.
        ``generator`` draws the dropout masks (train mode, ``dropout > 0``)."""
        emb = self._embed(timesteps, y)
        in_dtype = x.dtype
        h = self.in_conv(x.to(self.dtype))
        hs = [h]
        for entry in self.encoder:
            h = self._run(h, entry, emb, generator)
            hs.append(h)
        h = self._run(h, self.middle, emb, generator)
        for entry in self.decoder:
            h = self._run(torch.cat([h, hs.pop()], dim=-1), entry, emb, generator)
        return _gn_silu_conv(h.to(in_dtype), self.out_norm, self.out_conv)
