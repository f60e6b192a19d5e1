"""The UNet with timestep embedding and spatial self-attention, channels last.

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/models/unet.py``
(``UNetModel`` at 1, 2 or 3 spatial dims, its blocks, and ``SuperResModel``).
Block plan, naming, zero-init points, attention head split and dtype
handling follow the JAX model; the module names are the JAX names, so
``convert.params_from_flax`` maps one tree onto the other key by key.

At 2-D every ResBlock conv and the output head run the fused GN(+emb|FiLM)+
SiLU+conv3x3 op (``ops.gn_conv``), as the JAX model does with
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

Under tensor parallelism (``parallel.tp``) a sharded fused conv runs the
kernel on this rank's slice of Cout and gathers the channels; under a
spatial row split (``parallel.spatial``) it runs on a halo slab with
whole-image statistics, the ranks' summed moments folded inside the conv
kernel (``gn_moments_slab``, ``gn_silu_conv3x3_fold``), and attention
gathers the token rows of ``qkv`` and keeps this rank's queries.

At 1-D and 3-D the JAX model fuses no conv: a ResBlock is GroupNorm + SiLU
(the GroupNorm op, kernel on the card) then a plain ``F.conv1d`` /
``F.conv3d``, the head likewise, and attention runs over the flattened
tokens on the same attention op.

A ResBlock's dropout mask is drawn from the generator by the model before
the block runs and handed to it.  ``use_checkpoint`` recomputes each
ResBlock and AttentionBlock in the backward (``torch.utils.checkpoint``,
non-reentrant), as JAX's ``nn.remat`` does; the recompute reads the mask
handed to the block without touching the generator, so the gradients are
those of the model without checkpoints, and a captured CUDA graph needs no
generator state saved or restored.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..core.diffusion import timestep_embedding
from ..ops.attention import qkv_attention
from ..ops.gn_conv import gn_affine, gn_moments_slab, gn_silu_conv3x3, gn_silu_conv3x3_fold
from ..parallel import mesh as P
from ..parallel import spatial
from ..parallel.tp import gather_channels, to_model
from .layers import (
    Conv,
    Embedding,
    FusedConv3x3,
    GroupNorm32,
    Linear,
    avg_pool_nd,
    bilinear_resize,
    nearest_upsample_nd,
    silu,
)

__all__ = ["ResBlock", "AttentionBlock", "Downsample", "Upsample", "UNetModel",
           "SuperResModel"]


def dropout_mask(shape, p: float, generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """The keep mask of inverted dropout at rate ``p``, drawn from ``generator``
    (at the global batch under a mesh's batch split)."""
    if generator is None:
        raise ValueError("dropout > 0 in train mode needs a generator: pass "
                         "model(..., generator=...) (the train step passes its state's)")
    return P.rand(shape, generator=generator, device=device) >= p


def masked(x: torch.Tensor, keep: torch.Tensor, p: float) -> torch.Tensor:
    """Inverted dropout at rate ``p`` with the keep mask ``keep``."""
    return x * keep.to(x.dtype) / (1.0 - p)


def _gn_silu_conv(x: torch.Tensor, norm: GroupNorm32, conv: FusedConv3x3,
                  emb: Optional[torch.Tensor] = None, film=None) -> torch.Tensor:
    x = x.contiguous()  # the statistics and the conv kernel read one tensor
    rows = spatial.active()
    if rows is not None:
        return _gn_silu_conv_slab(x, norm, conv, rows, emb, film)
    a, off = gn_affine(x, norm.weight, norm.bias, norm.groups, norm.eps, emb=emb, film=film)
    if conv.tp is None:
        return gn_silu_conv3x3(x, a, off, conv.weight, conv.bias)
    # this rank's Cout slice; the whole bias after the gather
    x, a, off = to_model(conv.tp, x, a, off)
    y = gn_silu_conv3x3(x, a, off, conv.weight, conv.bias.new_zeros(conv.weight.shape[2]))
    return gather_channels(conv.tp, y) + conv.bias.to(y.dtype)


def _gn_silu_conv_slab(x: torch.Tensor, norm: GroupNorm32, conv: FusedConv3x3, rows,
                       emb: Optional[torch.Tensor], film) -> torch.Tensor:
    """``_gn_silu_conv`` on this rank's rows: whole-image statistics (the
    ranks' summed moments, folded inside the conv kernel); the kernel
    activates the halo rows and pads zeros at the slab's edges, whose rows
    are dropped."""
    mom = gn_moments_slab(x, norm.weight, norm.bias, norm.groups, norm.eps,
                          lambda m: spatial.total(m, rows))
    h = x.shape[1]
    x, top, _ = spatial.halo(x, 1, 1, rows)
    ins = (x, mom, norm.weight, norm.bias, *((emb,) if emb is not None else film or ()))
    bias = conv.bias
    if conv.tp is not None:
        # this rank's Cout slice; the whole bias after the gather
        ins = to_model(conv.tp, *ins)
        bias = conv.bias.new_zeros(conv.weight.shape[2])
    x, mom, gamma, beta, *conds = ins
    y = gn_silu_conv3x3_fold(x, mom, rows.count, gamma, beta, norm.groups, norm.eps,
                             conv.weight, bias, emb=conds[0] if emb is not None else None,
                             film=tuple(conds) if film is not None else None)
    y = y[:, top:top + h]
    if conv.tp is None:
        return y.contiguous()
    return gather_channels(conv.tp, y) + conv.bias.to(y.dtype)


class ResBlock(nn.Module):
    """GN-SiLU-conv, timestep-embedding add or FiLM, GN-SiLU-(dropout)-zero-
    init conv, plus the identity or a 1x1 (``use_conv_skip``: 3x3) conv skip.
    At ``dims`` 2 both GN-SiLU-convs are the fused op (``FusedConv3x3``
    weights), at 1 and 3 GroupNorm + SiLU and a plain ``Conv``."""

    def __init__(self, in_ch: int, out_ch: int, emb_dim: int,
                 use_conv_skip: bool = False, use_scale_shift_norm: bool = False,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, dims: int = 2):
        super().__init__()
        self.use_scale_shift_norm = use_scale_shift_norm
        self.dropout = dropout
        self.out_ch, self.dims = out_ch, dims
        self.in_norm = GroupNorm32(in_ch)
        if dims == 2:
            self.in_conv = FusedConv3x3(in_ch, out_ch, generator=generator)
        else:
            self.in_conv = Conv(in_ch, out_ch, 3, dtype=dtype, generator=generator, dims=dims)
        self.emb_proj = Linear(emb_dim, 2 * out_ch if use_scale_shift_norm else out_ch,
                               dtype=dtype, generator=generator)
        self.out_norm = GroupNorm32(out_ch)
        if dims == 2:
            self.out_conv = FusedConv3x3(out_ch, out_ch, zero_init=True)
        else:
            self.out_conv = Conv(out_ch, out_ch, 3, zero_init=True, dtype=dtype, dims=dims)
        self.skip_conv = None
        if out_ch != in_ch:
            self.skip_conv = Conv(in_ch, out_ch, 3 if use_conv_skip else 1,
                                  dtype=dtype, generator=generator, dims=dims)

    def drops(self) -> bool:
        return self.training and self.dropout > 0

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``keep``: the dropout keep mask of the output's shape (``dropout_mask``),
        needed where dropout acts (``drops()``)."""
        if self.dims != 2:
            return self._unfused(x, emb, keep)
        h = _gn_silu_conv(x, self.in_norm, self.in_conv)
        emb_out = self.emb_proj(silu(emb)).to(h.dtype)
        cond = (dict(film=tuple(emb_out.chunk(2, dim=-1))) if self.use_scale_shift_norm
                else dict(emb=emb_out))
        if self.drops():
            # JAX models/unet.py:129-146: the unfused path, dropout after the SiLU
            norm = self.out_norm
            h = h.contiguous()
            a, off = gn_affine(h, norm.weight, norm.bias, norm.groups, norm.eps, **cond)
            act = silu(h.float() * a[:, None, None, :] + off[:, None, None, :]).to(h.dtype)
            h = self.out_conv.conv(masked(act, keep, self.dropout))
        else:
            h = _gn_silu_conv(h, self.out_norm, self.out_conv, **cond)
        skip = x if self.skip_conv is None else self.skip_conv(x)
        return skip + h

    def _unfused(self, x, emb, keep):
        """JAX models/unet.py:99-153 off 2-D: GroupNorm (+SiLU) and plain convs."""
        h = self.in_conv(self.in_norm(x, silu=True))
        emb_out = self.emb_proj(silu(emb)).to(h.dtype)
        emb_out = emb_out.reshape(emb_out.shape[0], *(1,) * self.dims, -1)
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=-1)
            h = silu(self.out_norm(h) * (1 + scale) + shift)
        else:
            h = self.out_norm(h + emb_out, silu=True)
        if self.drops():
            h = masked(h, keep, self.dropout)
        h = self.out_conv(h)
        skip = x if self.skip_conv is None else self.skip_conv(x)
        return skip + h


class AttentionBlock(nn.Module):
    """GroupNorm -> 1x1 qkv -> per-head attention -> zero-init 1x1 proj,
    residual, over the flattened spatial tokens."""

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
        qkv = self.qkv(self.norm(tokens)).contiguous()
        rows = spatial.active()
        if rows is None:
            out = qkv_attention(qkv, self.num_heads)
        else:
            # every token's keys and values, this rank's queries
            n = qkv.shape[1]
            out = qkv_attention(spatial.gather_rows(qkv, rows), self.num_heads)
            out = out[:, rows.index * n:(rows.index + 1) * n]
        return (tokens + self.proj(out)).reshape(x.shape)


class Downsample(nn.Module):
    """Stride-2 3-wide conv (JAX SAME padding) or 2-wide average pool."""

    def __init__(self, channels: int, use_conv: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, dims: int = 2):
        super().__init__()
        self.op = Conv(channels, channels, 3, stride=2, dtype=dtype,
                       generator=generator, dims=dims) if use_conv else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return avg_pool_nd(x, 2) if self.op is None else self.op(x)


class Upsample(nn.Module):
    """Nearest 2x upsample, then an optional 3-wide conv."""

    def __init__(self, channels: int, use_conv: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, dims: int = 2):
        super().__init__()
        self.conv = Conv(channels, channels, 3, dtype=dtype,
                         generator=generator, dims=dims) if use_conv else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = nearest_upsample_nd(x)
        return x if self.conv is None else self.conv(x)


class UNetModel(nn.Module):
    """The UNet over ``dims`` (1, 2 or 3) spatial axes.
    ``attention_resolutions`` are downsample rates (the factory converts
    image-side lengths).  Input and output are channels last; the output
    head runs in the input's dtype at 2-D (float32 for a float32 input even
    when ``dtype`` is bfloat16) and in float32 at 1-D and 3-D, as JAX's
    plain head conv does.  ``use_checkpoint`` recomputes every ResBlock and
    AttentionBlock in the backward."""

    def __init__(self, in_channels: int, model_channels: int, out_channels: int,
                 num_res_blocks: int, attention_resolutions: Sequence[int],
                 channel_mult: Sequence[int] = (1, 2, 4, 8),
                 conv_resample: bool = True, num_classes: Optional[int] = None,
                 cfg_null_class: bool = False, num_heads: int = 1,
                 num_heads_upsample: int = -1, use_scale_shift_norm: bool = False,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, dims: int = 2,
                 use_checkpoint: bool = False):
        super().__init__()
        if dims not in (1, 2, 3):
            raise ValueError(f"dims must be 1, 2 or 3, got {dims}")
        mc = model_channels
        emb_dim = 4 * mc
        self.model_channels, self.num_classes, self.dtype = mc, num_classes, dtype
        self.cfg_null_class = bool(cfg_null_class)
        self.dims, self.use_checkpoint = dims, bool(use_checkpoint)
        gen = generator

        self.time_embed_1 = Linear(mc, emb_dim, dtype=dtype, generator=gen)
        self.time_embed_2 = Linear(emb_dim, emb_dim, dtype=dtype, generator=gen)
        if num_classes is not None:
            self.label_emb = Embedding(num_classes + int(cfg_null_class), emb_dim)
            with torch.no_grad():
                self.label_emb.weight.normal_(0.0, 1.0, generator=gen)
        self.in_conv = Conv(in_channels, mc, 3, dtype=dtype, generator=gen, dims=dims)

        heads_up = num_heads if num_heads_upsample == -1 else num_heads_upsample

        def res(name, cin, cout):
            self.add_module(name, ResBlock(cin, cout, emb_dim,
                                           use_scale_shift_norm=use_scale_shift_norm,
                                           dropout=dropout, dtype=dtype, generator=gen,
                                           dims=dims))
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
                                Downsample(ch, conv_resample, dtype=dtype, generator=gen,
                                           dims=dims))
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
                                                   generator=gen, dims=dims))
                    entry.append(name)
                    ds //= 2
                self.decoder.append(entry)

        self.out_norm = GroupNorm32(ch)
        if dims == 2:
            self.out_conv = FusedConv3x3(ch, out_channels, zero_init=True)
        else:
            self.out_conv = Conv(ch, out_channels, 3, zero_init=True, dims=dims)

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
        remat = self.use_checkpoint and torch.is_grad_enabled()
        for name in names:
            block = getattr(self, name)
            if isinstance(block, ResBlock):
                # drawn here, so a recompute reads the same mask
                keep = (dropout_mask((*h.shape[:-1], block.out_ch), block.dropout, generator,
                                     h.device) if block.drops() else None)
                h = (checkpoint(block, h, emb, keep, use_reentrant=False,
                                preserve_rng_state=False) if remat else block(h, emb, keep))
            elif remat and isinstance(block, AttentionBlock):
                h = checkpoint(block, h, use_reentrant=False, preserve_rng_state=False)
            else:
                h = block(h)
        return h

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                y: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None,
                return_features: bool = False,
                cache: Optional[Tuple[torch.Tensor, Sequence[torch.Tensor]]] = None,
                return_cache: bool = False, cache_middle: bool = False):
        """x: (B, *spatial, C) -> (B, *spatial, out_channels), in x's dtype at 2-D.
        ``generator`` draws the dropout masks (train mode, ``dropout > 0``).
        ``timesteps`` may be fractional (the EDM and flow conditioning).

        ``return_features``: instead of the output, a dict of the
        activations in x's dtype: ``down`` (the input conv's and each
        encoder entry's), ``middle`` and ``up`` (each decoder entry's).
        Encoder reuse: ``return_cache`` also returns ``(h, skips)``, the
        encoder's output and its skip activations, as ``(out, cache)``;
        ``cache=`` skips the encoder and runs the middle block and the
        decoder on those features.  ``cache_middle`` (on both calls) caches
        the middle block's output instead, so a cached call runs the
        decoder alone.
        """
        if return_features and cache is not None:
            raise ValueError("return_features needs the encoder to run: with cache= the "
                             "'down' activations would be empty")
        emb = self._embed(timesteps, y)
        in_dtype = x.dtype
        if cache is not None:
            h, skips = cache
            h = h.to(self.dtype)
            hs = [s.to(self.dtype) for s in skips]
        else:
            h = self.in_conv(x.to(self.dtype))
            hs = [h]
            for entry in self.encoder:
                h = self._run(h, entry, emb, generator)
                hs.append(h)
        # the features are cast only where they are returned: an eager cast
        # that nothing reads is a copy on the card (JAX's jit drops them)
        down = [s.to(in_dtype) for s in hs] if return_features else []
        new_cache = (h, tuple(hs)) if return_cache and not cache_middle else None
        if not (cache is not None and cache_middle):
            h = self._run(h, self.middle, emb, generator)
        middle = h.to(in_dtype) if return_features else None
        if return_cache and cache_middle:
            new_cache = (h, tuple(hs))
        up = []
        for entry in self.decoder:
            h = self._run(torch.cat([h, hs.pop()], dim=-1), entry, emb, generator)
            if return_features:
                up.append(h.to(in_dtype))
        if return_features:
            return {"down": down, "middle": middle, "up": up}
        if self.dims == 2:
            out = _gn_silu_conv(h.to(in_dtype), self.out_norm, self.out_conv)
        else:
            out = self.out_conv(self.out_norm(h.to(in_dtype), silu=True))
        return (out, new_cache) if return_cache else out


class SuperResModel(nn.Module):
    """The UNet conditioned on a low-resolution image: ``low_res`` is
    resized bilinearly to x's size (in float32, then x's dtype) and
    concatenated on the channel axis.  Built with the *base*
    ``in_channels``; the wrapped UNet, the submodule ``unet`` (the Flax
    tree's ``unet/...``), sees twice as many.  ``low_res`` is the third
    positional argument, as in the JAX model, so every caller that passes
    its conditioning as ``model(x, t, y)`` hands the low-res image over;
    class labels, where the model has classes, go by ``y=``."""

    def __init__(self, in_channels: int, **unet_kwargs):
        super().__init__()
        self.unet = UNetModel(in_channels=2 * in_channels, **unet_kwargs)
        self.num_classes = self.unet.num_classes
        self.cfg_null_class = self.unet.cfg_null_class

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                low_res: Optional[torch.Tensor] = None, y: Optional[torch.Tensor] = None,
                **kwargs):
        if low_res is None:
            raise ValueError("SuperResModel requires low_res")
        rows = spatial.active()
        if rows is None:
            up = bilinear_resize(low_res, x.shape[1], x.shape[2]).to(x.dtype)
        else:  # the whole image's resize, this rank's rows
            h = x.shape[1]
            up = bilinear_resize(low_res, h * rows.count, x.shape[2])
            up = up[:, rows.index * h:(rows.index + 1) * h].to(x.dtype)
        return self.unet(torch.cat([x, up], dim=-1), timesteps, y, **kwargs)
