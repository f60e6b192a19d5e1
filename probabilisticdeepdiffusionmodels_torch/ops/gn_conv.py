"""GroupNorm (+ emb add | FiLM) + SiLU + 3x3 conv: the folded affine, the
plain torch versions and the CUDA kernels.

``gn_affine`` folds the float32 GroupNorm statistics, the GN affine and the
ResBlock's timestep-embedding add or FiLM scale/shift into one
per-(sample, channel) scale ``a`` and offset ``off``, exactly as
``probabilisticdeepdiffusionmodels_tpu/ops/gn_conv_pallas.py:gn_affine``;
the fused op is then ``conv3x3_SAME(silu(x*a + off)) + bias``.  There the
fold is plain jnp that XLA fuses into one pass over x.  Here a CPU tensor
takes ``gn_affine_plain``, and a CUDA tensor one launch of the moments + fold
kernel of ``csrc/groupnorm.cu`` (``groupnorm.moments_fold``: x read once in
16-byte loads, no full-size temporary, bits that repeat from run to run).
Its gradient is two kernels as well (``gn_affine_grad``): the fold's backward
and one apply pass for dL/dx, from x itself and the (4, B, C) statistics the
forward left, so autograd keeps no float32 copy of x; ``gn_affine_grad_plain``
(autograd through ``gn_affine_plain``) is what it is held against.

Weight layout: the kernel reads the 3x3 weight as (kh, kw, Cout, Cin)
("HWOI"), so for one tap and one output channel the input channels are
contiguous and two neighbouring input channels form one 32-bit operand of
the tensor-core product.  ``convert.params_from_flax`` re-lays the JAX HWIO
kernel out once; the port's own init creates it in this layout.

Kernel (``csrc/gn_conv.cu``) — replaces ``gn_silu_conv3x3_pallas`` /
``_kernel`` in ``gn_conv_pallas.py``; one launch per call, and the
activation is never written to device memory.  ``conv_design`` picks one of
three designs (the source says more):

- ``wgmma`` (bf16, Cin and Cout multiples of 8, 16-byte aligned x and w:
  every bf16 site of the shipped configs).  Bound by tensor-core operations
  on the H100.  An implicit GEMM with M = output pixels, N = Cout,
  K = 9 taps x Cin, in a persistent, warp-specialised block: one thread
  copies each (64-channel slice, tap) weight tile and each slice's raw
  input halo by TMA, three warps activate the halo once in shared memory
  (zero outside the image *after* the activation, as the Pallas kernel pads
  after the SiLU), and one or two warpgroups run each tap as one ``wgmma``
  product with A read by ``ldmatrix`` from the halo shifted by the tap.
- ``narrow_f32`` (float32 with Cout <= 8, Cin % 4 == 0: the UNet's output
  head).  Bound by bytes.  The raw input halo streams in with ``cp.async``
  under the math, the whole weight stays in shared memory, each thread
  computes 4 pixels x all of Cout in true float32.
- ``general`` (every other shape, such as Cin % 8 != 0 or a wide float32
  conv): 64 pixels x 64 channels a block on ``mma.sync`` (bf16) or scalar
  FMAs (float32), the first design of this kernel.

The bias is added in float32 and the output stored in the input dtype.

Backward: no Pallas kernel has a backward kernel, so this op has none
either.  As ``_fused_bwd`` in ``gn_conv_pallas.py`` does, the gradient is
that of the plain math, recomputed from the saved inputs
(``autograd.kernel_op``); for a bf16 input the recomputed conv takes
bf16 operands (cuDNN accumulates in float32), the precision of the forward
kernel's product, instead of the plain version's float32 conv.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .autograd import forbid_forward_mode, kernel_op
from .groupnorm import (apply_affine, check_inputs, fold_backward, gn_fold, gn_fold_plain,
                        moments_fold, moments_plain)

__all__ = ["conv_design", "gn_affine", "gn_affine_plain", "gn_affine_grad",
           "gn_affine_grad_plain", "gn_affine_slab", "gn_affine_slab_plain",
           "gn_silu_conv3x3", "gn_silu_conv3x3_plain"]

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# the C entry point's design argument
DESIGNS = {"general": 0, "wgmma": 1, "narrow_f32": 2}
_SMEM_BYTES = 227 * 1024  # shared memory a block may use on the H100


def gn_affine_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    num_groups: int, eps: float, emb: Optional[torch.Tensor] = None,
                    film: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Per-(B, C) float32 scale/offset with

      normalize(x + emb) * gamma + beta          == x * a + off   (emb mode)
      (normalize(x)*gamma + beta)*(1+s) + shift  == x * a + off   (FiLM mode)

    x: (B, *spatial, C); emb: (B, C) or None; film: ((B, C), (B, C)) or None.
    """
    b, c = x.shape[0], x.shape[-1]
    g = num_groups
    xf = x.float().reshape(b, -1, c)
    mu_c = xf.mean(dim=1)
    m2_c = (xf * xf).mean(dim=1)
    if emb is not None:
        e = emb.float()
        m2_c = m2_c + 2.0 * e * mu_c + e * e
        mu_c = mu_c + e
    mu_g = mu_c.reshape(b, g, c // g).mean(dim=2)
    m2_g = m2_c.reshape(b, g, c // g).mean(dim=2)
    rstd_g = torch.rsqrt(m2_g - mu_g * mu_g + eps)
    mean_ch = mu_g.repeat_interleave(c // g, dim=1)
    rstd_ch = rstd_g.repeat_interleave(c // g, dim=1)
    a = rstd_ch * gamma.float()[None, :]
    off = beta.float()[None, :] - mean_ch * a
    if emb is not None:
        off = off + emb.float() * a
    if film is not None:
        s, shift = film
        s = 1.0 + s.float()
        a = a * s
        off = off * s + shift.float()
    return a, off


def _named(mode: int, conds) -> dict:
    return dict(emb=conds[0] if mode == 1 else None, film=tuple(conds) if mode == 2 else None)


def gn_affine_grad_plain(x, gamma, beta, num_groups, eps, ga, goff, emb=None, film=None):
    """The gradients of ``gn_affine_plain``'s (a, off), weighted by (ga,
    goff), in x, gamma, beta and emb or the FiLM pair, by autograd through
    the plain version: a tuple in that order."""
    conds = (emb,) if emb is not None else tuple(film or ())
    leaves = [t.detach().requires_grad_(True) for t in (x, gamma, beta, *conds)]
    with torch.enable_grad():
        out = gn_affine_plain(*leaves[:3], num_groups, eps,
                              **_named(1 if emb is not None else 2 if film else 0, leaves[3:]))
    return torch.autograd.grad(out, leaves, (ga, goff))


def gn_affine_grad(x, gamma, beta, num_groups, eps, ga, goff, ao, emb=None, film=None,
                   needs=None):
    """``gn_affine_grad_plain`` on the card: the fold's backward kernel, the
    apply kernel for dL/dx = 2 x dL/dS2 + dL/dS1, and two sums over the batch
    for gamma and beta.  ``ao`` is the forward's ``moments_fold`` output (not
    read for a CPU tensor); ``needs`` masks the gradients wanted (None where
    one is not).  A CPU tensor takes the plain version; inputs are as
    ``gn_affine`` hands them to its kernel (checked there)."""
    if x.device.type == "cpu":
        return gn_affine_grad_plain(x, gamma, beta, num_groups, eps, ga, goff, emb, film)
    conds = (emb,) if emb is not None else tuple(film or ())
    if needs is None:
        needs = (True,) * (3 + len(conds))
    g = fold_backward(ao, gamma, beta, x.numel() // (ao.shape[1] * ao.shape[2]), num_groups,
                      eps, ga, goff, emb=emb, film=film)
    gn_affine_grad.launches += 1
    grads = [apply_affine(x, g) if needs[0] else None,
             g[2].sum(0) if needs[1] else None, g[3].sum(0) if needs[2] else None]
    grads += [g[4 + i].to(t.dtype) if needs[3 + i] else None for i, t in enumerate(conds)]
    return tuple(grads)


gn_affine_grad.launches = 0


class _GnAffine(torch.autograd.Function):
    """``gn_affine`` on the card with its gradient from ``gn_affine_grad``:
    both directions are kernels, and what autograd keeps for the backward is
    x itself and the (4, B, C) statistics, no float32 copy of x."""

    @staticmethod
    def forward(ctx, num_groups, eps, mode, x, gamma, beta, *conds):
        ao = moments_fold(x, gamma, beta, num_groups, eps, **_named(mode, conds))
        gn_affine.launches += 1
        ctx.args = (num_groups, eps, mode)
        ctx.save_for_backward(ao, x, gamma, beta, *conds)
        return ao[0], ao[1]

    @staticmethod
    def backward(ctx, ga, goff):
        num_groups, eps, mode = ctx.args
        ao, x, gamma, beta, *conds = ctx.saved_tensors
        grads = gn_affine_grad(x, gamma, beta, num_groups, eps, ga, goff, ao,
                               needs=ctx.needs_input_grad[3:], **_named(mode, conds))
        return (None, None, None, *grads)


def _cond_in(t: torch.Tensor, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A conditioning tensor as the kernel reads it: (B, C) on x's device in
    ``dtype``, unit channel stride (the halves of a FiLM ``chunk`` keep their
    row stride; nothing is copied for them)."""
    if t.shape != (x.shape[0], x.shape[-1]):
        raise ValueError(f"emb/FiLM must be ({x.shape[0]}, {x.shape[-1]}), got {tuple(t.shape)}")
    if t.dtype != dtype or t.device != x.device:
        t = t.to(device=x.device, dtype=dtype)
    return t if t.stride(-1) == 1 else t.contiguous()


def gn_affine(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              num_groups: int, eps: float, emb: Optional[torch.Tensor] = None,
              film: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """``gn_affine_plain``'s (a, off), each (B, C) float32, for x of shape
    (B, *spatial, C).  A CPU tensor takes the plain version; a CUDA tensor
    (contiguous, float32 or bfloat16) launches the moments + fold kernel or
    raises.  Differentiable in x, gamma, beta and emb or the FiLM pair, by
    the backward kernels of ``gn_affine_grad``, in reverse mode only: a
    forward-mode tangent raises (``autograd.forbid_forward_mode``)."""
    if x.device.type == "cpu":
        return gn_affine_plain(x, gamma, beta, num_groups, eps, emb=emb, film=film)
    if emb is not None and film is not None:
        raise ValueError("gn_affine takes emb or film, not both")
    conds = (emb,) if emb is not None else tuple(film or ())
    forbid_forward_mode("gn_affine", x, gamma, beta, *conds)
    gamma, beta = check_inputs("gn_affine", x, gamma, beta, num_groups)
    mode = 1 if emb is not None else 2 if film is not None else 0
    # bf16 conditioning is read as it is; anything else in float32
    keep = all(t.dtype == torch.bfloat16 for t in conds)
    conds = tuple(_cond_in(t, x, torch.bfloat16 if keep else torch.float32) for t in conds)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, gamma, beta, *conds)):
        return _GnAffine.apply(num_groups, eps, mode, x, gamma, beta, *conds)
    ao = moments_fold(x, gamma, beta, num_groups, eps, **_named(mode, conds))
    gn_affine.launches += 1
    return ao[0], ao[1]


gn_affine.launches = 0


def gn_affine_slab_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                         num_groups: int, eps: float, average,
                         emb: Optional[torch.Tensor] = None,
                         film: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """``gn_affine_slab`` in plain torch (the moments and the fold)."""
    ao = gn_fold_plain(average(moments_plain(x)), gamma, beta, num_groups, eps,
                       emb=emb, film=film)
    return ao[0], ao[1]


def gn_affine_slab(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   num_groups: int, eps: float, average, emb: Optional[torch.Tensor] = None,
                   film: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """``gn_affine``'s (a, off) for a whole image of which ``x`` holds some
    rows: the (2, B, C) moments of ``x``, ``average``d over the ranks that
    hold the rest, folded (``groupnorm.gn_fold``).  A CPU tensor takes the
    plain version; a CUDA tensor launches the moments + fold kernel (its
    local fold unused) and the fold kernel.  Forward only (sampling)."""
    if x.device.type == "cpu":
        return gn_affine_slab_plain(x, gamma, beta, num_groups, eps, average,
                                    emb=emb, film=film)
    if emb is not None and film is not None:
        raise ValueError("gn_affine takes emb or film, not both")
    gamma, beta = check_inputs("gn_affine", x, gamma, beta, num_groups)
    conds = (emb,) if emb is not None else tuple(film or ())
    keep = all(t.dtype == torch.bfloat16 for t in conds)
    conds = tuple(_cond_in(t, x, torch.bfloat16 if keep else torch.float32) for t in conds)
    mode = 1 if emb is not None else 2 if film is not None else 0
    local = moments_fold(x, gamma, beta, num_groups, eps)
    gn_affine.launches += 1
    ao = gn_fold(average(local[2:4]), gamma, beta, num_groups, eps, **_named(mode, conds))
    return ao[0], ao[1]


def _affine_silu_conv(x, a, off, w, bias, conv_dtype):
    y = x.float() * a[:, None, None, :] + off[:, None, None, :]
    y = (y * torch.sigmoid(y)).to(x.dtype).to(conv_dtype)
    w_oihw = w.to(x.dtype).to(conv_dtype).permute(2, 3, 0, 1)
    out = F.conv2d(y.permute(0, 3, 1, 2), w_oihw, padding=1)
    out = out.permute(0, 2, 3, 1).float() + bias.float()
    return out.to(x.dtype).contiguous()


def gn_silu_conv3x3_plain(x: torch.Tensor, a: torch.Tensor, off: torch.Tensor,
                          w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, Cin); a/off: (B, Cin) float32; w: (3, 3, Cout, Cin);
    bias: (Cout,).  Returns (B, H, W, Cout) in x's dtype.

    The activation is rounded to x's dtype, the weight cast to it, and the
    conv accumulated in float32, as the kernel and the Pallas kernel do.
    """
    return _affine_silu_conv(x, a, off, w, bias, torch.float32)


def _grad_reference(x, a, off, w, bias):
    """What the kernel's backward differentiates: the plain version with the
    conv on operands of x's dtype."""
    return _affine_silu_conv(x, a, off, w, bias, x.dtype)


def gn_silu_conv3x3(x: torch.Tensor, a: torch.Tensor, off: torch.Tensor,
                    w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Fused ``conv3x3_SAME(silu(x*a + off)) + bias``; shapes as the plain
    version.  A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel or raises.  Differentiable in x, a, off, w and bias."""
    if x.device.type == "cpu":
        return gn_silu_conv3x3_plain(x, a, off, w, bias)
    if x.device.type != "cuda":
        raise ValueError(f"gn_silu_conv3x3: unsupported device {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"gn_silu_conv3x3 kernel takes float32/bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (B, H, W, Cin) tensor")
    b, h, wd, cin = x.shape
    if w.dim() != 4 or w.shape[:2] != (3, 3) or w.shape[3] != cin:
        raise ValueError(f"w must be (3, 3, Cout, {cin}), got {tuple(w.shape)}")
    cout = w.shape[2]
    if a.shape != (b, cin) or off.shape != (b, cin):
        raise ValueError(f"a/off must be ({b}, {cin})")
    if bias.shape != (cout,):
        raise ValueError(f"bias must be ({cout},)")
    # the casts stay outside the Function, so autograd carries each gradient
    # back to the float32 parameter it came from
    a = a.to(device=x.device, dtype=torch.float32).contiguous()
    off = off.to(device=x.device, dtype=torch.float32).contiguous()
    w = _weight_in(w, x)
    bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    return kernel_op(_launch, _grad_reference, x, a, off, w, bias)


def conv_design(x: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel design that a call on ``x`` (B, H, W, Cin) and ``w``
    (3, 3, Cout, Cin), both in the kernel's dtype, runs."""
    _, h, wd, cin = x.shape
    cout = w.shape[2]
    if (x.dtype == torch.bfloat16 and cin % 8 == 0 and cout % 8 == 0 and min(h, wd) >= 4
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0):
        return "wgmma"
    if x.dtype == torch.float32 and cout <= 8 and cin % 4 == 0 and x.data_ptr() % 16 == 0:
        # two raw 8-channel halo buffers, the activated one, the whole weight
        tw = (wd + 3) // 4 * 4 if wd <= 128 else 128
        halo = (256 // (tw // 4) + 2) * (tw + 2)
        if 4 * (16 * halo + 8 * (halo | 1) + 9 * cin * (4 if cout <= 4 else 8)) <= _SMEM_BYTES:
            return "narrow_f32"
    return "general"


# (tensor address, shape, dtype, device, target device and dtype) ->
# (source tensor, its in-place version, its cast); holding the source keeps
# the address its own, and one entry per tensor bounds the memory kept
_CASTS: "OrderedDict[tuple, tuple]" = OrderedDict()
_CASTS_KEPT = 256


def _weight_in(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``w`` on x's device in x's dtype, contiguous.  Where autograd does
    not record the cast (sampling), the cast of a tensor is kept until the
    tensor changes in place and reused, so a bf16 forward does not cast
    each float32 weight again on every call."""
    if w.device == x.device and w.dtype == x.dtype and w.is_contiguous():
        return w
    if ((torch.is_grad_enabled() and w.requires_grad)
            or (x.is_cuda and torch.cuda.is_current_stream_capturing())):
        # a graph keeps the cast it captured, which no version check guards
        return w.to(device=x.device, dtype=x.dtype).contiguous()
    key = (w.data_ptr(), tuple(w.shape), w.dtype, w.device, x.device, x.dtype)
    hit = _CASTS.get(key)
    if hit is not None and hit[1] == w._version:
        _CASTS.move_to_end(key)
        return hit[2]
    out = w.to(device=x.device, dtype=x.dtype).contiguous()
    _CASTS[key] = (w, w._version, out)
    _CASTS.move_to_end(key)
    if len(_CASTS) > _CASTS_KEPT:
        _CASTS.popitem(last=False)
    return out


def _launch(x, a, off, w, bias):
    b, h, wd, cin = x.shape
    cout = w.shape[2]
    out = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    _build.launch("pddm_gn_silu_conv3x3", x.data_ptr(), a.data_ptr(),
                  off.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
                  b, h, wd, cin, cout, int(x.dtype == torch.bfloat16),
                  DESIGNS[conv_design(x, w)])
    gn_silu_conv3x3.launches += 1
    return out


gn_silu_conv3x3.launches = 0
