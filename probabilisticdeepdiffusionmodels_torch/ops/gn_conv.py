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
16-byte loads, no full-size temporary, bits that repeat from run to run), in
the design its shape selects (``groupnorm.affine_design``): ``cluster``,
chunks of whole groups that each block folds itself, or whose split rows
meet in a thread-block cluster's distributed shared memory, so no site of the
CIFAR-10 UNet at batch 128 has a cross-block step; ``workspace``, the first
design, for samples longer than a cluster takes.  The sites are bound by
bytes at 32x32 and by the latency of a launch at 4x4 and 8x8.

Its gradient (``gn_affine_grad``) reads x itself and the (4, B, C)
statistics the forward left, so autograd keeps no float32 copy of x.  In
design ``fused_bwd`` (``grad_design``) it is two launches a site: each block
recomputes the fold's backward for its chunk of whole groups and writes
dL/dx and the conditioning's gradient in its dtype, then a small kernel
adds the per-sample shares of dL/dgamma and dL/dbeta over the batch in a
fixed order.  The first design, ``fold_bwd+apply`` (the fold's backward, the
apply pass, two torch sums and a cast: 4-5 device operations a site, which
bounded it more than DRAM did), stays for groups wider than a block and by
name for measurement.  ``gn_affine_grad_plain`` (autograd through
``gn_affine_plain``) is what both are held against.

Weight layout: the kernel reads the 3x3 weight as (kh, kw, Cout, Cin)
("HWOI"), so for one tap and one output channel the input channels are
contiguous and two neighbouring input channels form one 32-bit operand of
the tensor-core product.  ``convert.params_from_flax`` re-lays the JAX HWIO
kernel out once; the port's own init creates it in this layout.

Kernel (``csrc/gn_conv.cu``) — replaces ``gn_silu_conv3x3_pallas`` /
``_kernel`` in ``gn_conv_pallas.py``; one launch per call, and the
activation is never written to device memory.  ``conv_design`` picks one of
four designs (the source says more):

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
- ``tiled_f32`` (float32 with Cin and Cout multiples of 4, Cout > 8,
  16-byte aligned x and w: every float32 site of the shipped configs but the
  head; float32 is the configs' default ``compute_dtype``).  Bound by FP32
  operations.  128 pixels x 128 channels a block of 256 threads, 8 x 8
  float32 accumulators a thread fed by 16-byte shared loads, the raw halo
  and weight slices landing by ``cp.async`` two slices ahead, each slice
  activated once a block; where the tiles would not fill the card (the 8x8
  and 4x4 sites) a thread-block cluster splits the input channels and adds
  its partial tiles in rank order through distributed shared memory.
  ``tiled_tile`` mirrors its tiling.
- ``general`` (every other shape, such as bf16 with Cin % 8 != 0 or float32
  with Cin % 4 != 0, and by name for measurement): 64 pixels x 64 channels
  a block on ``mma.sync`` (bf16) or scalar FMAs (float32), the first design
  of this kernel.

The bias is added in float32 and the output stored in the input dtype.

A spatially sharded forward's slab (``models/unet.py``) runs the folding
variant of the same designs, ``gn_silu_conv3x3_fold``: it takes the ranks'
summed (2, B, Cin) moments (``gn_moments_slab``: one moments launch and
one all-reduce in place), the rank count, gamma, beta and the
conditioning, and folds (a, off) inside the kernel with ``gn_fold``'s
arithmetic (``csrc/gn_fold.cuh``), so no fold kernel runs before it.  The
first design, ``gn_affine_slab`` (the moments averaged over the ranks,
``groupnorm.gn_fold``) then the conv fed (a, off), stays callable by name.

Backward (``gn_silu_conv3x3_grad``, kernels in ``csrc/gn_conv_grad.cu``):
the Pallas kernel has no backward kernel; ``_fused_bwd`` in
``gn_conv_pallas.py`` takes ``jax.vjp`` of the XLA form, which XLA compiles
into two conv transposes and fused elementwise passes.  Here a CUDA tensor
takes a fixed set of launches a call, chosen by ``conv_grad_design`` and cut
by ``grad_plan``, each design ending in one launch that adds the partials in
a fixed order (no float atomics: the same bits on every run):

- ``wgmma`` (the bf16 sites): the input product (dgrad) on the tensor cores
  with the activation's backward in its epilogue (dx out, per-tile partial
  sums of the scale's and offset's gradients), which also stores the
  activation h once a site into a transient bf16 buffer (``GradPlan.
  activation``; one elementwise launch writes it where no dx is wanted):
  two consumer warpgroups take alternate tiles ("ping-pong"), so one tile's
  epilogue runs under the other's products, x arrives by TMA with the
  tile's last g slice and h and dx leave by TMA stores; then the weight
  product (wgrad9) reads h and g by TMA, a block owning all nine taps of its
  (pixel split, 64 Cin, 64 Cout).
- ``narrow_f32`` (float32 with Cout <= 8: the UNet's output head): one launch
  that reads x once, with the whole weight and the tile's g halo in shared
  memory, forming dx, h and every partial from the same x values.
- ``tiled_f32`` (the forward's float32 shapes): the input product on the
  forward's ``tiled_f32`` main loop (g's halo in place of the activation,
  the weight flipped), the activation's backward in its epilogue (dx, one
  partial of the scale's and offset's gradients a (tile, image, channel)),
  then ``general``'s weight product, unchanged.
- ``general`` (bf16 with channels not a multiple of 8, float32 with
  channels not a multiple of 4, and by name): a simple pair of true-float32
  FMA kernels.

By name only, for measurement: ``wgmma_sync_epilogue``, the second bf16
pair (its dgrad's two warpgroups share a tile and both stop their products
for its epilogue, which loads x and stores h and dx with plain 16-byte
accesses), ``wgmma_taprow``, the first (its wgrad re-activates x in shared
memory for 3 taps of a block), and
``recompute``, the first design of all (autograd through the plain version
from the saved inputs), which adds nothing to the op's launch count.
``gn_silu_conv3x3_grad_plain`` writes the five gradients out as formulas; it
equals autograd through ``_grad_reference`` (the plain version with the conv
on operands of x's dtype), and a CPU tensor takes it.  Autograd keeps x, a,
off, w and bias for the backward, no activation.
"""

from __future__ import annotations

import functools
from collections import OrderedDict
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .autograd import forbid_forward_mode
from .groupnorm import (_cond_args, _float32_on, _grad_plan, _shape, affine_backward,
                        apply_affine, check_inputs, fold_backward, gn_fold, gn_fold_plain,
                        moments_fold, moments_plain)

__all__ = ["conv_design", "conv_grad_design", "gn_affine", "gn_affine_plain", "gn_affine_grad",
           "gn_affine_grad_plain", "grad_design", "gn_affine_slab",
           "gn_affine_slab_plain", "gn_moments_slab", "gn_moments_slab_plain",
           "gn_silu_conv3x3", "gn_silu_conv3x3_plain", "gn_silu_conv3x3_fold",
           "gn_silu_conv3x3_fold_plain", "gn_silu_conv3x3_grad", "gn_silu_conv3x3_grad_plain",
           "grad_plan"]

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# the C entry point's design argument
DESIGNS = {"general": 0, "wgmma": 1, "narrow_f32": 2, "tiled_f32": 3}
_SMEM_BYTES = 227 * 1024  # shared memory a block may use on the H100
_TILED_POSITIONS = 512  # halo positions of a tiled_f32 tile, at most (MAX_POS)
_TILED_SLICE = 4 * 9 * 128  # floats of a tiled_f32 weight slice (WSLICE)


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


def grad_design(x: torch.Tensor, num_groups: int) -> str:
    """The design a ``gn_affine_grad`` call on CUDA tensor ``x`` runs:
    ``fused_bwd`` (two launches), or ``fold_bwd+apply`` where a group is
    wider than a block."""
    b, n, c = _shape(x)
    plan = _grad_plan(b, n, c, num_groups, x.element_size(), x.data_ptr() & 15)
    return "fold_bwd+apply" if plan is None else "fused_bwd"


def gn_affine_grad(x, gamma, beta, num_groups, eps, ga, goff, ao, emb=None, film=None,
                   needs=None, design=None):
    """``gn_affine_grad_plain`` on the card.  ``fused_bwd``
    (``groupnorm.affine_backward``): one launch that recomputes the fold's
    backward in each block and writes dL/dx and the conditioning's
    gradients in its dtype, one for the sums over the batch for gamma and
    beta.  ``fold_bwd+apply`` (the first
    design): the fold's backward kernel, the apply kernel for dL/dx = 2 x
    dL/dS2 + dL/dS1, two sums over the batch and the casts.  ``design``:
    None for ``grad_design``'s choice, or either by name (a measurement
    times both).  ``ao`` is the forward's ``moments_fold`` output
    (not read for a CPU tensor); ``needs`` masks the gradients wanted (None
    where one is not).  A CPU tensor takes the plain version; inputs are as
    ``gn_affine`` hands them to its kernel (checked there)."""
    if x.device.type == "cpu":
        return gn_affine_grad_plain(x, gamma, beta, num_groups, eps, ga, goff, emb, film)
    conds = (emb,) if emb is not None else tuple(film or ())
    if needs is None:
        needs = (True,) * (3 + len(conds))
    if design is None:
        design = grad_design(x, num_groups)
    if design == "fused_bwd":
        grads = affine_backward(x, ao, gamma, beta, num_groups, eps, ga, goff, emb=emb,
                                film=film, want_dx=needs[0])
    elif design == "fold_bwd+apply":
        g = fold_backward(ao, gamma, beta, x.numel() // (ao.shape[1] * ao.shape[2]),
                          num_groups, eps, ga, goff, emb=emb, film=film)
        grads = [apply_affine(x, g) if needs[0] else None,
                 g[2].sum(0) if needs[1] else None, g[3].sum(0) if needs[2] else None]
        grads += [g[4 + i].to(t.dtype) if needs[3 + i] else None for i, t in enumerate(conds)]
    else:
        raise ValueError(f"unknown gn_affine_grad design {design!r}")
    gn_affine_grad.launches += 1
    return tuple(t if need else None for t, need in zip(grads, needs))


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


def kernel_args(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, num_groups: int,
                emb: Optional[torch.Tensor] = None,
                film: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """(gamma, beta, mode, conditioning) as ``gn_affine``'s kernels take them:
    gamma/beta float32 on x's device (``check_inputs`` raises on what the
    kernels do not take), the mode (0 none, 1 emb, 2 FiLM) and emb or the
    FiLM pair as ``_cond_in`` makes them: bf16 conditioning is read as it
    is, anything else in float32."""
    if emb is not None and film is not None:
        raise ValueError("gn_affine takes emb or film, not both")
    gamma, beta = check_inputs("gn_affine", x, gamma, beta, num_groups)
    conds = (emb,) if emb is not None else tuple(film or ())
    keep = all(t.dtype == torch.bfloat16 for t in conds)
    conds = tuple(_cond_in(t, x, torch.bfloat16 if keep else torch.float32) for t in conds)
    return gamma, beta, 1 if emb is not None else 2 if film is not None else 0, conds


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
    forbid_forward_mode("gn_affine", x, gamma, beta, emb, *(film or ()))
    gamma, beta, mode, conds = kernel_args(x, gamma, beta, num_groups, emb, film)
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
    """``gn_affine_slab`` in plain torch (the moments and the fold).  The
    slab's first design, by name only (``gn_silu_conv3x3_fold`` folds
    inside the conv)."""
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
    local fold unused) and the fold kernel.  Forward only (sampling).  The
    slab's first design, callable by name for measurement; no path runs it
    (the slab's statistics come from ``gn_moments_slab`` and are folded
    inside ``gn_silu_conv3x3_fold``)."""
    if x.device.type == "cpu":
        return gn_affine_slab_plain(x, gamma, beta, num_groups, eps, average,
                                    emb=emb, film=film)
    gamma, beta, mode, conds = kernel_args(x, gamma, beta, num_groups, emb, film)
    local = moments_fold(x, gamma, beta, num_groups, eps)
    gn_affine.launches += 1
    ao = gn_fold(average(local[2:4]), gamma, beta, num_groups, eps, **_named(mode, conds))
    return ao[0], ao[1]


def gn_moments_slab_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                          num_groups: int, eps: float, total) -> torch.Tensor:
    """``gn_moments_slab`` in plain torch: ``total(moments_plain(x))``."""
    return total(moments_plain(x))


def gn_moments_slab(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, num_groups: int,
                    eps: float, total) -> torch.Tensor:
    """The (2, B, C) float32 E[x] and E[x^2] of the rows of an image that
    ``x`` holds, summed in place over the ranks that hold the rest by
    ``total`` (an all-reduce; the identity on one rank): what
    ``gn_silu_conv3x3_fold`` folds.  A CPU tensor takes the plain version; a
    CUDA tensor one launch of the moments + fold kernel (its fold unused,
    counted as ``gn_affine``'s).  Forward only."""
    if x.device.type == "cpu":
        return gn_moments_slab_plain(x, gamma, beta, num_groups, eps, total)
    gamma, beta, _, _ = kernel_args(x, gamma, beta, num_groups)
    local = moments_fold(x, gamma, beta, num_groups, eps)
    gn_affine.launches += 1
    return total(local[2:4])


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
                    w: torch.Tensor, bias: torch.Tensor,
                    design: Optional[str] = None) -> torch.Tensor:
    """Fused ``conv3x3_SAME(silu(x*a + off)) + bias``; shapes as the plain
    version.  A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel of ``design`` (None: ``conv_design``'s choice; a name, for
    measurement) or raises.  Differentiable in x, a, off, w and bias, on the
    card by ``gn_silu_conv3x3_grad``'s kernels, in reverse mode only."""
    if x.device.type == "cpu":
        return gn_silu_conv3x3_plain(x, a, off, w, bias)
    b, _, _, cin = _check_conv("gn_silu_conv3x3", x, w, bias)
    if a.shape != (b, cin) or off.shape != (b, cin):
        raise ValueError(f"a/off must be ({b}, {cin})")
    # the casts stay outside the Function, so autograd carries each gradient
    # back to the float32 parameter it came from
    a = a.to(device=x.device, dtype=torch.float32).contiguous()
    off = off.to(device=x.device, dtype=torch.float32).contiguous()
    w = _weight_in(w, x)
    bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    forbid_forward_mode("gn_silu_conv3x3", x, a, off, w, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, a, off, w, bias)):
        return _GnSiluConv.apply(x, a, off, w, bias, design)
    return _launch(x, a, off, w, bias, design)


def _check_conv(name: str, x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor):
    """(B, H, W, Cin) of a fused conv's call; raise on what its kernels do
    not take."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{name} kernel takes float32/bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (B, H, W, Cin) tensor")
    b, h, wd, cin = x.shape
    if w.dim() != 4 or w.shape[:2] != (3, 3) or w.shape[3] != cin:
        raise ValueError(f"w must be (3, 3, Cout, {cin}), got {tuple(w.shape)}")
    if bias.shape != (w.shape[2],):
        raise ValueError(f"bias must be ({w.shape[2]},)")
    return b, h, wd, cin


def tiled_tile(h: int, w: int) -> ConvTile:
    """tiled_f32's pixel tiles (``tiled::set_tile``): TW columns, the width
    rounded up to a power of two from 4, at most 128 (row segments beyond),
    and the rows that the 16 thread rows of 8 pixels hold (8 columns a
    thread, or 4 columns of two rows at TW = 4): TH rows of one image, or
    ``ni`` whole images where an image has fewer rows."""
    tw = 4
    while tw < w and tw < 128:
        tw *= 2
    pc = 8 if tw >= 8 else 4
    cap = 16 // (tw // pc) * (8 // pc)
    if h >= cap:
        ni, th = 1, cap
    else:
        ni, th = cap // _tiled_rows(h, tw), h
    return ConvTile(ni, th, tw, -(-h // th), -(-w // tw))


def tiled_splits(b: int, h: int, w: int, k: int, n: int, sms: int) -> int:
    """The blocks of a thread-block cluster that split tiled_f32's K (``k``
    channels of its A operand) for ``n`` output channels (``tiled::launch_pc``):
    the most, up to 8, whose blocks still fit one wave of two blocks an SM,
    each taking a multiple of 4 channels."""
    blocks = tiled_tile(h, w).count(b) * -(-n // 128)
    s = 1
    while s < 8 and blocks * s * 2 <= 2 * sms and k % (4 * s * 2) == 0:
        s *= 2
    return s


def _tiled_rows(th: int, tw: int) -> int:
    """A tiled_f32 tile's rows of one image, padded to a thread's rows."""
    pr = 1 if tw >= 8 else 2
    return -(-th // pr) * pr


def _tiled_positions(h: int, w: int) -> int:
    """tiled_f32's halo positions: ``ni`` images of (padded rows + 2) rows of
    TW + 4 floats."""
    t = tiled_tile(h, w)
    return t.ni * (_tiled_rows(t.th, t.tw) + 2) * (t.tw + 4)


def _tiled_smem(h: int, w: int, fold_floats: int = 0) -> int:
    """Shared memory of tiled_f32 (``tiled::Layout``): the position table,
    two raw halo and weight slices, two activated halos and weight slices,
    the FOLD table; or, where larger, the epilogue's partial tile and sums."""
    npos = _tiled_positions(h, w)
    raw_w = _TILED_SLICE + _TILED_SLICE // 8  # a unit of padding after every 8
    main = (-(-npos * 8 // 16) * 16 + 2 * npos * 16 + 2 * (raw_w + _TILED_SLICE) * 4
            + 2 * 4 * npos * 4)
    return max(main + fold_floats * 4, (128 * 128 + 16 * 128 * 2) * 4)


def conv_design(x: torch.Tensor, w: torch.Tensor, groups: int = 0) -> str:
    """The kernel design that a call on ``x`` (B, H, W, Cin) and ``w``
    (3, 3, Cout, Cin), both in the kernel's dtype, runs; ``groups``: the
    folding conv's GroupNorm groups (its narrow_f32 and tiled_f32 keep the
    scale, the offset and each group's statistics in shared memory too), 0
    for the conv fed (a, off)."""
    _, h, wd, cin = x.shape
    cout = w.shape[2]
    if (x.dtype == torch.bfloat16 and cin % 8 == 0 and cout % 8 == 0 and min(h, wd) >= 4
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0):
        return "wgmma"
    if x.dtype == torch.float32 and cout <= 8 and cin % 4 == 0 and x.data_ptr() % 16 == 0:
        # two raw 8-channel halo buffers, the activated one, the whole weight
        tw = (wd + 3) // 4 * 4 if wd <= 128 else 128
        halo = (256 // (tw // 4) + 2) * (tw + 2)
        fold = 2 * (cin + groups) if groups else 0
        if (4 * (16 * halo + 8 * (halo | 1) + 9 * cin * (4 if cout <= 4 else 8) + fold)
                <= _SMEM_BYTES):
            return "narrow_f32"
    if (x.dtype == torch.float32 and cin % 4 == 0 and cout % 4 == 0 and cout > 8
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
            and _tiled_positions(h, wd) <= _TILED_POSITIONS
            and _tiled_smem(h, wd, tiled_tile(h, wd).ni * 2 * (cin + groups) if groups else 0)
            <= _SMEM_BYTES):
        return "tiled_f32"
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


def _launch(x, a, off, w, bias, design=None):
    b, h, wd, cin = x.shape
    cout = w.shape[2]
    design = conv_design(x, w) if design is None else design
    if design not in DESIGNS:
        raise ValueError(f"unknown gn_silu_conv3x3 design {design!r}")
    if design == "tiled_f32":  # its scale and offset in 16-byte loads
        a, off = _aligned(a), _aligned(off)
    out = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    _build.launch("pddm_gn_silu_conv3x3", x.data_ptr(), a.data_ptr(),
                  off.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
                  b, h, wd, cin, cout, int(x.dtype == torch.bfloat16), DESIGNS[design])
    gn_silu_conv3x3.launches += 1
    return out


gn_silu_conv3x3.launches = 0


def gn_silu_conv3x3_fold_plain(x: torch.Tensor, moments: torch.Tensor, ranks: int,
                               gamma: torch.Tensor, beta: torch.Tensor, num_groups: int,
                               eps: float, w: torch.Tensor, bias: torch.Tensor,
                               emb: Optional[torch.Tensor] = None,
                               film: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                               ) -> torch.Tensor:
    """``gn_silu_conv3x3_fold`` in plain torch: the fold (``gn_fold_plain``)
    of the ranks' mean moments ``moments / ranks``, then
    ``gn_silu_conv3x3_plain``."""
    ao = gn_fold_plain(moments / ranks, gamma, beta, num_groups, eps, emb=emb, film=film)
    return gn_silu_conv3x3_plain(x, ao[0], ao[1], w, bias)


def _elements_from(t: torch.Tensor) -> int:
    """The elements of ``t``'s storage from its first one on: what the C
    entry point may read behind its pointer."""
    return t.untyped_storage().nbytes() // t.element_size() - t.storage_offset()


def gn_silu_conv3x3_fold(x: torch.Tensor, moments: torch.Tensor, ranks: int,
                         gamma: torch.Tensor, beta: torch.Tensor, num_groups: int, eps: float,
                         w: torch.Tensor, bias: torch.Tensor, emb: Optional[torch.Tensor] = None,
                         film: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                         ) -> torch.Tensor:
    """The fused conv of a spatially sharded forward's slab, its scale and
    offset folded inside the kernel: ``gn_silu_conv3x3`` of ``x`` (this
    rank's rows and the halo rows, (B, H, W, Cin)) with the (a, off) that
    ``gn_fold`` gives for the ranks' mean moments, ``moments`` (2, B, Cin)
    float32 being their sum over ``ranks`` ranks (``gn_moments_slab``).
    GroupNorm's gamma/beta and groups, and emb or the FiLM pair, as
    ``gn_affine`` takes them.  Each block folds its images' group statistics
    (whole groups, whatever channels its slices cut), then each slice's
    scale and offset, with ``gn_fold_kernel``'s arithmetic; the design is
    ``conv_design``'s.  A CPU tensor takes the plain version; a CUDA tensor
    one launch or raises.  Forward only: raises where autograd would record
    it."""
    if x.device.type == "cpu":
        return gn_silu_conv3x3_fold_plain(x, moments, ranks, gamma, beta, num_groups, eps, w,
                                          bias, emb=emb, film=film)
    b, h, wd, cin = _check_conv("gn_silu_conv3x3_fold", x, w, bias)
    conds = (emb,) if emb is not None else tuple(film or ())
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, moments, gamma, beta, w, bias, *conds)):
        raise ValueError("gn_silu_conv3x3_fold is forward only (a spatially sharded forward)")
    gamma, beta, mode, conds = kernel_args(x, gamma, beta, num_groups, emb, film)
    moments = _float32_on(moments, x.device)
    if moments.shape != (2, b, cin) or ranks < 1:
        raise ValueError(f"gn_silu_conv3x3_fold takes (2, {b}, {cin}) moments summed over "
                         f"ranks >= 1, got {tuple(moments.shape)} over {ranks}")
    w = _weight_in(w, x)
    bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    cout = w.shape[2]
    out = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    ptr0, ptr1, *rest = _cond_args(**_named(mode, conds))
    lens = [_elements_from(t) for t in conds] + [0, 0]
    _build.launch("pddm_gn_silu_conv3x3_fold", x.data_ptr(), moments.data_ptr(),
                  gamma.data_ptr(), beta.data_ptr(), ptr0, ptr1, w.data_ptr(), bias.data_ptr(),
                  out.data_ptr(), moments.numel(), lens[0], lens[1], b, h, wd, cin, cout,
                  num_groups, int(ranks), float(eps), *rest, int(x.dtype == torch.bfloat16),
                  DESIGNS[conv_design(x, w, num_groups)])
    gn_silu_conv3x3_fold.launches += 1
    return out


gn_silu_conv3x3_fold.launches = 0


# ----------------------------------------------------------------- gradient

# the C entry point's design argument; "recompute" (autograd through
# _grad_reference) is no kernel and runs only by name, for measurement, as
# do "wgmma_taprow" and "wgmma_sync_epilogue"
GRAD_DESIGNS = {"general": 0, "wgmma": 1, "narrow_f32": 2, "wgmma_taprow": 3,
                "wgmma_sync_epilogue": 4, "tiled_f32": 5}
_GENERAL_PX = 64    # pixels of a general dgrad tile, of a general wgrad chunk
_DGRAD_STAGES = 6   # wgmma_sync_epilogue's (and wgmma_taprow's) dgrad weight ring
_PP_STAGES = (16, 3)  # the ping-pong dgrad's weight ring: most stages, fewest
_PP_HALOS = 4  # the ping-pong dgrad's g halo buffers
_WGRAD_PX = 128     # pixels of a wgmma wgrad tile (8 k-steps of 16)
_WGRAD_WS_BYTES = 16 << 20  # wgmma_taprow's partials of dw, at most
_WGRAD9_WS_BYTES = 32 << 20  # wgrad9's partials of dw, at most (unless one split's are more)
_WGRAD9_SPLITS = 64
_WGRAD9_STAGES = 4  # wgrad9's ring of h halo and g tiles, at most
_NARROW_PIXELS = 1024  # pixels of a narrow_f32 tile, at most
_NARROW_THREADS = 256


class ConvTile(NamedTuple):
    """A pixel tiling as ``set_tile`` in ``csrc/gn_conv.cu`` and
    ``csrc/gn_conv_grad.cu`` makes it: ``ni`` whole images, or ``th`` rows
    of ``tw`` columns of one image; tile k lies at
    (k // (tiles_y * tiles_x) * ni, row k // tiles_x % tiles_y * th, column
    k % tiles_x * tw)."""
    ni: int
    th: int
    tw: int
    tiles_y: int
    tiles_x: int

    def count(self, b: int) -> int:
        return -(-b // self.ni) * self.tiles_y * self.tiles_x

    def pixels(self, b: int, h: int, w: int, k: int) -> List[Tuple[int, int, int, int]]:
        """(row p of the tile, image, y, x) of tile k's pixels inside the
        batch and the image, in the tile's row order."""
        b0 = k // (self.tiles_y * self.tiles_x) * self.ni
        y0 = k // self.tiles_x % self.tiles_y * self.th
        x0 = k % self.tiles_x * self.tw
        out = []
        for p in range(self.ni * self.th * self.tw):
            i, r, c = p // (self.th * self.tw), p // self.tw % self.th, p % self.tw
            if b0 + i < b and y0 + r < h and x0 + c < w:
                out.append((p, b0 + i, y0 + r, x0 + c))
        return out


def conv_tile(h: int, w: int, pixels: int) -> ConvTile:
    """Tiles of ``pixels`` output pixels: whole images, whole rows of one
    image or a segment of one row."""
    if h * w <= pixels:
        ni, th, tw = pixels // (h * w), h, w
    elif w <= pixels:
        ni, th, tw = 1, pixels // w, w
    else:
        ni, th, tw = 1, 1, pixels
    return ConvTile(ni, th, tw, -(-h // th), -(-w // tw))


class GradPlan(NamedTuple):
    """How ``gn_silu_conv3x3_grad``'s kernels cut one call.  ``dgrad``: the
    tiles of the input product, each writing one partial of the scale's and
    offset's gradients per (image of the tile, channel); ``nwg``, ``bn``:
    the tensor-core dgrad's tile in rows of 64 pixels (the m-tiles of each
    consumer warpgroup in ``wgmma``, the warpgroups sharing a tile in
    ``wgmma_sync_epilogue`` and ``wgmma_taprow``) and its channels a block
    (0 in ``general``, ``tiled_f32`` and ``narrow_f32``); ``wgrad``: the
    tensor-core weight product's tiles, or ``narrow_f32``'s (its one launch
    does both products), None for ``general``'s chunks of 64 flattened
    pixels (``tiled_f32``'s weight product is ``general``'s);
    ``splits``: the weight product's blocks along the pixels, block z taking
    tiles (chunks) z, z + splits, ... (``narrow_f32``: one a tile)."""
    design: str
    dgrad: ConvTile
    nwg: int
    bn: int
    wgrad: Optional[ConvTile]
    splits: int

    def workspace(self, b: int, cin: int, cout: int) -> Tuple[int, int, int]:
        """float32 elements of the three workspaces: the per-tile partials of
        (da, doff), the per-split partials of dw and of dbias (wgmma_taprow: one
        for each of a split's 3 x ceil(Cin / 64) weight-product blocks of a
        Cout slice, each adding its share of the rows)."""
        parts = 3 * -(-cin // 64) if self.design == "wgmma_taprow" else 1
        return (self.dgrad.count(b) * self.dgrad.ni * 2 * cin, self.splits * 9 * cout * cin,
                self.splits * parts * cout)

    def activation(self, b: int, h: int, w: int, cin: int, want_w: bool = True) -> int:
        """bf16 elements of the activation buffer that the dgrad of ``wgmma``
        or ``wgmma_sync_epilogue`` (or their elementwise launch) fills and
        their weight product reads: all of x's, where the weight product
        runs; none in the other designs."""
        return b * h * w * cin if self.design in _WGRAD9_PAIRS and want_w else 0

    def dgrad_slots(self, b: int) -> List[List[Tuple[int, int]]]:
        """For each sample, the (tile, image of the tile) partials that the
        last launch adds for its da and doff, in the order it adds them."""
        per = self.dgrad.tiles_y * self.dgrad.tiles_x
        ni = self.dgrad.ni
        return [[(s // ni * per + t, s % ni) for t in range(per)] for s in range(b)]

    def wgrad_units(self, b: int, h: int, w: int) -> List[List[int]]:
        """For each split, the tiles (wgmma, narrow_f32) or 64-pixel chunks
        (general) whose products it adds, in order; the finish adds the
        splits' partials in the order of the list."""
        n = self.wgrad.count(b) if self.wgrad else -(-b * h * w // _GENERAL_PX)
        return [list(range(z, n, self.splits)) for z in range(self.splits)]

    def weight_blocks(self, cin: int,
                      cout: int) -> List[Tuple[int, int, int, Tuple[int, ...], bool]]:
        """The weight product's blocks as the grid numbers them: (split,
        first Cin channel, first Cout channel, taps, adds dbias).  wgmma and
        wgmma_sync_epilogue (wgrad9): a
        block a (split, 64 Cin, 64 Cout), its three warpgroups taps 0-2, 3-5
        and 6-8, the blocks of Cin slice 0 adding dbias; wgmma_taprow: a block a
        tap row as well, every block a share of dbias; general: a block a
        tap, 64 Cin x 64 Cout (16 for Cout <= 16), and tiled_f32 as general;
        narrow_f32: a block a tile, every channel and tap."""
        if self.design == "narrow_f32":
            return [(z, 0, 0, tuple(range(9)), True) for z in range(self.splits)]
        if self.design in ("general", "tiled_f32"):
            bco = 16 if cout <= 16 else 64
            return [(z, ci, co, (tap,), ci == 0 and tap == 0) for z in range(self.splits)
                    for tap in range(9) for co in range(0, cout, bco)
                    for ci in range(0, cin, 64)]
        rows = ((0, 1, 2, 3, 4, 5, 6, 7, 8),) if self.design in _WGRAD9_PAIRS else (
            (0, 1, 2), (3, 4, 5), (6, 7, 8))
        return [(z, ci, co, taps, ci == 0 or self.design == "wgmma_taprow")
                for z in range(self.splits) for taps in rows for co in range(0, cout, 64)
                for ci in range(0, cin, 64)]


_WGRAD9_PAIRS = ("wgmma", "wgmma_sync_epilogue")  # the designs whose weight product is wgrad9


def _dgrad_smem(h: int, w: int, nwg: int, bn: int) -> int:
    """Shared memory of wgmma_sync_epilogue's (and wgmma_taprow's) dgrad
    (``DLayout`` in gn_conv_grad.cu)."""
    t = conv_tile(h, w, 64 * nwg)
    halo = -(-t.ni * (t.th + 2) * (t.tw + 2) * 128 // 1024) * 1024
    return (1024 + _DGRAD_STAGES * bn * 128 + 2 * halo + nwg * 4 * 16 * (bn + 8) * 2
            + nwg * 4 * 2 * bn * 4 + (2 * _DGRAD_STAGES + 4) * 8)


def _pingpong_smem(h: int, w: int, mt: int, bn: int, stages: int) -> int:
    """Shared memory of wgmma's ping-pong dgrad (``PLayout`` in
    gn_conv_grad.cu): ``stages`` weight tiles of 64 Cout x ``bn`` Cin, four g
    halo buffers of a tile of 64 ``mt`` pixels, two x tiles (one a consumer
    warpgroup, over which h and dx are staged), the partial sums of
    (warpgroup, m-tile, warp), each warpgroup's scale and offset of its
    tile's images, the mbarriers (a full barrier of each stage
    and halo buffer for each consumer warpgroup, one empty barrier of each,
    the x tiles'), the 1,024-byte alignment."""
    t = conv_tile(h, w, 64 * mt)
    halo = -(-t.ni * (t.th + 2) * (t.tw + 2) * 128 // 1024) * 1024
    return (1024 + stages * bn * 128 + _PP_HALOS * halo + 2 * (bn // 64) * mt * 64 * 128
            + 2 * mt * 4 * 2 * bn * 4 + 2 * t.ni * 2 * bn * 4
            + (3 * _PP_STAGES[0] + 3 * _PP_HALOS + 4) * 8)


@functools.lru_cache(maxsize=None)
def _pingpong_stages(h: int, w: int, mt: int, bn: int) -> int:
    """The ping-pong dgrad's weight ring: as many stages as fit, at most 16;
    0 where 3 do not (``pingpong_stages``)."""
    most, fewest = _PP_STAGES
    return next((s for s in range(most, fewest - 1, -1)
                 if _pingpong_smem(h, w, mt, bn, s) <= _SMEM_BYTES), 0)


def _wgrad_smem(h: int, w: int) -> int:
    """Shared memory of wgmma_taprow's wgrad (``WGLayout`` in gn_conv_grad.cu):
    three stages of the x halo, the g tile, the scale and offset, two
    mbarriers; the dbias partials."""
    t = conv_tile(h, w, _WGRAD_PX)
    halo = -(-t.ni * (t.th + 2) * (t.tw + 2) * 128 // 1024) * 1024
    return 1024 + 3 * (halo + _WGRAD_PX * 128 + t.ni * 2 * 64 * 4 + 2 * 8) + 7 * 64 * 4


def _wgrad9_smem(h: int, w: int, stages: int) -> int:
    """Shared memory of wgrad9 (``W9Layout`` in gn_conv_grad.cu): ``stages``
    h halo buffers and g tiles, the dbias partials of 16 row phases, the
    mbarriers."""
    t = conv_tile(h, w, _WGRAD_PX)
    halo = -(-t.ni * (t.th + 2) * (t.tw + 2) * 128 // 1024) * 1024
    return 1024 + stages * (halo + _WGRAD_PX * 128) + 16 * 64 * 4 + 2 * _WGRAD9_STAGES * 8


def _wgrad9_stages(h: int, w: int) -> int:
    """wgrad9's ring: as many stages as fit, at most 4; 0 where 2 do not
    (``wgrad9_stages``)."""
    return next((s for s in range(_WGRAD9_STAGES, 1, -1) if _wgrad9_smem(h, w, s) <= _SMEM_BYTES),
                0)


def _narrow_run(cout: int) -> int:
    """Channels a thread of narrow_f32 owns: its 9 Cout x run partials of dw
    stay in registers (``narrow_run``)."""
    return 2 if cout <= 6 else 1


def _narrow_tile(h: int, w: int) -> ConvTile:
    """narrow_f32's tiles: whole rows of one image, 1,024 pixels at most
    (``set_narrow_tile``)."""
    th = 1 if w >= _NARROW_PIXELS else min(h, _NARROW_PIXELS // w)
    return ConvTile(1, th, w, -(-h // th), 1)


def _narrow_grad_smem(h: int, w: int, cin: int, cout: int) -> int:
    """Shared memory of narrow_f32 (``narrow_grad_smem``): the g halo and the
    whole weight, then over them the threads' partials of dw, of (da, doff)
    and of dbias."""
    t = _narrow_tile(h, w)
    groups = _NARROW_THREADS // (cin // _narrow_run(cout))
    first = -(-(t.th + 2) * (w + 2) * cout // 4) * 4 + 9 * cout * cin
    return 4 * max(first, groups * (9 * cout + 2) * cin + groups * cout)


def _dgrad_config(b, h, w, cin):
    """(consumer warpgroups, channels a block) of the wgmma dgrad: as the
    forward picks them, two warpgroups and 128 channels where the tiles give
    most of a wave and fit shared memory, narrower blocks for the small
    sites; None where nothing fits."""
    m128 = conv_tile(h, w, 128).count(b)
    for nwg, bn, ok in ((2, 128, cin > 64 and m128 * -(-cin // 128) >= 128),
                        (2, 64, m128 * -(-cin // 64) >= 128), (1, 64, True)):
        if ok and _dgrad_smem(h, w, nwg, bn) <= _SMEM_BYTES:
            return nwg, bn
    return None


@functools.lru_cache(maxsize=None)
def _pingpong_config(b, h, w, cin):
    """(m-tiles of 64 pixels a consumer warpgroup, channels a block) of
    wgmma's ping-pong dgrad: 64 pixels x 128 channels where Cin is wider
    than 64, or 128 x 64, the first whose tiles give at least two a block on
    128 SMs (so one tile's epilogue has another's products to run under),
    else 64 x 64; None where no ring of 3 stages fits.  (128 x 128 would
    hold 128 accumulators a thread, which serialised the products.)"""
    fits = [(mt, bn) for mt, bn in ((1, 128), (2, 64), (1, 64))
            if (bn == 64 or cin > 64) and _pingpong_stages(h, w, mt, bn)]
    for mt, bn in fits:
        if conv_tile(h, w, 64 * mt).count(b) * -(-cin // bn) >= 256:
            return mt, bn
    return fits[-1] if fits else None


def _fewest_waves(base: int, most: int, sms: int) -> int:
    """Splits of ``base`` blocks each, at most ``most``, whose blocks fill
    ``sms`` SMs in the fewest waves for the work (one block an SM); ties to
    fewer splits."""
    return min(range(1, most + 1), key=lambda s: (-(-s * base // sms) / s, s))


def grad_plan(b: int, h: int, w: int, cin: int, cout: int, design: str, sms: int) -> GradPlan:
    """The tiles and the split of a ``gn_silu_conv3x3_grad`` call in design
    ``wgmma``, ``wgmma_sync_epilogue``, ``wgmma_taprow``, ``narrow_f32``,
    ``tiled_f32`` or ``general`` on a card of ``sms`` SMs.  The weight
    product's split fills the SMs in the fewest waves for its work (wgrad9:
    a block of 512 threads an SM, at most 64
    splits whose partials of dw take at most 32 MB unless one split is
    larger; wgmma_taprow: 512 threads, at most 16 splits, 16 MB) or about four
    times (general, and tiled_f32's weight product, which is general's),
    with no more splits than tiles; narrow_f32 has a split a tile.
    tiled_f32's input product has ``tiled_tile``'s tiles (the input channels
    a cluster splits are added inside the kernel: one partial a tile still).
    The C entry point refuses workspaces smaller than its own tiling fills,
    so a plan that drifts from it raises."""
    if design in ("wgmma", "wgmma_sync_epilogue", "wgmma_taprow"):
        config = (_pingpong_config if design == "wgmma" else _dgrad_config)(b, h, w, cin)
        if config is None:
            raise ValueError(f"gn_silu_conv3x3_grad design {design!r}: no dgrad tile of "
                             f"{h}x{w} fits shared memory")
        nwg, bn = config
        tile = conv_tile(h, w, _WGRAD_PX)
        base = -(-cin // 64) * -(-cout // 64)
        if design in _WGRAD9_PAIRS:
            cap, ws = _WGRAD9_SPLITS, _WGRAD9_WS_BYTES
        else:
            base, cap, ws = 3 * base, 16, _WGRAD_WS_BYTES
        most = max(1, min(tile.count(b), cap, ws // (9 * cin * cout * 4)))
        return GradPlan(design, conv_tile(h, w, 64 * nwg), nwg, bn, tile,
                        _fewest_waves(base, most, sms))
    if design == "narrow_f32":
        tile = _narrow_tile(h, w)
        return GradPlan(design, tile, 0, 0, tile, tile.count(b))
    chunks = -(-b * h * w // _GENERAL_PX)
    base = -(-cin // 64) * -(-cout // (16 if cout <= 16 else 64)) * 9
    tile = tiled_tile(h, w) if design == "tiled_f32" else conv_tile(h, w, _GENERAL_PX)
    return GradPlan("tiled_f32" if design == "tiled_f32" else "general", tile, 0, 0, None,
                    max(1, min(chunks, -(-4 * sms // base))))


def conv_grad_design(x: torch.Tensor, w: torch.Tensor) -> str:
    """The design of ``gn_silu_conv3x3_grad`` for ``x`` (B, H, W, Cin) and
    ``w`` (3, 3, Cout, Cin) in the kernel's dtype: ``wgmma`` for bf16 with
    channels in multiples of 8, images of at least 4x4 whose pixel count is
    over 64 or a multiple of 16 (no warp's 16 rows straddle two images),
    16-byte aligned operands and tiles that fit shared memory;
    ``narrow_f32`` for float32 with Cout <= 8 and Cin % 4 == 0 (the output
    head), rows of at most 1,024 pixels and 16-byte aligned operands, where
    its tile fits shared memory; ``tiled_f32`` for float32 with Cin and Cout
    multiples of 4, Cout > 8 and 16-byte aligned operands, where its tile
    fits (the forward's rule); ``general`` otherwise.
    ``wgmma_sync_epilogue``, ``wgmma_taprow`` and ``recompute`` run by name
    only."""
    b, h, wd, cin = x.shape
    cout = w.shape[2]
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    if (x.dtype == torch.bfloat16 and cin % 8 == 0 and cout % 8 == 0 and min(h, wd) >= 4
            and (h * wd > 64 or h * wd % 16 == 0) and aligned
            and _pingpong_config(b, h, wd, cin) is not None and _wgrad9_stages(h, wd)):
        return "wgmma"
    if (x.dtype == torch.float32 and cout <= 8 and cin % 4 == 0
            and cin // _narrow_run(cout) <= _NARROW_THREADS and wd <= _NARROW_PIXELS and aligned
            and _narrow_grad_smem(h, wd, cin, cout) <= _SMEM_BYTES):
        return "narrow_f32"
    if (x.dtype == torch.float32 and cin % 4 == 0 and cout % 4 == 0 and cout > 8 and aligned
            and _tiled_positions(h, wd) <= _TILED_POSITIONS
            and _tiled_smem(h, wd) <= _SMEM_BYTES):
        return "tiled_f32"
    return "general"


def gn_silu_conv3x3_grad_plain(x: torch.Tensor, a: torch.Tensor, off: torch.Tensor,
                               w: torch.Tensor, g: torch.Tensor, needs=None):
    """The gradients (dx, da, doff, dw, dbias) of ``_grad_reference`` for
    the output gradient ``g``, written out: the conv's input gradient dh as
    the sum over taps of the shifted g times the tap's weight (accumulated
    in float32, rounded to x's dtype as the conv's input gradient is), the
    activation's backward dp = dh s (1 + p (1 - s)), dx = dp a in x's dtype,
    da and doff the sums of dp x and dp over the sample's pixels, dw[tap] the
    sum over pixels of g times the activation shifted by the tap (zero
    outside the image after the activation) in w's dtype, dbias the sum of g,
    float32.  ``needs`` masks the five (None where one is not wanted)."""
    needs = (True,) * 5 if needs is None else tuple(needs)
    b, h, wd, cin = x.shape
    taps = [(dy, dx) for dy in range(3) for dx in range(3)]
    xf = x.float()
    p = xf * a.float()[:, None, None, :] + off.float()[:, None, None, :]
    s = torch.sigmoid(p)
    gf = g.to(x.dtype).float()
    out = [None] * 5
    if any(needs[:3]):
        wf = w.to(x.dtype).float()
        gp = F.pad(gf, (0, 0, 1, 1, 1, 1))
        dh = sum(gp[:, 2 - dy:2 - dy + h, 2 - dx:2 - dx + wd] @ wf[dy, dx] for dy, dx in taps)
        dp = dh.to(x.dtype).float() * s * (1 + p * (1 - s))
        out[:3] = [(dp * a.float()[:, None, None, :]).to(x.dtype), (dp * xf).sum((1, 2)),
                   dp.sum((1, 2))]
    if needs[3]:
        hp = F.pad((p * s).to(x.dtype).float(), (0, 0, 1, 1, 1, 1))
        dw = torch.stack([torch.einsum("bhwo,bhwi->oi", gf, hp[:, dy:dy + h, dx:dx + wd])
                          for dy, dx in taps])
        out[3] = dw.reshape(3, 3, -1, cin).to(w.dtype)
    if needs[4]:
        out[4] = gf.sum((0, 1, 2))
    return tuple(t if need else None for t, need in zip(out, needs))


def _recompute(x, a, off, w, g, needs):
    """The first design, by name only: autograd through ``_grad_reference``
    recomputed from the inputs (about 40 device operations a call)."""
    bias = torch.zeros(w.shape[2], dtype=torch.float32, device=x.device)
    leaves = [t.detach().requires_grad_(n) for t, n in zip((x, a, off, w, bias), needs)]
    with torch.enable_grad():
        out = _grad_reference(*leaves)
    grads = iter(torch.autograd.grad(out, [t for t in leaves if t.requires_grad], g))
    return [next(grads) if n else None for n in needs]


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address, as the kernels read it."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _launch_grad(x, a, off, w, g, needs, design, act=None):
    """The kernels of ``design`` on one call; ``act``: the activation buffer
    (a new one where None), for a test that reads it."""
    b, h, wd, cin = x.shape
    cout = w.shape[2]
    want_d, want_w = any(needs[:3]), any(needs[3:])
    plan = grad_plan(b, h, wd, cin, cout, design, _sm_count(x.device))
    g, a, off = _aligned(g.to(x.dtype)), _aligned(a), _aligned(off)
    f32 = dict(dtype=torch.float32, device=x.device)
    n_a, n_w, n_b = plan.workspace(b, cin, cout)
    n_h = plan.activation(b, h, wd, cin, want_w)
    out = [torch.empty_like(x), torch.empty(b, cin, **f32), torch.empty(b, cin, **f32)]
    out = (out if want_d else [None] * 3) + ([torch.empty_like(w), torch.empty(cout, **f32)]
                                            if want_w else [None] * 2)
    # transient: the partials the finish adds, and the activation between
    # wgmma's input and weight products
    ws = [torch.empty(n_a, **f32) if want_d else None, torch.empty(n_w, **f32) if want_w else None,
          torch.empty(n_b, **f32) if want_w else None,
          act if act is not None else torch.empty(n_h, dtype=x.dtype, device=x.device)
          if n_h else None]
    try:
        _build.launch("pddm_gn_silu_conv3x3_grad", x.data_ptr(), a.data_ptr(), off.data_ptr(),
                      w.data_ptr(), g.data_ptr(),
                      *(0 if t is None else t.data_ptr() for t in (*out, *ws)),
                      *(0 if t is None else t.numel() for t in ws), b, h, wd, cin, cout,
                      int(x.dtype == torch.bfloat16), GRAD_DESIGNS[design], int(want_d),
                      int(want_w), plan.nwg, plan.bn, plan.splits)
    except RuntimeError as err:
        raise RuntimeError(f"{err} (x {tuple(x.shape)} {x.dtype}, Cout {cout}, {plan})") from err
    return out


def gn_silu_conv3x3_grad(x: torch.Tensor, a: torch.Tensor, off: torch.Tensor, w: torch.Tensor,
                         g: torch.Tensor, needs=None, design: Optional[str] = None):
    """(dx, da, doff, dw, dbias) of ``gn_silu_conv3x3`` for the output
    gradient ``g``, from the inputs as the op hands them to its kernel (a,
    off float32; w in x's dtype).  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernels of ``design`` (None: ``conv_grad_design``'s
    choice; ``wgmma``, ``wgmma_sync_epilogue``, ``wgmma_taprow``,
    ``narrow_f32``, ``tiled_f32``, ``general`` or
    ``recompute`` by name, for measurement) or raises.  ``needs`` (x, a,
    off, w, bias) masks the gradients wanted (None where one is not): no
    input product where none of x, a, off needs one, no weight product
    where neither w nor bias does.  dx in x's dtype, dw in w's, the rest
    float32."""
    needs = (True,) * 5 if needs is None else tuple(needs)
    if x.device.type == "cpu":
        return gn_silu_conv3x3_grad_plain(x, a, off, w, g, needs)
    design = conv_grad_design(x, w) if design is None else design
    if design == "recompute":
        # plain PyTorch, no kernel of this op: the count stays
        grads = _recompute(x, a, off, w, g, needs)
    elif design in GRAD_DESIGNS:
        grads = _launch_grad(x, a, off, w, g, needs, design)
        gn_silu_conv3x3_grad.launches += 1
    else:
        raise ValueError(f"unknown gn_silu_conv3x3_grad design {design!r}")
    return tuple(t if need else None for t, need in zip(grads, needs))


gn_silu_conv3x3_grad.launches = 0


class _GnSiluConv(torch.autograd.Function):
    """``gn_silu_conv3x3`` with its gradient from ``gn_silu_conv3x3_grad``:
    both directions are kernels on the card, and autograd keeps x, a, off, w
    and bias, no activation.  On CPU tensors (the tests) the plain versions
    stand in for both."""

    @staticmethod
    def forward(ctx, x, a, off, w, bias, design=None):
        ctx.save_for_backward(x, a, off, w, bias)
        if x.device.type == "cpu":
            return gn_silu_conv3x3_plain(x, a, off, w, bias)
        return _launch(x, a, off, w, bias, design)

    @staticmethod
    def backward(ctx, g):
        x, a, off, w, bias = ctx.saved_tensors
        dx, da, doff, dw, dbias = gn_silu_conv3x3_grad(x, a, off, w, g,
                                                       needs=ctx.needs_input_grad[:5])
        return dx, da, doff, dw, None if dbias is None else dbias.to(bias.dtype), None
