"""GroupNorm (+ optional SiLU): plain torch version and the CUDA kernels.

Semantics of ``group_norm_silu_xla`` / ``group_norm_silu_pallas`` in
``probabilisticdeepdiffusionmodels_tpu/ops/groupnorm_pallas.py``: statistics
in float32 over (spatial, channels-of-group), eps inside the rsqrt, affine,
optional SiLU, output in the input dtype.

Kernels (``csrc/groupnorm.cu``) -- replace ``group_norm_silu_pallas`` /
``_gn_kernel`` and the statistics pass of ``gn_affine`` in
``ops/gn_conv_pallas.py``.  Bound by bytes on the H100, so every access is
as wide as the shape allows (16 bytes a thread: 8 bf16 or 4 float32
channels, narrower where C or the address is not a multiple of that).  The
work is three parts:

- *moments*: per-(sample, channel) float32 sum and sum of squares, x read
  once.
- *fold*: the (B, C)-sized rest, in the tail of the same launch: channels to
  groups, ``rsqrt(var + eps)``, gamma/beta and (for ``gn_affine``) the
  timestep-embedding add or the FiLM pair folded into a scale ``a`` and an
  offset ``off`` with ``normalized = x * a + off``.  ``moments_fold`` is that
  one launch; ``ops.gn_conv.gn_affine`` is built on it.
- *apply*: ``y = x * a + off`` (+ SiLU), stored in the input dtype.

``affine_design`` picks one of two designs for ``moments_fold``:

- ``cluster`` (``affine_plan``): chunks of whole groups, about two blocks an
  SM; a block over all rows of its chunk folds its own groups (every site of
  the CIFAR-10 UNet at batch 128, the small ones now several blocks a
  sample), and where a chunk of a sample is long and the batch small its
  rows are split over at most 8 blocks launched as one thread-block cluster,
  whose blocks read each other's partial sums in distributed shared memory
  and fold a slice of whole groups each.
- ``workspace`` (``moments_plan``, the first design): N split over blocks
  whose partial sums meet in a global workspace, added in split order by the
  sample's last block (a counter per sample); kept where a sample needs more
  blocks than a cluster holds (256x256) and, by name, for measurement.

Neither adds floats with atomics, so two runs give the same bits.

The fold also has an entry of its own (``gn_fold``: one block a sample, from
the (2, B, C) moments E[x], E[x^2] to the same (4, B, C) output as
``moments_fold``).  A spatially sharded forward uses it: each rank's
moments over its rows are averaged over the ranks and folded, so the
normalisation uses whole-image statistics (``group_norm_silu_slab``,
``gn_conv.gn_affine_slab``).

``gn_affine``'s gradient runs the same parts backwards.  ``affine_backward``
(design ``fused_bwd``, ``grad_plan``): one launch in which each block
recomputes the fold's backward for its chunk of whole groups and writes
dL/dx, the conditioning's gradient and each sample's shares of dL/dgamma
and dL/dbeta, then one launch that adds the shares over the batch in a fixed
order; ``fold_backward_plain`` is its arithmetic in plain torch.  The first
design, ``fold_backward`` (one small launch from the gradients of ``a`` and
``off`` to dL/dS1 and dL/dS2 per (sample, channel)) then ``apply_affine``
for dL/dx = 2 x dL/dS2 + dL/dS1, stays for groups wider than a block.

``groupnorm_design`` picks one of two designs for ``group_norm_silu``:

- ``fused`` (short inputs: a chunk of whole groups over all rows of a sample
  is at most 48 KB, as at the UNet's attention norms): one launch; a block
  owns its groups, folds them itself and reads its rows again from L1/L2.
- ``split`` (long inputs, 64x64 and up): ``moments_fold``, then the apply
  kernel, each with enough blocks to fill the card.

``moments_plan`` / ``fused_plan`` compute the launch geometry here, where the
CPU tests reach it; the C side checks it and launches.  Everything is CUDA
C++ like the other kernels, so the port builds from one toolchain.

Backward: no Pallas kernel has a backward kernel, so this op has none
either.  As ``_gns_bwd`` in ``groupnorm_pallas.py`` does, the gradient is
that of the plain version, recomputed from the saved inputs
(``autograd.kernel_op``).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build
from .autograd import kernel_op

__all__ = ["group_norm_silu", "group_norm_silu_plain", "groupnorm_design", "moments_plan",
           "fused_plan", "affine_plan", "grad_plan", "affine_design", "moments_fold",
           "fold_backward", "fold_backward_plain", "affine_backward", "apply_affine", "gn_fold",
           "gn_fold_plain", "moments_plain", "group_norm_silu_slab",
           "group_norm_silu_slab_plain"]

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_NT = 256                  # threads of a block (csrc/groupnorm.cu)
_FILL = 4 * 132            # blocks that keep the H100's 132 SMs busy
_SPLIT_BYTES = 64 * 1024   # the least of x that one block of a split sample reads
_FUSED_ROW_BYTES = 128     # fused design: the least bytes of a row one block takes
_FUSED_BYTES = 48 * 1024   # fused design: the most of x one block takes (stays in L1)
_MAX_CHANNELS = 8192       # the fold's backward keeps five floats a channel in shared memory
_CLUSTER_MAX = 8           # blocks of a portable thread-block cluster (kClusterMax)
_CHUNK_ROW_BYTES = 64      # cluster design: the least bytes of a row one block takes
_CHUNK_FILL = 2 * 132      # cluster design: blocks wanted (two an SM measured best)
# where the blocks of a sample meet (csrc/groupnorm.cu kLocal, kCluster, kWorkspace)
_FOLDS = {"local": 0, "cluster": 1, "workspace": 2}


class Plan(NamedTuple):
    """Launch geometry of the moments and apply kernels."""
    v: int       # channels a thread loads at once
    cvb: int     # channel vectors (threads along the channels) of a block
    splits: int  # blocks along N of one sample
    rows: int    # rows of one block
    # where a sample's blocks meet: "local" (a block folds its own chunk of
    # whole groups), "cluster" (a sample's splits are one cluster) or
    # "workspace" (a global workspace, the sample's last block folds)
    fold: str = "local"

    def chunks(self, c: int) -> int:
        """Blocks along the channels."""
        return -(-(c // self.v) // self.cvb)


def _low_bits(addresses) -> int:
    """The low four bits any of the addresses has set: what their common
    alignment up to 16 bytes depends on."""
    low = 0
    for a in addresses:
        low |= a
    return low & 15


def _vector(c: int, itemsize: int, low: int) -> int:
    """The widest vector (up to 16 bytes) that divides C and the addresses."""
    v = 16 // itemsize
    while v > 1 and (c % v or low % (v * itemsize)):
        v //= 2
    return v


def moments_plan(b: int, n: int, c: int, itemsize: int, *addresses: int) -> Plan:
    """Geometry for a (B, N, C) tensor: a block is ``cvb`` vectors wide and
    ``256 // cvb`` rows tall; N is split until about ``_FILL`` blocks run,
    but no block reads less than ``_SPLIT_BYTES`` or fewer rows than it is
    tall (so the 4x4 and 8x8 sites are one block a sample)."""
    return _moments_plan(b, n, c, itemsize, _low_bits(addresses))


@functools.lru_cache(maxsize=1024)
def _moments_plan(b, n, c, itemsize, low):
    v = _vector(c, itemsize, low)
    cv = c // v
    cvb = min(cv, _NT)
    chunks = -(-cv // cvb)
    want = -(-_FILL // (b * chunks))
    splits = max(1, min(want, n * c * itemsize // _SPLIT_BYTES, n // (_NT // cvb)))
    rows = -(-n // splits)
    splits = -(-n // rows)
    return Plan(v, cvb, splits, rows, "local" if splits == 1 and chunks == 1 else "workspace")


def _chunking(b, n, c, groups, itemsize, low):
    """(v, cvb, splits) with chunks of whole groups: a chunk is a power of
    two times the least whole number of groups and vectors, at least
    ``_CHUNK_ROW_BYTES`` of a row and as many vectors as keep the block's
    256 threads on rows (256 / N), and the chunks are about ``_CHUNK_FILL``
    / B; a chunk of a sample is split along N where it still leaves the card
    short of blocks and is long.  None where one group is wider than a
    block."""
    v = _vector(c, itemsize, low)
    cv = c // v
    unit = math.lcm(c // groups, v) // v
    if unit > _NT:
        return None
    least = max(-(-_CHUNK_ROW_BYTES // (v * itemsize)), -(-_NT // n))
    want = -(-_CHUNK_FILL // b)
    cvb = unit
    while cvb < cv and 2 * cvb <= _NT and (cvb < least or cvb * want < cv):
        cvb *= 2
    cvb = min(cvb, cv)
    chunks = -(-cv // cvb)
    splits = max(1, min(want // chunks, n * cvb * v * itemsize // _SPLIT_BYTES, n // (_NT // cvb)))
    return v, cvb, splits


def affine_plan(b: int, n: int, c: int, groups: int, itemsize: int, *addresses: int) -> Plan:
    """Geometry of ``moments_fold`` on a (B, N, C) tensor: the design
    ``cluster`` (channel chunks of whole groups; a chunk of a sample split
    over at most ``_CLUSTER_MAX`` blocks is one cluster, folded in
    distributed shared memory; unsplit, its block folds it) or, where a
    sample needs more blocks than a cluster holds or a group is wider than
    a block, ``moments_plan``'s (design ``workspace``)."""
    return _affine_plan(b, n, c, groups, itemsize, _low_bits(addresses))


@functools.lru_cache(maxsize=1024)
def _affine_plan(b, n, c, groups, itemsize, low):
    chunked = _chunking(b, n, c, groups, itemsize, low)
    if chunked is None or chunked[2] > _CLUSTER_MAX:
        return _moments_plan(b, n, c, itemsize, low)
    v, cvb, splits = chunked
    rows = -(-n // splits)
    splits = -(-n // rows)
    return Plan(v, cvb, splits, rows, "cluster" if splits > 1 else "local")


def grad_plan(b: int, n: int, c: int, groups: int, itemsize: int,
              *addresses: int) -> Optional[Plan]:
    """Geometry of the one-launch backward (``affine_backward``, design
    ``fused_bwd``): the chunks of ``affine_plan``'s, N split with no limit
    (the blocks of a sample do not meet); None where a group is wider than
    a block (design ``fold_bwd+apply``)."""
    return _grad_plan(b, n, c, groups, itemsize, _low_bits(addresses))


@functools.lru_cache(maxsize=1024)
def _grad_plan(b, n, c, groups, itemsize, low):
    chunked = _chunking(b, n, c, groups, itemsize, low)
    if chunked is None:
        return None
    v, cvb, splits = chunked
    rows = -(-n // splits)
    return Plan(v, cvb, -(-n // rows), rows)


def fused_plan(n: int, c: int, groups: int, itemsize: int, *addresses: int) -> Optional[Plan]:
    """Geometry of the fused design, or None where it does not apply: a
    block takes all N rows of a chunk of channels that is whole groups and
    whole vectors, at least ``_FUSED_ROW_BYTES`` of a row."""
    return _fused_plan(n, c, groups, itemsize, _low_bits(addresses))


@functools.lru_cache(maxsize=1024)
def _fused_plan(n, c, groups, itemsize, low):
    v = _vector(c, itemsize, low)
    unit = math.lcm(c // groups, v)
    chunk = min(c, unit * max(1, -(-_FUSED_ROW_BYTES // (unit * itemsize))))
    cvb = chunk // v
    if cvb > _NT or n * chunk * itemsize > _FUSED_BYTES:
        return None
    return Plan(v, cvb, 1, n)


def group_norm_silu_plain(x: torch.Tensor, gamma: torch.Tensor,
                          beta: torch.Tensor, num_groups: int = 32,
                          eps: float = 1e-5, silu: bool = True) -> torch.Tensor:
    """x: (B, *spatial, C), channels last; two-pass float32 statistics."""
    b, c = x.shape[0], x.shape[-1]
    g = num_groups
    xf = x.float().reshape(b, -1, g, c // g)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = y * gamma.float() + beta.float()
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


@functools.lru_cache(maxsize=1024)
def _bnc(shape) -> Tuple[int, int, int]:
    return shape[0], math.prod(shape[1:-1]), shape[-1]


def _shape(x: torch.Tensor) -> Tuple[int, int, int]:
    """(B, N, C) of a (B, *spatial, C) tensor; one lookup on the hot path."""
    return _bnc(x.shape)


def groupnorm_design(x: torch.Tensor, num_groups: int = 32) -> str:
    """The design a ``group_norm_silu`` call on CUDA tensor ``x`` runs."""
    _, n, c = _shape(x)
    fused = _fused_plan(n, c, num_groups, x.element_size(), x.data_ptr() & 15)
    return "split" if fused is None else "fused"


def group_norm_silu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    num_groups: int = 32, eps: float = 1e-5,
                    silu: bool = True) -> torch.Tensor:
    """x: (B, *spatial, C), channels last; gamma/beta: (C,).  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernels or raises.
    Differentiable in x, gamma and beta."""
    if x.device.type == "cpu":
        return group_norm_silu_plain(x, gamma, beta, num_groups, eps, silu)
    gamma, beta = check_inputs("group_norm_silu", x, gamma, beta, num_groups)
    return kernel_op(
        lambda x, gamma, beta: _launch(x, gamma, beta, num_groups, eps, silu),
        lambda x, gamma, beta: group_norm_silu_plain(x, gamma, beta, num_groups, eps, silu),
        x, gamma, beta)


def check_inputs(name: str, x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 num_groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raise on what the kernels do not take; gamma and beta on x's device
    in float32 (the casts stay outside the Function, so gradients reach the
    parameters they came from)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{name} kernel takes float32/bfloat16, got {x.dtype}")
    shape = x.shape
    if len(shape) < 2 or not x.is_contiguous() or 0 in shape:
        raise ValueError("x must be a contiguous, non-empty (B, *spatial, C) tensor")
    b, c = shape[0], shape[-1]
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    if c > _MAX_CHANNELS or b > 65535:
        raise ValueError(f"{name} kernel takes at most {_MAX_CHANNELS} channels and a batch "
                         f"of 65535, got {c} and {b}")
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"gamma/beta must be ({c},)")
    return _float32_on(gamma, x.device), _float32_on(beta, x.device)


def _float32_on(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    if t.dtype == torch.float32 and t.device == device and t.is_contiguous():
        return t  # the model's parameters: nothing to do on the hot path
    return t.to(device=device, dtype=torch.float32).contiguous()


_counters = {}  # (device index, stream) -> zeroed int32 counters, one a sample


def _counters_for(x: torch.Tensor, b: int) -> torch.Tensor:
    """The per-sample block counters of the split moments kernel: zero
    between launches (the kernel sets back what it counted), one buffer per
    stream, so launches that share one run one after the other."""
    key = (x.device.index, _build._stream())
    buf = _counters.get(key)
    if buf is None or buf.numel() < b:
        buf = _counters[key] = torch.zeros(max(b, 1024), dtype=torch.int32, device=x.device)
    return buf


def affine_design(x: torch.Tensor, num_groups: int) -> str:
    """The design a ``moments_fold`` (``gn_affine``) call on CUDA tensor
    ``x`` runs: ``cluster`` or, for samples longer than a cluster takes,
    ``workspace``."""
    b, n, c = _shape(x)
    plan = _affine_plan(b, n, c, num_groups, x.element_size(), x.data_ptr() & 15)
    return "workspace" if plan.fold == "workspace" else "cluster"


def moments_fold(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, num_groups: int,
                 eps: float, emb: Optional[torch.Tensor] = None,
                 film: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 design: Optional[str] = None) -> torch.Tensor:
    """One launch: a (4, B, C) float32 tensor of the scale ``a``, the offset
    ``off`` with ``normalized(x [+ emb]) * gamma + beta [FiLM] == x * a + off``,
    and E[x], E[x^2] per (sample, channel), which the backward starts from.
    x is a contiguous CUDA (B, *spatial, C) tensor, gamma/beta float32; emb
    or the FiLM pair are (B, C), float32 or bfloat16 (both of one dtype), with
    unit channel stride (``gn_conv.gn_affine`` checks and converts).
    ``design``: None for ``affine_design``'s choice, or ``cluster`` or
    ``workspace`` by name (a measurement times both on one input)."""
    b, n, c = _shape(x)
    low = x.data_ptr() & 15
    if design == "workspace":
        plan = _moments_plan(b, n, c, x.element_size(), low)
    else:
        plan = _affine_plan(b, n, c, num_groups, x.element_size(), low)
        if design not in (None, "cluster") or (design and plan.fold == "workspace"):
            raise ValueError(f"the gn_affine design {design!r} does not take {tuple(x.shape)}")
    ao = torch.empty((4, b, c), dtype=torch.float32, device=x.device)
    ws = counters = None  # both alive until the launch is queued
    if plan.fold == "workspace":
        counters = _counters_for(x, b)
        ws = torch.empty((b, plan.splits, c, 2), dtype=torch.float32, device=x.device)
    ptr0, ptr1, *rest = _cond_args(emb, film)
    _build.launch("pddm_gn_moments_fold", x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                  ptr0, ptr1, ao.data_ptr(), None if ws is None else ws.data_ptr(),
                  None if counters is None else counters.data_ptr(), b, n, c, num_groups,
                  float(eps), *rest,
                  int(x.dtype == torch.bfloat16), plan.v, plan.cvb, plan.splits, plan.rows,
                  _FOLDS[plan.fold])
    return ao


def _cond_args(emb, film):
    """(pointer 0, pointer 1, mode, row stride 0, row stride 1, is bf16) of
    the conditioning, as the C entry points take them."""
    conds = (emb,) if emb is not None else (film or ())
    mode = 1 if emb is not None else 2 if film is not None else 0
    ptrs = [t.data_ptr() for t in conds] + [None, None]
    strides = [t.stride(0) for t in conds] + [0, 0]
    return (ptrs[0], ptrs[1], mode, strides[0], strides[1],
            int(bool(conds) and conds[0].dtype == torch.bfloat16))


def fold_backward(ao: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, n: int,
                  num_groups: int, eps: float, ga: torch.Tensor, goff: torch.Tensor,
                  emb: Optional[torch.Tensor] = None,
                  film: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """One launch: the (6, B, C) float32 gradients behind ``moments_fold``'s
    ``ao`` (over ``n`` rows a sample) for the gradients ``ga``, ``goff`` of its
    scale and offset: rows 0-1 are (2 dL/dS2, dL/dS1), so ``apply_affine(x,
    g)`` is dL/dx; rows 2-3 each sample's share of dL/dgamma and dL/dbeta;
    rows 4-5 dL/d(emb), or dL/d(FiLM scale) and dL/d(FiLM shift)."""
    _, b, c = ao.shape
    g = torch.empty((6, b, c), dtype=torch.float32, device=ao.device)
    ga = _float32_on(ga, ao.device)
    goff = _float32_on(goff, ao.device)
    ptr0, ptr1, *rest = _cond_args(emb, film)
    _build.launch("pddm_gn_fold_bwd", ao.data_ptr(), gamma.data_ptr(), beta.data_ptr(), ptr0,
                  ptr1, ga.data_ptr(), goff.data_ptr(), g.data_ptr(), b, n, c, num_groups,
                  float(eps), *rest)
    return g


def fold_backward_plain(ao: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, n: int,
                        num_groups: int, eps: float, ga: torch.Tensor, goff: torch.Tensor,
                        emb: Optional[torch.Tensor] = None,
                        film: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                        chunk: Optional[int] = None) -> torch.Tensor:
    """``fold_backward``'s (6, B, C) in plain torch, by the formulas each
    block of the one-launch backward runs on its chunk of ``chunk`` channels
    (whole groups; default all C), chunk by chunk: rows 0-1 (2 dL/dS2,
    dL/dS1), so that dL/dx = x * g[0] + g[1]; rows 2-3 each sample's share of
    dL/dgamma and dL/dbeta; rows 4-5 dL/d(emb), or dL/d(FiLM scale) and
    dL/d(FiLM shift).  float32."""
    _, b, c = ao.shape
    cg = c // num_groups
    chunk = c if chunk is None else chunk
    if chunk % cg:
        raise ValueError(f"a chunk of {chunk} channels is no whole number of groups of {cg}")
    g = torch.zeros((6, b, c), dtype=torch.float32, device=ao.device)
    for c0 in range(0, c, chunk):
        cs = slice(c0, min(c, c0 + chunk))
        k = cs.stop - c0
        mean_raw, m2_raw = ao[2, :, cs].float(), ao[3, :, cs].float()
        e = emb[:, cs].float() if emb is not None else torch.zeros_like(mean_raw)
        mu = mean_raw + e
        m2 = m2_raw + 2.0 * e * mean_raw + e * e

        def per_group(t):  # (B, k) -> each channel's group mean, (B, k)
            return t.reshape(b, k // cg, cg).mean(dim=2).repeat_interleave(cg, dim=1)

        mg, qg = per_group(mu), per_group(m2)
        rstd = torch.rsqrt(qg - mg * mg + eps)
        gam = gamma[cs].float()[None, :]
        a0 = rstd * gam
        off0 = beta[cs].float()[None, :] - mg * a0 + e * a0
        da, doff = ga[:, cs].float(), goff[:, cs].float()
        if film is not None:
            sc = 1.0 + film[0][:, cs].float()
            g[4, :, cs] = da * a0 + doff * off0
            g[5, :, cs] = doff
            da, doff = da * sc, doff * sc
        g[3, :, cs] = doff
        da = da + doff * (e - mg)
        g[2, :, cs] = da * rstd
        sm, sr = per_group(-a0 * doff), per_group(da * gam)
        r3 = rstd * rstd * rstd
        dmu = sm + r3 * mg * sr
        dm2 = -0.5 * r3 * sr
        g[0, :, cs] = 2.0 * dm2 / n
        g[1, :, cs] = (dmu + 2.0 * e * dm2) / n
        if emb is not None:
            g[4, :, cs] = doff * a0 + dmu + dm2 * (2.0 * mean_raw + 2.0 * e)
    return g


def apply_affine(x: torch.Tensor, ao: torch.Tensor, silu: bool = False) -> torch.Tensor:
    """One launch: ``x * ao[0] + ao[1]`` (+ SiLU) in x's dtype, for a
    contiguous CUDA (B, *spatial, C) x and float32 (2 or more, B, C) ``ao``."""
    b, n, c = _shape(x)
    out = torch.empty_like(x)
    plan = _moments_plan(b, n, c, x.element_size(), (x.data_ptr() | out.data_ptr()) & 15)
    _build.launch("pddm_gn_apply", x.data_ptr(), ao.data_ptr(), out.data_ptr(), b, n, c,
                  int(silu), int(x.dtype == torch.bfloat16), plan.v, plan.cvb, plan.splits,
                  plan.rows)
    return out


def affine_backward(x: torch.Tensor, ao: torch.Tensor, gamma: torch.Tensor,
                    beta: torch.Tensor, num_groups: int, eps: float, ga: torch.Tensor,
                    goff: torch.Tensor, emb: Optional[torch.Tensor] = None,
                    film: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    want_dx: bool = True):
    """``gn_affine``'s gradient (design ``fused_bwd``): one launch for dL/dx
    in x's dtype (None unless ``want_dx``), each sample's shares of
    dL/dgamma and dL/dbeta and the gradients of emb or of the FiLM pair,
    (B, C) in their dtype; a second for the sums of the shares over the
    batch, dL/dgamma and dL/dbeta (C,) float32.  A tuple (dx, dgamma, dbeta,
    *conditioning).  ``ao`` is the forward's ``moments_fold`` output, ga /
    goff the gradients of its scale and offset; inputs as ``moments_fold``
    takes them.  Raises where ``grad_plan`` has no plan."""
    b, n, c = _shape(x)
    dx = torch.empty_like(x) if want_dx else None
    low = (x.data_ptr() | (0 if dx is None else dx.data_ptr())) & 15
    plan = _grad_plan(b, n, c, num_groups, x.element_size(), low)
    if plan is None:
        raise ValueError(f"the gn_affine_grad design 'fused_bwd' does not take {tuple(x.shape)} "
                         f"in {num_groups} groups")
    ga = _float32_on(ga, x.device)
    goff = _float32_on(goff, x.device)
    conds = (emb,) if emb is not None else tuple(film or ())
    dconds = [torch.empty((b, c), dtype=t.dtype, device=x.device) for t in conds]
    dgamma = torch.empty(c, dtype=torch.float32, device=x.device)
    dbeta = torch.empty(c, dtype=torch.float32, device=x.device)
    shares = torch.empty((b, 2, c), dtype=torch.float32, device=x.device)
    ptr0, ptr1, *rest = _cond_args(emb, film)
    dptr = [t.data_ptr() for t in dconds] + [None, None]
    _build.launch("pddm_gn_affine_bwd", x.data_ptr(), ao.data_ptr(), gamma.data_ptr(),
                  beta.data_ptr(), ptr0, ptr1, ga.data_ptr(), goff.data_ptr(),
                  None if dx is None else dx.data_ptr(), shares.data_ptr(), dptr[0], dptr[1],
                  dgamma.data_ptr(), dbeta.data_ptr(), b, n, c, num_groups, float(eps), *rest,
                  int(x.dtype == torch.bfloat16), plan.v, plan.cvb, plan.splits, plan.rows)
    return (dx, dgamma, dbeta, *dconds)


def _launch(x, gamma, beta, num_groups, eps, silu, design=None):
    """``design``: None for ``groupnorm_design``'s choice, or one by name (a
    measurement times both on one input)."""
    b, n, c = _shape(x)
    fused = None
    if design in (None, "fused"):
        out = torch.empty_like(x)
        fused = _fused_plan(n, c, num_groups, x.element_size(),
                            (x.data_ptr() | out.data_ptr()) & 15)
    if fused is not None:
        _build.launch("pddm_group_norm_silu", x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                      out.data_ptr(), b, n, c, num_groups, float(eps), int(silu),
                      int(x.dtype == torch.bfloat16), fused.v, fused.cvb)
    elif design in (None, "split"):
        out = apply_affine(x, moments_fold(x, gamma, beta, num_groups, eps), silu)
    else:
        raise ValueError(f"the GroupNorm design {design!r} does not take {tuple(x.shape)}")
    group_norm_silu.launches += 1
    return out


group_norm_silu.launches = 0


# ------------------------------------------------------------ the fold alone


def moments_plain(x: torch.Tensor) -> torch.Tensor:
    """(2, B, C) float32: E[x] and E[x^2] per (sample, channel) of a
    (B, *spatial, C) tensor."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, c)
    return torch.stack([xf.mean(dim=1), (xf * xf).mean(dim=1)])


def gn_fold_plain(moments: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  num_groups: int, eps: float, emb: Optional[torch.Tensor] = None,
                  film: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """The fold in plain torch: from the (2, B, C) moments to the (4, B, C)
    float32 (a, off, E[x], E[x^2]) that ``moments_fold`` returns, with
    ``normalized(x [+ emb]) * gamma + beta [FiLM] == x * a + off``."""
    mu_c, m2_c = moments[0].float(), moments[1].float()
    b, c = mu_c.shape
    g = num_groups
    if emb is not None:
        e = emb.float()
        mu, m2 = mu_c + e, m2_c + 2.0 * e * mu_c + e * e
    else:
        mu, m2 = mu_c, m2_c
    mu_g = mu.reshape(b, g, c // g).mean(dim=2)
    m2_g = m2.reshape(b, g, c // g).mean(dim=2)
    rstd = torch.rsqrt(m2_g - mu_g * mu_g + eps).repeat_interleave(c // g, dim=1)
    a = rstd * gamma.float()[None, :]
    off = beta.float()[None, :] - mu_g.repeat_interleave(c // g, dim=1) * a
    if emb is not None:
        off = off + emb.float() * a
    if film is not None:
        s = 1.0 + film[0].float()
        a, off = a * s, off * s + film[1].float()
    return torch.stack([a, off, mu_c, m2_c])


def gn_fold(moments: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, num_groups: int,
            eps: float, emb: Optional[torch.Tensor] = None,
            film: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """``gn_fold_plain``'s (4, B, C).  A CPU tensor takes the plain version;
    a CUDA tensor launches the fold kernel (one block a sample) or raises.
    ``moments`` is (2, B, C) float32; gamma/beta float32 (C,); emb or the
    FiLM pair (B, C), float32 or bfloat16 with unit channel stride (as
    ``gn_conv.gn_affine`` hands them on).  Forward only."""
    if moments.device.type == "cpu":
        return gn_fold_plain(moments, gamma, beta, num_groups, eps, emb=emb, film=film)
    if moments.device.type != "cuda":
        raise ValueError(f"gn_fold: unsupported device {moments.device}")
    if moments.dim() != 3 or moments.shape[0] < 2 or moments.dtype != torch.float32:
        raise ValueError(f"gn_fold takes (2, B, C) float32 moments, got "
                         f"{tuple(moments.shape)} {moments.dtype}")
    _, b, c = moments.shape
    if c % num_groups or c > _MAX_CHANNELS or b > 65535:
        raise ValueError(f"gn_fold: {c} channels in {num_groups} groups, batch {b}")
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"gamma/beta must be ({c},)")
    moments = moments[:2].contiguous()
    gamma, beta = _float32_on(gamma, moments.device), _float32_on(beta, moments.device)
    ao = torch.empty((4, b, c), dtype=torch.float32, device=moments.device)
    ptr0, ptr1, *rest = _cond_args(emb, film)
    _build.launch("pddm_gn_fold", moments.data_ptr(), gamma.data_ptr(), beta.data_ptr(), ptr0,
                  ptr1, ao.data_ptr(), b, c, num_groups, float(eps), *rest)
    gn_fold.launches += 1
    return ao


gn_fold.launches = 0


def group_norm_silu_slab_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                               num_groups: int, eps: float, silu: bool,
                               average) -> torch.Tensor:
    """``group_norm_silu_slab`` in plain torch (the moments, the fold, the
    affine and SiLU)."""
    ao = gn_fold_plain(average(moments_plain(x)), gamma, beta, num_groups, eps)
    shape = (x.shape[0], *(1,) * (x.dim() - 2), x.shape[-1])
    y = x.float() * ao[0].reshape(shape) + ao[1].reshape(shape)
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def group_norm_silu_slab(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                         num_groups: int, eps: float, silu: bool, average) -> torch.Tensor:
    """``group_norm_silu`` of a whole image of which ``x`` holds some rows:
    the moments of ``x``, ``average``d over the ranks that hold the rest
    ((2, B, C) float32 in, the same out), folded, applied to ``x``.  A CPU
    tensor takes the plain version; a CUDA tensor launches the moments,
    fold and apply kernels.  Forward only."""
    if x.device.type == "cpu":
        return group_norm_silu_slab_plain(x, gamma, beta, num_groups, eps, silu, average)
    x = x.contiguous()
    gamma, beta = check_inputs("group_norm_silu", x, gamma, beta, num_groups)
    local = moments_fold(x, gamma, beta, num_groups, eps)
    ao = gn_fold(average(local[2:4]), gamma, beta, num_groups, eps)
    out = apply_affine(x, ao, silu)
    group_norm_silu.launches += 1
    return out
