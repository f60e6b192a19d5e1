"""The matrix-unit probe: one 256x256 @ 256x256 product, float32 accumulation.

Counterpart of ``scripts/probe_mosaic_bf16.py`` (``_kernel`` via
``try_dtype``), which asks whether the Pallas toolchain accepts bf16 matmul
operands on the TPU's matrix unit.  Here the question is whether the port's
toolchain builds and runs a hand-written ``sm_90a`` kernel on the H100's
tensor cores: ``csrc/probe_mma.cu`` computes the product with ``mma.sync``
m16n8k16 on bf16 operands and with scalar FMAs (no TF32) on float32 ones,
and is held against the plain version ``a.float() @ b.float()``.  It bounds
nothing on the card: the work is far below a launch's latency.

    python -m probabilisticdeepdiffusionmodels_torch.ops.probe_mma

prints the device, then each dtype's max abs error against the plain version,
and exits 1 if either is over tolerance; a failed build or launch raises.
"""

from __future__ import annotations

import sys
from typing import Optional, Tuple

import torch

from . import _build

__all__ = ["SIZE", "TOL", "probe_mma", "probe_mma_plain", "random_operands",
           "try_dtype", "main"]

SIZE = 256
# of max|plain|: float32 sums of 256 products, exact in float32 for bf16
# operands, taken in another order than the plain version's
TOL = 1e-4
_DTYPES = (torch.float32, torch.bfloat16)


def probe_mma_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(256, 256) float32 product of the operands upcast to float32."""
    return a.float() @ b.float()


def probe_mma(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with float32 accumulation, a and b (256, 256) of one dtype
    (float32 or bfloat16); other shapes and dtypes raise on every device.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise ValueError(f"probe_mma takes two float32 or two bfloat16 operands, "
                         f"got {a.dtype} and {b.dtype}")
    if a.shape != (SIZE, SIZE) or b.shape != (SIZE, SIZE):
        raise ValueError(f"probe_mma computes {SIZE}x{SIZE} @ {SIZE}x{SIZE} only, got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return probe_mma_plain(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"probe_mma: operands on {a.device} and {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()) or a.data_ptr() % 4 or b.data_ptr() % 4:
        raise ValueError("probe_mma operands must be contiguous and 4-byte aligned")
    out = torch.empty((SIZE, SIZE), dtype=torch.float32, device=a.device)
    _build.launch("pddm_probe_mma", a.data_ptr(), b.data_ptr(), out.data_ptr(),
                  int(a.dtype == torch.bfloat16))
    probe_mma.launches += 1
    return out


probe_mma.launches = 0


def random_operands(dtype: torch.dtype, device, seed: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two standard-normal (256, 256) operands drawn on the CPU from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    a, b = torch.randn(2, SIZE, SIZE, generator=gen).to(device=device, dtype=dtype)
    return a.contiguous(), b.contiguous()


def try_dtype(dtype: torch.dtype, a: Optional[torch.Tensor] = None,
              b: Optional[torch.Tensor] = None, device=None) -> torch.Tensor:
    """The probe's product for operands of ``dtype`` on ``device`` (default
    CUDA).  Missing operands are seeded random values, not ones: a product
    of ones hides indexing faults."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    if a is None or b is None:
        a, b = random_operands(dtype, device)
    return probe_mma(a.to(device=device, dtype=dtype), b.to(device=device, dtype=dtype))


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain float32 product in float32
    device = torch.device("cuda")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: the probe runs on the card")
    print(f"device: {torch.cuda.get_device_name(device)}")
    ok = True
    for dtype in _DTYPES:
        a, b = random_operands(dtype, device)
        out = try_dtype(dtype, a, b)
        torch.cuda.synchronize()
        ref = probe_mma_plain(a, b)
        err = float((out - ref).abs().max())
        tol = TOL * float(ref.abs().max())
        good = err <= tol
        ok &= good
        print(f"{str(dtype).replace('torch.', '')}: max abs err {err:.3e} "
              f"(tol {tol:.3e}) {'OK' if good else 'OVER TOLERANCE'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
