"""Time the float32 rows of chip_smoke.py's kernel phase alone.

    python3 time_conv_f32.py [--out DIR] [--convs-only]

Records the calls of one float32 batch-128 forward of the full-width
CIFAR-10 UNet (``chip_smoke.MODEL_CFG`` with ``compute_dtype=float32``, the
shipped configs' default; zero-init parameters filled from a seed) and runs
``chip_smoke.f32_kernels``: at each fused-conv signature but the head the
forward and the gradient in the design the shape selects (``tiled_f32``) and
in ``general`` by name, held against the plain versions and timed
device-only beside ``F.conv2d`` and ``convolution_backward``'s input and
weight products (TF32 off) and the bounds; then (without ``--convs-only``)
attention's and GroupNorm's float32 sites, forward and backward.  Prints
one ``kernel_site`` line a site, the ``kernels_f32`` line with the sums over
a forward's calls, and the card's name and power limit.  The same code as
``chip_smoke.py``'s kernel phase, alone.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys


def main(argv=None) -> int:
    here = pathlib.Path(__file__).resolve().parent
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=pathlib.Path, default=None,
                        help="directory for the sites' JSON lines")
    parser.add_argument("--convs-only", action="store_true",
                        help="the fused convs alone, not attention and GroupNorm")
    args = parser.parse_args(argv)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("time_conv_f32.py needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(here))
    import chip_smoke
    from probabilisticdeepdiffusionmodels_torch.models import get_model

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        chip_smoke.LINES_OUT.append(args.out / "time_conv_f32.jsonl")
        chip_smoke.LINES_OUT[0].write_text("")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ops = chip_smoke.Ops()
    model = get_model(chip_smoke.RESOLUTION, chip_smoke.MODEL_CFG, device="cuda", seed=0)
    chip_smoke.fill_zero_params(torch, model, seed=1)
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(chip_smoke.FORWARD_BATCH, chip_smoke.RESOLUTION, chip_smoke.RESOLUTION, 3,
                    device="cuda", generator=gen)
    t = torch.randint(1, 1001, (chip_smoke.FORWARD_BATCH,), device="cuda", generator=gen)
    chip_smoke.f32_kernels(torch, F, ops, model, x, t, [], convs_only=args.convs_only)
    chip_smoke.emit({"phase": "summary", "nvidia_smi": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
