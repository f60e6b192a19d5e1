"""Time the fused conv's gradient at every conv site of the CIFAR-10 UNet.

    python3 time_conv_grad.py [--out DIR] [--dgrad-tile MT,BN]

Records the fused conv's calls in one bf16 batch-128 forward of the
full-width CIFAR-10 UNet (``chip_smoke.MODEL_CFG``, zero-init parameters
filled from a seed) and runs ``chip_smoke.conv_grad_site`` at each distinct
site: the design of ``gn_silu_conv3x3_grad`` that the site's shape selects
and its earlier ones by name (``wgmma``, ``wgmma_sync_epilogue`` and
``wgmma_taprow`` at the bf16 sites; the first two's dgrads are
``dgrad_pingpong_kernel`` and ``dgrad_wgmma_kernel``), against the plain
backward (the same bits twice, one count a call), the first two timed with
and without the host's cost, each kernel's device ms from a
profile of the site's CUDA graph, beside ``convolution_backward`` (both
products, the weight product alone, the input product alone) and the
bounds (the two products, the input product, the weight product).  Prints
one ``kernel_site`` line a site, then one ``summary`` line with the sums
over the 61 sites a forward (bf16 sites and the head apart), and the card's
name and power limit.

``--dgrad-tile MT,BN`` runs ``wgmma``'s dgrad at every bf16 site in tiles
of 64 MT pixels x BN channels (1,128, 2,64 or 1,64) instead of the ones
``ops/gn_conv.py::_pingpong_config`` picks: the same products over a weight
stream of another size.  The same code as ``chip_smoke.py``'s kernel phase,
alone: a quick reading of one kernel's designs.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys


def main(argv=None) -> int:
    here = pathlib.Path(__file__).resolve().parent
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=pathlib.Path, default=None,
                        help="directory for the sites' JSON lines")
    parser.add_argument("--dgrad-tile", default=None,
                        help="MT,BN: wgmma's dgrad tile at every bf16 site")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("time_conv_grad.py needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(here))
    import chip_smoke
    from probabilisticdeepdiffusionmodels_torch.models import get_model
    from probabilisticdeepdiffusionmodels_torch.ops import gn_conv

    if args.dgrad_tile is not None:
        tile = tuple(int(v) for v in args.dgrad_tile.split(","))
        gn_conv._pingpong_config = lambda b, h, w, cin: tile

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        chip_smoke.LINES_OUT.append(args.out / "time_conv_grad.jsonl")
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
    calls = {}
    with torch.no_grad(), ops.recording(calls):
        model(x, t)
    torch.cuda.synchronize()
    per_site, summary = [], {}
    for entry in calls.values():
        if entry["name"] != "gn_silu_conv3x3":
            continue
        a = entry["args"]
        chip_smoke.conv_grad_site(torch, ops, a, entry["count"],
                                  {"shape": list(a[0].shape),
                                   "dtype": str(a[0].dtype).replace("torch.", "")},
                                  per_site, summary)
    chip_smoke.emit({"phase": "summary", "nvidia_smi": smi, "dgrad_tile": args.dgrad_tile,
                     "gn_silu_conv3x3_grad": summary["gn_silu_conv3x3_grad"]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
