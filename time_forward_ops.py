"""Count the device operations of one bf16 batch-128 forward of one checkout.

    python3 time_forward_ops.py [--root CHECKOUT] [--label NAME]

Imports ``probabilisticdeepdiffusionmodels_torch`` from CHECKOUT (default:
this file's directory), builds the full-width CIFAR-10 UNet in bf16
(``chip_smoke.MODEL_CFG``, seed 0, zero-init parameters filled from seed 1,
as ``chip_smoke.py`` does) and profiles one forward on float32 x at batch
128, twice.  Prints one JSON line: the device operations (the larger of the
two profiles' counts: a profile may drop records), each profile's device
busy ms, the copy kernels (``copy`` in the name) and their ms, each
kernel's device ms and launches by its name without template arguments
(``kernels``: one entry a profile, so the main path's kernels, such as the
fused conv's ``conv_wgmma_kernel``, read device-only beside the parent's),
and a SHA-256 of the output's bytes, so two commits unpacked side by side,
one process each, show the same output and the operations one has fewer.
Needs a CUDA card; the measuring helpers are ``chip_smoke.py``'s.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import sys

BATCH, RESOLUTION = 128, 32


def main(argv=None) -> int:
    here = pathlib.Path(__file__).resolve().parent
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=pathlib.Path, default=here)
    parser.add_argument("--label", default=None)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("time_forward_ops.py needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(here))
    from chip_smoke import MODEL_CFG, fill_zero_params, kernel_name, profile_device
    sys.path.insert(0, str(args.root.resolve()))
    from probabilisticdeepdiffusionmodels_torch.models import get_model

    model = get_model(RESOLUTION, MODEL_CFG, device="cuda", seed=0)
    fill_zero_params(torch, model, seed=1)
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(BATCH, RESOLUTION, RESOLUTION, 3, device="cuda", generator=gen)
    t = torch.randint(1, 1001, (BATCH,), device="cuda", generator=gen)

    def forward():
        with torch.no_grad():
            return model(x, t)

    out = forward()
    torch.cuda.synchronize()
    profs = [profile_device(torch, forward) for _ in range(2)]
    copies = [[k for k in p["all"] if "copy" in k["name"].lower()] for p in profs]
    kernels = {}
    for i, p in enumerate(profs):
        for k in p["all"]:
            entry = kernels.setdefault(kernel_name(k["name"]).split("<")[0],
                                       {"ms": [0.0] * len(profs), "calls": [0] * len(profs)})
            entry["ms"][i] += k["ms"]
            entry["calls"][i] += k["calls"]
    print(json.dumps({
        "label": args.label or str(args.root), "batch": BATCH,
        "device_ops": max(p["device_ops"] for p in profs),
        "device_busy_ms": [p["device_busy_ms"] for p in profs],
        "copy_ops": max(sum(k["calls"] for k in c) for c in copies),
        "copy_ms": [sum(k["ms"] for k in c) for c in copies],
        "kernels": kernels,
        "output_sha256": hashlib.sha256(out.float().cpu().numpy().tobytes()).hexdigest()}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
