"""Time attention's bf16 forward in both designs across batch sizes: where the grid fill turns.

    python3 time_attention.py [--root CHECKOUT]

Imports ``probabilisticdeepdiffusionmodels_torch`` from CHECKOUT (default:
this file's directory).  For heads of 64 (the CIFAR-10 UNet's) and of 32
(the 1-D and 3-D UNets'), 4 heads, T = 256 and T = 64, and batch sizes from
8 to 128 (32 to 512 (head, sample) items, across the card's SM count), it
runs ``attention_forward`` in ``wgmma`` and in ``mma_ring`` by name, holds
each against ``qkv_attention_plain`` (bf16 2e-2 of the largest element, as
the chip check does), and prints one JSON line a shape with each design's
device ms a call (the launches replayed from one CUDA graph over copies of
qkv that do not fit the L2 cache together), the design ``attention_design``
chooses there, and the items; after a first line with the card's name,
power limit and SM count.  Needs a CUDA card; the measuring helpers are
``chip_smoke.py``'s.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

HEADS = 4
WIDTHS = {64: (8, 16, 24, 32, 33, 40, 48, 64, 96, 128), 32: (8, 16, 32, 33, 48, 64, 128)}
TOKENS = (256, 64)
TOL = 2e-2


def main(argv=None) -> int:
    here = pathlib.Path(__file__).resolve().parent
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=pathlib.Path, default=here)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("time_attention.py needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(here))
    from chip_smoke import cold_copies, graph_time
    sys.path.insert(0, str(args.root.resolve()))
    from probabilisticdeepdiffusionmodels_torch.ops import attention as mod

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(json.dumps({"device": smi, "sms": sms}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = []
    with torch.no_grad():
        for ch, batches in WIDTHS.items():
            for t in TOKENS:
                for b in batches:
                    x = torch.randn(b, t, 3 * HEADS * ch, device="cuda",
                                    generator=gen).to(torch.bfloat16)
                    ref = mod.qkv_attention_plain(x, HEADS).float()
                    copies = cold_copies(x, x.numel() * 2 * 4 / 3)
                    line = {"shape": [b, t, 3 * HEADS * ch], "heads": HEADS, "items": b * HEADS,
                            "chosen": mod.attention_design(x, HEADS), "device_ms": {},
                            "max_abs_err": {}}
                    for d in ("wgmma", "mma_ring"):
                        err = float((mod.attention_forward(x, HEADS, d)[0].float() - ref)
                                    .abs().max())
                        line["max_abs_err"][d] = err
                        if not err <= TOL * max(1.0, float(ref.abs().max())):
                            bad.append((line["shape"], d, err))

                        def one_round(d=d):
                            for c in copies:
                                mod.qkv_attention(c, HEADS, design=d)

                        per = max(1, 100 // len(copies))
                        line["device_ms"][d] = graph_time(torch, one_round, per) / len(copies)
                    print(json.dumps(line), flush=True)
                    del copies
    if bad:
        print(json.dumps({"outside_tolerance": bad}), flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
