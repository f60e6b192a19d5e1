"""Time ``group_norm_silu`` of one checkout at the CIFAR-10 UNet's attention norms.

    python3 time_groupnorm.py [--root CHECKOUT] [--label NAME]

Imports ``probabilisticdeepdiffusionmodels_torch`` from CHECKOUT (default:
this file's directory) and only its public ``group_norm_silu`` and
``group_norm_silu_plain``, so two commits unpacked side by side can be read
by the same code in one job, one process each.  For each site (batch 128,
256 channels in 32 groups, bf16, T = 256, 64, 16 rows) it holds the kernel
against the plain version and prints one JSON line with

- ``wrapper_ms``: per call through the wrapper, launches issued back to back
  from Python (the least and the median of ``ROUNDS`` rounds by CUDA events;
  at these sizes it is the host's cost of a call, not the kernel's time);
- ``device_ms``: per call with no host cost, the launches replayed from one
  CUDA graph over copies of the input that do not fit the L2 cache together
  (the least and the median of ``ROUNDS`` timings).

Needs a CUDA card; the measuring helpers are ``chip_smoke.py``'s.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys

SITES = (256, 64, 16)
BATCH, CHANNELS, GROUPS = 128, 256, 32
ROUNDS = 7
BF16_TOL = 2e-2  # of max(1, max|ref|), as chip_smoke.py holds bf16 outputs


def main(argv=None) -> int:
    here = pathlib.Path(__file__).resolve().parent
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=pathlib.Path, default=here)
    parser.add_argument("--label", default=None)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("time_groupnorm.py needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(here))
    from chip_smoke import PEAK_BYTES, cold_copies, graph_time, sync_time
    sys.path.insert(0, str(args.root.resolve()))
    from probabilisticdeepdiffusionmodels_torch.ops import groupnorm

    gen = torch.Generator(device="cuda").manual_seed(0)
    gamma = torch.randn(CHANNELS, device="cuda", generator=gen)
    beta = torch.randn(CHANNELS, device="cuda", generator=gen)
    for t in SITES:
        x = (torch.randn(BATCH, t, CHANNELS, device="cuda", generator=gen) + 0.5).bfloat16()
        nbytes = 2 * x.numel() * x.element_size()
        xs = cold_copies(x, nbytes)

        def cold_round():
            for y in xs:
                groupnorm.group_norm_silu(y, gamma, beta, GROUPS)

        with torch.no_grad():
            out = groupnorm.group_norm_silu(x, gamma, beta, GROUPS)
            ref = groupnorm.group_norm_silu_plain(x, gamma, beta, GROUPS)
            err = float((out.float() - ref.float()).abs().max())
            tol = BF16_TOL * max(1.0, float(ref.float().abs().max()))
            wrapper = [sync_time(torch, lambda: groupnorm.group_norm_silu(x, gamma, beta, GROUPS))
                       for _ in range(ROUNDS)]
            device = [graph_time(torch, cold_round, max(1, 100 // len(xs)), 10) / len(xs)
                      for _ in range(ROUNDS)]
        print(json.dumps({
            "label": args.label or str(args.root), "rows": t, "max_abs_err": err, "tol": tol,
            "bound_ms": nbytes / PEAK_BYTES * 1e3,
            "wrapper_ms": {"min": min(wrapper), "median": statistics.median(wrapper)},
            "device_ms": {"min": min(device), "median": statistics.median(device)}}), flush=True)
        if not err <= tol:
            raise AssertionError(f"T={t}: kernel vs plain max abs err {err} > {tol}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
