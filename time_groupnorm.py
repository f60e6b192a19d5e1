"""Time ``group_norm_silu`` of one checkout at the CIFAR-10 UNet's attention norms.

    python3 time_groupnorm.py [--root CHECKOUT] [--label NAME]
    python3 time_groupnorm.py --grad [--vary FILL=132 STAGES=1 ...]

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

With ``--grad`` it times the gradient, ``group_norm_silu_grad``, at the
same three sites instead, without the SiLU as the UNet's attention norms
run it: each design by name in the same process
(``tma_resident``, then ``fused``; with ``--vary``, ``tma_resident``
also planned with one of ``ops/groupnorm.py``'s ``_RESIDENT_*`` constants set
to another value, one run a comma-separated list: ``FILL`` (items wanted),
``BYTES``, ``STAGES``, ``STAGE_ROWS``, ``SAMPLES``), each held
against the plain backward (bf16 1e-2 of the largest element) and run twice
for the same bits, and prints one JSON line a (site, design) with the plan,
``device_ms`` (as above, the inputs x, g and the statistics copied),
each kernel's device ms from a profile of that graph (lower bounds: the
profiler drops records; a programmatic dependent's time counts from its
early start), the bound (x and g read, dx written, the statistics read,
dgamma and dbeta written) and ``native_group_norm_backward``'s device ms on
the same values in NCHW without the SiLU (after a first line with the
card's name and power limit); for ``tma_resident`` the edges
of a graph captured over one call (``chip_smoke.graph_edges``: whether the
batch sums' programmatic launch stayed programmatic under capture).

Needs a CUDA card; the measuring helpers are ``chip_smoke.py``'s.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

SITES = (256, 64, 16)
BATCH, CHANNELS, GROUPS = 128, 256, 32
ROUNDS = 7
BF16_TOL = 2e-2  # of max(1, max|ref|), as chip_smoke.py holds bf16 outputs
BF16_GRAD_TOL = 1e-2  # of the largest element, as chip_smoke.py holds bf16 gradients


def main(argv=None) -> int:
    here = pathlib.Path(__file__).resolve().parent
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=pathlib.Path, default=here)
    parser.add_argument("--label", default=None)
    parser.add_argument("--grad", action="store_true", help="time the gradient's designs")
    parser.add_argument("--vary", nargs="*", default=[], metavar="NAME=VALUE",
                        help="with --grad: also tma_resident planned with _RESIDENT_NAME = VALUE")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("time_groupnorm.py needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(here))
    from chip_smoke import PEAK_BYTES, cold_copies, graph_time, sync_time
    sys.path.insert(0, str(args.root.resolve()))
    from probabilisticdeepdiffusionmodels_torch.ops import groupnorm

    if args.grad:
        return time_grad(torch, groupnorm, args)
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


def time_grad(torch, groupnorm, args) -> int:
    """``--grad``: the gradient's designs at the three sites (module doc)."""
    from chip_smoke import (PEAK_BYTES, capture_graph, cold_copies, graph_edges, graph_kernels,
                            graph_time, replay_ms)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"device": smi}), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    gamma = 1 + 0.3 * torch.randn(CHANNELS, device="cuda", generator=gen)
    beta = 0.3 * torch.randn(CHANNELS, device="cuda", generator=gen)
    eps, silu, bad = 1e-5, False, []
    for t in SITES:
        x = (torch.randn(BATCH, t, CHANNELS, device="cuda", generator=gen) + 0.5).bfloat16()
        g = torch.randn(x.shape, device="cuda", generator=gen).bfloat16()
        with torch.no_grad():
            _, ao = groupnorm._launch(x, gamma, beta, GROUPS, eps, silu, want_ao=True)
        ref = groupnorm.group_norm_silu_grad_plain(x, gamma, beta, g, GROUPS, eps, silu, ao=ao)
        nbytes = 3 * x.numel() * x.element_size() + ao.numel() * 4 + 4 * CHANNELS * 4
        copies = [(x.clone(), g.clone(), ao.clone()) for _ in cold_copies(x, nbytes)]
        per_graph = max(1, 100 // len(copies))
        xc = x.reshape(BATCH, t, CHANNELS).permute(0, 2, 1).contiguous()
        gc = g.reshape(BATCH, t, CHANNELS).permute(0, 2, 1).contiguous()
        w, bias = gamma.bfloat16(), beta.bfloat16()
        _, mean, rstd = torch.ops.aten.native_group_norm(xc, w, bias, BATCH, CHANNELS, t, GROUPS,
                                                         eps)
        library = graph_time(torch, lambda: torch.ops.aten.native_group_norm_backward(
            gc, xc, mean, rstd, w, BATCH, CHANNELS, t, GROUPS, [True, True, True]), 20, 10)
        runs = [("tma_resident", "tma_resident", {}), ("fused", "fused", {})]
        for spec in args.vary:
            runs.append((f"tma_resident@{spec}", "tma_resident",
                         {f"_RESIDENT_{k}": int(v) for k, v in
                          (kv.split("=") for kv in spec.split(","))}))
        for label, design, consts in runs:
            saved = {k: getattr(groupnorm, k) for k in consts}
            for k, v in consts.items():
                setattr(groupnorm, k, v)
            groupnorm._resident_plan.cache_clear()
            groupnorm._silu_grad_plan.cache_clear()
            try:
                plan = groupnorm.silu_grad_plan(BATCH, t, CHANNELS, GROUPS, 2, x.data_ptr())[1]
                if design == "fused":
                    plan = groupnorm.fused_plan(t, CHANNELS, GROUPS, 2, x.data_ptr())

                def call(xx, gg, aa, design=design):
                    return groupnorm.group_norm_silu_grad(xx, gamma, beta, gg, GROUPS, eps, silu,
                                                          ao=aa, design=design)

                with torch.no_grad():
                    before = groupnorm.group_norm_silu_grad.launches
                    got, again = call(x, g, ao), call(x, g, ao)
                    torch.cuda.synchronize()
                    launches = groupnorm.group_norm_silu_grad.launches - before
                    err = max(float((p.float() - q.float()).abs().max())
                              / max(1e-30, float(q.float().abs().max()))
                              for p, q in zip(got, ref))
                    same = all(torch.equal(p, q) for p, q in zip(got, again))

                    def cold_round(call=call):
                        for c in copies:
                            call(*c)

                    device = [graph_time(torch, cold_round, per_graph, 10) / len(copies)
                              for _ in range(ROUNDS)]
                    graph = capture_graph(torch, cold_round, per_graph)
                    replay_ms(torch, graph, 2)
                    kernels = graph_kernels(torch, graph, per_graph * len(copies))
                    del graph
                    edges = (graph_edges(torch, lambda: call(x, g, ao))
                             if design == "tma_resident" else None)
            finally:
                for k, v in saved.items():
                    setattr(groupnorm, k, v)
                groupnorm._resident_plan.cache_clear()
                groupnorm._silu_grad_plan.cache_clear()
            print(json.dumps({
                "label": args.label or str(args.root), "rows": t, "silu": silu, "design": label,
                "plan": plan._asdict(), "max_rel_err": err, "tol": BF16_GRAD_TOL,
                "same_bits_twice": same, "launches_two_calls": launches,
                "bound_ms": nbytes / PEAK_BYTES * 1e3,
                "device_ms": {"min": min(device), "median": statistics.median(device)},
                "kernels": kernels, "graph_edges": edges,
                "library_device_ms": library}), flush=True)
            if not (err <= BF16_GRAD_TOL and same and launches == 2):
                bad.append((t, label, err, same, launches))
    if bad:
        raise AssertionError(f"gradient designs vs plain (tolerance, same bits, counts): {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
