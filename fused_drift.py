"""How far K = 4 fused train steps drift from 4 eager steps, parameter by parameter.

    python3 fused_drift.py [--seeds 2 3]

``chip_smoke.py``'s fused gate holds a replayed chunk of K = 4 bench_train.py
steps (the CIFAR-10 UNet at full width, bf16, batch 128) against the same
steps run eagerly from one copy of the state, within lr / 10 of the largest
parameter: the graph's Adam update rounds once more than torch.optim.Adam,
and the later steps carry that round-off.  This script shows what sets that
distance: for each seed it runs the gate's two sides with every gradient
on the kernels the shapes select (attention's: ``wgmma``; GroupNorm's:
``tma_resident``, its batch sums a programmatic dependent launch inside the
graph; attention's forward ``wgmma``, whose log-sum-exp the backward reads),
with the conv's, attention's and GroupNorm's, and attention's forward, in
the designs before them by name (``wgmma_sync_epilogue``, ``two_pass``,
``fused``, ``mma_ring``), and with
attention's and GroupNorm's as ``recompute`` by
name (autograd through the plain versions), in turns, and prints one JSON line a
run with the largest differences by parameter name.  A gradient that is
zero in exact arithmetic (the attention key bias's: softmax ignores a shift
of every key) is where Adam turns round-off into whole steps.  Needs a CUDA
card; the gate's helpers are ``chip_smoke.py``'s.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

TOP = 5


def main(argv=None) -> int:
    here = pathlib.Path(__file__).resolve().parent
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[2, 3])
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("fused_drift.py needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(here))
    import chip_smoke as cs
    from probabilisticdeepdiffusionmodels_torch.engine import DiffusionEngine

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    ops = cs.Ops()

    def engine():
        e = DiffusionEngine(dict(cs.MODEL_CFG), {"lr": cs.FUSED_LR}, ema=0.9999, device="cuda")
        cs.fill_zero_params(torch, e.state.model, seed=50)
        e.state.ema_model.load_state_dict(e.state.model.state_dict())
        return e

    for seed in args.seeds:
        for design, swap in (("kernels", {}), ("parent_designs", cs.parent_designs(ops)),
                             ("recompute", cs.ATTN_GN_RECOMPUTE)):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            with cs.swapped_designs(ops, swap):
                graph_e, eager_e = engine(), engine()
                xs = [torch.rand((cs.FUSED_K, cs.TRAIN_BATCH, cs.RESOLUTION, cs.RESOLUTION, 3),
                                 device="cuda", generator=gen) * 2.0 - 1.0 for _ in range(2)]
                graph_e.training_steps(xs[0])  # warm-up and capture
                cs.copy_state(graph_e.state, eager_e.state)
                graph_e.training_steps(xs[1])
                for x in xs[1]:
                    eager_e.training_step(x)
            diffs = sorted(((float((a.detach() - b.detach()).abs().max()), name)
                            for (name, a), b in zip(graph_e.state.model.named_parameters(),
                                                    eager_e.state.model.parameters())),
                           reverse=True)
            print(json.dumps({"seed": seed, "design": design, "lr": cs.FUSED_LR,
                              "gate": cs.FUSED_PARAM_TOL, "largest": diffs[:TOP]}), flush=True)
            del graph_e, eager_e
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
