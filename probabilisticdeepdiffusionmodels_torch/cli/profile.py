"""Profile a trained run: the train step and the sampling chain.

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/cli/profile.py``:

    python -m probabilisticdeepdiffusionmodels_torch.cli.profile \\
        run_dir=runs/<name> steps=5 sample_steps=50 [batch_size=8] [device=cpu]

Rebuilds the run's engine (its best checkpoint) on ``device`` (null: cuda),
warms each path up outside the trace, then times ``steps`` train steps and
one ``sample_steps``-step chain of ``batch_size`` images under
``torch.profiler``.  Writes ``<run_dir>/profile/`` with ``train_trace/`` and
``sample_trace/`` (each a Chrome ``trace.json``) and ``timings.json``: the
batch, ``fwd_gflops`` (JAX's analytic count from the config's UNet keys,
``utils.profiling.unet_flops``; a dense run has none), ``train_step_ms``,
``train_img_per_sec``, ``sample_chain_s`` and ``sample_img_per_sec``.  The
times are taken under the profiler, its recording included, and stop
before the trace is written out.  A
class-conditional run gets zero labels and a super-resolution run a random
low-res batch at half the resolution.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

from ..config import load_config
from ..utils.profiling import step_timer, trace, unet_flops

__all__ = ["run_profile", "main"]


def run_profile(cfg) -> dict:
    if not cfg.get("run_dir"):
        raise ValueError("pass run_dir=<path to a training run>")
    from .sample import load_engine_from_run

    engine, run_cfg = load_engine_from_run(cfg["run_dir"], device=cfg.get("device"))
    out = Path(cfg["run_dir"]) / "profile"
    out.mkdir(exist_ok=True)

    res = engine.resolution
    b = int(cfg.get("batch_size", 8))
    steps = int(cfg.get("steps", 3))
    sample_steps = cfg.get("sample_steps")
    x = np.random.default_rng(0).normal(
        size=(b, *(res,) * engine.dims, engine.in_channels)).astype(np.float32)

    timings = {"batch_size": b}
    mc = dict(run_cfg["model"])
    try:  # JAX's count, from the config's UNet keys (a dense run has none)
        flops = unet_flops(res, engine.in_channels, mc["model_channels"],
                           mc["num_res_blocks"], mc.get("attention_resolutions", []),
                           mc["channel_mult"], mc.get("num_heads", 1))
        timings["fwd_gflops"] = round(flops / 1e9, 2)
    except (KeyError, TypeError):
        pass

    # a conditional run needs its conditioning batch
    y = None
    if engine.cond_kind == "class":
        y = np.zeros((b,), np.int64)
    elif engine.cond_kind == "superres":
        low = max(1, res // 2)
        y = np.random.default_rng(1).normal(
            size=(b, *(low,) * engine.dims, engine.in_channels)).astype(np.float32)

    if steps:
        # warm up outside the trace, so it records the steady state
        engine.training_step(x, y)
        # the clock stops before the trace is written
        with trace(str(out / "train_trace")), step_timer() as timer:
            for _ in range(steps):
                metrics = engine.training_step(x, y)
            float(metrics["loss"])  # the steps' device work, inside the trace
        timings["train_step_ms"] = round(1e3 * timer.seconds / steps, 3)
        timings["train_img_per_sec"] = round(b * steps / timer.seconds, 2)

    if sample_steps is not None:
        engine.generate_images(n=b, minibatch=b, seed=0, num_sample_steps=sample_steps, y=y)
        with trace(str(out / "sample_trace")), step_timer() as timer:
            engine.generate_images(n=b, minibatch=b, seed=1, num_sample_steps=sample_steps,
                                   y=y)
        timings["sample_chain_s"] = round(timer.seconds, 3)
        timings["sample_img_per_sec"] = round(b / timer.seconds, 2)

    (out / "timings.json").write_text(json.dumps(timings, indent=1))
    print(f"[profile] {timings}")
    print(f"[profile] traces in {out} (Chrome trace.json files)")
    return timings


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    return run_profile(load_config("profile", argv))


if __name__ == "__main__":
    main()
