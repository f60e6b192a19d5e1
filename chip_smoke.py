"""Drive the PyTorch port on one CUDA card, end to end.

    python3 chip_smoke.py [--out DIR]

1. device: the card's name and count, and nvidia-smi's name and power limit;
2. build: compiles the CUDA kernels from ``probabilisticdeepdiffusionmodels_torch/csrc``;
3. kernels: records every call of the three kernels in one batch-128 bf16
   forward of the full-width CIFAR-10 UNet (``config/model/unet.yaml``, as
   ``bench.py`` builds it), then for each distinct shape holds the kernel
   against its plain PyTorch version on the recorded inputs and times the
   kernel, the plain version and one PyTorch library call that computes
   the same function, beside the least time the card needs for the work;
4. main path: the 20-step ancestral sampler (linear T=1000 respaced to 20,
   clip=True) through ``get_model`` and ``p_sample_loop``: bf16 at batch 32
   with the launch counts asserted, float32 on the kernels against float32
   on the plain versions with the same weights and noise, one timed bf16
   forward at batch 128 with its device profile, and the 250-step chain of
   ``bench.py`` (bf16, batch 128) three times in a row, whose img/s is the
   sampler's headline metric.

Prints one JSON line per phase, then the ``{"kernels": [...]}`` line, then
``{"ok": true, "device": {...}}`` as the last line.  Any failure raises and
exits non-zero without that line; so does a machine without a CUDA device.
With ``--out DIR`` the per-shape measurements and the compiler's log are
also written to DIR.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
PKG = "probabilisticdeepdiffusionmodels_torch"

# bench.py:108-120, the CIFAR-10 UNet in bf16
MODEL_CFG = dict(name="unet", in_channels=3, model_channels=128, num_res_blocks=3,
                 attention_resolutions=[16, 8], channel_mult=[1, 2, 2, 2], num_heads=4,
                 compute_dtype="bfloat16")
RESOLUTION = 32
STEPS = 20
BENCH_STEPS = 250      # bench.py's headline chain
BENCH_REPEATS = 3      # chains timed in a row, each reported, for the spread
CHAIN_BATCH = 32
FORWARD_BATCH = 128
PER_FORWARD = {"gn_silu_conv3x3": 61, "qkv_attention": 15, "group_norm_silu": 15}
F32_CHAIN_TOL = 1e-3   # kernels vs plain, float32, after 20 steps (sums in another order)

# H100 SXM published peaks (NVIDIA data sheet), dense
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

REPLACES = {
    "gn_silu_conv3x3": "probabilisticdeepdiffusionmodels_tpu/ops/gn_conv_pallas.py:180",
    "group_norm_silu": "probabilisticdeepdiffusionmodels_tpu/ops/groupnorm_pallas.py:112",
    "qkv_attention": "probabilisticdeepdiffusionmodels_tpu/ops/attention_pallas.py:67",
}
SOURCES = {
    "gn_silu_conv3x3": f"{PKG}/csrc/gn_conv.cu",
    "group_norm_silu": f"{PKG}/csrc/groupnorm.cu",
    "qkv_attention": f"{PKG}/csrc/attention.cu",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def sync_time(torch, fn, min_ms=50.0, max_reps=200):
    """Mean ms per call of ``fn`` by CUDA events, after warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    reps = int(min(max_reps, max(10, min_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Ops:
    """The three ops as the model modules see them, with a context manager
    that swaps them for recorders or for the plain versions."""

    def __init__(self):
        import importlib

        self.unet = importlib.import_module(f"{PKG}.models.unet")
        self.layers = importlib.import_module(f"{PKG}.models.layers")
        self.ops = importlib.import_module(f"{PKG}.ops")
        # (module, attribute) -> kernel name
        self.sites = {(self.unet, "gn_silu_conv3x3"): "gn_silu_conv3x3",
                      (self.unet, "qkv_attention"): "qkv_attention",
                      (self.layers, "group_norm_silu"): "group_norm_silu"}
        self.wrappers = {name: getattr(self.ops, name) for name in PER_FORWARD}
        self.plain = {name: getattr(self.ops, name + "_plain") for name in PER_FORWARD}

    def reset(self):
        for fn in self.wrappers.values():
            fn.launches = 0

    def counts(self):
        return {name: fn.launches for name, fn in self.wrappers.items()}

    @contextlib.contextmanager
    def swapped(self, make):
        saved = {site: getattr(*site) for site in self.sites}
        try:
            for site, name in self.sites.items():
                setattr(*site, make(name))
            yield
        finally:
            for site, fn in saved.items():
                setattr(*site, fn)

    def plain_versions(self):
        return self.swapped(lambda name: self.plain[name])

    def recording(self, log):
        """Record the first call of each distinct signature (its arguments,
        cloned) and count the calls of each."""
        def make(name):
            real = self.wrappers[name]

            def rec(*args, **kwargs):
                key = (name,) + tuple(
                    (tuple(a.shape), str(a.dtype)) if hasattr(a, "shape") else a
                    for a in args) + tuple(sorted(kwargs.items()))
                entry = log.setdefault(key, {"name": name, "count": 0, "args": None,
                                             "kwargs": kwargs})
                entry["count"] += 1
                if entry["args"] is None:
                    entry["args"] = [a.clone() if hasattr(a, "clone") else a for a in args]
                return real(*args, **kwargs)
            return rec
        return self.swapped(make)


def work(name, args, kwargs):
    """(bytes, flops, dtype name) the function needs: each input read once,
    each output written once."""
    x = args[0]
    dtype = str(x.dtype).replace("torch.", "")
    s = x.element_size()
    if name == "gn_silu_conv3x3":
        _, a, off, w, bias = args
        b, h, wd, cin = x.shape
        cout = w.shape[2]
        nbytes = (x.numel() * s + (a.numel() + off.numel()) * 4 + w.numel() * s
                  + cout * 4 + b * h * wd * cout * s)
        return nbytes, 2.0 * b * h * wd * 9 * cin * cout, dtype
    if name == "qkv_attention":
        heads = args[1]
        b, t, c3 = x.shape
        ch = c3 // (3 * heads)
        return x.numel() * s * 4 / 3, 4.0 * b * heads * t * t * ch, dtype
    # group_norm_silu: x in, y out, affine; ~8 flops per element
    c = x.shape[-1]
    return 2 * x.numel() * s + 2 * c * 4, 8.0 * x.numel(), dtype


def library_call(torch, F, name, args, kwargs):
    """One PyTorch call computing the same function (the conv alone on the
    pre-activated input for the fused conv), or None."""
    x = args[0]
    if name == "qkv_attention":
        heads = args[1]
        b, t, c3 = x.shape
        ch = c3 // (3 * heads)
        qkv = x.view(b, t, heads, 3 * ch).permute(0, 2, 1, 3)
        q, k, v = qkv[..., :ch], qkv[..., ch:2 * ch], qkv[..., 2 * ch:]
        return lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0 / ch ** 0.5)
    if name == "group_norm_silu":
        gamma, beta, groups = args[1].to(x.dtype), args[2].to(x.dtype), args[3]
        xc = x.reshape(x.shape[0], -1, x.shape[-1]).permute(0, 2, 1)
        return lambda: F.group_norm(xc, groups, gamma, beta, 1e-5)
    _, a, off, w, bias = args
    y = x.float() * a[:, None, None, :] + off[:, None, None, :]
    y = (y * torch.sigmoid(y)).to(x.dtype).permute(0, 3, 1, 2)
    w_oihw = w.to(x.dtype).permute(2, 3, 0, 1).contiguous(memory_format=torch.channels_last)
    b = bias.to(x.dtype)
    return lambda: F.conv2d(y, w_oihw, b, padding=1)


def profile_forward(torch, forward, top=12):
    """Device time of one forward by CUDA kernel name (torch.profiler), the
    idle share of the profiled forward's wall time (the profiler's own host
    cost included), and the heaviest kernels; ``all`` lists every kernel."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        forward()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t_start = time.perf_counter()
            forward()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t_start) * 1e3
    kernels = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0 and getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            kernels.append((us / 1e3, ev.count, ev.key))
    kernels.sort(reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    listed = [{"ms": ms, "calls": n, "name": name} for ms, n, name in kernels]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
            "top": [dict(k, name=k["name"][:90]) for k in listed[:top]], "all": listed}


def fill_zero_params(torch, model, seed):
    """Fill every all-zero parameter (the zero-init convs, the GN biases)
    from a seeded normal, so every branch of the model counts."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            if not p.any():
                p.copy_(0.02 * torch.randn(p.shape, generator=gen))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=pathlib.Path, default=None,
                        help="directory for the per-shape measurements and the build log")
    args = parser.parse_args(argv)

    if not (ROOT / PKG).is_dir():
        print(f"{PKG}/ is not beside chip_smoke.py", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py measures the port on a card", file=sys.stderr)
        return 1
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)

    # 1. device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "kind": kind, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. build
    from probabilisticdeepdiffusionmodels_torch.ops import _build
    t0 = time.perf_counter()
    _build.lib()
    build_s = time.perf_counter() - t0
    emit({"phase": "build", "seconds": build_s, "library": str(_build.library_path)})
    if args.out is not None:
        log = _build.library_path.with_suffix(".log")
        if log.exists():
            (args.out / "nvcc.log").write_text(log.read_text())

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    from probabilisticdeepdiffusionmodels_torch.core import DiffusionTables, NoiseSchedule
    from probabilisticdeepdiffusionmodels_torch.models import get_model
    from probabilisticdeepdiffusionmodels_torch.sample import (
        p_sample_loop,
        respaced_schedule,
        space_timesteps,
    )

    ops = Ops()
    model = get_model(RESOLUTION, MODEL_CFG, device="cuda", seed=0)
    fill_zero_params(torch, model, seed=1)
    gen = torch.Generator(device="cuda").manual_seed(2)

    # 3. kernels, at the shapes one batch-128 bf16 forward gives them
    x128 = torch.randn(FORWARD_BATCH, RESOLUTION, RESOLUTION, 3, device="cuda",
                       generator=gen)
    t128 = torch.randint(1, 1001, (FORWARD_BATCH,), device="cuda", generator=gen)
    calls = {}
    with torch.no_grad(), ops.recording(calls):
        model(x128, t128)
    torch.cuda.synchronize()
    per_site, summary = [], {}
    for entry in calls.values():
        name, a, kw, n = entry["name"], entry["args"], entry["kwargs"], entry["count"]
        kernel = ops.wrappers[name]
        with torch.no_grad():
            out = kernel(*a, **kw)
            torch.cuda.synchronize()
            ref = ops.plain[name](*a, **kw)
            err = float((out.float() - ref.float()).abs().max())
            scale = max(1.0, float(ref.float().abs().max()))
            tol = (2e-2 if a[0].dtype == torch.bfloat16 else 1e-4) * scale
            ms = sync_time(torch, lambda: kernel(*a, **kw))
            plain_ms = sync_time(torch, lambda: ops.plain[name](*a, **kw))
            lib_ms = sync_time(torch, library_call(torch, F, name, a, kw))
        nbytes, flops, dtype = work(name, a, kw)
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        site = {"kernel": name, "shape": [list(t.shape) for t in a if hasattr(t, "shape")][0],
                "dtype": dtype, "calls_per_forward": n, "max_abs_err": err, "tol": tol,
                "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        per_site.append(site)
        emit(dict(phase="kernel_site", **site))
        if not err <= tol:
            raise AssertionError(f"{name} {site['shape']} {dtype}: kernel vs plain "
                                 f"max abs err {err} > {tol}")
        s = summary.setdefault(name, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                                          library_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
                                          bound_ms=0.0, calls=0))
        s["max_abs_err"] = max(s["max_abs_err"], err)
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                         ("bytes_ms", t_bytes), ("ops_ms", t_ops),
                         ("bound_ms", max(t_bytes, t_ops))):
            s[key] += n * val
        s["calls"] += n
    for name, n in PER_FORWARD.items():
        if summary.get(name, {}).get("calls") != n:
            raise AssertionError(f"{name}: {summary.get(name, {}).get('calls')} calls per "
                                 f"forward, expected {n}")
    del calls

    # 4. main path: 20-step sampler, bf16, batch 32, on the kernels
    sched, tmap = respaced_schedule(NoiseSchedule.create(1000, "linear"),
                                    space_timesteps(1000, STEPS))
    tables = DiffusionTables.from_schedule(sched, "cuda")
    tmap = torch.as_tensor(tmap, device="cuda").long()
    x_T = torch.randn(CHAIN_BATCH, RESOLUTION, RESOLUTION, 3, device="cuda", generator=gen)
    noise = torch.randn((STEPS,) + tuple(x_T.shape), device="cuda", generator=gen)

    def chain(m, **kw):
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        out = p_sample_loop(m, tables, x_T, clip=True, timestep_map=tmap, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t_start

    ops.reset()
    x0, chain_s = chain(model, generator=torch.Generator(device="cuda").manual_seed(3))
    launches = ops.counts()
    expected = {name: STEPS * n for name, n in PER_FORWARD.items()}
    if launches != expected:
        raise AssertionError(f"launches {launches} != {expected}")
    if x0.shape != x_T.shape or not bool(torch.isfinite(x0).all()):
        raise AssertionError("bf16 chain output is not finite or has the wrong shape")
    _, chain_s2 = chain(model, generator=torch.Generator(device="cuda").manual_seed(3))
    emit({"phase": "sampler_bf16", "steps": STEPS, "batch": CHAIN_BATCH,
          "launches": launches, "seconds_first": chain_s, "seconds": chain_s2,
          "img_per_s": CHAIN_BATCH / chain_s2, "x0_abs_mean": float(x0.abs().mean())})

    # float32: kernels against plain versions, same weights and noise
    model32 = get_model(RESOLUTION, dict(MODEL_CFG, compute_dtype="float32"),
                        device="cuda", seed=0)
    model32.load_state_dict(model.state_dict())
    ops.reset()
    x0_k, _ = chain(model32, noise=noise)
    launches32 = ops.counts()
    if launches32 != expected:
        raise AssertionError(f"float32 launches {launches32} != {expected}")
    with ops.plain_versions():
        x0_p, _ = chain(model32, noise=noise)
    if ops.counts() != launches32:
        raise AssertionError("the plain-version run launched a kernel")
    diff = float((x0_k - x0_p).abs().max())
    emit({"phase": "sampler_f32_vs_plain", "max_abs_diff": diff, "tol": F32_CHAIN_TOL,
          "finite": bool(torch.isfinite(x0_k).all())})
    if not diff <= F32_CHAIN_TOL:
        raise AssertionError(f"float32 chain: kernels vs plain differ by {diff}")
    del model32

    # one timed bf16 forward at batch 128
    with torch.no_grad():
        fwd_ms = sync_time(torch, lambda: model(x128, t128), min_ms=200.0, max_reps=20)
    kernel_ms = sum(s["ms"] for s in summary.values())
    emit({"phase": "forward_bf16", "batch": FORWARD_BATCH, "ms": fwd_ms,
          "kernel_ms_sum": kernel_ms})
    prof = profile_forward(torch, lambda: model(x128, t128))
    all_kernels = prof.pop("all")
    # the device's idle share of the unprofiled forward: its CUDA-event time
    # against the device time the profiler summed
    prof["idle_share_unprofiled"] = 1.0 - prof["device_busy_ms"] / fwd_ms
    emit(dict(phase="forward_bf16_profile", **prof))

    # the headline metric: the 250-step bench.py chain, bf16, batch 128
    sched250, tmap250 = respaced_schedule(NoiseSchedule.create(1000, "linear"),
                                          space_timesteps(1000, BENCH_STEPS))
    tables250 = DiffusionTables.from_schedule(sched250, "cuda")
    tmap250 = torch.as_tensor(tmap250, device="cuda").long()
    bench_s = []
    for rep in range(BENCH_REPEATS):
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        x0_250 = p_sample_loop(model, tables250, x128,
                               torch.Generator(device="cuda").manual_seed(4 + rep),
                               clip=True, timestep_map=tmap250)
        torch.cuda.synchronize()
        bench_s.append(time.perf_counter() - t_start)
        if not bool(torch.isfinite(x0_250).all()):
            raise AssertionError("250-step chain output is not finite")
    emit({"phase": "sampler_250_bf16", "steps": BENCH_STEPS, "batch": FORWARD_BATCH,
          "seconds": bench_s, "img_per_s": [FORWARD_BATCH / s for s in bench_s]})

    if args.out is not None:
        (args.out / "chip_smoke_sites.json").write_text(json.dumps(
            {"nvidia_smi": smi, "sites": per_site, "forward_bf16_profile": all_kernels},
            indent=1))

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": s["max_abs_err"], "ms": s["ms"],
         "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
         "bound_by": "bytes" if s["bytes_ms"] >= s["ops_ms"] else "operations",
         "library_ms": s["library_ms"]}
        for name, s in summary.items()]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
