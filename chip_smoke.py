"""Drive the PyTorch port on one CUDA card, end to end.

    python3 chip_smoke.py [--out DIR]

1. device: the card's name and count, and nvidia-smi's name and power limit;
2. build: compiles the CUDA kernels from ``probabilisticdeepdiffusionmodels_torch/csrc``;
3. kernels: records every call of the three kernels in one batch-128 bf16
   forward of the full-width CIFAR-10 UNet (``config/model/unet.yaml``, as
   ``bench.py`` builds it), then for each distinct shape holds the kernel
   against its plain PyTorch version on the recorded inputs and times the
   kernel, the plain version and one PyTorch library call that computes
   the same function, beside the least time the card needs for the work,
   and names the kernel design that ran at that site;
4. main path: the 20-step ancestral sampler (linear T=1000 respaced to 20,
   clip=True) through ``get_model`` and ``p_sample_loop``: bf16 at batch 32
   with the launch counts asserted, float32 on the kernels against float32
   on the plain versions with the same weights and noise, one timed bf16
   forward at batch 128 with its device profile, and the 250-step chain of
   ``bench.py`` (bf16, batch 128) three times in a row, whose img/s is the
   sampler's headline metric;
5. the probe: ``ops/probe_mma.py``'s entry point for float32 and bf16, its
   kernel held against its plain version and timed beside ``torch.matmul``;
6. training: float32 gradients of one eps-MSE loss with the kernels against
   the same loss on the plain versions (batch cut to 8); the train step of
   ``scripts/bench_train.py`` (bf16, batch 128, Adam 2e-4, EMA 0.9999,
   uniform t) timed over two passes of 10 steps with the launch counts
   asserted, its forward / backward / update split and a device profile;
   and a few importance-sampled steps on a warmed-up history;
7. a second model: one bf16 forward of ``unet_celebahq64`` at 64x64 (head
   widths 96 and 128, FiLM conditioning) at batch 8 on the kernels, with
   the launch counts asserted, against the same model on the plain versions.

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
import math
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
# config/model/unet_celebahq64.yaml of the JAX package, in bf16
CELEBAHQ64_CFG = dict(name="unet", in_channels=3, model_channels=128, num_res_blocks=2,
                      attention_resolutions=[16, 8], channel_mult=[1, 2, 3, 4], num_heads=4,
                      use_scale_shift_norm=True, compute_dtype="bfloat16")
CELEBAHQ64_RES, CELEBAHQ64_BATCH = 64, 8
# a bf16 forward on the kernels against the plain versions: each op rounds
# to bf16 in its own order, and the differences pass through ~60 layers
BF16_FORWARD_TOL = 5e-2
STEPS = 20
BENCH_STEPS = 250      # bench.py's headline chain
BENCH_REPEATS = 3      # chains timed in a row, each reported, for the spread
CHAIN_BATCH = 32
FORWARD_BATCH = 128
PER_FORWARD = {"gn_silu_conv3x3": 61, "qkv_attention": 15, "group_norm_silu": 15}
F32_CHAIN_TOL = 1e-3   # kernels vs plain, float32, after 20 steps (sums in another order)
GRAD_BATCH = 8         # float32 gradient check at full width, batch cut from 128
# float32 gradients, kernels vs plain: the forward sums run in another order,
# the backward code is the same on both sides
F32_GRAD_TOL = 1e-3
# the conv's backward recompute on bf16 operands against the float32 plain
# version's: both round each gradient to bf16 once; the float32 sums differ
RECOMPUTE_TOL = 1e-2
TRAIN_BATCH = 128      # scripts/bench_train.py's first batch size
TRAIN_WARMUP, TRAIN_STEPS, TRAIN_PASSES = 3, 10, 2
IMPORTANCE_STEPS = 3

# H100 SXM published peaks (NVIDIA data sheet), dense
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

REPLACES = {
    "gn_silu_conv3x3": "probabilisticdeepdiffusionmodels_tpu/ops/gn_conv_pallas.py:180",
    "group_norm_silu": "probabilisticdeepdiffusionmodels_tpu/ops/groupnorm_pallas.py:112",
    "qkv_attention": "probabilisticdeepdiffusionmodels_tpu/ops/attention_pallas.py:67",
    "probe_mma": "scripts/probe_mosaic_bf16.py:21",
}
SOURCES = {
    "gn_silu_conv3x3": f"{PKG}/csrc/gn_conv.cu",
    "group_norm_silu": f"{PKG}/csrc/groupnorm.cu",
    "qkv_attention": f"{PKG}/csrc/attention.cu",
    "probe_mma": f"{PKG}/csrc/probe_mma.cu",
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


def design(ops, name, args):
    """The kernel design a call with these arguments runs."""
    x = args[0]
    if name == "gn_silu_conv3x3":
        return ops.ops.conv_design(x, args[3].to(x.dtype).contiguous())
    if name == "qkv_attention":
        return ops.ops.attention_design(x)
    return "block_per_group"


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


def recompute_check(torch, gn_conv, args):
    """The fused conv's backward at one bf16 site: the largest difference,
    relative to each gradient's largest element, between the gradients of
    the bf16-operand recompute the kernel's backward runs and those of the
    float32 plain version, and the ms of each (recompute + autograd.grad)."""
    x, a, off, w, bias = args
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (x, a, off, w.to(x.dtype), bias)]
    gen = torch.Generator(device="cuda").manual_seed(9)
    g = torch.randn(x.shape[:3] + (w.shape[2],), device="cuda", generator=gen).to(x.dtype)

    def grads(fn):
        return torch.autograd.grad(fn(*leaves), leaves, g)

    want = grads(gn_conv.gn_silu_conv3x3_plain)
    got = grads(gn_conv._grad_reference)
    err = max(float((p.float() - q.float()).abs().max()) / max(1e-30, float(q.float().abs().max()))
              for p, q in zip(got, want))
    return {"max_rel_err": err, "tol": RECOMPUTE_TOL,
            "bf16_recompute_ms": sync_time(torch, lambda: grads(gn_conv._grad_reference)),
            "f32_recompute_ms": sync_time(torch, lambda: grads(gn_conv.gn_silu_conv3x3_plain))}


def profile_device(torch, fn, top=12):
    """Device time of one call of ``fn`` by CUDA kernel name
    (torch.profiler), the idle share of the profiled call's wall time (the
    profiler's own host cost included), and the heaviest kernels; ``all``
    lists every kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t_start) * 1e3
    kernels = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        # user annotations (``Optimizer.step#Adam.step``) span kernels that
        # are counted on their own
        if (us > 0 and getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)):
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


def probe_phase(torch):
    """Drive ``ops/probe_mma.py``'s entry point for both dtypes with the
    count at 0, then hold each kernel against its plain version and time it
    beside ``torch.matmul``; returns the kernel's summary (times summed over
    the two dtypes, as the entry point runs both)."""
    import importlib

    probe = importlib.import_module(f"{PKG}.ops.probe_mma")
    dtypes = (torch.float32, torch.bfloat16)
    operands = {dt: probe.random_operands(dt, "cuda") for dt in dtypes}
    probe.probe_mma.launches = 0
    outs = {dt: probe.try_dtype(dt, *operands[dt]) for dt in dtypes}
    torch.cuda.synchronize()
    launched = probe.probe_mma.launches
    if launched != len(dtypes):
        raise AssertionError(f"probe: {launched} launches for {len(dtypes)} dtypes")
    s = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, bytes_ms=0.0,
             ops_ms=0.0, bound_ms=0.0, launches=launched)
    rows = []
    for dt in dtypes:
        a, b = operands[dt]
        ref = probe.probe_mma_plain(a, b)
        err = float((outs[dt] - ref).abs().max())
        tol = probe.TOL * float(ref.abs().max())
        dtype = str(dt).replace("torch.", "")
        t_bytes = (2 * a.numel() * a.element_size() + ref.numel() * 4) / PEAK_BYTES * 1e3
        t_ops = 2.0 * probe.SIZE ** 3 / PEAK_FLOPS[dtype] * 1e3
        row = {"dtype": dtype, "max_abs_err": err, "tol": tol,
               "ms": sync_time(torch, lambda: probe.probe_mma(a, b)),
               "plain_ms": sync_time(torch, lambda: probe.probe_mma_plain(a, b)),
               "library_ms": sync_time(torch, lambda: torch.matmul(a, b)),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        rows.append(row)
        if not err <= tol:
            raise AssertionError(f"probe {dtype}: kernel vs plain max abs err {err} > {tol}")
        s["max_abs_err"] = max(s["max_abs_err"], err)
        for key, val in (("ms", row["ms"]), ("plain_ms", row["plain_ms"]),
                         ("library_ms", row["library_ms"]), ("bytes_ms", t_bytes),
                         ("ops_ms", t_ops), ("bound_ms", row["bound_ms"])):
            s[key] += val
    emit({"phase": "probe_mma", "launches": launched, "dtypes": rows})
    return s


def train_phases(torch, ops, model, gen):
    """The training phases; returns the train step's kernel launches per
    pass and its device profile by kernel name."""
    from probabilisticdeepdiffusionmodels_torch.core import (
        DiffusionTables,
        NoiseSchedule,
        mean_flat,
        q_sample,
    )
    from probabilisticdeepdiffusionmodels_torch.engine import AdamChain
    from probabilisticdeepdiffusionmodels_torch.models import get_model
    from probabilisticdeepdiffusionmodels_torch.train import (
        TrainState,
        make_train_step,
        sample_importance,
        sample_uniform,
    )

    tables = DiffusionTables.from_schedule(NoiseSchedule.create(1000, "linear"), "cuda")

    # float32 gradients: kernels against plain versions, one loss, same
    # x0, t and noise, the sampler model's weights (zero-init points filled)
    model32 = get_model(RESOLUTION, dict(MODEL_CFG, compute_dtype="float32"),
                        device="cuda", seed=0)
    model32.load_state_dict(model.state_dict())
    model32.train()
    xg = torch.randn(GRAD_BATCH, RESOLUTION, RESOLUTION, 3, device="cuda", generator=gen)
    tg = torch.randint(1, 1001, (GRAD_BATCH,), device="cuda", generator=gen)
    ng = torch.randn(xg.shape, device="cuda", generator=gen)

    def loss_and_grads():
        model32.zero_grad(set_to_none=True)
        out = model32(q_sample(tables, xg, ng, tg), tg)
        loss = mean_flat((ng - out) ** 2).mean()
        loss.backward()
        return out, loss, {n: p.grad.detach().clone() for n, p in model32.named_parameters()}

    ops.reset()
    out_k, loss_k, g_k = loss_and_grads()
    if out_k.grad_fn is None:
        raise AssertionError("model(x, t) on CUDA has no grad_fn")
    if ops.counts() != PER_FORWARD:
        raise AssertionError(f"float32 loss launches {ops.counts()} != {PER_FORWARD}")
    with ops.plain_versions():
        _, loss_p, g_p = loss_and_grads()
    worst, worst_name = 0.0, None
    for name, gp in g_p.items():
        rel = float((g_k[name] - gp).abs().max()) / max(1e-6, float(gp.abs().max()))
        if rel >= worst:
            worst, worst_name = rel, name
    zero = [name for name, gp in g_p.items() if not gp.any()]
    emit({"phase": "train_grads_f32_vs_plain", "batch": GRAD_BATCH,
          "batch_cut_from": TRAIN_BATCH, "params": len(g_p), "loss_kernels": float(loss_k.detach()),
          "loss_plain": float(loss_p.detach()), "max_rel_err": worst, "worst_param": worst_name,
          "tol": F32_GRAD_TOL, "all_zero_grads": zero})
    if not worst <= F32_GRAD_TOL or zero:
        raise AssertionError(f"float32 gradients: kernels vs plain {worst} at {worst_name} "
                             f"(tol {F32_GRAD_TOL}); all-zero gradients: {zero}")
    del model32, g_k, g_p, out_k

    # the bf16 train step of scripts/bench_train.py at batch 128
    tmodel = get_model(RESOLUTION, MODEL_CFG, device="cuda", seed=0)
    state = TrainState(tmodel, AdamChain(tmodel.parameters(), 2e-4), 1000,
                       torch.Generator(device="cuda").manual_seed(5), ema_decay=0.9999)
    step = make_train_step(tables)
    xb = torch.randn(TRAIN_BATCH, RESOLUTION, RESOLUTION, 3, device="cuda", generator=gen)
    for _ in range(TRAIN_WARMUP):
        step(state, xb)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    passes, expected = [], {n: TRAIN_STEPS * c for n, c in PER_FORWARD.items()}
    for _ in range(TRAIN_PASSES):
        ops.reset()
        t_start = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            metrics = step(state, xb)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t_start
        if ops.counts() != expected:
            raise AssertionError(f"train step launches {ops.counts()} != {expected}")
        passes.append({"ms_per_step": seconds / TRAIN_STEPS * 1e3,
                       "img_per_s": TRAIN_BATCH * TRAIN_STEPS / seconds})
    train_launches = ops.counts()
    peak = torch.cuda.max_memory_allocated()
    loss, grad_norm = float(metrics["loss"]), float(metrics["grad_norm"])
    if not (math.isfinite(loss) and math.isfinite(grad_norm)):
        raise AssertionError(f"train step: loss {loss}, grad_norm {grad_norm}")

    # one step by parts, as make_train_step runs it, with CUDA events between
    t, _ = sample_uniform(state.generator, TRAIN_BATCH, 1000)
    noise = torch.randn(xb.shape, generator=state.generator, device="cuda")
    x_t = q_sample(tables, xb, noise, t)
    tmodel.train()
    tmodel.zero_grad(set_to_none=True)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ops.reset()
    events[0].record()
    per_sample = mean_flat(torch.square(noise - tmodel(x_t, t)))
    loss_part = per_sample.mean()
    events[1].record()
    fwd_counts = ops.counts()
    loss_part.backward()
    events[2].record()
    bwd_counts = ops.counts()
    state.loss_history.update(t, per_sample.detach())
    events[3].record()
    state.apply_gradients()
    events[4].record()
    torch.cuda.synchronize()
    if fwd_counts != PER_FORWARD or bwd_counts != fwd_counts:
        raise AssertionError(f"one step: forward launched {fwd_counts}, backward added "
                             f"{ {n: bwd_counts[n] - fwd_counts[n] for n in PER_FORWARD} }")
    split = {name: events[i].elapsed_time(events[i + 1]) for i, name in
             enumerate(("forward_ms", "backward_ms", "history_ms", "optimizer_ema_ms"))}
    prof = profile_device(torch, lambda: step(state, xb), top=15)
    all_kernels = prof.pop("all")
    syncs = [k for k in all_kernels if "DtoH" in k["name"]]
    if syncs:
        raise AssertionError(f"the train step copies to the host: {syncs}")
    emit({"phase": "train_step_bf16", "batch": TRAIN_BATCH, "steps_per_pass": TRAIN_STEPS,
          "warmup_steps": TRAIN_WARMUP, "passes": passes, "launches_per_pass": train_launches,
          "split_one_step": split, "max_memory_allocated_bytes": peak, "loss": loss,
          "grad_norm": grad_norm, "profile": prof})

    # importance sampling on a history warmed past min_counts through update
    min_counts = 10
    steps_t = torch.arange(1, 1001, device="cuda")
    for _ in range(min_counts):
        losses = 0.02 + steps_t.float() / 1000 + 0.01 * torch.rand(1000, device="cuda",
                                                                    generator=gen)
        state.loss_history.update(steps_t, losses)
    if not bool(state.loss_history.is_warmed_up(min_counts)):
        raise AssertionError("the loss history did not warm up")
    _, weights = sample_importance(torch.Generator(device="cuda").manual_seed(6),
                                   TRAIN_BATCH, state.loss_history, min_counts)
    uniform_w = bool(torch.all(weights == 1.0 / TRAIN_BATCH))
    imp_step = make_train_step(tables, sampling="importance", min_counts=min_counts)
    losses = []
    ops.reset()
    for _ in range(IMPORTANCE_STEPS):
        losses.append(float(imp_step(state, xb)["loss"]))
    imp_expected = {n: IMPORTANCE_STEPS * c for n, c in PER_FORWARD.items()}
    emit({"phase": "train_step_importance", "steps": IMPORTANCE_STEPS, "losses": losses,
          "weights_min": float(weights.min()), "weights_max": float(weights.max()),
          "launches": ops.counts()})
    if uniform_w or not all(math.isfinite(v) for v in losses) or ops.counts() != imp_expected:
        raise AssertionError(f"importance steps: weights all 1/B {uniform_w}, losses "
                             f"{losses}, launches {ops.counts()}")
    return train_launches, all_kernels


def celeba_phase(torch, ops):
    """One bf16 forward of unet_celebahq64 at 64x64 on the kernels, with one
    launch per fused conv, attention and attention norm, against the same
    model and inputs on the plain versions."""
    from probabilisticdeepdiffusionmodels_torch.models import get_model, unet

    model = get_model(CELEBAHQ64_RES, CELEBAHQ64_CFG, device="cuda", seed=7)
    fill_zero_params(torch, model, seed=8)
    n_res = sum(isinstance(m, unet.ResBlock) for m in model.modules())
    n_attn = sum(isinstance(m, unet.AttentionBlock) for m in model.modules())
    expected = {"gn_silu_conv3x3": 2 * n_res + 1, "qkv_attention": n_attn,
                "group_norm_silu": n_attn}
    gen = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn(CELEBAHQ64_BATCH, CELEBAHQ64_RES, CELEBAHQ64_RES, 3, device="cuda",
                    generator=gen)
    t = torch.randint(1, 1001, (CELEBAHQ64_BATCH,), device="cuda", generator=gen)
    with torch.no_grad():
        ops.reset()
        out = model(x, t)
        torch.cuda.synchronize()
        launches = ops.counts()
        with ops.plain_versions():
            ref = model(x, t)
    diff = float((out.float() - ref.float()).abs().max())
    scale = max(1.0, float(ref.float().abs().max()))
    heads = sorted({m.qkv.weight.shape[0] // 3 // m.num_heads for m in model.modules()
                    if isinstance(m, unet.AttentionBlock)})
    emit({"phase": "unet_celebahq64_bf16_vs_plain", "batch": CELEBAHQ64_BATCH,
          "resolution": CELEBAHQ64_RES, "head_widths": heads, "launches": launches,
          "max_abs_diff": diff, "ref_abs_max": scale, "tol": BF16_FORWARD_TOL * scale,
          "finite": bool(torch.isfinite(out).all())})
    if launches != expected:
        raise AssertionError(f"unet_celebahq64 launches {launches} != {expected}")
    if out.shape != x.shape or not bool(torch.isfinite(out).all()):
        raise AssertionError("unet_celebahq64: output not finite or of the wrong shape")
    if not diff <= BF16_FORWARD_TOL * scale:
        raise AssertionError(f"unet_celebahq64: kernels vs plain differ by {diff}")


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
                "design": design(ops, name, a), "dtype": dtype, "calls_per_forward": n, "max_abs_err": err, "tol": tol,
                "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        if name == "gn_silu_conv3x3" and dtype == "bfloat16":
            site["grad_recompute"] = recompute_check(torch, ops.ops.gn_conv, a)
        per_site.append(site)
        emit(dict(phase="kernel_site", **site))
        if not err <= tol:
            raise AssertionError(f"{name} {site['shape']} {dtype}: kernel vs plain "
                                 f"max abs err {err} > {tol}")
        rc = site.get("grad_recompute")
        if rc and not rc["max_rel_err"] <= RECOMPUTE_TOL:
            raise AssertionError(f"{name} {site['shape']}: bf16 backward recompute vs "
                                 f"float32 differs by {rc['max_rel_err']} of the gradient")
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
    def forward128():
        with torch.no_grad():
            model(x128, t128)

    prof = profile_device(torch, forward128)
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
    del tables250, x0_250

    # 5. the probe's entry point, float32 and bf16
    summary["probe_mma"] = probe_phase(torch)

    # 6. training
    train_launches, train_profile = train_phases(torch, ops, model, gen)

    # 7. unet_celebahq64, bf16, kernels against plain versions
    celeba_phase(torch, ops)

    if args.out is not None:
        (args.out / "chip_smoke_sites.json").write_text(json.dumps(
            {"nvidia_smi": smi, "sites": per_site, "forward_bf16_profile": all_kernels,
             "train_step_bf16_profile": train_profile}, indent=1))

    # each kernel's main path: the sampler for the UNet's three, the probe's
    # entry point for the probe; the train step's launches beside them
    main_launches = dict(launches, probe_mma=summary["probe_mma"].pop("launches"))
    by_path = {name: {"sampler_bf16": launches[name], "train_step_bf16": train_launches[name]}
               for name in PER_FORWARD}
    by_path["probe_mma"] = {"probe": main_launches["probe_mma"]}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
         "launches": main_launches[name], "launches_by_path": by_path[name],
         "max_abs_err": s["max_abs_err"], "ms": s["ms"],
         "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
         "bound_by": "bytes" if s["bytes_ms"] >= s["ops_ms"] else "operations",
         "library_ms": s["library_ms"]}
        for name, s in summary.items()]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
