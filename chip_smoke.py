"""Drive the PyTorch port on one CUDA card, end to end.

    python3 chip_smoke.py [--out DIR]

1. device: the card's name and count, and nvidia-smi's name and power limit;
2. build: compiles the CUDA kernels from ``probabilisticdeepdiffusionmodels_torch/csrc``;
3. kernels: records every call of the forward's four kernels (the folded
   GroupNorm affine ``gn_affine``, the fused conv, GroupNorm, attention) in
   one batch-128 bf16 forward of the full-width CIFAR-10 UNet
   (``config/model/unet.yaml``, as ``bench.py`` builds it), then for each
   distinct shape holds the kernel against its plain PyTorch version on the
   recorded inputs and times the kernel, the plain version and one PyTorch
   library call that computes the same function (for ``gn_affine``
   ``torch.var_mean`` over the spatial axis, the nearest single call), beside
   the least time the card needs for the work, and names the kernel design
   that ran at that site; ``gn_affine`` and GroupNorm are run twice and the
   two results compared bit for bit, GroupNorm is timed in both of its
   designs, and at each ``gn_affine`` site its backward kernels
   (``gn_affine_grad``) are held against autograd through the plain version;
4. main path: the 20-step ancestral sampler (linear T=1000 respaced to 20,
   clip=True) through ``get_model`` and ``p_sample_loop``: bf16 at batch 32
   with the launch counts asserted, float32 on the kernels against float32
   on the plain versions with the same weights and noise, one timed bf16
   forward at batch 128 with its device profile, and the 250-step chain of
   ``bench.py`` (bf16, batch 128) three times in a row, whose img/s is the
   sampler's headline metric;
5. the probe: ``ops/probe_mma.py``'s entry point for float32 and bf16, its
   kernel held against its plain version and timed beside ``torch.matmul``,
   and its device-only time from launches replayed out of one CUDA graph;
6. training: float32 gradients of one eps-MSE loss with the kernels against
   the same loss on the plain versions (batch cut to 8); the train step of
   ``scripts/bench_train.py`` (bf16, batch 128, Adam 2e-4, EMA 0.9999,
   uniform t) timed over two passes of 10 steps with the launch counts
   asserted (the backward's ``gn_affine_grad`` among them), its forward /
   backward / update split and a device profile;
   and a few importance-sampled steps on a warmed-up history;
7. a second model: one bf16 forward of ``unet_celebahq64`` at 64x64 (head
   widths 96 and 128, FiLM conditioning) at batch 8 on the kernels, with
   the launch counts asserted, against the same model on the plain versions,
   and ``gn_affine`` held against its plain version at each of its FiLM sites;
8. the command-line entry points at the CIFAR-10 UNet's full width (bf16,
   ``engine=cifar10``, ``data=synthetic`` with 1,280 images at batch 128):
   ``cli.train`` (10 steps, 10 validation batches, a checkpoint, the final
   NLL test at T=1000 on one batch), a ``cont_run`` resume (steps 10 to 20),
   ``cli.eval`` on the first run (equal to its ``final_test.json``) and
   ``cli.sample``'s 250-step grid of 4 (finite, in [-1, 1]), each with its
   launch counts asserted; each kernel against its plain version on the
   inputs the grid's first steps give it (batch 4, bf16, the run's weights);
   then the float32 NLL at T=50 and the float32 grid path at batch 4 on the
   kernels against the plain versions.

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
PER_FORWARD = {"gn_affine": 61, "gn_silu_conv3x3": 61, "qkv_attention": 15,
               "group_norm_silu": 15}
PER_BACKWARD = {"gn_affine_grad": 61}  # the one op whose backward is a kernel too


def expected_counts(steps, backward):
    """Launch counts of ``steps`` forwards, with or without their backwards."""
    return dict({n: steps * c for n, c in PER_FORWARD.items()},
                **{n: steps * c * int(backward) for n, c in PER_BACKWARD.items()})
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
# the cli phase: the port's CIFAR-10 config at full width in bf16, cut to one
# epoch of 10 steps on synthetic data (no dataset can be downloaded)
CLI_ARGS = ["model=unet", "model.compute_dtype=bfloat16", "engine=cifar10", "data=synthetic",
            "data.n=1280", "data.batch_size=128", "engine.ema=0.9999", "trainer.max_epochs=1",
            "trainer.check_val_every_n_epoch=1", "trainer.limit_test_batches=1",
            "visualization=none"]
NLL_T = 1000
EVAL_REL_TOL = 1e-6    # cli.eval against the train CLI's final test: same weights, batch, seed
GRID_STEPS, GRID_N = 250, 4
GRID_CHECK_STEPS = 10  # the grid path at batch GRID_N against the plain versions
NLL_CHECK_T, NLL_CHECK_BATCH = 50, 8
NLL_CHECK_TOL = 1e-4   # float32 NLL terms, kernels vs plain, of max(1, |ref|)
NLL_PROFILE_T = 10     # a profiled bf16 NLL batch: the per-t device work and idle share

# H100 SXM published peaks (NVIDIA data sheet), dense
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

REPLACES = {
    # the fold that XLA fuses into one pass before the fused conv: the one
    # entry that is no Pallas kernel in the JAX package
    "gn_affine": "probabilisticdeepdiffusionmodels_tpu/ops/gn_conv_pallas.py:41",
    # its gradient, which the JAX package takes by recomputing the fold in
    # XLA inside the fused op's custom VJP
    "gn_affine_grad": "probabilisticdeepdiffusionmodels_tpu/ops/gn_conv_pallas.py:238",
    "gn_silu_conv3x3": "probabilisticdeepdiffusionmodels_tpu/ops/gn_conv_pallas.py:180",
    "group_norm_silu": "probabilisticdeepdiffusionmodels_tpu/ops/groupnorm_pallas.py:112",
    "qkv_attention": "probabilisticdeepdiffusionmodels_tpu/ops/attention_pallas.py:67",
    "probe_mma": "scripts/probe_mosaic_bf16.py:21",
}
SOURCES = {
    "gn_affine": f"{PKG}/csrc/groupnorm.cu",
    "gn_affine_grad": f"{PKG}/csrc/groupnorm.cu",
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
    """The four ops as the model modules see them, with a context manager
    that swaps them for recorders or for the plain versions."""

    def __init__(self):
        import importlib

        self.unet = importlib.import_module(f"{PKG}.models.unet")
        self.layers = importlib.import_module(f"{PKG}.models.layers")
        self.ops = importlib.import_module(f"{PKG}.ops")
        # (module, attribute) -> kernel name
        self.sites = {(self.unet, "gn_affine"): "gn_affine",
                      (self.unet, "gn_silu_conv3x3"): "gn_silu_conv3x3",
                      (self.unet, "qkv_attention"): "qkv_attention",
                      (self.layers, "group_norm_silu"): "group_norm_silu"}
        self.wrappers = {name: getattr(self.ops, name) for name in (*PER_FORWARD, *PER_BACKWARD)}
        self.plain = {name: getattr(self.ops, name + "_plain") for name in self.wrappers}

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
        def describe(a):
            if hasattr(a, "shape"):
                return (tuple(a.shape), str(a.dtype))
            return tuple(map(describe, a)) if isinstance(a, tuple) else a

        def make(name):
            real = self.wrappers[name]

            def rec(*args, **kwargs):
                key = (name,) + tuple(map(describe, args)) + tuple(
                    (k, describe(v)) for k, v in sorted(kwargs.items()))
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
    if name == "gn_affine":
        # x in, (a, off) out, gamma/beta and the conditioning in; a sum, a
        # square and an add per element.  The flops run outside the tensor
        # cores, whatever x's dtype
        conds = [t for t in (kwargs.get("emb"), *(kwargs.get("film") or ())) if t is not None]
        b, c = x.shape[0], x.shape[-1]
        nbytes = (x.numel() * s + 2 * b * c * 4 + 2 * c * 4
                  + sum(t.numel() * t.element_size() for t in conds))
        return nbytes, 3.0 * x.numel(), "float32"
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
    if name == "gn_affine":
        b, n, c = ops.ops.groupnorm._shape(x)
        plan = ops.ops.groupnorm.moments_plan(b, n, c, x.element_size(), x.data_ptr())
        return f"moments_fold v{plan.v} cvb{plan.cvb} splits{plan.splits}"
    return ops.ops.groupnorm_design(x, args[3])


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
    if name == "gn_affine":
        # the nearest single call: the per-channel statistics alone
        xc = x.reshape(x.shape[0], -1, x.shape[-1])
        return lambda: torch.var_mean(xc, dim=1)
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


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def hold(torch, ops, name, a, kw):
    """The kernel and its plain version on one recorded call's inputs:
    (kernel outputs, plain outputs, max abs err, tolerance).  bf16 outputs:
    2e-2, float32 outputs: 1e-4, of max(1, max|ref|); the output furthest
    into its tolerance is reported."""
    with torch.no_grad():
        outs = as_tuple(ops.wrappers[name](*a, **kw))
        torch.cuda.synchronize()
        refs = as_tuple(ops.plain[name](*a, **kw))
    err, tol = 0.0, 1.0
    for out, ref in zip(outs, refs):
        e = float((out.float() - ref.float()).abs().max())
        t = ((2e-2 if ref.dtype == torch.bfloat16 else 1e-4)
             * max(1.0, float(ref.float().abs().max())))
        if not e <= t or e / t >= err / tol:
            err, tol = e, t
    return outs, refs, err, tol


def hold_sites(torch, ops, calls):
    """Each recorded call's kernel against its plain version, untimed; one
    entry per distinct call, raising where one is over its tolerance."""
    sites = []
    for entry in calls.values():
        name, a, kw = entry["name"], entry["args"], entry["kwargs"]
        _, _, err, tol = hold(torch, ops, name, a, kw)
        sites.append({"kernel": name, "shape": list(a[0].shape),
                      "dtype": str(a[0].dtype).replace("torch.", ""),
                      "design": design(ops, name, a), "calls": entry["count"],
                      "max_abs_err": err, "tol": tol})
    for site in sites:
        if not site["max_abs_err"] <= site["tol"]:
            raise AssertionError(f"{site['kernel']} {site['shape']} {site['dtype']}: kernel "
                                 f"vs plain max abs err {site['max_abs_err']} > {site['tol']}")
    return sites


def check_sites(torch, F, ops, calls, per_site, summary=None, only=None):
    """Hold each recorded call's kernel against its plain version on the
    recorded inputs, time both and the library call, and emit one
    ``kernel_site`` line; sums go into ``summary`` by kernel name."""
    for entry in calls.values():
        name, a, kw, n = entry["name"], entry["args"], entry["kwargs"], entry["count"]
        if only is not None and name not in only:
            continue
        kernel = ops.wrappers[name]
        nbytes, flops, dtype = work(name, a, kw)
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        outs, refs, err, tol = hold(torch, ops, name, a, kw)
        with torch.no_grad():
            ms = sync_time(torch, lambda: kernel(*a, **kw))
            plain_ms = sync_time(torch, lambda: ops.plain[name](*a, **kw))
            lib_ms = sync_time(torch, library_call(torch, F, name, a, kw))
        site = {"kernel": name, "shape": list(a[0].shape), "design": design(ops, name, a),
                "dtype": str(a[0].dtype).replace("torch.", ""), "calls_per_forward": n,
                "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        if name == "gn_affine":
            site["mode"] = ("emb" if kw.get("emb") is not None
                            else "film" if kw.get("film") is not None else "plain")
        if name in ("gn_affine", "group_norm_silu"):
            # no float atomics: a second run gives the same bits
            with torch.no_grad():
                again = as_tuple(kernel(*a, **kw))
            site["same_bits_twice"] = all(torch.equal(p, q) for p, q in zip(outs, again))
            # without the host's cost of a call, over copies of x that do
            # not fit the L2 cache together
            xs = cold_copies(a[0], nbytes)

            def round_of(run):
                def go():
                    for x in xs:
                        run(x)
                return go

            def device_ms(run):
                with torch.no_grad():
                    return graph_time(torch, round_of(run), max(1, 100 // len(xs)), 10) / len(xs)

            site["device_ms"] = device_ms(lambda x: kernel(x, *a[1:], **kw))
        if name == "group_norm_silu":
            gn = ops.ops.groupnorm
            gamma, beta = gn.check_inputs(name, *a[:4])
            rest = (a[3], kw.get("eps", 1e-5), kw.get("silu", True))
            site["design_ms"] = {}
            for d in sorted({site["design"], "split"}):
                with torch.no_grad():
                    got = gn._launch(a[0], gamma, beta, *rest, design=d)
                    d_err = float((got.float() - refs[0].float()).abs().max())
                    run = lambda x=a[0]: gn._launch(x, gamma, beta, *rest, design=d)
                    site["design_ms"][d] = {"ms": sync_time(torch, run),
                                            "device_ms": device_ms(run)}
                if not d_err <= tol:
                    raise AssertionError(f"{name} {site['shape']} design {d}: max abs err "
                                         f"{d_err} > {tol}")
        if name == "gn_silu_conv3x3" and site["dtype"] == "bfloat16":
            site["grad_recompute"] = recompute_check(torch, ops.ops.gn_conv, a)
        if name == "gn_affine":
            grad_site(torch, ops, a, kw, n, site, per_site, summary)
        per_site.append(site)
        emit(dict(phase="kernel_site", **site))
        if not err <= tol:
            raise AssertionError(f"{name} {site['shape']} {site['dtype']}: kernel vs plain "
                                 f"max abs err {err} > {tol}")
        if site.get("same_bits_twice") is False:
            raise AssertionError(f"{name} {site['shape']}: two runs differ in their bits")
        rc = site.get("grad_recompute")
        if rc and not rc["max_rel_err"] <= RECOMPUTE_TOL:
            raise AssertionError(f"{name} {site['shape']}: bf16 backward recompute vs "
                                 f"float32 differs by {rc['max_rel_err']} of the gradient")
        if summary is None:
            continue
        s = summary.setdefault(name, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                                          library_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
                                          bound_ms=0.0, calls=0))
        s["max_abs_err"] = max(s["max_abs_err"], err)
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                         ("bytes_ms", t_bytes), ("ops_ms", t_ops),
                         ("bound_ms", max(t_bytes, t_ops))):
            s[key] += n * val
        if "device_ms" in site:
            s["device_ms"] = s.get("device_ms", 0.0) + n * site["device_ms"]
        s["calls"] += n


def grad_site(torch, ops, a, kw, n, affine_site, per_site, summary):
    """``gn_affine``'s backward kernels at one recorded site, on seeded
    gradients of (a, off), against autograd through the plain version: each
    gradient within 2e-2 (bf16) or 1e-4 (float32: another formula and order
    of sums) of its reference's largest element."""
    gn_conv = ops.ops.gn_conv
    x = a[0]
    gen = torch.Generator(device="cuda").manual_seed(11)
    ga, goff = torch.randn(2, x.shape[0], x.shape[-1], device="cuda", generator=gen)
    with torch.no_grad():
        ao = ops.ops.groupnorm.moments_fold(*a, **kw)
        run = lambda: gn_conv.gn_affine_grad(*a, ga, goff, ao, **kw)
        got = run()
        torch.cuda.synchronize()
    ref = gn_conv.gn_affine_grad_plain(*a, ga, goff, **kw)
    err, tol = 0.0, 1.0
    for p, q in zip(got, ref):
        if p.dtype != q.dtype or p.shape != q.shape:
            raise AssertionError(f"gn_affine_grad: {p.dtype} {tuple(p.shape)} against "
                                 f"{q.dtype} {tuple(q.shape)}")
        e = float((p.float() - q.float()).abs().max())
        t = (2e-2 if q.dtype == torch.bfloat16 else 1e-4) * max(1e-30, float(q.float().abs().max()))
        if not e <= t or e / t >= err / tol:
            err, tol = e, t
    with torch.no_grad():
        ms = sync_time(torch, run)
    plain_ms = sync_time(torch, lambda: gn_conv.gn_affine_grad_plain(*a, ga, goff, **kw))
    # x read, dL/dx written, the (B, C)-sized rest; a multiply-add an element
    nbytes = 2 * x.numel() * x.element_size() + 14 * ga.numel() * 4
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, 2.0 * x.numel() / PEAK_FLOPS["float32"] * 1e3
    site = {"kernel": "gn_affine_grad", "shape": affine_site["shape"],
            "dtype": affine_site["dtype"], "mode": affine_site["mode"], "design": "fold_bwd+apply",
            "calls_per_forward": n, "max_abs_err": err, "tol": tol, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    per_site.append(site)
    emit(dict(phase="kernel_site", **site))
    if not err <= tol:
        raise AssertionError(f"gn_affine_grad {site['shape']} {site['mode']}: kernel vs plain "
                             f"max abs err {err} > {tol}")
    if summary is None:
        return
    s = summary.setdefault("gn_affine_grad", dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                                                  library_ms=None, bytes_ms=0.0, ops_ms=0.0,
                                                  bound_ms=0.0, calls=0))
    s["max_abs_err"] = max(s["max_abs_err"], err)
    for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bytes_ms", t_bytes),
                     ("ops_ms", t_ops), ("bound_ms", max(t_bytes, t_ops))):
        s[key] += n * val
    s["calls"] += n


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
            "device_ops": sum(k[1] for k in kernels),
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


def cold_copies(x, nbytes, total=200e6, most=64):
    """Clones of ``x``, enough that a round over them moves ``total`` bytes
    (several times the 50 MB L2 cache), at most ``most``: a kernel timed over
    the round finds little of its input in the cache."""
    return [x.clone() for _ in range(int(max(1, min(most, -(-total // nbytes)))))]


def graph_time(torch, fn, launches=100, replays=20):
    """Device-only ms per call of ``fn``: ``launches`` calls captured into
    one CUDA graph, replayed, by CUDA events over all of them (no host cost
    between the kernels)."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def wgmma_in_probe(library):
    """How many warpgroup matrix instructions (HGMMA in the card's own
    assembly) the built library holds in the probe's bf16 kernel, from
    ``cuobjdump -sass``; raises where the toolkit has no cuobjdump."""
    from probabilisticdeepdiffusionmodels_torch.ops import _build

    tool = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        raise RuntimeError(f"{tool} not found: the probe's wgmma instructions cannot be counted")
    sass = subprocess.run([str(tool), "-sass", str(library)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    count, inside = 0, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = "probe_bf16" in line
        elif inside and "HGMMA" in line:
            count += 1
    return count


def probe_phase(torch):
    """Drive ``ops/probe_mma.py``'s entry point for both dtypes with the
    count at 0, then hold each kernel against its plain version and time it
    beside ``torch.matmul``, with the host's launch cost (``ms``) and without
    it (``device_ms``, from a CUDA graph); returns the kernel's summary
    (times summed over the two dtypes, as the entry point runs both)."""
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
    s = dict(max_abs_err=0.0, ms=0.0, device_ms=0.0, library_device_ms=0.0, plain_ms=0.0,
             library_ms=0.0, bytes_ms=0.0, ops_ms=0.0, bound_ms=0.0, launches=launched)
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
               "device_ms": graph_time(torch, lambda: probe.probe_mma(a, b)),
               "library_device_ms": graph_time(torch, lambda: torch.matmul(a, b)),
               "plain_ms": sync_time(torch, lambda: probe.probe_mma_plain(a, b)),
               "library_ms": sync_time(torch, lambda: torch.matmul(a, b)),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        rows.append(row)
        if not err <= tol:
            raise AssertionError(f"probe {dtype}: kernel vs plain max abs err {err} > {tol}")
        s["max_abs_err"] = max(s["max_abs_err"], err)
        for key, val in (("ms", row["ms"]), ("device_ms", row["device_ms"]),
                         ("library_device_ms", row["library_device_ms"]),
                         ("plain_ms", row["plain_ms"]),
                         ("library_ms", row["library_ms"]), ("bytes_ms", t_bytes),
                         ("ops_ms", t_ops), ("bound_ms", row["bound_ms"])):
            s[key] += val
    from probabilisticdeepdiffusionmodels_torch.ops import _build
    hgmma = wgmma_in_probe(_build.library_path)
    emit({"phase": "probe_mma", "launches": launched, "dtypes": rows,
          "hgmma_instructions_in_probe_bf16": hgmma})
    if not hgmma:
        raise AssertionError("the probe's bf16 kernel holds no wgmma (HGMMA) instruction")
    return s


def train_phases(torch, ops, model, gen):
    """The training phases; returns the train step's kernel launches per
    pass, its device profile by kernel name and its timed passes."""
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
    if ops.counts() != expected_counts(1, True):
        raise AssertionError(f"float32 loss launches {ops.counts()} != {expected_counts(1, True)}")
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
    passes, expected = [], expected_counts(TRAIN_STEPS, True)
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
    if fwd_counts != expected_counts(1, False) or bwd_counts != expected_counts(1, True):
        raise AssertionError(f"one step: forward launched {fwd_counts}, backward added "
                             f"{ {n: bwd_counts[n] - fwd_counts[n] for n in fwd_counts} }")
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
    imp_expected = expected_counts(IMPORTANCE_STEPS, True)
    emit({"phase": "train_step_importance", "steps": IMPORTANCE_STEPS, "losses": losses,
          "weights_min": float(weights.min()), "weights_max": float(weights.max()),
          "launches": ops.counts()})
    if uniform_w or not all(math.isfinite(v) for v in losses) or ops.counts() != imp_expected:
        raise AssertionError(f"importance steps: weights all 1/B {uniform_w}, losses "
                             f"{losses}, launches {ops.counts()}")
    return train_launches, all_kernels, passes


def celeba_phase(torch, F, ops, per_site):
    """One bf16 forward of unet_celebahq64 at 64x64 on the kernels, with one
    launch per folded affine, fused conv, attention and attention norm,
    against the same model and inputs on the plain versions; then
    ``gn_affine`` at each of the forward's sites (FiLM mode but for the first
    conv of each block) against its plain version."""
    from probabilisticdeepdiffusionmodels_torch.models import get_model, unet

    model = get_model(CELEBAHQ64_RES, CELEBAHQ64_CFG, device="cuda", seed=7)
    fill_zero_params(torch, model, seed=8)
    n_res = sum(isinstance(m, unet.ResBlock) for m in model.modules())
    n_attn = sum(isinstance(m, unet.AttentionBlock) for m in model.modules())
    expected = {"gn_affine": 2 * n_res + 1, "gn_silu_conv3x3": 2 * n_res + 1,
                "qkv_attention": n_attn, "group_norm_silu": n_attn, "gn_affine_grad": 0}
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
    calls = {}
    with torch.no_grad(), ops.recording(calls):
        model(x, t)
    torch.cuda.synchronize()
    check_sites(torch, F, ops, calls, per_site, only=("gn_affine",))


@contextlib.contextmanager
def timing_calls(owner, names, log):
    """Time each call of ``owner``'s methods ``names`` by the host clock,
    ending in a synchronise, into ``log[name]``."""
    import torch

    saved = {name: getattr(owner, name) for name in names}

    def make(name, real):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t_start = time.perf_counter()
            out = real(*args, **kwargs)
            torch.cuda.synchronize()
            log.setdefault(name, []).append(time.perf_counter() - t_start)
            return out
        return run

    try:
        for name, real in saved.items():
            setattr(owner, name, make(name, real))
        yield log
    finally:
        for name, real in saved.items():
            setattr(owner, name, real)


def cli_phase(torch, ops, smi, bare_passes, out_dir=None):
    """The command-line entry points on the card, each with the counts set
    to 0 before it and its launches asserted; returns the launches by entry
    point.  The runs go to ``runs/chip_smoke_cli`` beside this script and
    are deleted at the end (their checkpoints hold about 0.8 GB each)."""
    import importlib.util
    import shutil

    import numpy as np

    from probabilisticdeepdiffusionmodels_torch.cli import eval as cli_eval
    from probabilisticdeepdiffusionmodels_torch.cli import sample as cli_sample
    from probabilisticdeepdiffusionmodels_torch.cli import train as cli_train
    from probabilisticdeepdiffusionmodels_torch.config import load_config
    from probabilisticdeepdiffusionmodels_torch.engine import DiffusionEngine

    root = ROOT / "runs" / "chip_smoke_cli"
    shutil.rmtree(root, ignore_errors=True)
    cfg = load_config("default", CLI_ARGS)
    train_loader, val_loader = cli_train.build_loaders(cfg)
    n_steps, n_val = len(train_loader), len(val_loader)
    batch = int(cfg["data"]["batch_size"])
    grad_per_step = PER_BACKWARD["gn_affine_grad"]
    args = CLI_ARGS + [f"out_dir={root}"]
    launches, timed, readings = {}, {}, {}
    test_keys = ("test_nll", "test_L_0", "test_L_intermediate", "test_L_T", "test_mse")

    def run(name, fn, expected):
        ops.reset()
        t_start = time.perf_counter()
        with timing_calls(DiffusionEngine, ("test_step", "generate_images"), timed):
            result = fn()
        readings[f"{name}_seconds"] = time.perf_counter() - t_start
        launches[name] = ops.counts()
        if launches[name] != expected:
            raise AssertionError(f"{name} launches {launches[name]} != {expected}")
        return result

    try:
        # 1. train: n_steps steps, n_val validation batches on the EMA and
        # the live weights, one checkpoint, the NLL test on one val batch
        trained = run("cli_train", lambda: cli_train.main(args + ["run_name=smoke"]),
                      dict(expected_counts(n_steps + 2 * n_val + NLL_T, False),
                           gn_affine_grad=n_steps * grad_per_step))
        run_dir = pathlib.Path(trained["run_dir"])
        final = json.loads((run_dir / "final_test.json").read_text())
        rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
        epoch_s = next(r["epoch_time_s"] for r in rows if "epoch_time_s" in r)
        if trained["steps"] != n_steps or not all(math.isfinite(final[k]) for k in test_keys):
            raise AssertionError(f"cli.train: {final}")
        readings["nll_batch_seconds_train_cli"] = timed["test_step"][-1]

        # 2. resume from the run's checkpoint, no final test
        resumed = run("cli_resume", lambda: cli_train.main(
            args + ["cont_run=smoke", "run_name=smoke_resumed", "trainer.limit_test_batches=0"]),
            dict(expected_counts(n_steps + 2 * n_val, False),
                 gn_affine_grad=n_steps * grad_per_step))
        if resumed["steps"] != 2 * n_steps:
            raise AssertionError(f"cont_run: {resumed['steps']} steps, expected {2 * n_steps}")

        # 3. eval: the best checkpoint, the same val batch and seed
        evaluated = run("cli_eval", lambda: cli_eval.main(
            [f"run_dir={run_dir}", "use_train_data=false", "trainer.limit_test_batches=1"]),
            expected_counts(NLL_T, False))
        readings["nll_batch_seconds"] = timed["test_step"][-1]
        eval_err = {k: abs(evaluated[k] - final[k]) / max(abs(final[k]), 1e-30)
                    for k in test_keys}

        # the device's share of an NLL batch: the same batch and width at a
        # short T (each t runs the same work), profiled and unprofiled
        cfg_p = load_config("default", CLI_ARGS + [f"engine.diffusion_steps={NLL_PROFILE_T}",
                                                   "engine.ema=null"])
        engine_p = cli_train.build_engine(cfg_p)
        x_val = next(iter(val_loader))[0]
        nll_prof = profile_device(torch, lambda: engine_p.test_step(x_val, use_ema=False))
        nll_prof.pop("all")
        unprofiled = []
        with timing_calls(DiffusionEngine, ("test_step",), {"test_step": unprofiled}):
            engine_p.test_step(x_val, use_ema=False)
        nll_prof = {"T": NLL_PROFILE_T, "seconds_unprofiled": unprofiled[-1],
                    "idle_share_unprofiled": 1.0 - nll_prof["device_busy_ms"] / 1e3
                    / unprofiled[-1], **nll_prof}
        del engine_p

        # 4. sample: the respaced ancestral grid
        sampled = run("cli_sample", lambda: cli_sample.main(
            [f"run_dir={run_dir}", "regular_viz=false", f"num_sample_steps={GRID_STEPS}",
             f"n_random={GRID_N}"]), expected_counts(GRID_STEPS, False))
        readings["grid_seconds"] = timed["generate_images"][-1]
        images = sampled["images"]
        png = pathlib.Path(sampled["path"])
        png_bytes = png.stat().st_size

        # the grid's own shapes (batch GRID_N, bf16, the run's weights): each
        # kernel against its plain version on the inputs that the first
        # steps of the same grid give it
        engine_s, _ = cli_sample.load_engine_from_run(run_dir)
        calls = {}
        with ops.recording(calls):
            engine_s.generate_images(n=GRID_N, minibatch=GRID_N, seed=0,
                                     num_sample_steps=GRID_CHECK_STEPS)
        grid_sites = hold_sites(torch, ops, calls)
        del engine_s, calls

        # 5. float32 NLL, kernels against plain versions, same weights and seed
        cfg32 = load_config("default", CLI_ARGS + [
            "model.compute_dtype=float32", f"engine.diffusion_steps={NLL_CHECK_T}",
            "engine.ema=null"])
        engine32 = cli_train.build_engine(cfg32)
        fill_zero_params(torch, engine32.state.model, seed=12)
        x = next(iter(val_loader))[0][:NLL_CHECK_BATCH]
        ops.reset()
        got = engine32.calculate_likelihood(x, seed=13, use_ema=False)
        torch.cuda.synchronize()
        launches["nll_f32"] = ops.counts()
        with ops.plain_versions():
            ref = engine32.calculate_likelihood(x, seed=13, use_ema=False)
        if launches["nll_f32"] != expected_counts(NLL_CHECK_T, False) or \
                ops.counts() != launches["nll_f32"]:
            raise AssertionError(f"float32 NLL launches {launches['nll_f32']}, then "
                                 f"{ops.counts()} with the plain versions")
        nll_err = {k: float(((got[k] - ref[k]).abs() / ref[k].abs().clamp(min=1.0)).max())
                   for k in ref}
        # the grid path at batch GRID_N in float32, kernels against plain
        # versions, with the same weights and seed
        grid_kw = dict(n=GRID_N, minibatch=GRID_N, seed=0, use_ema=False,
                       num_sample_steps=GRID_CHECK_STEPS)
        ops.reset()
        grid32 = engine32.generate_images(**grid_kw)
        torch.cuda.synchronize()
        launches["grid_f32"] = ops.counts()
        with ops.plain_versions():
            grid32_ref = engine32.generate_images(**grid_kw)
        if launches["grid_f32"] != expected_counts(GRID_CHECK_STEPS, False) or \
                ops.counts() != launches["grid_f32"]:
            raise AssertionError(f"float32 grid launches {launches['grid_f32']}, then "
                                 f"{ops.counts()} with the plain versions")
        grid32_diff = float(np.abs(grid32 - grid32_ref).max())
        if out_dir is not None:
            keep = out_dir / "cli"
            keep.mkdir(exist_ok=True)
            for path in (run_dir / "final_test.json", run_dir / "metrics.jsonl", png):
                shutil.copy(path, keep / path.name)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    bare = [p["img_per_s"] for p in bare_passes]
    emit({"phase": "cli", "nvidia_smi": smi, "steps": n_steps, "batch": batch,
          "val_batches": n_val, "nll_T": NLL_T,
          "train_cli_img_per_s": n_steps * batch / epoch_s, "train_cli_epoch_seconds": epoch_s,
          "bare_train_step_img_per_s": bare, **readings,
          "final_test": {k: final[k] for k in test_keys}, "eval_rel_err": eval_err,
          "eval_rel_tol": EVAL_REL_TOL, "resumed_steps": resumed["steps"],
          "grid": {"steps": GRID_STEPS, "n": GRID_N, "png_bytes": png_bytes,
                   "abs_max": float(np.abs(images).max()),
                   "finite": bool(np.isfinite(images).all()),
                   "sites_vs_plain": grid_sites,
                   "f32_vs_plain": {"steps": GRID_CHECK_STEPS, "max_abs_diff": grid32_diff,
                                    "tol": F32_CHAIN_TOL}},
          "nll_profile": nll_prof,
          "python_has": {name: importlib.util.find_spec(name) is not None
                         for name in ("yaml", "matplotlib")},
          "nll_f32_vs_plain": {"T": NLL_CHECK_T, "batch": NLL_CHECK_BATCH, "rel_err": nll_err,
                               "tol": NLL_CHECK_TOL},
          "launches": launches})
    if not max(eval_err.values()) <= EVAL_REL_TOL:
        raise AssertionError(f"cli.eval differs from the train CLI's final test: {eval_err}")
    if images.shape != (GRID_N, RESOLUTION, RESOLUTION, 3) or not np.isfinite(images).all() \
            or not np.abs(images).max() <= 1.0 or not png_bytes:
        raise AssertionError(f"cli.sample: images {images.shape}, abs max "
                             f"{np.abs(images).max()}, png {png_bytes} bytes")
    if not max(nll_err.values()) <= NLL_CHECK_TOL:
        raise AssertionError(f"float32 NLL: kernels vs plain {nll_err}")
    if not grid32_diff <= F32_CHAIN_TOL:
        raise AssertionError(f"float32 grid: kernels vs plain differ by {grid32_diff}")
    return {name: launches[name] for name in ("cli_train", "cli_resume", "cli_eval",
                                              "cli_sample")}


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
    check_sites(torch, F, ops, calls, per_site, summary)
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
    expected = expected_counts(STEPS, False)
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
    kernel_ms = sum(summary[name]["ms"] for name in PER_FORWARD)
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
    train_launches, train_profile, train_passes = train_phases(torch, ops, model, gen)

    # 7. unet_celebahq64, bf16, kernels against plain versions
    celeba_phase(torch, F, ops, per_site)

    # 8. the command-line entry points
    cli_launches = cli_phase(torch, ops, smi, train_passes, args.out)

    if args.out is not None:
        (args.out / "chip_smoke_sites.json").write_text(json.dumps(
            {"nvidia_smi": smi, "sites": per_site, "forward_bf16_profile": all_kernels,
             "train_step_bf16_profile": train_profile}, indent=1))

    # each kernel's main path: the sampler for the forward's four, the train
    # step for the backward kernel, the probe's entry point for the probe
    main_launches = dict(launches, probe_mma=summary["probe_mma"].pop("launches"),
                         **{name: train_launches[name] for name in PER_BACKWARD})
    by_path = {name: {"sampler_bf16": launches[name], "train_step_bf16": train_launches[name],
                      **{path: counts[name] for path, counts in cli_launches.items()}}
               for name in (*PER_FORWARD, *PER_BACKWARD)}
    by_path["probe_mma"] = {"probe": main_launches["probe_mma"]}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
         "launches": main_launches[name], "launches_by_path": by_path[name],
         "max_abs_err": s["max_abs_err"], "ms": s["ms"],
         "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
         "bound_by": "bytes" if s["bytes_ms"] >= s["ops_ms"] else "operations",
         "library_ms": s["library_ms"],
         # without the host's launch cost, where it was measured (the probe)
         "device_ms": s.get("device_ms"), "library_device_ms": s.get("library_device_ms")}
        for name, s in summary.items()]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
