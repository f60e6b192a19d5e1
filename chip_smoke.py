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
   that ran at that site (then the same forward through the spatially
   sharded path on a world of one rank: the folding conv at every conv site
   and fold + apply at every GroupNorm, each against its plain version, the
   same bits twice and as ``gn_fold`` + the consumer fed its (a, off), timed
   device-only beside both, by name); ``gn_affine`` and GroupNorm are run
   twice and the two results compared bit for bit, GroupNorm is timed in both of its
   designs, ``gn_affine`` in both of its (``cluster``, ``workspace``),
   attention, where ``wgmma`` takes the shape, in both bf16 designs by
   name, ``wgmma`` and ``mma_ring``, whichever the shape selects (each held
   against the plain version with its log-sum-exp within 1e-4, run twice for the same bits
   with one count a call, its device time from a CUDA graph over copies of
   qkv that do not fit L2 and each kernel's from a profile of that graph,
   beside SDPA's forward device-only from a profile), and at
   each ``gn_affine`` site its backward kernels (``gn_affine_grad``, designs
   ``fused_bwd`` and ``fold_bwd+apply``) are held against autograd through
   the plain version, run twice for the same bits and timed, each design by
   name, with and without the host's cost of a call; at each fused conv
   site (the float32 head too) its backward kernels
   (``gn_silu_conv3x3_grad``: ``wgmma`` at the bf16 sites, ``narrow_f32``
   at the head) and the earlier designs for the same shape by name
   (``wgmma_sync_epilogue`` and ``wgmma_taprow``, ``general``) on a seeded
   output gradient against the plain backward, each run twice for the same
   bits, the selected and the latest earlier design timed with and without
   the host's cost (``wgmma_taprow`` only checked), each kernel's device
   time from a profile of that graph, beside the parent's path (``recompute``), the plain
   backward, ``convolution_backward`` without the host's cost (the two bare
   products, the weight product alone, the input product alone), and the
   bounds of the two products, of the input product and of the weight
   product; at each attention and GroupNorm site their backward kernels
   (``qkv_attention_grad``, ``group_norm_silu_grad``; attention also in
   its earlier design ``two_pass`` by name where ``wgmma`` runs, GroupNorm
   in ``fused`` by name where ``tma_resident`` runs, with the captured
   graph's edges read for the batch sums' programmatic launch) on a seeded
   output gradient against the plain backward (bf16 1e-2, float32 1e-4 of the
   largest element), run twice for the same bits with one count a call,
   timed with and without the host's cost, each kernel's device ms from a
   profile of the site's graph, beside the parent's path (``recompute``),
   the plain backward, the library's backward alone (SDPA's flash backend;
   ``native_group_norm_backward`` in NCHW, no SiLU) and the bound; then the
   float32 rows (``kernels_f32``): the calls of one float32 batch-128 forward
   (the shipped configs' default dtype), each fused-conv signature but the
   head in ``tiled_f32`` and ``general`` by name, forward and gradient (its
   input and weight products apart), held against the plain versions, run
   twice for the same bits and timed device-only beside ``F.conv2d`` and
   ``convolution_backward``'s products (TF32 off), each attention and
   GroupNorm signature as above (SDPA's memory-efficient backend for the
   float32 backward), ``tiled_f32`` asserted at all 60 sites;
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
   asserted (the backward's ``gn_affine_grad`` and ``gn_silu_conv3x3_grad``
   among them), its forward / backward / update split and a device profile,
   with the step's device operations, device ms, idle share and peak
   memory in the designs the shapes select, with ``gn_affine_grad``'s first
   design, with the conv's, attention's and GroupNorm's gradients and
   attention's forward in the designs before their last redesigns, by name
   (``wgmma_sync_epilogue`` at the bf16 conv sites, ``two_pass``, ``fused``,
   ``mma_ring``), with the conv's gradient as
   ``recompute`` (whose steps must leave the conv gradient's launch count
   where it was), and with attention's and GroupNorm's gradients as
   ``recompute`` by name (the same rule for their counts); the float32
   forward's attention and GroupNorm sites at batch 8 hold their backward
   kernels against the plain versions;
   and a few importance-sampled steps on a warmed-up history;
7. a second model: one bf16 forward of ``unet_celebahq64`` at 64x64 (head
   widths 96 and 128, FiLM conditioning) at batch 8 on the kernels, with
   the launch counts asserted, against the same model on the plain versions,
   and ``gn_affine`` held against its plain version at each of its FiLM sites,
   attention's and GroupNorm's backward kernels at their sites, timed;
8. the command-line entry points at the CIFAR-10 UNet's full width (bf16,
   ``engine=cifar10``, ``data=synthetic`` with 1,280 images at batch 128):
   ``cli.train`` (10 steps, 10 validation batches, a checkpoint, the final
   NLL test at T=1000 on one batch), a ``cont_run`` resume (steps 10 to 20),
   ``cli.eval`` on the first run (equal to its ``final_test.json``) and
   ``cli.sample``'s 250-step grid of 4 (finite, in [-1, 1]), each with its
   launch counts asserted; each kernel against its plain version on the
   inputs the grid's first steps give it (batch 4, bf16, the run's weights);
   then the float32 NLL at T=50 and the float32 grid path at batch 4 on the
   kernels against the plain versions;
9. the FID family and the ODE likelihood (``evals``): InceptionV3 with random
   weights in float32 at batch 256 on the card against the same module on
   the CPU (TF32 off, and on for comparison; the card's resize against the
   CPU's), with its img/s; ``cli.fid_score`` on the cli run (the CIFAR-10
   UNet at full width, bf16) at 256 samples of the 250-step chain (cut
   from 10,000; synthetic reals) with P&R, KID and IS, its scores, stamp,
   seconds and sampled img/s and the sampler's launches asserted;
   ``cli.fid_debug`` on 256 synthetic images a split; the ODE likelihood
   of a flow and an EDM model at full width in float32 (batch 4, 4 Heun
   steps) on the kernels against the plain versions, then ``cli.eval
   ode_nll=true ode_steps=20`` (cut from 100) on one bf16 batch of 128 of a
   flow and an EDM run (T cut to 100), launches asserted, with one
   integration profiled (device operations a probe evaluation, no copy to
   the host);
10. consistency distillation (``consistency_distill``): CD rounds (bf16,
   batch 128, 10 steps after 3) from the cli run's eps teacher and from an
   EDM teacher, in turns beside the eps step, launches asserted (4 forwards
   and one backward a step), each step's device operations and no copy to
   the host; the float32 gradients of one CD step of each teacher on the
   kernels against the plain versions; ``cli.consistency`` on the cli run
   then ``cli.sample sampler=consistency`` on its output;
11. K = 4 fused train steps (``fused_train``): bench_train.py's step (bf16,
   batch 128) as one captured CUDA graph (``engine.training_steps``): from
   one copy of the state a replay beside 4 eager steps and beside the
   graph's steps run eagerly, and in float32 on the kernels beside eager
   steps on the plain versions (counts and the generator equal, floats
   within their stated tolerances), and a replay with one table row zeroed
   failing that gate; the capture stream's GroupNorm
   counters zero; one replay's device operations from a profile, each of
   this repository's kernels 4x an eager step's, no copy to the host; img/s
   in turns (eager, fused, fused, eager) with peak memory, each mode's
   device busy ms and idle share from its profile; a replay's device ms a
   step with the gradients captured in the selected designs and with the
   conv's, attention's and GroupNorm's, and attention's forward, in the
   designs before their last redesigns by name (``wgmma_sync_epilogue``,
   ``two_pass``, ``fused``, ``mma_ring``), and with attention's and
   GroupNorm's gradients captured as ``recompute``; ``cli.train trainer.fused_steps=4
   data.device_resident=true`` beside the plain CLI over 2 epochs with one
   capture asserted, and 2 + 2 steps resumed from its checkpoint against 4;
12. progressive distillation and reflow (``distill_reflow``): the distil
   step (from the cli run's eps teacher, T 1000 -> 500) and the reflow
   step (on 256 couplings of the evals phase's flow run) beside the eps
   step in turns, launches asserted, device operations a step and no copy
   to the host; the float32 gradients of one distil and one reflow step on
   the kernels against the plain versions; ``cli.distill`` and
   ``cli.reflow`` with their launches, each student read by ``cli.sample``.
   The cli run is deleted after this phase;
13. the IDDPM configuration through the same entry points (``iddpm_cli``): the
   CIFAR-10 UNet at full width (bf16) under ``engine=cifar10_iddpm`` (cosine,
   learned sigma, hybrid loss) with its T cut from 1000 to 25, and the
   default visualization: ``cli.train`` (10 steps, the four views at the end
   of training, the NLL test), ``cli.sample`` (the four views and the
   detailed panels) and ``cli.eval`` (equal to the run's final test), each
   with its launches asserted and every PNG decoded; the hybrid step's img/s
   beside the eps step's (eps, hybrid, hybrid, eps); every kernel site the
   five visualization endpoints reach (batch 1, 4 and 10, bf16) and the
   endpoints in float32 (T=10, injected noise) on the kernels against the
   plain versions; the float32 gradients of one hybrid loss (the Cout = 6
   head's forward and backward, ``gn_affine_grad``) on the kernels against
   the plain versions; and one bf16 batch-128 train step each of v with
   min-SNR on a zero-terminal-SNR schedule and of x0, with exact launches
   and no device-to-host copy;
14. the fast samplers at the CIFAR-10 UNet's full width (bf16, batch 128,
   linear T=1000, clip): DDIM-50, DPM-Solver++(2M) at 10 and 20 steps,
   Heun at ``karras18``, the ancestral 250-step and DDIM-50 chains with
   ``encoder_reuse=3``, DDIM-50 under guidance 3 on a class-conditional
   variant (its forward at batch 256), RePaint (``right_half``, 50 steps)
   and DDIM inversion at 50 steps and back (``fast_samplers``): each chain
   timed once with its launches asserted (a cached call launches the
   decoder's share), the launches and device operations of a full, a
   cached and a guided model call, one chain profiled with no copy to the
   host, the guided and cached calls' kernel sites against the plain
   versions, and every chain in float32 at batch 4 on the kernels against
   the plain versions with the same generator state;
15. the EDM, flow-matching and consistency families (``model_families``):
   each bf16 train step at batch 128 beside the eps step in turns (10 steps
   after 3, launches asserted, device operations a step, no copy to the
   host), each one's float32 gradients on the kernels against the plain
   versions, the kernel sites of the EDM and flow inputs, the native
   samplers (EDM Heun at 18, flow Euler and Heun at 50, consistency at 1
   and 2 steps) timed and in float32 at batch 4 against the plain
   versions, and ``cli.train engine.prediction_type=consistency`` then
   ``cli.sample sampler=consistency`` with their launches asserted;
16. the model extras (``model_extras``): super-resolution on the CIFAR-10
   UNet at full width (``model.name=superres``, the low-res input 16x16,
   bf16): the batch-128 forward with its launches and every kernel site of
   it against the plain versions (untimed), the float32 forward and eps-MSE gradients
   at batch 4 on the kernels against the plain versions, the train step
   beside the eps step in turns (eps, superres, superres, eps), the
   100-step chain at batch 128 conditioned on the low-res batch through
   ``engine.generate_images``, ``cli.train model.name=superres
   data.superres_factor=2`` (10 steps on 1,280 synthetic images; its one cut
   T 1000 -> 100, the final NLL's forwards) with its launches, then
   ``cli.profile`` on that run (5 steps, a 50-step chain) whose
   ``timings.json`` is printed and whose traces name the conv, attention and
   GroupNorm kernels; ``use_checkpoint`` at the same width: the bf16 batch-128
   step with and without it in turns (img/s, peak memory, the recompute's
   launches), float32 gradients with dropout 0.1 with against without it
   (1e-6, cuDNN deterministic), one K = 4 fused replay of the checkpointed
   model with dropout against 4 eager steps (the fused_train gates) and
   against the plain model's graph steps run eagerly (1e-6); the 1-D UNet
   (length 1,024, 64 channels, mult 1-2-2-2, attention at 256 and 128 tokens,
   batch 16) and the 3-D UNet (16^3, 64 channels, mult 1-2-2, attention at
   512 and 64 tokens, batch 8), each in float32 (forward and gradients) on
   the kernels against the plain versions, every GroupNorm and attention
   site of its bf16 forward against the plain versions, and one bf16
   forward timed with its launches; the dense model
   (``config/model/dense.yaml``) on the card against the same weights on
   the CPU;
17. data and model parallelism (``parallel``): A. on a one-rank NCCL group, the
   plain, data-parallel (``make_mesh(1)``) and FSDP engines at full width
   (bf16, batch 128, bench_train.py's step) in turns (plain, dp, fsdp,
   fsdp, dp, plain; 10 steps after 3), img/s, launches a step equal to the
   plain step's, the all-reduce of the gradient bucket timed by CUDA events,
   a profiled DP step with no copy to the host, and float32 at batch 8:
   parameters after 2 steps within 1e-6 of plain; B. two ranks sharing
   cuda:0 over gloo (``parallel.spawn``), float32, global batch 8: the DP
   and FSDP steps against one process (1e-5 of the largest parameter), a
   10-step batch-sharded chain (1e-5), the FID moments of 67 images on the
   random Inception network (1e-6 relative), each rank's seconds; C.
   ``cli.train trainer.devices=2`` refused on a one-card machine; D. the
   native transform (``data/native``) on a CIFAR batch of 128 against numpy,
   ms and bit for bit (the ``cli`` line names the executor its loaders ran);
   E. K = 4 fused steps on the one-rank NCCL mesh (bf16, batch 32) under
   ``fused_train``'s gates (``fused_gate``), its profiles read as lower
   bounds; F. two ranks sharing cuda:0 over gloo: tensor parallelism at full
   width on a 1x2 mesh (float32 steps and a DDIM chain against one process,
   bf16 steps with their launches, 64-channel conv slices on ``wgmma``,
   every kernel site of a step against the plain versions), then
   ``unet_celebahq`` at 256x256 with its height over the two ranks: the
   forward's launches against one process's (no ``gn_fold``: a folding conv
   for each conv, a fold + apply for each GroupNorm), every slab site
   against the plain versions, each folding consumer timed at its sites
   beside ``gn_fold`` and the consumer fed its (a, off), by name, one
   sharded forward's device operations in both designs, the forward and a
   4-step chain against one process, the chain's launches, one bf16 sharded
   forward against one process's; G. a 2x2 mesh of four ranks against one
   process.

Prints one JSON line per phase, then the ``{"kernels": [...]}`` line, then
``{"ok": true, "device": {...}}`` as the last line.  Any failure raises and
exits non-zero without that line; so does a machine without a CUDA device.
With ``--out DIR`` the per-shape measurements, the compiler's log and every
line printed (``lines.jsonl``) are also written to DIR.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import pathlib
import shutil
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
# the backward kernels, once a site of every backward: the folded affine's,
# the fused conv's, attention's and its GroupNorm's
PER_BACKWARD = {"gn_affine_grad": 61, "gn_silu_conv3x3_grad": 61, "qkv_attention_grad": 15,
                "group_norm_silu_grad": 15}
# the kernels that only a spatially sharded forward launches: the consumers
# that fold the ranks' summed statistics themselves, one a GroupNorm (fold +
# apply) and one a fused conv on a slab
SLAB_ONLY = ("gn_fold_apply", "gn_silu_conv3x3_fold")
# their first design, by name only: the fold alone, whose (a, off) fed the
# GroupNorm's apply and the conv; no path may launch it
FOLD_ALONE = "gn_fold"
# the two ops of a slab (rows of an image) that launch the moments, and the
# kernel counter each ticks
SLAB_OPS = {"gn_moments_slab": "gn_affine", "group_norm_silu_slab": "group_norm_silu"}


def expected_counts(steps, backward):
    """Launch counts of ``steps`` forwards, with or without their backwards."""
    return dict({n: steps * c for n, c in PER_FORWARD.items()},
                **backward_counts(steps * int(backward)))


def backward_counts(n):
    """Launch counts of the backward kernels of ``n`` backwards."""
    return {name: n * c for name, c in PER_BACKWARD.items()}
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
# steps a turn where paths run beside each other in turns (after TRAIN_WARMUP):
# cut from 10 to hold the command's time
TURN_STEPS = 5
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
CLI_ROOT = ROOT / "runs" / "chip_smoke_cli"
FLOW_RUN = CLI_ROOT / "ode" / "ode_flow"  # the evals phase's flow run (T = 100)
# the evals phase: InceptionV3 in float32 at batch 256 against the CPU;
# cli.fid_score on the cli run at 256 samples (cut from 10,000; synthetic
# reals, random Inception weights) of the 250-step chain with P&R, KID and
# IS; cli.fid_debug on 256 synthetic images a split; the ODE likelihood in
# float32 (batch 4, 4 Heun steps) on the kernels against the plain versions,
# then cli.eval ode_nll=true ode_steps=20 (cut from 100) on one bf16 batch
# of 128 of a flow and an EDM run (their T cut to 100, the bound's share)
INCEPTION_BATCH = 256
INCEPTION_CPU_BATCH = 64   # of those, the images the CPU reference runs (cut from all 256)
INCEPTION_REL_TOL = 1e-4   # float32 features, the card against the CPU (TF32 off)
RESIZE_TOL = 1e-5          # the card's bilinear resize against the CPU's
FID_SAMPLES, FID_STEPS, FID_MINIBATCH = 256, 250, 256  # samples: cut from 512
FID_ARGV = ["true", str(FID_SAMPLES), str(FID_STEPS), "", "true", "true", "true"]  # clip n
# steps devices pr kid is; 256 a side (cut from 1,024, then 512), for the time limit
FID_DEBUG_N = 256  # images a split: cut from 512
FID_DEBUG_ARGS = ["model=unet", "engine=cifar10", "data=synthetic", f"data.n={FID_DEBUG_N}",
                  "data.batch_size=128"]
ODE_CHECK_BATCH, ODE_CHECK_STEPS = 4, 4
ODE_CHECK_TOL = 1e-3       # float32 nll and delta_logp, kernels vs plain, of their largest
ODE_EVAL_STEPS, ODE_EVAL_T = 20, 100
# the consistency_distill phase: CD rounds at batch 128 (bf16, 10 steps
# after 3) from the cli run's eps teacher and an EDM teacher, beside the
# eps step in turns; a CD step is 2 teacher forwards, the student's forward
# and backward and the target's forward
CD_TURNS = ("eps", "cd_eps", "cd_edm", "cd_edm", "cd_eps", "eps")
CD_FORWARDS = 4
# the fused_train phase: K train steps (bench_train.py's step: bf16, batch
# 128, Adam 2e-4, EMA 0.9999, uniform t) as one captured CUDA graph beside K
# eager steps from one copy of the state.  The graph's Adam update rounds
# its parameter step once more than torch.optim.Adam, a round-off that the
# later steps carry: parameters and EMA within FUSED_PARAM_TOL (a tenth of
# one update), the moments within FUSED_MOMENT_TOL of the model's largest,
# the loss rows within FUSED_LOSS_TOL relative.  Against the graph's steps
# run eagerly (the same arithmetic) and a resume, every float within
# FUSED_SAME_TOL.  A replay whose table has one row zeroed (that update's
# parameter step skipped) must fail the gate.
FUSED_K, FUSED_LR, FUSED_CHUNKS = 4, 2e-4, 4  # chunks a turn: cut from 6
FUSED_TURNS = ("eager", "fused", "fused", "eager")
FUSED_PARAM_TOL = FUSED_LR / 10
FUSED_MOMENT_TOL = 1e-3
FUSED_LOSS_TOL = 1e-4
FUSED_SAME_TOL = 1e-6
FUSED_CLI_ARGS = ["trainer.max_epochs=2", "trainer.limit_test_batches=0"]
# the distill_reflow phase: progressive distillation (cli.distill, one round
# T 1000 -> 500, one epoch of 10 steps, the NLL on one batch) from the cli
# run, reflow (cli.reflow, 256 couplings of the 50-step flow ODE at batch
# 128, one epoch) from the evals phase's flow run (T = 100); the distil and
# reflow steps beside the eps step in turns
DR_TURNS = ("eps", "distill", "reflow", "reflow", "distill", "eps")
DISTILL_FORWARDS = 3   # two teacher forwards and the student's, one backward
REFLOW_COUPLINGS, REFLOW_GEN_STEPS = 256, 50
# the iddpm_cli phase: engine=cifar10_iddpm at full width in bf16 with the
# default visualization (more); the one cut is T, 1000 to 25 (100 before
# the model_extras phase came, 50 before the parallel phase), which keeps
# its ~900 model calls (the views, the detailed panels, two NLL tests)
# within the time limit
IDDPM_T = 25
IDDPM_ARGS = ["model=unet", "model.compute_dtype=bfloat16", "engine=cifar10_iddpm",
              "data=synthetic", "data.n=1280", "data.batch_size=128",
              f"engine.diffusion_steps={IDDPM_T}", "trainer.max_epochs=1",
              "trainer.check_val_every_n_epoch=1", "trainer.limit_test_batches=1"]
ENDPOINT_CHECK_T = 10  # the five endpoints in float32, kernels vs plain
ENDPOINT_F32_TOL = 1e-3  # max abs difference after up to 10 steps (sums in another order)
VIEWS = ("visualize_random_grid", "visualize_interpolation", "visualize_reconstructions_grid",
         "visualize_single_reconstructions")

# the fast_samplers phase: the CIFAR-10 UNet at full width (bf16, batch 128)
# on linear T=1000 with clip, each sampler timed over FS_RUNS chains in a row;
# the float32 checks at batch 4 over chains cut to about 10 steps
FS_BATCH, FS_RUNS, FS_CHECK_BATCH = 128, 2, 4
FS_TIMED = {"ddim_50": ("ddim", 50), "dpmpp2_10": ("dpmpp", 10), "dpmpp2_20": ("dpmpp", 20),
            "heun_karras18": ("heun", "karras18"), "ancestral_250_reuse3": ("reuse_p", 250),
            "ddim_50_reuse3": ("reuse_ddim", 50), "cfg3_ddim_50": ("cfg_ddim", 50),
            "inpaint_right_half_50": ("inpaint", 50), "ddim_invert_50_and_back": ("invert", 50)}
FS_CHECK = {"ddim": 10, "dpmpp": 10, "heun": "karras6", "reuse_p": 10, "reuse_ddim": 10,
            "cfg_ddim": 10, "inpaint": 10, "invert_part": 10}
CFG_SCALE, NUM_CLASSES = 3.0, 10
# the model_families phase: each family's bf16 step at batch 128 beside the
# eps step, in turns; the native samplers at batch 128; float32 checks
FAMILIES = ("edm", "flow", "consistency")
FAMILY_TURNS = ("eps", "edm", "flow", "consistency", "consistency", "flow", "edm", "eps")
NATIVE_TIMED = {"edm_heun_18": ("edm", dict(n_steps=18)),
                "flow_euler_50": ("flow", dict(n_steps=50)),
                "flow_heun_50": ("flow", dict(n_steps=50, heun=True)),
                "consistency_1": ("consistency", dict(n_steps=1)),
                "consistency_2": ("consistency", dict(n_steps=2))}
NATIVE_CHECK = {"edm_churn_6": ("edm", dict(n_steps=6, s_churn=2.0)),
                "flow_euler_8": ("flow", dict(n_steps=8)),
                "flow_heun_4": ("flow", dict(n_steps=4, heun=True)),
                "consistency_2": ("consistency", dict(n_steps=2))}

# the model_extras phase: super-resolution on the CIFAR-10 UNet at full width
# (model.name=superres: the wrapped UNet sees 6 channels; the low-res input is
# 16x16), bf16, batch 128; use_checkpoint at the same width; the 1-D and 3-D
# UNets at this phase's own sizes (no config has them); config/model/dense.yaml
SR_CFG = dict(MODEL_CFG, name="superres")
SR_FACTOR = 2
SR_TURNS = ("eps", "superres", "superres", "eps")
SR_GRAD_BATCH = 4
SR_CHAIN_STEPS = 100   # the conditioned chain: cut from 250
SR_CLI_T = 100  # cli.train's one cut: T 1000 -> 100, the final NLL's forwards on its batch
SR_CLI_ARGS = CLI_ARGS + ["model.name=superres", "data.superres_factor=2",
                          f"engine.diffusion_steps={SR_CLI_T}"]
SR_PROFILE_STEPS, SR_PROFILE_SAMPLE_STEPS = 5, 50
SR_PROFILE_ARGS = [f"steps={SR_PROFILE_STEPS}", f"sample_steps={SR_PROFILE_SAMPLE_STEPS}"]
# what cli.profile's traces must name: the conv, attention (at the
# profile's batch of 8, 32 items, the forward's mma_ring), the GroupNorm
# statistics (GroupNorm and gn_affine) and, in training, gn_affine's backward
PROFILE_SAMPLE_KERNELS = ("conv_wgmma_kernel", "attn_bf16_kernel", "gn_moments_kernel")
PROFILE_TRAIN_KERNELS = PROFILE_SAMPLE_KERNELS + (
    "gn_affine_bwd_kernel", "gn_batch_sum_kernel", "dgrad_pingpong_kernel", "wgrad9_wgmma_kernel",
    "grad_narrow_f32_kernel", "grad_finish_kernel", "attn_bwd_wgmma_kernel",
    "attn_bwd_dq_bf16_kernel", "attn_bwd_dkv_bf16_kernel", "gn_silu_bwd_resident_kernel",
    "gn_batch_sum_pdl_kernel")
CKPT_TURNS = ("plain", "checkpoint", "checkpoint", "plain")
CKPT_GRAD_BATCH, CKPT_DROPOUT = 8, 0.1
CKPT_SAME_TOL = 1e-6  # float32 gradients with against without checkpoints (cuDNN deterministic)
# dims -> (config, length, batch): 1-D length 1,024 with attention at 256 and
# 128 tokens; 3-D 16^3 with attention at 8^3 = 512 and 4^3 = 64 tokens
ND_CFGS = {
    1: (dict(name="unet", in_channels=1, model_channels=64, num_res_blocks=2,
             attention_resolutions=[256, 128], channel_mult=[1, 2, 2, 2], num_heads=4,
             dims=1, compute_dtype="bfloat16"), 1024, 16),
    3: (dict(name="unet", in_channels=1, model_channels=64, num_res_blocks=2,
             attention_resolutions=[8, 4], channel_mult=[1, 2, 2], num_heads=4, dims=3,
             compute_dtype="bfloat16"), 16, 8),
}
DENSE_BATCH = 64
DENSE_TOL = 1e-4  # float32 (TF32 off), the card against the CPU, of max(1, |ref|)

# H100 SXM published peaks (NVIDIA data sheet), dense
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

REPLACES = {
    # the fused conv's gradient, which the JAX package takes by jax.vjp of
    # the XLA form inside the op's custom VJP
    "gn_silu_conv3x3_grad": "probabilisticdeepdiffusionmodels_tpu/ops/gn_conv_pallas.py:238",
    # the fold that XLA fuses into one pass before the fused conv: the one
    # entry that is no Pallas kernel in the JAX package
    "gn_affine": "probabilisticdeepdiffusionmodels_tpu/ops/gn_conv_pallas.py:41",
    # its gradient, which the JAX package takes by recomputing the fold in
    # XLA inside the fused op's custom VJP
    "gn_affine_grad": "probabilisticdeepdiffusionmodels_tpu/ops/gn_conv_pallas.py:238",
    "gn_silu_conv3x3": "probabilisticdeepdiffusionmodels_tpu/ops/gn_conv_pallas.py:180",
    "group_norm_silu": "probabilisticdeepdiffusionmodels_tpu/ops/groupnorm_pallas.py:112",
    "qkv_attention": "probabilisticdeepdiffusionmodels_tpu/ops/attention_pallas.py:67",
    # the gradients that the JAX package takes through qkv_attention_xla and
    # by jax.vjp of group_norm_silu_xla inside the custom VJP (_gns_bwd)
    "qkv_attention_grad": "probabilisticdeepdiffusionmodels_tpu/ops/attention.py:37",
    "group_norm_silu_grad": "probabilisticdeepdiffusionmodels_tpu/ops/groupnorm_pallas.py:98",
    "probe_mma": "scripts/probe_mosaic_bf16.py:21",
    # gn_affine's fold, the (B, C)-sized rest, which XLA's partitioner runs
    # on all-reduced statistics under spatial_sharding, folded into the
    # consumers of a slab: GroupNorm's apply and the fused conv
    "gn_fold_apply": "probabilisticdeepdiffusionmodels_tpu/ops/gn_conv_pallas.py:41",
    "gn_silu_conv3x3_fold": "probabilisticdeepdiffusionmodels_tpu/ops/gn_conv_pallas.py:41",
}
SOURCES = {
    "gn_silu_conv3x3_grad": f"{PKG}/csrc/gn_conv_grad.cu",
    "gn_affine": f"{PKG}/csrc/groupnorm.cu",
    "gn_affine_grad": f"{PKG}/csrc/groupnorm.cu",
    "gn_silu_conv3x3": f"{PKG}/csrc/gn_conv.cu",
    "group_norm_silu": f"{PKG}/csrc/groupnorm.cu",
    "qkv_attention": f"{PKG}/csrc/attention.cu",
    "qkv_attention_grad": f"{PKG}/csrc/attention_grad.cu",
    "group_norm_silu_grad": f"{PKG}/csrc/groupnorm_grad.cu",
    "probe_mma": f"{PKG}/csrc/probe_mma.cu",
    "gn_fold_apply": f"{PKG}/csrc/groupnorm.cu",
    "gn_silu_conv3x3_fold": f"{PKG}/csrc/gn_conv.cu",
}


LINES_OUT = []  # with --out DIR: DIR/lines.jsonl, every line printed, written as it is printed
START = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase's line carries the seconds since the
    script started (``t_s``), so each phase's cost can be read off."""
    if "phase" in obj:
        obj = dict(obj, t_s=time.perf_counter() - START)
    line = json.dumps(obj)
    print(line, flush=True)
    for path in LINES_OUT:
        with open(path, "a") as f:
            f.write(line + "\n")


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
    """The ops as the model modules see them (the forward's four, the
    slab ops of a spatially sharded forward and the folding consumers they
    call), with a context manager that swaps them for recorders or for the
    plain versions, and the kernels' launch counters (the fold alone's
    too, which no path may launch)."""

    def __init__(self):
        import importlib

        self.unet = importlib.import_module(f"{PKG}.models.unet")
        self.layers = importlib.import_module(f"{PKG}.models.layers")
        self.ops = importlib.import_module(f"{PKG}.ops")
        gn_conv = importlib.import_module(f"{PKG}.ops.gn_conv")
        groupnorm = importlib.import_module(f"{PKG}.ops.groupnorm")
        # (module, attribute) -> op name
        self.sites = {(self.unet, "gn_affine"): "gn_affine",
                      (self.unet, "gn_silu_conv3x3"): "gn_silu_conv3x3",
                      (self.unet, "qkv_attention"): "qkv_attention",
                      (self.layers, "group_norm_silu"): "group_norm_silu",
                      (self.unet, "gn_moments_slab"): "gn_moments_slab",
                      (self.unet, "gn_silu_conv3x3_fold"): "gn_silu_conv3x3_fold",
                      (self.layers, "group_norm_silu_slab"): "group_norm_silu_slab",
                      (groupnorm, "gn_fold_apply"): "gn_fold_apply"}
        self.kernels = (*PER_FORWARD, *PER_BACKWARD, *SLAB_ONLY, FOLD_ALONE)
        self.wrappers = {name: getattr(self.ops, name) for name in (*self.kernels, *SLAB_OPS)}
        self.plain = {name: getattr(self.ops, name + "_plain") for name in self.wrappers}

    def reset(self):
        for name in self.kernels:
            self.wrappers[name].launches = 0

    def counts(self):
        """Each kernel's launches since ``reset``; the slab-only kernels and
        the fold alone where they launched (no other path launches them)."""
        out = {name: self.wrappers[name].launches for name in (*PER_FORWARD, *PER_BACKWARD)}
        out.update({name: self.wrappers[name].launches for name in (*SLAB_ONLY, FOLD_ALONE)
                    if self.wrappers[name].launches})
        return out

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
            if callable(a):  # a slab op's ``average``, a new closure each call
                return "callable"
            return tuple(map(describe, a)) if isinstance(a, tuple) else a

        def make(name):
            real = self.wrappers[name]

            class Recorder:
                # a wrapper swapped in its own module (gn_fold_apply) counts
                # its launches on the name it is called by
                launches = property(lambda self: real.launches,
                                    lambda self, n: setattr(real, "launches", n))

                def __call__(self, *args, **kwargs):
                    key = (name,) + tuple(map(describe, args)) + tuple(
                        (k, describe(v)) for k, v in sorted(kwargs.items()))
                    entry = log.setdefault(key, {"name": name, "count": 0, "args": None,
                                                 "kwargs": kwargs})
                    entry["count"] += 1
                    if entry["args"] is None:
                        entry["args"] = [a.clone() if hasattr(a, "clone") else a for a in args]
                    return real(*args, **kwargs)
            return Recorder()
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
    if name == "gn_silu_conv3x3_fold":
        # the conv's bytes and products, with the (2, B, Cin) moments, gamma,
        # beta and the conditioning read in place of (a, off)
        _, mom, _, _, _, _, _, w, _ = args
        b, h, wd, cin = x.shape
        cout = w.shape[2]
        conds = [t for t in (kwargs.get("emb"), *(kwargs.get("film") or ())) if t is not None]
        nbytes = (x.numel() * s + mom.numel() * 4 + 2 * cin * 4
                  + sum(t.numel() * t.element_size() for t in conds) + w.numel() * s
                  + cout * 4 + b * h * wd * cout * s)
        return nbytes, 2.0 * b * h * wd * 9 * cin * cout, dtype
    if name == "gn_fold_apply":
        # x in, y out, the (2, B, C) moments and gamma/beta in; ~8 flops an
        # element (the fold's B x C work is a few hundredths of that)
        b, c = x.shape[0], x.shape[-1]
        return 2 * x.numel() * s + 2 * b * c * 4 + 2 * c * 4, 8.0 * x.numel(), dtype
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
    if name == "gn_silu_conv3x3_fold":
        return ops.ops.conv_design(x, args[7].to(x.dtype).contiguous(), args[5]) + " (folding)"
    if name == "qkv_attention":
        return ops.ops.attention_design(x, args[1])
    if name == "gn_fold_apply":
        gn = ops.ops.groupnorm
        b, n, c = gn._shape(x)
        plan = gn.moments_plan(b, n, c, x.element_size(), x.data_ptr())
        return f"fold + apply v{plan.v} cvb{plan.cvb} splits{plan.splits}"
    if name in ("gn_affine", *SLAB_OPS):
        gn = ops.ops.groupnorm
        b, n, c = gn._shape(x)
        groups = args[3]
        plan = gn.affine_plan(b, n, c, groups, x.element_size(), x.data_ptr())
        kind = (f"{gn.affine_design(x, groups)} v{plan.v} cvb{plan.cvb} splits{plan.splits} "
                f"{plan.fold}")
        if name == "gn_moments_slab":
            return kind + " (moments; folded in the conv)"
        return kind + " (moments) + fold + apply" if name in SLAB_OPS else kind
    return ops.ops.groupnorm_design(x, args[3])


def library_call(torch, F, name, args, kwargs):
    """One PyTorch call computing the same function (the conv alone on the
    pre-activated input for the fused conv), or None."""
    x = args[0]
    if name == "gn_fold_apply":
        # the nearest single call: GroupNorm with the slab's own statistics
        gamma, beta, groups = args[3].to(x.dtype), args[4].to(x.dtype), args[5]
        xc = x.reshape(x.shape[0], -1, x.shape[-1]).permute(0, 2, 1)
        return lambda: F.group_norm(xc, groups, gamma, beta, 1e-5)
    if name == "gn_silu_conv3x3_fold":
        # the conv alone on the input the kernel activates (as for the conv)
        from probabilisticdeepdiffusionmodels_torch.ops.groupnorm import gn_fold_plain

        mom, ranks, gamma, beta, groups, eps, w, bias = args[1:]
        ao = gn_fold_plain(mom / ranks, gamma, beta, groups, eps, **kwargs)
        args = (x, ao[0], ao[1], w, bias)
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


def check_sites(torch, F, ops, calls, per_site, summary=None, only=None, grads_timed=True):
    """Hold each recorded call's kernel against its plain version on the
    recorded inputs, time both and the library call, and emit one
    ``kernel_site`` line; sums go into ``summary`` by kernel name.  At each
    attention and GroupNorm site also its backward kernels
    (``attn_gn_grad_site``, timed where ``grads_timed``)."""
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
            lib = library_call(torch, F, name, a, kw)
            lib_ms = None if lib is None else sync_time(torch, lib)
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
        if name == "gn_affine":
            # both designs by name, each held against the plain version and
            # run twice, timed with and without the host's cost of a call
            gn, gc = ops.ops.groupnorm, ops.ops.gn_conv
            gamma, beta, mode, conds = gc.kernel_args(a[0], *a[1:4], kw.get("emb"),
                                                      kw.get("film"))
            conds = gc._named(mode, conds)
            rest = (a[3], a[4] if len(a) > 4 else kw.get("eps", 1e-5))
            site["design_ms"] = {}
            for d in sorted({gn.affine_design(a[0], a[3]), "workspace"}):
                def run(x=a[0], d=d):
                    return gn.moments_fold(x, gamma, beta, *rest, design=d, **conds)
                with torch.no_grad():
                    got, again = run(), run()
                    d_err = max(float((got[i] - refs[i].float()).abs().max()) for i in range(2))
                    site["design_ms"][d] = {"ms": sync_time(torch, run),
                                            "device_ms": device_ms(run),
                                            "same_bits_twice": torch.equal(got, again)}
                if not d_err <= tol or not site["design_ms"][d]["same_bits_twice"]:
                    raise AssertionError(f"{name} {site['shape']} design {d}: max abs err "
                                         f"{d_err} (tol {tol}), same bits twice "
                                         f"{site['design_ms'][d]['same_bits_twice']}")
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
        if name == "qkv_attention":
            attn_forward_designs(torch, F, ops, a, nbytes, refs, tol, site)
        if name == "gn_silu_conv3x3" and site["dtype"] == "bfloat16":
            site["grad_recompute"] = recompute_check(torch, ops.ops.gn_conv, a)
        if name == "gn_affine":
            grad_site(torch, ops, a, kw, n, site, per_site, summary)
        if name == "gn_silu_conv3x3":
            conv_grad_site(torch, ops, a, n, site, per_site, summary)
        if name in GRAD_OF:
            attn_gn_grad_site(torch, F, ops, name, a, kw, n, site, per_site, summary,
                              grads_timed)
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
            s[key] = None if val is None or s[key] is None else s[key] + n * val
        if "device_ms" in site:
            s["device_ms"] = s.get("device_ms", 0.0) + n * site["device_ms"]
        if site.get("library_device_ms") is not None:
            s["library_device_ms"] = s.get("library_device_ms", 0.0) + n * site["library_device_ms"]
        add_designs(s, site, n)
        for d, t in site.get("design_ms", {}).items():
            if "kernels" in t:
                per = s.setdefault("design_kernel_device_ms", {}).setdefault(f"{d} ({dtype})", {})
                for kname, kms in t["kernels"].items():
                    per[kname] = per.get(kname, 0.0) + n * kms
        s.setdefault("site_designs", []).append([site["shape"], site["design"], n])
        s["calls"] += n


def fold_fed(ops, name, a, kw):
    """(gn_fold alone, the consumer fed its (a, off)) of a folding
    consumer's recorded call: the first design, by name; the ranks' mean
    moments are formed once, outside both."""
    gn, gc = ops.ops.groupnorm, ops.ops.gn_conv
    x, mom, ranks, gamma, beta, groups, eps = a[:7]
    mean = mom / ranks
    if name == "gn_fold_apply":
        ao = gn.gn_fold(mean, gamma, beta, groups, eps)
        return (lambda: gn.gn_fold(mean, gamma, beta, groups, eps),
                lambda: gn.apply_affine(x, ao, a[7]))
    ao = gn.gn_fold(mean, gamma, beta, groups, eps, **kw)
    w, bias = a[7:]
    return (lambda: gn.gn_fold(mean, gamma, beta, groups, eps, **kw),
            lambda: gc.gn_silu_conv3x3(x, ao[0], ao[1], w, bias))


def fold_sites(torch, F, ops, calls, per_site, summary, timed=True, launches=20,
               replays=5):
    """Each recorded call of a consumer that folds a slab's summed
    statistics (``gn_fold_apply``, ``gn_silu_conv3x3_fold``) held against
    its plain version (``hold``'s tolerances), run twice for the same bits,
    and against its first design by name, gn_fold and the consumer fed
    gn_fold's (a, off): the same bits, so the same (a, off).  Device-only ms
    (``launches`` calls captured in a CUDA graph, replayed ``replays``
    times) of the folding consumer,
    of the consumer fed (a, off) and of gn_fold alone; where ``timed``, the
    wrapper-inclusive ms, the plain version's and the library call's too.
    One ``kernel_site`` line each; sums into ``summary`` by kernel name.
    Raises where a site misses a gate."""
    for entry in calls.values():
        name, a, kw, n = entry["name"], entry["args"], entry["kwargs"], entry["count"]
        if name not in SLAB_ONLY:
            continue
        kernel = ops.wrappers[name]
        nbytes, flops, dtype = work(name, a, kw)
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        outs, _, err, tol = hold(torch, ops, name, a, kw)
        fold_alone, fed = fold_fed(ops, name, a, kw)
        with torch.no_grad():
            again = kernel(*a, **kw)
            before = fed()
            site = {"kernel": name, "shape": list(a[0].shape), "design": design(ops, name, a),
                    "dtype": str(a[0].dtype).replace("torch.", ""), "calls_per_forward": n,
                    "ranks": a[2], "max_abs_err": err, "tol": tol,
                    "same_bits_twice": torch.equal(outs[0], again),
                    "same_bits_as_gn_fold_fed": torch.equal(outs[0], before),
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
            if name == "gn_silu_conv3x3_fold":
                site["mode"] = ("emb" if kw.get("emb") is not None
                                else "film" if kw.get("film") is not None else "plain")
            del again, before
            site["device_ms"] = graph_time(torch, lambda: kernel(*a, **kw), launches, replays)
            site["fed_device_ms"] = graph_time(torch, fed, launches, replays)
            site["gn_fold_device_ms"] = graph_time(torch, fold_alone, launches, replays)
            ms = plain_ms = lib_ms = None
            if timed:  # (a few calls each: the slab sites' convs take up to 3.6 ms)
                ms = sync_time(torch, lambda: kernel(*a, **kw), 20.0, 5)
                plain_ms = sync_time(torch, lambda: ops.plain[name](*a, **kw), 20.0, 5)
                lib = library_call(torch, F, name, a, kw)
                lib_ms = None if lib is None else sync_time(torch, lib, 20.0, 5)
            site.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms)
        per_site.append(site)
        emit(dict(phase="kernel_site", **site))
        if not (err <= tol and site["same_bits_twice"] and site["same_bits_as_gn_fold_fed"]):
            raise AssertionError(f"{name} {site['shape']} {site['dtype']}: max abs err {err} "
                                 f"(tol {tol}), same bits twice {site['same_bits_twice']}, "
                                 f"the same bits as gn_fold + the consumer fed its (a, off) "
                                 f"{site['same_bits_as_gn_fold_fed']}")
        s = summary.setdefault(name, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
                                          bytes_ms=0.0, ops_ms=0.0, bound_ms=0.0, calls=0,
                                          device_ms=0.0, fed_device_ms=0.0,
                                          gn_fold_device_ms=0.0))
        s["max_abs_err"] = max(s["max_abs_err"], err)
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                         ("bytes_ms", t_bytes), ("ops_ms", t_ops),
                         ("bound_ms", max(t_bytes, t_ops)), ("device_ms", site["device_ms"]),
                         ("fed_device_ms", site["fed_device_ms"]),
                         ("gn_fold_device_ms", site["gn_fold_device_ms"])):
            s[key] = None if val is None or s[key] is None else s[key] + n * val
        s.setdefault("site_designs", []).append([site["shape"], site["design"], n])
        s["design"] = ", ".join(sorted(set(filter(None, s.get("design", "").split(", ")))
                                       | {site["design"]}))
        s["calls"] += n


@contextlib.contextmanager
def gn_fold_slabs(ops, spatial):
    """The slab ops in their first design, by name (forward only, no tp):
    the moments averaged over the ranks (a copy, the all-reduce, a divide),
    ``gn_fold``, then the apply kernel or the conv fed (a, off)."""
    gn, gc = ops.ops.groupnorm, ops.ops.gn_conv

    def norm_slab(x, gamma, beta, groups, eps, silu, total, ranks):
        rows = spatial.active()
        return gn.group_norm_silu_slab_gn_fold(x, gamma, beta, groups, eps, silu,
                                               lambda m: spatial.average(m, rows))

    def conv_slab(x, norm, conv, rows, emb, film):
        a, off = gc.gn_affine_slab(x, norm.weight, norm.bias, norm.groups, norm.eps,
                                   lambda m: spatial.average(m, rows), emb=emb, film=film)
        h = x.shape[1]
        x, top, _ = spatial.halo(x, 1, 1, rows)
        y = gc.gn_silu_conv3x3(x, a, off, conv.weight, conv.bias)
        return y[:, top:top + h].contiguous()

    saved = ops.layers.group_norm_silu_slab, ops.unet._gn_silu_conv_slab
    ops.layers.group_norm_silu_slab, ops.unet._gn_silu_conv_slab = norm_slab, conv_slab
    try:
        yield
    finally:
        ops.layers.group_norm_silu_slab, ops.unet._gn_silu_conv_slab = saved


ATTN_LSE_TOL = 1e-4  # each row's log-sum-exp, of the plain one's largest element


def attn_forward_designs(torch, F, ops, a, nbytes, refs, tol, site):
    """Attention's forward at one recorded site in the design the shape
    selects and, where ``wgmma`` takes the shape, in the other bf16 design
    by name (``wgmma`` or ``mma_ring``), so that each site shows both sides
    of the choice's grid-fill rule: each held against the plain version (``tol``) with each row's
    log-sum-exp against the plain one of the scaled scores (ATTN_LSE_TOL),
    run twice for the same bits with one count a call, timed with the
    host's cost and device-only (a CUDA graph over copies of qkv that do not
    fit L2 together), each kernel's device ms from a profile of that graph;
    SDPA's forward device-only on the same copies, from a profile of its
    calls (the library's yardstick; the port never calls it).  Into
    ``site``: ``design_ms``, ``device_ms`` (the selected design's) and
    ``library_device_ms``; raises where a design misses a gate."""
    mod = ops.ops.attention
    x, heads = a[0], a[1]
    b, t, c3 = x.shape
    ch = c3 // (3 * heads)
    kernel = ops.wrappers["qkv_attention"]
    with torch.no_grad():
        q, k, _ = mod._split_heads(x, heads)
        scale = 1.0 / math.sqrt(math.sqrt(ch))
        lse_ref = torch.logsumexp(torch.einsum("bthc,bshc->bhts", (q * scale).float(),
                                               (k * scale).float()), -1)
        lse_tol = ATTN_LSE_TOL * max(1.0, float(lse_ref.abs().max()))
        copies = cold_copies(x, nbytes)
        per_graph = max(1, 100 // len(copies))
        by_design, worst = {}, None
        both = site["design"] != "scalar_f32" and mod._fwd_wgmma_takes(t, heads, ch)
        others = [d for d in ("wgmma", "mma_ring") if both and d != site["design"]]
        for d in (site["design"], *others):
            before = kernel.launches
            runs = [mod.attention_forward(x, heads, d) for _ in range(2)]
            torch.cuda.synchronize()
            launches = kernel.launches - before
            err = float((runs[0][0].float() - refs[0].float()).abs().max())
            lse_err = float((runs[0][1] - lse_ref).abs().max())
            same = all(torch.equal(p, q_) for p, q_ in zip(runs[0], runs[1]))
            del runs

            def one_round(d=d):
                for c in copies:
                    mod.qkv_attention(c, heads, design=d)

            graph = capture_graph(torch, one_round, per_graph)
            by_design[d] = {
                "max_abs_err": err, "tol": tol, "lse_max_abs_err": lse_err, "lse_tol": lse_tol,
                "same_bits_twice": same, "launches_two_calls": launches,
                "ms": sync_time(torch, lambda d=d: mod.qkv_attention(x, heads, design=d)),
                "device_ms": replay_ms(torch, graph, 10) / (per_graph * len(copies)),
                "kernels": graph_kernels(torch, graph, per_graph * len(copies))}
            del graph
            if not (err <= tol and lse_err <= lse_tol and same and launches == 2):
                worst = f"design {d}: {by_design[d]}"
        views = [c.view(b, t, heads, 3 * ch).permute(0, 2, 1, 3) for c in copies]

        def library_round():
            for v in views:
                F.scaled_dot_product_attention(v[..., :ch], v[..., ch:2 * ch], v[..., 2 * ch:],
                                               scale=1.0 / ch ** 0.5)

        busy = profile_device(torch, library_round)["device_busy_ms"]
        n_copies = len(copies)
        del copies, views
    site["design_ms"] = by_design
    site["device_ms"] = by_design[site["design"]]["device_ms"]
    site["library_device_ms"] = busy / n_copies if busy > 0 else None
    if worst is not None:
        raise AssertionError(f"qkv_attention {site['shape']}: {worst} (kernel vs plain within "
                             f"tol, its log-sum-exp within {ATTN_LSE_TOL}, the same bits "
                             f"twice, one count a call)")


def add_designs(s, site, n):
    """Into a kernel's summary: the designs that ran at its sites and, where
    the site timed its designs by name, each one's device-only ms over the
    sites, ``n`` calls a forward."""
    if "design_ms" not in site:
        return
    ran = site["design"].split()[0]
    s["design"] = ", ".join(sorted(set(filter(None, s.get("design", "").split(", "))) | {ran}))
    per = s.setdefault("design_device_ms", {})
    for d, t in site["design_ms"].items():
        per[d] = per.get(d, 0.0) + n * t["device_ms"]


def grad_site(torch, ops, a, kw, n, affine_site, per_site, summary):
    """``gn_affine``'s backward kernels at one recorded site, on seeded
    gradients of (a, off), against autograd through the plain version: each
    gradient within 2e-2 (bf16) or 1e-4 (float32: another formula and order
    of sums) of its reference's largest element, in the design the shape
    selects and in the first design by name, each run twice for the same
    bits and timed with and without the host's cost of a call."""
    gn_conv = ops.ops.gn_conv
    x = a[0]
    gen = torch.Generator(device="cuda").manual_seed(11)
    ga, goff = torch.randn(2, x.shape[0], x.shape[-1], device="cuda", generator=gen)
    with torch.no_grad():
        ao = ops.ops.groupnorm.moments_fold(*a, **kw)
    ref = gn_conv.gn_affine_grad_plain(*a, ga, goff, **kw)
    # x read, dL/dx written, the (B, C)-sized rest; a multiply-add an element
    nbytes = 2 * x.numel() * x.element_size() + 14 * ga.numel() * 4
    chosen = gn_conv.grad_design(x, a[3])
    designs, worst = {}, None
    for d in sorted({chosen, "fold_bwd+apply"}):
        def run(xc=x, d=d):
            return gn_conv.gn_affine_grad(xc, *a[1:], ga, goff, ao, design=d, **kw)

        with torch.no_grad():
            before = gn_conv.gn_affine_grad.launches
            got, again = run(), run()
            torch.cuda.synchronize()
            launches = gn_conv.gn_affine_grad.launches - before
        err, tol = 0.0, 1.0
        for p, q in zip(got, ref):
            if p.dtype != q.dtype or p.shape != q.shape:
                raise AssertionError(f"gn_affine_grad {d}: {p.dtype} {tuple(p.shape)} against "
                                     f"{q.dtype} {tuple(q.shape)}")
            e = float((p.float() - q.float()).abs().max())
            t = ((2e-2 if q.dtype == torch.bfloat16 else 1e-4)
                 * max(1e-30, float(q.float().abs().max())))
            if not e <= t or e / t >= err / tol:
                err, tol = e, t
        with torch.no_grad():
            # without the host's cost of a call, over copies of x that do
            # not fit the L2 cache together, as gn_affine's device_ms
            xs = cold_copies(x, nbytes)

            def one_round():
                for xc in xs:
                    run(xc)

            designs[d] = {"ms": sync_time(torch, run),
                          "device_ms": graph_time(torch, one_round, max(1, 100 // len(xs)),
                                                  10) / len(xs),
                          "max_abs_err": err, "tol": tol, "launches_two_calls": launches,
                          "same_bits_twice": all(torch.equal(p, q) for p, q in zip(got, again))}
            del xs
        if not err <= tol or launches != 2 or not designs[d]["same_bits_twice"]:
            worst = f"design {d}: {designs[d]}"
    plain_ms = sync_time(torch, lambda: gn_conv.gn_affine_grad_plain(*a, ga, goff, **kw))
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, 2.0 * x.numel() / PEAK_FLOPS["float32"] * 1e3
    main = designs[chosen]
    site = {"kernel": "gn_affine_grad", "shape": affine_site["shape"],
            "dtype": affine_site["dtype"], "mode": affine_site["mode"], "design": chosen,
            "calls_per_forward": n, "max_abs_err": main["max_abs_err"], "tol": main["tol"],
            "ms": main["ms"], "device_ms": main["device_ms"],
            "same_bits_twice": main["same_bits_twice"], "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "design_ms": {d: {k: v[k] for k in ("ms", "device_ms", "same_bits_twice")}
                          for d, v in designs.items()}}
    per_site.append(site)
    emit(dict(phase="kernel_site", **site))
    if worst is not None:
        raise AssertionError(f"gn_affine_grad {site['shape']} {site['mode']}: {worst} (kernel "
                             f"vs plain within tol, one launch a call, the same bits twice)")
    if summary is None:
        return
    s = summary.setdefault("gn_affine_grad", dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                                                  library_ms=None, bytes_ms=0.0, ops_ms=0.0,
                                                  bound_ms=0.0, calls=0))
    s["max_abs_err"] = max(s["max_abs_err"], main["max_abs_err"])
    for key, val in (("ms", main["ms"]), ("device_ms", main["device_ms"]),
                     ("plain_ms", plain_ms), ("bytes_ms", t_bytes), ("ops_ms", t_ops),
                     ("bound_ms", max(t_bytes, t_ops))):
        s[key] = s.get(key, 0.0) + n * val
    add_designs(s, site, n)
    s["calls"] += n


# attention's and GroupNorm's backward kernels against their plain versions,
# of the reference's largest element: bf16 outputs each side rounds
# once from float32 values that differ in their last bits (a bf16 step is
# 2^-8 of the value), float32 sums in another order, as the conv's gradient
ATTN_GN_GRAD_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
GRAD_OF = {"qkv_attention": "qkv_attention_grad", "group_norm_silu": "group_norm_silu_grad"}


def attn_gn_grad_site(torch, F, ops, name, a, kw, n, fwd_site, per_site, summary, timed=True):
    """The backward kernels of ``qkv_attention`` or ``group_norm_silu`` at one
    recorded site, on a seeded output gradient, against the plain backward
    (within ATTN_GN_GRAD_TOL of each reference's largest element), in the
    design the shape selects, run twice for the same bits with one count a
    call.  ``timed``: also the ms with and without the host's cost (a CUDA
    graph over copies of the inputs that do not fit L2 together) and each
    kernel's device ms from a profile of that graph, beside the parent's
    path (``recompute``: autograd through the plain version), the plain
    backward, the library's backward alone, with and without the host's
    cost (attention: SDPA's flash backend on the same q, k, v in bf16, its
    memory-efficient one in float32, device time from a profile; GroupNorm:
    ``aten.native_group_norm_backward`` on the same values in NCHW, without
    the SiLU, device time from a CUDA graph of its calls) and the bound."""
    gname = GRAD_OF[name]
    kernel = ops.wrappers[gname]
    x = a[0]
    dtype = str(x.dtype).replace("torch.", "")
    s = x.element_size()
    gen = torch.Generator(device="cuda").manual_seed(17)
    lib = lib_device = None
    if name == "qkv_attention":
        mod = ops.ops.attention
        heads = a[1] if len(a) > 1 else kw.get("num_heads", 1)
        b, t, c3 = x.shape
        ch = c3 // (3 * heads)
        with torch.no_grad():
            out, lse = mod.attention_forward(x, heads)
        g = torch.randn(out.shape, device="cuda", generator=gen).to(x.dtype)
        chosen = mod.attention_grad_design(x, heads)
        inputs = (x, g, lse)

        def run(xc, gg, lc, d=None):
            return (kernel(xc, gg, heads, lse=lc, design=d),)

        def plain():
            return (mod.qkv_attention_grad_plain(x, g, heads),)

        # qkv, dO and the log-sum-exp read, dqkv written; the five products
        # of FlashAttention-2's backward
        nbytes = (2 * x.numel() + out.numel()) * s + lse.numel() * 4
        flops = 10.0 * b * heads * t * t * ch
        if timed:
            from torch.nn.attention import SDPBackend, sdpa_kernel

            qh = x.view(b, t, heads, 3 * ch).permute(0, 2, 1, 3)
            qkv_l = [z.detach().clone().requires_grad_(True)
                     for z in (qh[..., :ch], qh[..., ch:2 * ch], qh[..., 2 * ch:])]
            # flash takes bf16 only; float32 takes the memory-efficient backend
            with sdpa_kernel(SDPBackend.FLASH_ATTENTION if x.dtype == torch.bfloat16
                             else SDPBackend.EFFICIENT_ATTENTION):
                o_l = F.scaled_dot_product_attention(*qkv_l, scale=1.0 / ch ** 0.5)
            go_l = g.view(b, t, heads, ch).permute(0, 2, 1, 3)

            def lib():
                return torch.autograd.grad(o_l, qkv_l, go_l, retain_graph=True)

            def lib_device():
                # from a profile of 10 calls (autograd's backward does not
                # capture into a graph from here); None where the profile
                # recorded no device time
                busy = profile_device(torch, lambda: [lib() for _ in range(10)])["device_busy_ms"]
                return busy / 10 if busy > 0 else None
    else:
        gn = ops.ops.groupnorm
        groups, eps = a[3], a[4] if len(a) > 4 else kw.get("eps", 1e-5)
        silu = kw.get("silu", a[5] if len(a) > 5 else True)
        gamma, beta = gn.check_inputs(name, *a[:4])
        with torch.no_grad():
            _, ao = gn._launch(x, gamma, beta, groups, eps, silu, want_ao=True)
        g = torch.randn(x.shape, device="cuda", generator=gen).to(x.dtype)
        chosen = gn.groupnorm_grad_design(x, groups)
        inputs = (x, g, ao)

        def run(xc, gg, ac, d=None):
            return kernel(xc, gamma, beta, gg, groups, eps, silu, ao=ac, design=d)

        def plain():
            return gn.group_norm_silu_grad_plain(x, gamma, beta, g, groups, eps, silu, ao=ao)

        # x and g read, dx written, the statistics read, dgamma and dbeta
        # written; about 20 float32 operations an element
        nbytes = 3 * x.numel() * s + ao.numel() * 4 + 4 * gamma.numel() * 4
        flops = 20.0 * x.numel()
        if timed:
            bb, nn_, cc = gn._shape(x)
            xc_ = x.reshape(bb, nn_, cc).permute(0, 2, 1).contiguous()
            gc_ = g.reshape(bb, nn_, cc).permute(0, 2, 1).contiguous()
            w_, bias_ = gamma.to(x.dtype), beta.to(x.dtype)
            _, mean_, rstd_ = torch.ops.aten.native_group_norm(xc_, w_, bias_, bb, cc, nn_,
                                                               groups, eps)

            def lib():
                return torch.ops.aten.native_group_norm_backward(
                    gc_, xc_, mean_, rstd_, w_, bb, cc, nn_, groups, [True, True, True])
            lib_device = lambda: graph_time(torch, lib, 20, 10)  # noqa: E731
    ref = plain()
    tol_rel = ATTN_GN_GRAD_TOL[dtype]
    # the design the shape selects and, where attention runs wgmma or
    # GroupNorm tma_resident, its earlier design by name
    earlier = (ATTN_GRAD_EARLIER if name == "qkv_attention" else GN_GRAD_EARLIER).get(chosen)
    designs = [chosen] + ([earlier] if earlier else [])
    by_design, worst = {}, None
    for d in designs:
        with torch.no_grad():
            before = kernel.launches
            got, again = run(*inputs, d=d), run(*inputs, d=d)
            torch.cuda.synchronize()
            launches = kernel.launches - before
        err, tol = 0.0, 1.0
        for mine, want in zip(got, ref):
            if mine.dtype != want.dtype or mine.shape != want.shape:
                raise AssertionError(f"{gname} {d}: {mine.dtype} {tuple(mine.shape)} against "
                                     f"{want.dtype} {tuple(want.shape)}")
            e = float((mine.float() - want.float()).abs().max())
            t_ = tol_rel * max(1e-30, float(want.float().abs().max()))
            if not e <= t_ or e / t_ >= err / tol:
                err, tol = e, t_
        same = all(torch.equal(first, second) for first, second in zip(got, again))
        del got, again
        by_design[d] = {"max_abs_err": err, "tol": tol, "same_bits_twice": same,
                        "launches_two_calls": launches}
        if not err <= tol or not same or launches != 2:
            worst = f"design {d}: {by_design[d]}"
    main = by_design[chosen]
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    site = {"kernel": gname, "shape": fwd_site["shape"], "dtype": dtype, "design": chosen,
            "calls_per_forward": n, **main, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    if timed:
        with torch.no_grad():
            copies = [tuple(z.clone() for z in inputs)
                      for _ in range(len(cold_copies(x, nbytes)))]
            per_graph = max(1, 100 // len(copies))
            for d in designs:
                def one_round(d=d):
                    for c in copies:
                        run(*c, d=d)
                graph = capture_graph(torch, one_round, per_graph)
                by_design[d]["ms"] = sync_time(torch, lambda d=d: run(*inputs, d=d))
                by_design[d]["device_ms"] = replay_ms(torch, graph, 10) / (per_graph * len(copies))
                by_design[d]["kernels"] = graph_kernels(torch, graph, per_graph * len(copies))
                del graph
            del copies
            if chosen == "tma_resident":
                site["programmatic_edges"] = graph_edges(torch, lambda: run(*inputs))
            site.update({k: by_design[chosen][k] for k in ("ms", "device_ms", "kernels")})
            if len(designs) > 1:
                site["design_ms"] = by_design
            site["plain_ms"] = sync_time(torch, plain)
        site["recompute_ms"] = sync_time(torch, lambda: run(*inputs, d="recompute"))
        site["library_ms"] = None if lib is None else sync_time(torch, lib)
        site["library_device_ms"] = None if lib_device is None else lib_device()
    per_site.append(site)
    emit(dict(phase="kernel_site", **site))
    if worst is not None:
        raise AssertionError(f"{gname} {site['shape']} {dtype}: {worst} (kernel vs plain within "
                             f"tol, the same bits twice, one launch a call)")
    if summary is None or not timed:
        return
    sm = summary.setdefault(gname, dict(max_abs_err=0.0, calls=0, library_ms=0.0))
    sm["max_abs_err"] = max(sm["max_abs_err"], main["max_abs_err"])
    sm["design"] = ", ".join(sorted(set(filter(None, sm.get("design", "").split(", ")))
                                    | {chosen}))
    for key, val in (("ms", site["ms"]), ("device_ms", site["device_ms"]),
                     ("plain_ms", site["plain_ms"]), ("recompute_ms", site["recompute_ms"]),
                     ("library_ms", site["library_ms"]),
                     ("library_device_ms", site["library_device_ms"]), ("bytes_ms", t_bytes),
                     ("ops_ms", t_ops), ("bound_ms", max(t_bytes, t_ops))):
        sm[key] = None if val is None or sm.get(key, 0.0) is None else sm.get(key, 0.0) + n * val
    add_designs(sm, site, n)
    for d, t in by_design.items():
        per = sm.setdefault("design_kernel_device_ms", {}).setdefault(f"{d} ({dtype})", {})
        for kname, ms in t["kernels"].items():
            per[kname] = per.get(kname, 0.0) + n * ms
    sm["calls"] += n


def grad_sites(torch, F, ops, calls, per_site, summary=None, timed=True):
    """``attn_gn_grad_site`` at each recorded attention and GroupNorm call."""
    for entry in calls.values():
        if entry["name"] in GRAD_OF:
            a = entry["args"]
            fwd = {"shape": list(a[0].shape)}
            attn_gn_grad_site(torch, F, ops, entry["name"], a, entry["kwargs"], entry["count"],
                              fwd, per_site, summary, timed)


# the conv's backward kernels against the plain backward: float32 sums over
# up to 131,072 pixels in another order (float32); the kernel keeps the
# conv's input gradient in float32 where the plain version rounds it to bf16
CONV_GRAD_F32_TOL = 1e-4
# the designs run beside the one a shape selects: the conv gradient's
# earlier designs for that shape, by name, the first timed and the rest
# checked against the plain backward untimed (wgmma_sync_epilogue: the bf16
# pair before the ping-pong dgrad; wgmma_taprow: the first bf16 pair;
# general: the head's first); attention's
ATTN_GRAD_EARLIER = {"wgmma": "two_pass"}
# GroupNorm's gradient: the fused design, by name beside tma_resident
GN_GRAD_EARLIER = {"tma_resident": "fused"}
CONV_GRAD_EARLIER = {"wgmma": ("wgmma_sync_epilogue", "wgmma_taprow"), "narrow_f32": ("general",)}


# attention's and GroupNorm's gradients as recompute by name (autograd
# through the plain versions): (module name, attribute) -> the design
# function swapped in
ATTN_GN_RECOMPUTE = {("attention", "attention_grad_design"): lambda qkv, heads=1: "recompute",
                     ("groupnorm", "groupnorm_grad_design"): lambda x, groups=32: "recompute"}


@contextlib.contextmanager
def swapped_designs(ops, swap):
    """Design functions swapped for a run: ``swap`` maps an attribute of
    ``ops.gn_conv`` (a name) or (module name under ``ops``, attribute) to
    the function swapped in; restored after."""
    def owner(key):
        return (ops.ops.gn_conv, key) if isinstance(key, str) else (getattr(ops.ops, key[0]),
                                                                      key[1])
    saved = {key: getattr(*owner(key)) for key in swap}
    try:
        for key, fn in swap.items():
            setattr(*owner(key), fn)
        yield
    finally:
        for key, fn in saved.items():
            setattr(*owner(key), fn)


def earlier_designs(selects, earlier=CONV_GRAD_EARLIER):
    """A design function that picks the latest earlier design for each shape
    where ``selects`` picks one that has an earlier design by name."""
    def pick(*a):
        d = earlier.get(selects(*a), selects(*a))
        return d if isinstance(d, str) else d[0]
    return pick


def parent_designs(ops):
    """The conv's, attention's and GroupNorm's gradients and attention's
    forward in the designs before their last redesigns
    (``wgmma_sync_epilogue``, ``two_pass``, ``fused``, ``mma_ring``), by
    name: a swap for ``swapped_designs``."""
    return {"conv_grad_design": earlier_designs(ops.ops.gn_conv.conv_grad_design),
            ("attention", "attention_grad_design"): earlier_designs(
                ops.ops.attention.attention_grad_design, ATTN_GRAD_EARLIER),
            ("groupnorm", "groupnorm_grad_design"): earlier_designs(
                ops.ops.groupnorm.groupnorm_grad_design, GN_GRAD_EARLIER),
            ("attention", "attention_design"): earlier_designs(
                ops.ops.attention.attention_design, {"wgmma": "mma_ring"})}


def kernel_name(key):
    """A profiler key without its return type, namespaces and argument list:
    ``dgrad_pingpong_kernel<1, 128, true>``."""
    key = key.replace("(anonymous namespace)::", "").replace("void ", "", 1)
    base, sep, args = key.split("(")[0].partition("<")
    return base.split("::")[-1].strip() + sep + args


def conv_grad_site(torch, ops, a, n, conv_site, per_site, summary):
    """``gn_silu_conv3x3``'s backward kernels (``gn_silu_conv3x3_grad``) at
    one recorded site, on a seeded output gradient, against the plain
    backward (each gradient within RECOMPUTE_TOL of its reference's largest
    element in bf16, CONV_GRAD_F32_TOL in float32), in the design the shape
    selects and in the earlier ones for that shape by name (``wgmma_sync_epilogue``
    and ``wgmma_taprow`` at the bf16 sites, ``general`` at the float32 head),
    each run twice for the same bits with one count a call; the selected
    design and the latest earlier one timed with and without the host's cost
    of a call (``design_ms``: a CUDA graph over inputs that do not fit L2
    together), with each kernel's device ms a call from a profile of that
    graph by kernel name (lower bounds: the profiler drops records), and the
    older ones only checked (``checked_designs``); beside
    the parent's path (``recompute``: autograd through ``_grad_reference``),
    the plain backward, ``torch.ops.aten.convolution_backward`` device-only
    (the two bare products; the weight product with dbias alone, output
    mask (False, True, True); the input product alone, (True, False,
    False)), the bound of the two products, of the input product (dgrad:
    x, h, dx and g moved once, the product of the forward's size) and of
    the weight product."""
    gc = ops.ops.gn_conv
    x, sc, off, w, _ = a
    wk = w.to(x.dtype).contiguous()
    b, h, wd, cin = x.shape
    cout = wk.shape[2]
    gen = torch.Generator(device="cuda").manual_seed(13)
    g = torch.randn(b, h, wd, cout, device="cuda", generator=gen).to(x.dtype)
    ref = gc.gn_silu_conv3x3_grad_plain(x, sc, off, wk, g)
    chosen = gc.conv_grad_design(x, wk)
    earlier = CONV_GRAD_EARLIER.get(chosen, ())
    designs, checked = [chosen, *earlier[:1]], list(earlier[1:])
    s = x.element_size()
    # x and g read, dx and dw written, w, the scale and offset read, their
    # gradients and dbias written; two products of the forward's size
    nbytes = (2 * x.numel() + g.numel() + 2 * wk.numel()) * s + 6 * b * cin * 4 + cout * 4
    flops = 2 * 2.0 * b * h * wd * 9 * cin * cout
    dtype = str(x.dtype).replace("torch.", "")
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    # the weight product alone: x (as h) and g read, dw and dbias written
    w_bytes = (x.numel() + g.numel() + wk.numel()) * s + cout * 4
    wgrad_bound = max(w_bytes / PEAK_BYTES * 1e3, flops / 2 / PEAK_FLOPS[dtype] * 1e3)
    # the input product with the activation's backward: x read, h and dx
    # written (h where the weight product reads it: bf16), g read
    d_bytes = ((3 if x.dtype == torch.bfloat16 else 2) * x.numel() + g.numel()) * s
    dgrad_bound = max(d_bytes / PEAK_BYTES * 1e3, flops / 2 / PEAK_FLOPS[dtype] * 1e3)

    def run(xc=x, gg=g, d=chosen):
        return gc.gn_silu_conv3x3_grad(xc, sc, off, wk, gg, design=d)

    def activated(xc):
        y = xc.float() * sc[:, None, None, :] + off[:, None, None, :]
        return (y * torch.sigmoid(y)).to(x.dtype).permute(0, 3, 1, 2)

    w_oihw = wk.permute(2, 3, 0, 1).contiguous(memory_format=torch.channels_last)

    def library(hh, gg, mask):
        return torch.ops.aten.convolution_backward(
            gg.permute(0, 3, 1, 2), hh, w_oihw, [cout], [1, 1], [1, 1], [1, 1], False, [0, 0],
            1, list(mask))

    by_design, by_check, worst = {}, {}, None
    with torch.no_grad():
        # copies of (x, g) that do not fit the L2 cache together
        pairs = [(x.clone(), g.clone()) for _ in range(len(cold_copies(x, nbytes)))]
        hs = [activated(xc) for xc, _ in pairs]
        per_graph = max(1, 100 // len(pairs))

        def rounds(fn):
            def go():
                for i, (xc, gg) in enumerate(pairs):
                    fn(i, xc, gg)
            return go

        for d in designs + checked:
            before = gc.gn_silu_conv3x3_grad.launches
            got, again = run(d=d), run(d=d)
            torch.cuda.synchronize()
            launches = gc.gn_silu_conv3x3_grad.launches - before
            err, tol = 0.0, 1.0
            for p, q in zip(got, ref):
                if p.dtype != q.dtype or p.shape != q.shape:
                    raise AssertionError(f"gn_silu_conv3x3_grad {d}: {p.dtype} {tuple(p.shape)} "
                                         f"against {q.dtype} {tuple(q.shape)}")
                e = float((p.float() - q.float()).abs().max())
                t = ((RECOMPUTE_TOL if x.dtype == torch.bfloat16 else CONV_GRAD_F32_TOL)
                     * max(1e-30, float(q.float().abs().max())))
                if not e <= t or e / t >= err / tol:
                    err, tol = e, t
            same = all(torch.equal(p, q) for p, q in zip(got, again))
            del got, again
            if d in checked:
                by_check[d] = {"max_abs_err": err, "tol": tol, "same_bits_twice": same,
                               "launches_two_calls": launches}
                if not err <= tol or not same or launches != 2:
                    worst = f"design {d}: {by_check[d]}"
                continue
            one_round = rounds(lambda i, xc, gg, d=d: run(xc, gg, d))
            graph = capture_graph(torch, one_round, per_graph)
            by_design[d] = {
                "ms": sync_time(torch, lambda d=d: run(d=d)),
                "device_ms": replay_ms(torch, graph, 10) / (per_graph * len(pairs)),
                "kernels": graph_kernels(torch, graph, per_graph * len(pairs)),
                "max_abs_err": err, "tol": tol, "same_bits_twice": same,
                "launches_two_calls": launches}
            del graph
            if not err <= tol or not same or launches != 2:
                worst = f"design {d}: {by_design[d]}"
        lib = {}
        for key, mask in (("library_ms", (True, True, True)),
                          ("library_weight_ms", (False, True, True)),
                          ("library_input_ms", (True, False, False))):
            lib[key] = graph_time(torch, rounds(lambda i, xc, gg, m=mask: library(hs[i], gg, m)),
                                  per_graph, 10) / len(pairs)
        del pairs, hs
        plain_ms = sync_time(torch, lambda: gc.gn_silu_conv3x3_grad_plain(x, sc, off, wk, g))
    parent_ms = sync_time(torch, lambda: run(d="recompute"))
    main = by_design[chosen]
    site = {"kernel": "gn_silu_conv3x3_grad", "shape": conv_site["shape"],
            "cout": cout, "dtype": conv_site["dtype"], "design": chosen,
            "calls_per_forward": n, "max_abs_err": main["max_abs_err"], "tol": main["tol"],
            "ms": main["ms"], "device_ms": main["device_ms"],
            "same_bits_twice": main["same_bits_twice"],
            "launches_two_calls": main["launches_two_calls"], "recompute_ms": parent_ms,
            "plain_ms": plain_ms, **lib, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "wgrad_bound_ms": wgrad_bound, "dgrad_bound_ms": dgrad_bound,
            "dgrad_bytes_ms": d_bytes / PEAK_BYTES * 1e3, "design_ms": by_design,
            "checked_designs": by_check}
    per_site.append(site)
    emit(dict(phase="kernel_site", **site))
    if worst is not None:
        raise AssertionError(f"gn_silu_conv3x3_grad {site['shape']} -> {cout} {site['dtype']}: "
                             f"{worst} (kernel vs plain within tol, the same bits twice, one "
                             f"launch a call)")
    if summary is None:
        return
    s = summary.setdefault("gn_silu_conv3x3_grad", dict(max_abs_err=0.0, calls=0))
    s["max_abs_err"] = max(s["max_abs_err"], main["max_abs_err"])
    for key, val in (("ms", main["ms"]), ("device_ms", main["device_ms"]),
                     ("plain_ms", plain_ms), ("recompute_ms", parent_ms),
                     ("library_device_ms", lib["library_ms"]), ("bytes_ms", t_bytes),
                     ("ops_ms", t_ops), ("bound_ms", max(t_bytes, t_ops)),
                     ("wgrad_bound_ms", wgrad_bound), ("dgrad_bound_ms", dgrad_bound),
                     ("dgrad_bytes_ms", d_bytes / PEAK_BYTES * 1e3), *lib.items()):
        s[key] = s.get(key, 0.0) + n * val
    add_designs(s, site, n)
    # each kernel's device ms over the sites, by design (bf16 sites and the
    # head apart), from the graphs' profiles
    per = s.setdefault("design_kernel_device_ms", {})
    for d, t in by_design.items():
        into = per.setdefault(f"{d} ({site['dtype']})", {})
        for name, ms in t["kernels"].items():
            into[name] = into.get(name, 0.0) + n * ms
    s["calls"] += n


# a float32 fused-conv site's device-only times: calls captured in one CUDA
# graph and its replays (general takes up to 10 ms a call at batch 128)
F32_CONV_LAUNCHES, F32_CONV_REPLAYS = 3, 3
# the design timed beside the one a float32 site selects, by name
F32_CONV_EARLIER = "general"


def few_ms(torch, fn, reps=2):
    """ms a call of ``fn`` by CUDA events over ``reps`` calls after one
    warm-up: the plain versions at batch 128 in float32 take 10-100 ms."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def f32_conv_site(torch, F, ops, a, n, per_site, summary):
    """One fused-conv signature of a float32 batch-128 forward (``a``: the
    recorded call, ``n`` calls a forward), forward and gradient: the design
    the shape selects (``tiled_f32``) and ``general`` by name, each held
    against the plain version (forward: ``hold``'s tolerance; gradient:
    CONV_GRAD_F32_TOL of each gradient's largest element, on a seeded output
    gradient), run twice for the same bits with one count a call, and timed
    device-only (F32_CONV_LAUNCHES calls in a CUDA graph, F32_CONV_REPLAYS
    replays; the gradient's input product with its finish, needs (x, a,
    off), and its weight product, needs (w, bias), apart); beside the
    library's calls device-only (``F.conv2d`` on the activated input, the
    input and the weight products of ``convolution_backward``, TF32 off,
    cuDNN's settings recorded), the plain versions' ms and the bounds at
    the float32 peak.  Two ``kernel_site`` lines; sums into ``summary``
    (``gn_silu_conv3x3 (float32)``, ``gn_silu_conv3x3_grad (float32)``)."""
    gc = ops.ops.gn_conv
    x, sc, off, w, bias = a
    wk = w.to(x.dtype).contiguous()
    b, h, wd, cin = x.shape
    cout = wk.shape[2]
    flops = 2.0 * b * h * wd * 9 * cin * cout
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    cudnn = {"allow_tf32": torch.backends.cudnn.allow_tf32,
             "deterministic": torch.backends.cudnn.deterministic,
             "benchmark": torch.backends.cudnn.benchmark}

    def graph_ms(fn):
        return graph_time(torch, fn, F32_CONV_LAUNCHES, F32_CONV_REPLAYS)

    worst = []
    # the forward
    nbytes, _, _ = work("gn_silu_conv3x3", a, {})
    chosen = gc.conv_design(x, wk)
    fwd = {}
    with torch.no_grad():
        ref = gc.gn_silu_conv3x3_plain(*a)
        tol = 1e-4 * max(1.0, float(ref.abs().max()))
        for d in (chosen, F32_CONV_EARLIER):
            before = gc.gn_silu_conv3x3.launches
            runs = [gc.gn_silu_conv3x3(*a, design=d) for _ in range(2)]
            torch.cuda.synchronize()
            fwd[d] = {"max_abs_err": float((runs[0] - ref).abs().max()), "tol": tol,
                      "same_bits_twice": torch.equal(runs[0], runs[1]),
                      "launches_two_calls": gc.gn_silu_conv3x3.launches - before,
                      "device_ms": graph_ms(lambda d=d: gc.gn_silu_conv3x3(*a, design=d))}
            del runs
            if not (fwd[d]["max_abs_err"] <= tol and fwd[d]["same_bits_twice"]
                    and fwd[d]["launches_two_calls"] == 2):
                worst.append(f"forward {d}: {fwd[d]}")
        del ref
        lib_ms = graph_ms(library_call(torch, F, "gn_silu_conv3x3", a, {}))
        plain_ms = few_ms(torch, lambda: gc.gn_silu_conv3x3_plain(*a))
    t_bytes = nbytes / PEAK_BYTES * 1e3
    site = {"kernel": "gn_silu_conv3x3", "shape": list(x.shape), "cout": cout,
            "dtype": "float32", "design": chosen, "calls_per_forward": n,
            **{k: fwd[chosen][k] for k in ("max_abs_err", "tol", "same_bits_twice")},
            "device_ms": fwd[chosen]["device_ms"], "design_ms": fwd, "plain_ms": plain_ms,
            "library_device_ms": lib_ms, "library": "F.conv2d", "cudnn": cudnn,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    per_site.append(site)
    emit(dict(phase="kernel_site", **site))
    s = summary.setdefault("gn_silu_conv3x3 (float32)", dict(calls=0))
    for key, val in (("device_ms", site["device_ms"]), ("library_device_ms", lib_ms),
                     ("plain_ms", plain_ms), ("bound_ms", site["bound_ms"]),
                     *((f"{d}_device_ms", v["device_ms"]) for d, v in fwd.items())):
        s[key] = s.get(key, 0.0) + n * val
    s.setdefault("site_designs", []).append([site["shape"], cout, chosen, n])
    s["calls"] += n

    # the gradient, on a seeded output gradient
    gen = torch.Generator(device="cuda").manual_seed(13)
    g = torch.randn(b, h, wd, cout, device="cuda", generator=gen)
    ref = gc.gn_silu_conv3x3_grad_plain(x, sc, off, wk, g)
    chosen_g = gc.conv_grad_design(x, wk)
    parts = {"dgrad": (True, True, True, False, False), "wgrad": (False, False, False, True, True)}
    grads = {}
    with torch.no_grad():
        for d in (chosen_g, F32_CONV_EARLIER):
            before = gc.gn_silu_conv3x3_grad.launches
            runs = [gc.gn_silu_conv3x3_grad(x, sc, off, wk, g, design=d) for _ in range(2)]
            torch.cuda.synchronize()
            err, etol = 0.0, 1.0
            for p, q in zip(runs[0], ref):
                e = float((p - q).abs().max())
                t_ = CONV_GRAD_F32_TOL * max(1e-30, float(q.abs().max()))
                if not e <= t_ or e / t_ >= err / etol:
                    err, etol = e, t_
            grads[d] = {"max_abs_err": err, "tol": etol,
                        "same_bits_twice": all(torch.equal(p, q) for p, q in zip(*runs)),
                        "launches_two_calls": gc.gn_silu_conv3x3_grad.launches - before,
                        **{f"{part}_device_ms": graph_ms(
                            lambda d=d, nd=nd: gc.gn_silu_conv3x3_grad(x, sc, off, wk, g,
                                                                        needs=nd, design=d))
                           for part, nd in parts.items()}}
            del runs
            if not (err <= etol and grads[d]["same_bits_twice"]
                    and grads[d]["launches_two_calls"] == 2):
                worst.append(f"gradient {d}: {grads[d]}")
        y = x * sc[:, None, None, :] + off[:, None, None, :]
        hh = (y * torch.sigmoid(y)).permute(0, 3, 1, 2)
        w_oihw = wk.permute(2, 3, 0, 1).contiguous(memory_format=torch.channels_last)

        def library(mask):
            return lambda: torch.ops.aten.convolution_backward(
                g.permute(0, 3, 1, 2), hh, w_oihw, [cout], [1, 1], [1, 1], [1, 1], False,
                [0, 0], 1, list(mask))

        lib = {"library_input_device_ms": graph_ms(library((True, False, False))),
               "library_weight_device_ms": graph_ms(library((False, True, True)))}
        del y, hh
    plain_g_ms = few_ms(torch, lambda: gc.gn_silu_conv3x3_grad_plain(x, sc, off, wk, g), 1)
    del ref
    # the input product with the activation's backward: x and g read, dx
    # written; the weight product: x (as h) and g read, dw written
    d_bytes = (2 * x.numel() + g.numel()) * 4
    w_bytes = (x.numel() + g.numel() + wk.numel()) * 4 + cout * 4
    half = flops / PEAK_FLOPS["float32"] * 1e3
    gsite = {"kernel": "gn_silu_conv3x3_grad", "shape": list(x.shape), "cout": cout,
             "dtype": "float32", "design": chosen_g, "calls_per_forward": n,
             **{k: grads[chosen_g][k] for k in ("max_abs_err", "tol", "same_bits_twice")},
             "design_ms": grads, "plain_ms": plain_g_ms, **lib, "cudnn": cudnn,
             "dgrad_bound_ms": max(d_bytes / PEAK_BYTES * 1e3, half),
             "wgrad_bound_ms": max(w_bytes / PEAK_BYTES * 1e3, half)}
    per_site.append(gsite)
    emit(dict(phase="kernel_site", **gsite))
    s = summary.setdefault("gn_silu_conv3x3_grad (float32)", dict(calls=0))
    for key, val in (("plain_ms", plain_g_ms), ("dgrad_bound_ms", gsite["dgrad_bound_ms"]),
                     ("wgrad_bound_ms", gsite["wgrad_bound_ms"]), *lib.items(),
                     *((f"{d}_{part}_device_ms", v[f"{part}_device_ms"])
                       for d, v in grads.items() for part in parts)):
        s[key] = s.get(key, 0.0) + n * val
    s.setdefault("site_designs", []).append([gsite["shape"], cout, chosen_g, n])
    s["calls"] += n
    if worst:
        raise AssertionError(f"float32 conv {list(x.shape)} -> {cout}: {worst} (kernel vs "
                             f"plain within tol, the same bits twice, one count a call)")


# a kernel's row in f32_kernels' summary, where its name differs
F32_ROWS = {"gn_silu_conv3x3": "gn_silu_conv3x3 (float32)",
            "gn_silu_conv3x3_grad": "gn_silu_conv3x3_grad (float32)"}
# the fused convs of a CIFAR-10 UNet forward but the output head
F32_CONV_SITES = 60


def f32_kernels(torch, F, ops, model, x, t, per_site, convs_only=False):
    """The float32 rows: the calls of one float32 batch-128 forward of the
    CIFAR-10 UNet (the shipped configs' default ``compute_dtype``; the same
    weights as ``model``), each fused-conv signature but the head (timed with
    the bf16 model's) by ``f32_conv_site``, each attention and GroupNorm
    signature by ``check_sites`` (forward and backward, scalar_f32 and
    fused, beside SDPA's memory-efficient backend and GroupNorm's library
    calls); one ``kernels_f32`` line with the sums over a forward's calls."""
    from probabilisticdeepdiffusionmodels_torch.models import get_model

    model32 = get_model(RESOLUTION, dict(MODEL_CFG, compute_dtype="float32"), device="cuda",
                        seed=0)
    model32.load_state_dict(model.state_dict())
    calls = {}
    with torch.no_grad(), ops.recording(calls):
        model32(x, t)
    torch.cuda.synchronize()
    del model32
    summary = {}
    for entry in calls.values():
        a = entry["args"]
        if entry["name"] == "gn_silu_conv3x3" and a[3].shape[2] > 8:
            f32_conv_site(torch, F, ops, a, entry["count"], per_site, summary)
    for row in F32_ROWS.values():
        ran = {d for _, _, d, _ in summary[row]["site_designs"]}
        if ran != {"tiled_f32"} or summary[row]["calls"] != F32_CONV_SITES:
            raise AssertionError(f"{row}: designs {ran} at {summary[row]['calls']} sites, "
                                 f"expected tiled_f32 at {F32_CONV_SITES}")
    if not convs_only:
        check_sites(torch, F, ops, calls, per_site, summary,
                    only=("qkv_attention", "group_norm_silu"))
    designs = {}
    for entry in calls.values():
        designs.setdefault(entry["name"], set()).add(design(ops, entry["name"], entry["args"]))
    emit({"phase": "kernels_f32", "batch": FORWARD_BATCH, "summary": summary,
          "designs": {k: sorted(v) for k, v in designs.items()}})
    del calls
    return summary


def recompute_check(torch, gn_conv, args):
    """The fused conv's backward at one bf16 site: the largest difference,
    relative to each gradient's largest element, between the gradients of
    the bf16-operand recompute that the backward's first design runs
    (``recompute``, by name) and those of the float32 plain version, and the
    ms of each (recompute + autograd.grad)."""
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


def capture_graph(torch, fn, launches):
    """``launches`` calls of ``fn`` captured into one CUDA graph, after a
    warm-up on a side stream; replayed once."""
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
    return graph


def graph_edges(torch, fn):
    """The edges of a CUDA graph captured over one call of ``fn``, by kind:
    ``programmatic`` where a launch made with programmatic stream
    serialization kept its early start under capture, ``default`` (a full
    dependency) otherwise; None where this torch does not keep a captured
    graph for reading or libcuda has no ``cuGraphGetEdges_v2``."""
    import ctypes

    class EdgeData(ctypes.Structure):  # CUgraphEdgeData
        _fields_ = [("from_port", ctypes.c_ubyte), ("to_port", ctypes.c_ubyte),
                    ("type", ctypes.c_ubyte), ("reserved", ctypes.c_ubyte * 5)]

    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        get = ctypes.CDLL("libcuda.so.1").cuGraphGetEdges_v2
    except (TypeError, OSError, AttributeError):
        return None
    # (graph, from nodes, to nodes, edge data, edge count) -> CUresult
    get.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.POINTER(EdgeData), ctypes.POINTER(ctypes.c_size_t)]
    get.restype = ctypes.c_int

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        fn()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if get(raw, None, None, None, ctypes.byref(n)) != 0:
        return None
    ends = [(ctypes.c_void_p * max(1, n.value))() for _ in range(2)]
    data = (EdgeData * max(1, n.value))()
    if get(raw, ctypes.addressof(ends[0]), ctypes.addressof(ends[1]), data,
           ctypes.byref(n)) != 0:
        return None
    kinds = [data[i].type for i in range(n.value)]
    return {"programmatic": kinds.count(1), "default": kinds.count(0),
            "ports": sorted({(data[i].from_port, data[i].to_port) for i in range(n.value)})}


def replay_ms(torch, graph, replays):
    """ms of one replay of ``graph``, by CUDA events over ``replays``."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / replays


def graph_time(torch, fn, launches=100, replays=20):
    """Device-only ms per call of ``fn``: ``launches`` calls captured into
    one CUDA graph, replayed, by CUDA events over all of them (no host cost
    between the kernels)."""
    return replay_ms(torch, capture_graph(torch, fn, launches), replays) / launches


def graph_kernels(torch, graph, calls):
    """Each kernel's device ms a call, by kernel name, from a profile of one
    replay of ``graph`` that holds ``calls`` calls: lower bounds, since the
    profiler may drop records."""
    out = {}
    for k in profile_device(torch, graph.replay)["all"]:
        name = kernel_name(k["name"])
        out[name] = out.get(name, 0.0) + k["ms"] / calls
    return out


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
    # attention's and GroupNorm's backward kernels at every site of the
    # float32 forward at GRAD_BATCH, held against their plain versions
    calls32 = {}
    with torch.no_grad(), ops.recording(calls32):
        model32(q_sample(tables, xg, ng, tg), tg)
    grad_sites(torch, None, ops, calls32, [], timed=False)
    del model32, g_k, g_p, out_k, calls32

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
    # device operations a step, each the larger of two profiles (a profile
    # may drop records, so each count is a lower bound), the device ms and
    # idle share of each profile and the peak memory: in the designs the
    # shapes select, with gn_affine's gradient in its first design
    # (fold_bwd+apply: 4-5 operations a site), with the conv's, attention's
    # and GroupNorm's gradients and attention's forward in the designs before
    # their last redesigns, by name (wgmma_sync_epilogue at the bf16 sites,
    # two_pass, fused, mma_ring), with the conv's gradient as
    # recompute (autograd through the recomputed plain version, about 40
    # operations a site); and attention's and GroupNorm's gradients as
    # recompute (autograd through the plain versions)
    by_design = {}
    gc = ops.ops.gn_conv
    for name, swap in (("selected", {}),
                       ("fold_bwd+apply", {"grad_design": lambda x, groups: "fold_bwd+apply"}),
                       ("parent_designs", parent_designs(ops)),
                       ("conv_recompute", {"conv_grad_design": lambda x, w: "recompute"}),
                       ("attn_gn_recompute", ATTN_GN_RECOMPUTE)):
        before = {k: ops.wrappers[k].launches for k in PER_BACKWARD}
        with swapped_designs(ops, swap):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            profs = [profile_device(torch, lambda: step(state, xb)) for _ in range(2)]
            turn_peak = torch.cuda.max_memory_allocated()
        # a recompute launches no kernel of its op's gradient; the kernel
        # designs launch it
        moved = {k: ops.wrappers[k].launches - before[k] for k in PER_BACKWARD}
        recomputed = {"conv_recompute": {"gn_silu_conv3x3_grad"},
                      "attn_gn_recompute": {"qkv_attention_grad", "group_norm_silu_grad"}}
        if any((moved[k] == 0) != (k in recomputed.get(name, ())) for k in PER_BACKWARD):
            raise AssertionError(f"train step, {name}: the backward kernels counted {moved}")
        by_design[name] = {"device_ops": max(p["device_ops"] for p in profs),
                           "device_busy_ms": [p["device_busy_ms"] for p in profs],
                           "idle_share": [p["idle_share"] for p in profs],
                           "max_memory_allocated_bytes": turn_peak}
    ops_a_step = {k: v["device_ops"] for k, v in by_design.items()}
    ops_a_step["fewer"] = ops_a_step["fold_bwd+apply"] - ops_a_step["selected"]
    # device ms a step, the mean of the two profiles, by design
    device_ms = {k: sum(v["device_busy_ms"]) / len(v["device_busy_ms"])
                 for k, v in by_design.items()}
    ops_a_step["fewer_than_conv_recompute"] = (ops_a_step["conv_recompute"]
                                               - ops_a_step["selected"])
    ops_a_step["fewer_than_attn_gn_recompute"] = (ops_a_step["attn_gn_recompute"]
                                                  - ops_a_step["selected"])
    emit({"phase": "train_step_bf16", "batch": TRAIN_BATCH, "steps_per_pass": TRAIN_STEPS,
          "warmup_steps": TRAIN_WARMUP, "passes": passes, "launches_per_pass": train_launches,
          "split_one_step": split, "max_memory_allocated_bytes": peak, "loss": loss,
          "grad_norm": grad_norm, "profile": prof, "device_ops_by_grad_design": ops_a_step,
          "device_ms_by_grad_design": device_ms, "device_by_grad_design": by_design})

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
                "qkv_attention": n_attn, "group_norm_silu": n_attn, **backward_counts(0)}
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
    # attention's and its GroupNorm's backward kernels at the heads of 96
    # and 128 and their norms, timed
    grad_sites(torch, F, ops, calls, per_site)


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


def read_png(path):
    """The 8-bit pixels [H, W, C] of a PNG that ``viz.image.write_png``
    wrote (one IDAT chunk, no row filter), checking each chunk's CRC."""
    import zlib

    import numpy as np

    data = pathlib.Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: no PNG signature")
    pos, chunks = 8, {}
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if int.from_bytes(data[pos + 8 + n:pos + 12 + n], "big") != zlib.crc32(kind + body):
            raise AssertionError(f"{path}: bad CRC in {kind}")
        chunks[kind] = body
        pos += 12 + n
    w, h = int.from_bytes(chunks[b"IHDR"][:4], "big"), int.from_bytes(chunks[b"IHDR"][4:8], "big")
    c = {0: 1, 2: 3}[chunks[b"IHDR"][9]]
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + w * c)
    if rows[:, 0].any():
        raise AssertionError(f"{path}: a row filter other than none")
    return rows[:, 1:].reshape(h, w, c)


def cli_phase(torch, ops, smi, bare_passes, out_dir=None):
    """The command-line entry points on the card, each with the counts set
    to 0 before it and its launches asserted; returns the launches by entry
    point and the first run's directory.  The runs go to ``CLI_ROOT``
    beside this script; the caller deletes them after the ``evals`` and
    ``consistency_distill`` phases, which read the first (on a failure here
    they are deleted at once; their checkpoints hold about 0.8 GB each)."""
    import importlib.util
    import shutil

    import numpy as np

    from probabilisticdeepdiffusionmodels_torch.cli import eval as cli_eval
    from probabilisticdeepdiffusionmodels_torch.cli import sample as cli_sample
    from probabilisticdeepdiffusionmodels_torch.cli import train as cli_train
    from probabilisticdeepdiffusionmodels_torch.config import load_config
    from probabilisticdeepdiffusionmodels_torch.engine import DiffusionEngine

    root = CLI_ROOT
    shutil.rmtree(root, ignore_errors=True)
    cfg = load_config("default", CLI_ARGS)
    train_loader, val_loader = cli_train.build_loaders(cfg)
    n_steps, n_val = len(train_loader), len(val_loader)
    next(iter(train_loader))
    executor = train_loader.transform.executor  # the loaders' transform: native or numpy
    batch = int(cfg["data"]["batch_size"])
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
                           **backward_counts(n_steps)))
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
                 **backward_counts(n_steps)))
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
    except BaseException:
        shutil.rmtree(root, ignore_errors=True)
        raise

    bare = [p["img_per_s"] for p in bare_passes]
    emit({"phase": "cli", "nvidia_smi": smi, "steps": n_steps, "batch": batch,
          "transform_executor": executor,
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
                                              "cli_sample")}, run_dir


def viz_model_calls(T, vis_cfg, val_batch):
    """Model calls of one pass of the four views at T, with the timesteps
    that ``cli.train`` and ``cli.sample`` give them."""
    import numpy as np

    ts = sorted(set(int(t) for t in np.linspace(1, T - 1, 5 if T <= 30 else 10)))
    pairs = min(int(vis_cfg["n_interpolation_pairs"]), val_batch // 2)
    # random grid (one chunk of n_random from T), interpolation (each pair
    # from T // 2), reconstruction grid (each t), single reconstruction (T)
    return T + pairs * (T // 2) + sum(t for t in ts if 1 < t <= T) + T


def iddpm_phase(torch, ops, smi, out_dir=None):
    """``engine=cifar10_iddpm`` through the entry points with the default
    visualization, each with the counts set to 0 before it and its launches
    asserted, then the new shapes and objectives held on the card; returns
    the launches by entry point.  The runs go to ``runs/chip_smoke_iddpm``
    beside this script and are deleted at the end."""
    import copy
    import shutil

    import numpy as np

    from probabilisticdeepdiffusionmodels_torch.cli import eval as cli_eval
    from probabilisticdeepdiffusionmodels_torch.cli import sample as cli_sample
    from probabilisticdeepdiffusionmodels_torch.cli import train as cli_train
    from probabilisticdeepdiffusionmodels_torch.config import load_config
    from probabilisticdeepdiffusionmodels_torch.core import (
        DiffusionTables,
        NoiseSchedule,
        rescale_zero_terminal_snr,
    )
    from probabilisticdeepdiffusionmodels_torch.engine import AdamChain, DiffusionEngine
    from probabilisticdeepdiffusionmodels_torch.models import get_model
    from probabilisticdeepdiffusionmodels_torch.train import TrainState, make_train_step
    from probabilisticdeepdiffusionmodels_torch.viz.hooks import VisualizationCallback

    phase_start = time.perf_counter()
    root = ROOT / "runs" / "chip_smoke_iddpm"
    shutil.rmtree(root, ignore_errors=True)
    cfg = load_config("default", IDDPM_ARGS)
    train_loader, val_loader = cli_train.build_loaders(cfg)
    n_steps, n_val = len(train_loader), len(val_loader)
    batch = int(cfg["data"]["batch_size"])
    T = IDDPM_T
    viz_calls = viz_model_calls(T, cfg["visualization"], batch)
    detailed_calls = 4 * sum((T, int(0.9 * T), int(0.8 * T), int(0.5 * T)))
    args = IDDPM_ARGS + [f"out_dir={root}"]
    launches, timed, readings = {}, {}, {}
    test_keys = ("test_nll", "test_L_0", "test_L_intermediate", "test_L_T", "test_mse")
    keep = None
    if out_dir is not None:
        keep = out_dir / "iddpm"
        keep.mkdir(exist_ok=True)

    def run(name, fn, expected):
        ops.reset()
        t_start = time.perf_counter()
        with timing_calls(DiffusionEngine, ("test_step",), timed), \
                timing_calls(VisualizationCallback, VIEWS, timed), \
                timing_calls(cli_sample, ("run_detailed_viz",), timed):
            result = fn()
        readings[f"{name}_seconds"] = time.perf_counter() - t_start
        launches[name] = ops.counts()
        if launches[name] != expected:
            raise AssertionError(f"{name} launches {launches[name]} != {expected}")
        return result

    def decoded(paths):
        shapes = {}
        for path in paths:
            pixels = read_png(path)
            if pixels.shape[0] < RESOLUTION or pixels.shape[2] != 3:
                raise AssertionError(f"{path}: pixels of shape {pixels.shape}")
            shapes[pathlib.Path(path).name] = list(pixels.shape)
        return shapes

    try:
        # 1. train with the default visualization: its train-end pass
        trained = run("iddpm_train", lambda: cli_train.main(args + ["run_name=iddpm"]),
                      dict(expected_counts(n_steps + 2 * n_val + viz_calls + T, False),
                           **backward_counts(n_steps)))
        run_dir = pathlib.Path(trained["run_dir"])
        final = json.loads((run_dir / "final_test.json").read_text())
        if trained["steps"] != n_steps or not all(math.isfinite(final[k]) for k in test_keys):
            raise AssertionError(f"iddpm cli.train: {final}")
        views = [run_dir / "media" / f"{name}_final.png" for name in
                 ("random_grid", f"interpolation_t{T // 2}", "reconstructions",
                  "single_recon_std")]
        train_pngs = decoded(views)
        rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
        epoch_s = next(r["epoch_time_s"] for r in rows if "epoch_time_s" in r)
        readings["view_seconds_train"] = {name: timed[name][-1] for name in VIEWS}
        readings["nll_batch_seconds_train_cli"] = timed["test_step"][-1]

        # 2. sample: the four views (regular_viz defaults on) and the panels
        sampled = run("iddpm_sample", lambda: cli_sample.main(
            [f"run_dir={run_dir}", "detailed_viz=true"]),
            expected_counts(viz_calls + detailed_calls, False))
        if len(sampled["viz"]) != 8:
            raise AssertionError(f"iddpm cli.sample wrote {sampled['viz']}")
        sample_pngs = decoded(sampled["viz"])
        readings["view_seconds_sample"] = {name: timed[name][-1] for name in VIEWS}
        readings["detailed_viz_seconds"] = timed["run_detailed_viz"][-1]

        # 3. eval: the best checkpoint, the same val batch and seed
        evaluated = run("iddpm_eval", lambda: cli_eval.main(
            [f"run_dir={run_dir}", "use_train_data=false", "trainer.limit_test_batches=1"]),
            expected_counts(T, False))
        readings["nll_batch_seconds"] = timed["test_step"][-1]
        eval_err = {k: abs(evaluated[k] - final[k]) / max(abs(final[k]), 1e-30)
                    for k in test_keys}

        # every kernel site of the five endpoints (batch 1, 4 and 10, bf16,
        # the run's weights), each endpoint called once, mean_only where it
        # takes it
        engine_s, _ = cli_sample.load_engine_from_run(run_dir)
        gen = torch.Generator(device="cuda").manual_seed(20)
        x0 = torch.as_tensor(next(iter(val_loader))[0], device="cuda")
        x10 = torch.randn((10,) + tuple(x0.shape[1:]), device="cuda", generator=gen)
        calls = {}
        with ops.recording(calls):
            engine_s.generate_images_grid((2, 1), n=4, minibatch=4, mean_only=True)
            engine_s.sample_from_step(x10, 3, mean_only=True)
            engine_s.sample_and_return_steps(x0[:1], 3, (2, 1), mean_only=True,
                                             return_stds=True)
            engine_s.diffuse_and_reconstruct(x0[:4], 3)
            engine_s.diffuse_and_reconstruct_grid(x0[:1], 3, (2, 1), mean_only=True,
                                                  return_stds=True)
        viz_sites = hold_sites(torch, ops, calls)
        if keep is not None:
            (keep / "viz_sites.json").write_text(json.dumps(viz_sites, indent=1))
        worst_site = max(viz_sites, key=lambda site: site["max_abs_err"] / site["tol"])
        batches = sorted({site["shape"][0] for site in viz_sites})
        if batches != [1, 4, 10]:
            raise AssertionError(f"endpoint sites at batches {batches}, expected [1, 4, 10]")
        del engine_s, calls

        # the five endpoints in float32, kernels against plain versions,
        # same weights and injected noise
        cfg32 = load_config("default", IDDPM_ARGS + [
            "model.compute_dtype=float32", f"engine.diffusion_steps={ENDPOINT_CHECK_T}",
            "engine.ema=null"])
        engine32 = cli_train.build_engine(cfg32)
        fill_zero_params(torch, engine32.state.model, seed=22)
        Tc = ENDPOINT_CHECK_T

        def randn(*shape):
            return torch.randn(shape, device="cuda", generator=gen)

        x1, x4 = x0[:1], x0[:4]
        z1, z4, z10 = randn(Tc, *x1.shape), randn(Tc, *x4.shape), randn(Tc, *x10.shape)
        q1, q4, xT4 = randn(*x1.shape), randn(*x4.shape), randn(*x4.shape)

        def endpoints():
            return {
                "generate_images_grid": engine32.generate_images_grid(
                    (5, 1), n=4, minibatch=4, use_ema=False, x_T=xT4, noise=z4)[1],
                "sample_from_step": engine32.sample_from_step(
                    x10, Tc // 2, use_ema=False, noise=z10[:Tc // 2]),
                "sample_and_return_steps": engine32.sample_and_return_steps(
                    x1, Tc, (5, 1), use_ema=False, return_stds=True, noise=z1),
                "diffuse_and_reconstruct": engine32.diffuse_and_reconstruct(
                    x4, Tc, use_ema=False, q_noise=q4, noise=z4)[0],
                "diffuse_and_reconstruct_grid": engine32.diffuse_and_reconstruct_grid(
                    x1, Tc, (5, 1), use_ema=False, return_stds=True, q_noise=q1,
                    noise=z1)[0],
            }

        def flat(v):
            parts = v if isinstance(v, tuple) else (v,)
            return np.concatenate([np.asarray(p.cpu() if hasattr(p, "cpu") else p,
                                              np.float64).ravel() for p in parts])

        ops.reset()
        got = endpoints()
        torch.cuda.synchronize()
        launches["endpoints_f32"] = ops.counts()
        with ops.plain_versions():
            want = endpoints()
        if launches["endpoints_f32"] != expected_counts(4 * Tc + Tc // 2, False) or \
                ops.counts() != launches["endpoints_f32"]:
            raise AssertionError(f"float32 endpoint launches {launches['endpoints_f32']}, then "
                                 f"{ops.counts()} with the plain versions")
        endpoint_err = {k: float(np.abs(flat(got[k]) - flat(want[k])).max()) for k in got}
        finite = all(np.isfinite(flat(v)).all() for v in got.values())
        del engine32, got, want
    finally:
        if keep is not None:
            for path in root.glob("*/final_test.json"):
                shutil.copy(path, keep / path.name)
            for path in root.glob("*/media/*.png"):
                shutil.copy(path, keep / path.name)
        shutil.rmtree(root, ignore_errors=True)

    # float32 gradients of one hybrid loss (the Cout = 6 head, forward and
    # backward; gn_affine_grad), kernels against plain versions: one step
    # each on two copies of one state, same x0, t (t = 1 among them) and noise
    tables = DiffusionTables.from_schedule(NoiseSchedule.create(1000, "cosine"), "cuda")
    model32 = get_model(RESOLUTION, dict(MODEL_CFG, compute_dtype="float32", learn_sigma=True),
                        device="cuda", seed=0)
    fill_zero_params(torch, model32, seed=23)
    xg = torch.randint(0, 256, (GRAD_BATCH, RESOLUTION, RESOLUTION, 3), device="cuda",
                       generator=gen).float() / 127.5 - 1.0
    tg = torch.randint(1, 1001, (GRAD_BATCH,), device="cuda", generator=gen)
    tg[0] = 1
    ng = randn(*xg.shape)
    hybrid = make_train_step(tables, loss_type="hybrid")
    states = [TrainState(m, AdamChain(m.parameters(), 2e-4), 1000,
                         torch.Generator(device="cuda").manual_seed(24))
              for m in (model32, copy.deepcopy(model32))]
    ops.reset()
    metrics_k = hybrid(states[0], xg, t=tg, noise=ng)
    torch.cuda.synchronize()
    launches["hybrid_grads_f32"] = ops.counts()
    with ops.plain_versions():
        metrics_p = hybrid(states[1], xg, t=tg, noise=ng)
    if launches["hybrid_grads_f32"] != expected_counts(1, True) or \
            ops.counts() != launches["hybrid_grads_f32"]:
        raise AssertionError(f"hybrid loss launches {launches['hybrid_grads_f32']}")
    worst, worst_name = 0.0, None
    named_p = dict(states[1].model.named_parameters())
    for name, p in states[0].model.named_parameters():
        gp = named_p[name].grad
        rel = float((p.grad - gp).abs().max()) / max(1e-6, float(gp.abs().max()))
        if rel >= worst:
            worst, worst_name = rel, name
    zero = [name for name, p in named_p.items() if not p.grad.any()]
    hybrid_grads = {"batch": GRAD_BATCH, "loss_kernels": float(metrics_k["loss"]),
                    "loss_plain": float(metrics_p["loss"]), "vlb_kernels": float(metrics_k["vlb"]),
                    "vlb_plain": float(metrics_p["vlb"]), "max_rel_err": worst,
                    "worst_param": worst_name, "tol": F32_GRAD_TOL, "all_zero_grads": zero}
    del states, model32

    # the train step's img/s: eps (bare) and hybrid in turns, bf16, batch 128
    xb = randn(TRAIN_BATCH, RESOLUTION, RESOLUTION, 3)
    steppers = {}
    for kind, mode in (("simple", "linear"), ("hybrid", "cosine")):
        model = get_model(RESOLUTION, dict(MODEL_CFG, learn_sigma=kind == "hybrid"),
                          device="cuda", seed=0)
        state = TrainState(model, AdamChain(model.parameters(), 2e-4), 1000,
                           torch.Generator(device="cuda").manual_seed(5), ema_decay=0.9999)
        step = make_train_step(DiffusionTables.from_schedule(
            NoiseSchedule.create(1000, mode), "cuda"), loss_type=kind)
        for _ in range(TRAIN_WARMUP):
            step(state, xb)
        steppers[kind] = (state, step)
    step_passes, vlb = {"simple": [], "hybrid": []}, None
    for kind in ("simple", "hybrid", "hybrid", "simple"):
        state, step = steppers[kind]
        torch.cuda.synchronize()
        ops.reset()
        t_start = time.perf_counter()
        for _ in range(TURN_STEPS):
            metrics = step(state, xb)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t_start
        if ops.counts() != expected_counts(TURN_STEPS, True):
            raise AssertionError(f"{kind} step launches {ops.counts()}")
        step_passes[kind].append(TRAIN_BATCH * TURN_STEPS / seconds)
        if kind == "hybrid":
            vlb = float(metrics["vlb"])
    del steppers, state, step

    # one bf16 batch-128 step of v + min-SNR on a zero-terminal-SNR schedule,
    # and of x0: finite, exact launches, no device-to-host copy
    objectives = {}
    linear = NoiseSchedule.create(1000, "linear")
    for name, kw, sched in (
            ("v_min_snr_ztsnr", dict(prediction_type="v", loss_weighting="min_snr"),
             NoiseSchedule.create(1000, betas=rescale_zero_terminal_snr(linear.betas))),
            ("x0", dict(prediction_type="x0"), linear)):
        model = get_model(RESOLUTION, MODEL_CFG, device="cuda", seed=0)
        state = TrainState(model, AdamChain(model.parameters(), 2e-4), 1000,
                           torch.Generator(device="cuda").manual_seed(25), ema_decay=0.9999)
        step = make_train_step(DiffusionTables.from_schedule(sched, "cuda"), **kw)
        step(state, xb)
        ops.reset()
        loss = float(step(state, xb)["loss"])
        counts = ops.counts()
        prof = profile_device(torch, lambda: step(state, xb))
        syncs = [k["name"] for k in prof.pop("all") if "DtoH" in k["name"]]
        objectives[name] = {"loss": loss, "launches": counts, "device_ops": prof["device_ops"],
                            "device_busy_ms": prof["device_busy_ms"], "host_copies": syncs}
        if not math.isfinite(loss) or counts != expected_counts(1, True) or syncs:
            raise AssertionError(f"{name} step: loss {loss}, launches {counts}, copies {syncs}")
        del model, state, step

    line = {"phase": "iddpm_cli", "nvidia_smi": smi, "reduced": {"diffusion_steps": [1000, T]},
            "steps": n_steps, "batch": batch, "val_batches": n_val,
            "viz_model_calls": viz_calls, "detailed_viz_model_calls": detailed_calls,
            "train_cli_img_per_s": n_steps * batch / epoch_s, "train_cli_epoch_seconds": epoch_s,
            "hybrid_step_img_per_s": step_passes["hybrid"],
            "eps_step_img_per_s": step_passes["simple"], "vlb": vlb, **readings,
            "final_test": {k: final[k] for k in test_keys}, "eval_rel_err": eval_err,
            "eval_rel_tol": EVAL_REL_TOL, "pngs": {"train": train_pngs, "sample": sample_pngs},
            "viz_sites_vs_plain": {"sites": len(viz_sites), "batches": batches,
                                   "worst": worst_site,
                                   "worst_share": worst_site["max_abs_err"] / worst_site["tol"]},
            "endpoints_f32_vs_plain": {"T": Tc, "max_abs_diff": endpoint_err,
                                       "tol": ENDPOINT_F32_TOL, "finite": finite},
            "hybrid_grads_f32_vs_plain": hybrid_grads, "objectives_bf16": objectives,
            "phase_seconds": time.perf_counter() - phase_start, "launches": launches}
    emit(line)
    if keep is not None:
        (keep / "iddpm_cli.json").write_text(json.dumps(line, indent=1))
    if not max(eval_err.values()) <= EVAL_REL_TOL:
        raise AssertionError(f"iddpm cli.eval differs from the run's final test: {eval_err}")
    if not finite or not max(endpoint_err.values()) <= ENDPOINT_F32_TOL:
        raise AssertionError(f"float32 endpoints: kernels vs plain {endpoint_err}")
    if not worst <= F32_GRAD_TOL or zero:
        raise AssertionError(f"float32 hybrid gradients: kernels vs plain {worst} at "
                             f"{worst_name} (tol {F32_GRAD_TOL}); all-zero gradients: {zero}")
    if vlb is None or not math.isfinite(vlb):
        raise AssertionError(f"hybrid step: vlb {vlb}")
    return {name: launches[name] for name in ("iddpm_train", "iddpm_sample", "iddpm_eval")}


def sampler_chain(kind, spec, sched, m, cm, x_T, y, x0, mask, seed):
    """One chain of the fast_samplers phase: (output, full model calls,
    cached model calls).  ``m`` is the model (eps), ``cm`` the class-
    conditional one for guidance; every chain clips x0 but the inversion's
    way back."""
    from probabilisticdeepdiffusionmodels_torch.core import DiffusionTables
    from probabilisticdeepdiffusionmodels_torch.sample import (
        ddim_invert_loop,
        ddim_sample_loop,
        dpmpp_sample_loop,
        heun_sample_loop,
        inpaint_sample_loop,
        make_cfg_apply_fn,
        p_sample_loop,
        respaced_schedule,
        space_timesteps,
    )
    import torch

    new, tmap = respaced_schedule(sched, space_timesteps(1000, spec,
                                                         alphas_hat=sched.alphas_hat))
    tables, n = DiffusionTables.from_schedule(new, "cuda"), new.diffusion_steps
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(timestep_map=tmap)
    if kind == "ddim":
        return ddim_sample_loop(m, tables, x_T, clip=True, **kw), n, 0
    if kind == "dpmpp":
        return dpmpp_sample_loop(m, tables, x_T, clip=True, order=2, **kw), n, 0
    if kind == "heun":
        return heun_sample_loop(m, tables, x_T, clip=True, **kw), 2 * n - 1, 0
    if kind in ("reuse_p", "reuse_ddim"):
        segments = n // 3
        if kind == "reuse_p":
            out = p_sample_loop(m, tables, x_T, gen, clip=True, encoder_reuse=3, **kw)
        else:
            out = ddim_sample_loop(m, tables, x_T, clip=True, encoder_reuse=3, **kw)
        return out, n - 2 * segments, 2 * segments
    if kind == "cfg_ddim":
        guided = make_cfg_apply_fn(cm, CFG_SCALE, NUM_CLASSES)
        return ddim_sample_loop(guided, tables, x_T, clip=True, y=y, **kw), n, 0
    if kind == "inpaint":
        return inpaint_sample_loop(m, tables, x_T, gen, x0_known=x0, mask=mask, clip=True,
                                   **kw), n, 0
    # "invert": the whole chain and back; "invert_part": to 7/10 of it and
    # back (decoding from ab_T ~ 4e-5 magnifies float32 rounding by 158)
    t_end = n if kind == "invert" else 7 * n // 10
    latent = ddim_invert_loop(m, tables, x0, t_end=t_end, **kw)
    return ddim_sample_loop(m, tables, latent, t_start=t_end, **kw), 2 * t_end, 0


def fast_samplers_phase(torch, ops, model, gen, smi, out_dir=None):
    """DDIM, DPM-Solver++, Heun, encoder reuse, guidance, inpainting and DDIM
    inversion at the CIFAR-10 UNet's full width: each chain timed with its
    launches asserted (a cached call launches the decoder's share), the
    device operations of each kind of model call, one chain profiled, the
    new kernel sites (guidance's doubled batch, the cached calls) and every
    chain in float32 at batch 4 on the kernels against the plain versions
    (the same generator state); returns the launches by chain."""
    import numpy as np

    from probabilisticdeepdiffusionmodels_torch.core import DiffusionTables, NoiseSchedule
    from probabilisticdeepdiffusionmodels_torch.models import get_model
    from probabilisticdeepdiffusionmodels_torch.sample import (
        dpmpp_sample_loop,
        make_cfg_apply_fn,
        respaced_schedule,
        space_timesteps,
    )

    phase_start = time.perf_counter()
    sched = NoiseSchedule.create(1000, "linear")
    cm = get_model(RESOLUTION, dict(MODEL_CFG, num_classes=NUM_CLASSES, cfg_null_class=True),
                   device="cuda", seed=0)
    fill_zero_params(torch, cm, seed=30)

    def inputs(batch):
        x_T = torch.randn(batch, RESOLUTION, RESOLUTION, 3, device="cuda", generator=gen)
        x0 = torch.rand(x_T.shape, device="cuda", generator=gen) * 2.0 - 1.0
        mask = torch.zeros(RESOLUTION, RESOLUTION, 1, device="cuda")
        mask[:, : RESOLUTION // 2] = 1.0  # right_half: keep the left half
        y = torch.arange(batch, device="cuda") % NUM_CLASSES
        return x_T, y, x0, mask

    x_T, y, x0, mask = inputs(FS_BATCH)
    t128 = torch.full((FS_BATCH,), 500, device="cuda")

    # one model call of each kind: launches, device operations; the sites
    # a guided (batch 256) and a cached call (decoder, and after the middle)
    # give the kernels, held against the plain versions
    calls, per_call = {}, {}
    with torch.no_grad():
        _, cache = model(x_T, t128, return_cache=True)
        _, cache_mid = model(x_T, t128, return_cache=True, cache_middle=True)
        kinds = {
            "full": lambda: model(x_T, t128),
            "cached": lambda: model(x_T, t128 - 1, cache=cache),
            "cached_middle": lambda: model(x_T, t128 - 1, cache=cache_mid, cache_middle=True),
            "guided_batch_256": lambda: make_cfg_apply_fn(cm, CFG_SCALE, NUM_CLASSES)(
                x_T, t128, y),
        }
        for name, fn in kinds.items():
            ops.reset()
            with ops.recording(calls):
                fn()
            torch.cuda.synchronize()
            per_call[name] = {"launches": ops.counts()}
            prof = profile_device(torch, fn)
            per_call[name].update(device_ops=prof["device_ops"],
                                  device_busy_ms=prof["device_busy_ms"])
    sites = hold_sites(torch, ops, calls)
    if per_call["full"]["launches"] != expected_counts(1, False) or \
            per_call["guided_batch_256"]["launches"] != expected_counts(1, False):
        raise AssertionError(f"model call launches {per_call}")
    cached_counts = per_call["cached"]["launches"]
    if not 0 < cached_counts["gn_silu_conv3x3"] < PER_FORWARD["gn_silu_conv3x3"]:
        raise AssertionError(f"a cached call launched {cached_counts}")
    if 2 * FS_BATCH not in {site["shape"][0] for site in sites}:
        raise AssertionError(f"no kernel site at guidance's batch {2 * FS_BATCH}")
    del cache, cache_mid, calls

    # the timed chains, bf16, batch 128
    chains, launches = {}, {}
    for name, (kind, spec) in FS_TIMED.items():
        seconds = []
        for run in range(FS_RUNS):
            ops.reset()
            torch.cuda.synchronize()
            t_start = time.perf_counter()
            out, n_full, n_cached = sampler_chain(kind, spec, sched, model, cm, x_T, y, x0,
                                                  mask, seed=40 + run)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t_start)
            if run == 0:
                launches[f"fs_{name}"] = ops.counts()
                want = {k: n_full * PER_FORWARD[k] + n_cached * cached_counts[k]
                        for k in PER_FORWARD}
                want.update(backward_counts(0))
                if ops.counts() != want:
                    raise AssertionError(f"{name} launches {ops.counts()} != {want}")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name}: output not finite")
        chains[name] = {"model_calls": n_full + n_cached, "full_calls": n_full,
                        "cached_calls": n_cached, "seconds": seconds,
                        "img_per_s": [FS_BATCH / s for s in seconds],
                        "device_ops_per_model_call": {
                            k: per_call[k]["device_ops"] for k in
                            (("guided_batch_256",) if kind == "cfg_ddim" else
                             ("full", "cached") if n_cached else ("full",))}}
        if kind == "inpaint" and not bool((out[:, :, : RESOLUTION // 2]
                                           == x0[:, :, : RESOLUTION // 2]).all()):
            raise AssertionError("inpaint changed the known half")

    # one chain profiled: its device operations, and no copy to the host
    tables10, tmap10 = respaced_schedule(sched, space_timesteps(1000, 10))
    tables10 = DiffusionTables.from_schedule(tables10, "cuda")
    prof = profile_device(torch, lambda: dpmpp_sample_loop(model, tables10, x_T, clip=True,
                                                           timestep_map=tmap10))
    copies = [k["name"] for k in prof.pop("all") if "DtoH" in k["name"]]
    if copies:
        raise AssertionError(f"the DPM-Solver++ chain copies to the host: {copies}")
    chain_profile = dict(chain="dpmpp2_10", **{k: prof[k] for k in
                                               ("wall_ms", "device_busy_ms", "device_ops",
                                                "idle_share")})

    # float32 chains at batch 4: kernels against plain versions
    model32 = get_model(RESOLUTION, dict(MODEL_CFG, compute_dtype="float32"), device="cuda",
                        seed=0)
    model32.load_state_dict(model.state_dict())
    cm32 = get_model(RESOLUTION, dict(MODEL_CFG, compute_dtype="float32",
                                      num_classes=NUM_CLASSES, cfg_null_class=True),
                     device="cuda", seed=0)
    cm32.load_state_dict(cm.state_dict())
    xs = inputs(FS_CHECK_BATCH)
    f32 = {}
    for kind, spec in FS_CHECK.items():
        ops.reset()
        got, _, _ = sampler_chain(kind, spec, sched, model32, cm32, *xs, seed=50)
        torch.cuda.synchronize()
        counts = ops.counts()
        with ops.plain_versions():
            want, _, _ = sampler_chain(kind, spec, sched, model32, cm32, *xs, seed=50)
        if not counts["gn_silu_conv3x3"] or ops.counts() != counts:
            raise AssertionError(f"float32 {kind}: launches {counts}, then {ops.counts()}")
        f32[kind] = {"max_abs_diff": float((got - want).abs().max()),
                     "finite": bool(torch.isfinite(got).all())}
    # the inversion's round trip, float32 on the kernels, 50 steps
    back, _, _ = sampler_chain("invert", 50, sched, model32, cm32, *xs, seed=51)
    round_trip = float((back - xs[2]).abs().max())
    del model32, cm32

    line = {"phase": "fast_samplers", "nvidia_smi": smi, "batch": FS_BATCH, "runs": FS_RUNS,
            "chains": chains, "model_call_kinds": per_call, "chain_profile": chain_profile,
            "new_sites_vs_plain": {"sites": len(sites),
                                   "batches": sorted({site["shape"][0] for site in sites}),
                                   "worst": max(sites, key=lambda st: st["max_abs_err"] /
                                                st["tol"])},
            "f32_chains_vs_plain": {"batch": FS_CHECK_BATCH, "tol": F32_CHAIN_TOL, **f32},
            "ddim_round_trip_f32_max_abs_err": round_trip,
            "phase_seconds": time.perf_counter() - phase_start}
    emit(line)
    if out_dir is not None:
        (out_dir / "fast_samplers.json").write_text(json.dumps(dict(line, sites=sites), indent=1))
    bad = {k: v for k, v in f32.items() if not (v["finite"] and v["max_abs_diff"] <= F32_CHAIN_TOL)}
    if bad:
        raise AssertionError(f"float32 chains, kernels vs plain: {bad}")
    return launches


def family_step(kind, tables):
    """The train step of a family (``eps``: the eps step)."""
    from probabilisticdeepdiffusionmodels_torch.core import (
        ConsistencyConfig,
        EDMConfig,
        FlowConfig,
    )
    from probabilisticdeepdiffusionmodels_torch.train.consistency import make_ct_train_step
    from probabilisticdeepdiffusionmodels_torch.train.step import (
        make_edm_train_step,
        make_flow_train_step,
        make_train_step,
    )

    if kind == "edm":
        return make_edm_train_step(tables, EDMConfig())
    if kind == "flow":
        return make_flow_train_step(tables, FlowConfig())
    if kind == "consistency":
        return make_ct_train_step(tables, ConsistencyConfig())
    return make_train_step(tables)


def native_chain(kind, kw, m, x_T, seed):
    """One native chain of the model_families phase and its model calls."""
    import torch

    from probabilisticdeepdiffusionmodels_torch.sample import (
        consistency_sample_loop,
        edm_sample_loop,
        flow_sample_loop,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = kw["n_steps"]
    if kind == "edm":
        return edm_sample_loop(m, None, x_T, gen, **kw), 2 * n - 1
    if kind == "flow":
        return flow_sample_loop(m, None, x_T, gen, **kw), (2 * n - 1 if kw.get("heun") else n)
    return consistency_sample_loop(m, None, x_T, gen, **kw), n


def model_families_phase(torch, ops, gen, smi, out_dir=None):
    """The EDM, flow and consistency families at the CIFAR-10 UNet's full
    width: each bf16 train step at batch 128 beside the eps step in turns
    (launches asserted; a consistency step is two forwards, one without
    gradients, and one backward), each step's device operations and no copy
    to the host, the float32 gradients of each on the kernels against the
    plain versions, the native samplers timed, their float32 chains at
    batch 4 against the plain versions, the kernel sites of the EDM and flow
    inputs, and one CLI chain: ``cli.train engine.prediction_type=
    consistency`` then ``cli.sample sampler=consistency``; returns the
    launches by path."""
    import copy
    import shutil

    from probabilisticdeepdiffusionmodels_torch.cli import sample as cli_sample
    from probabilisticdeepdiffusionmodels_torch.cli import train as cli_train
    from probabilisticdeepdiffusionmodels_torch.config import load_config
    from probabilisticdeepdiffusionmodels_torch.core import (
        DiffusionTables,
        NoiseSchedule,
        TIME_SCALE,
        edm_denoise,
    )
    from probabilisticdeepdiffusionmodels_torch.engine import AdamChain
    from probabilisticdeepdiffusionmodels_torch.models import get_model
    from probabilisticdeepdiffusionmodels_torch.train import TrainState

    phase_start = time.perf_counter()
    tables = DiffusionTables.from_schedule(NoiseSchedule.create(1000, "linear"), "cuda")
    launches = {}
    per_step = {"eps": expected_counts(1, True), "edm": expected_counts(1, True),
                "flow": expected_counts(1, True),
                "consistency": dict(expected_counts(2, False),
                                    **backward_counts(1))}

    def scaled(counts, n):
        return {k: n * v for k, v in counts.items()}

    # the train steps, bf16, batch 128, in turns
    xb = torch.rand(TRAIN_BATCH, RESOLUTION, RESOLUTION, 3, device="cuda",
                    generator=gen) * 2.0 - 1.0
    steppers = {}
    for kind in ("eps",) + FAMILIES:
        m = get_model(RESOLUTION, MODEL_CFG, device="cuda", seed=0)
        state = TrainState(m, AdamChain(m.parameters(), 2e-4), 1000,
                           torch.Generator(device="cuda").manual_seed(60), ema_decay=0.9999)
        step = family_step(kind, tables)
        for _ in range(TRAIN_WARMUP):
            step(state, xb)
        steppers[kind] = (state, step)
    img_per_s = {kind: [] for kind in steppers}
    for kind in FAMILY_TURNS:
        state, step = steppers[kind]
        torch.cuda.synchronize()
        ops.reset()
        t_start = time.perf_counter()
        for _ in range(TURN_STEPS):
            metrics = step(state, xb)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t_start
        want = scaled(per_step[kind], TURN_STEPS)
        if ops.counts() != want:
            raise AssertionError(f"{kind} step launches {ops.counts()} != {want}")
        launches[f"train_step_{kind}"] = ops.counts()
        img_per_s[kind].append(TRAIN_BATCH * TURN_STEPS / seconds)
        if not math.isfinite(float(metrics["loss"])):
            raise AssertionError(f"{kind} step: loss {float(metrics['loss'])}")
    step_profiles = {}
    for kind, (state, step) in steppers.items():
        prof = profile_device(torch, lambda: step(state, xb))
        copies = [k["name"] for k in prof.pop("all") if "DtoH" in k["name"]]
        step_profiles[kind] = {"device_ops": prof["device_ops"],
                               "device_busy_ms": prof["device_busy_ms"], "host_copies": copies}
        if copies:
            raise AssertionError(f"the {kind} step copies to the host: {copies}")
    del steppers, state, step

    # float32 gradients at a small batch: kernels against plain versions,
    # the same draws (the same generator state) on both copies
    model32 = get_model(RESOLUTION, dict(MODEL_CFG, compute_dtype="float32"), device="cuda",
                        seed=0)
    fill_zero_params(torch, model32, seed=61)
    xg = torch.rand(GRAD_BATCH, RESOLUTION, RESOLUTION, 3, device="cuda",
                    generator=gen) * 2.0 - 1.0
    grads = {}
    for kind in FAMILIES:
        states = [TrainState(mm, AdamChain(mm.parameters(), 2e-4), 1000,
                             torch.Generator(device="cuda").manual_seed(62))
                  for mm in (copy.deepcopy(model32), copy.deepcopy(model32))]
        step = family_step(kind, tables)
        ops.reset()
        loss_k = float(step(states[0], xg)["loss"])
        counts = ops.counts()
        with ops.plain_versions():
            loss_p = float(step(states[1], xg)["loss"])
        if counts != per_step[kind] or ops.counts() != counts:
            raise AssertionError(f"float32 {kind} step launches {counts}, then {ops.counts()}")
        worst, worst_name = 0.0, None
        named_p = dict(states[1].model.named_parameters())
        for name, p in states[0].model.named_parameters():
            gp = named_p[name].grad
            rel = float((p.grad - gp).abs().max()) / max(1e-6, float(gp.abs().max()))
            if rel >= worst:
                worst, worst_name = rel, name
        zero = [name for name, p in named_p.items() if not p.grad.any()]
        grads[kind] = {"loss_kernels": loss_k, "loss_plain": loss_p, "max_rel_err": worst,
                       "worst_param": worst_name, "all_zero_grads": zero}
        del states
    del model32

    # the kernel sites of the EDM and flow inputs (c_in x at c_noise; x_t at
    # t * 1000), bf16, batch 128, on a sampler model
    model = get_model(RESOLUTION, MODEL_CFG, device="cuda", seed=0)
    fill_zero_params(torch, model, seed=63)
    x_T = torch.randn(TRAIN_BATCH, RESOLUTION, RESOLUTION, 3, device="cuda", generator=gen)
    calls = {}
    with torch.no_grad(), ops.recording(calls):
        edm_denoise(model, 80.0 * x_T, 80.0, 0.5)
        model(x_T, torch.full((TRAIN_BATCH,), 0.37 * TIME_SCALE, device="cuda"))
    sites = hold_sites(torch, ops, calls)
    del calls

    # the native samplers, bf16, batch 128
    native = {}
    for name, (kind, kw) in NATIVE_TIMED.items():
        ops.reset()
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        out, n_calls = native_chain(kind, kw, model, x_T, seed=64)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t_start
        launches[f"native_{name}"] = ops.counts()
        if ops.counts() != expected_counts(n_calls, False):
            raise AssertionError(f"{name} launches {ops.counts()} for {n_calls} model calls")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name}: output not finite")
        native[name] = {"model_calls": n_calls, "seconds": seconds,
                        "img_per_s": TRAIN_BATCH / seconds}
    model32 = get_model(RESOLUTION, dict(MODEL_CFG, compute_dtype="float32"), device="cuda",
                        seed=0)
    model32.load_state_dict(model.state_dict())
    x4 = x_T[:FS_CHECK_BATCH].clone()
    native_f32 = {}
    for name, (kind, kw) in NATIVE_CHECK.items():
        ops.reset()
        got, _ = native_chain(kind, kw, model32, x4, seed=65)
        torch.cuda.synchronize()
        counts = ops.counts()
        with ops.plain_versions():
            want, _ = native_chain(kind, kw, model32, x4, seed=65)
        if not counts["gn_silu_conv3x3"] or ops.counts() != counts:
            raise AssertionError(f"float32 {name}: launches {counts}, then {ops.counts()}")
        native_f32[name] = {"max_abs_diff": float((got - want).abs().max()),
                            "finite": bool(torch.isfinite(got).all())}
    del model, model32

    # one CLI chain: consistency training at the cli phase's cuts, then its
    # one-step grid (the views, the detailed panels and the NLL skipped)
    root = ROOT / "runs" / "chip_smoke_families"
    shutil.rmtree(root, ignore_errors=True)
    args = CLI_ARGS + ["engine.prediction_type=consistency", f"out_dir={root}",
                       "run_name=consistency"]
    cfg = load_config("default", args)
    train_loader, val_loader = cli_train.build_loaders(cfg)
    n_steps, n_val = len(train_loader), len(val_loader)
    try:
        ops.reset()
        t_start = time.perf_counter()
        trained = cli_train.main(args)
        torch.cuda.synchronize()
        cli_train_s = time.perf_counter() - t_start
        launches["consistency_train"] = ops.counts()
        # a step: 2 forwards and a backward; validation and the test batch:
        # 2 forwards for each of the live and the EMA weights
        want = dict(expected_counts(2 * n_steps + 4 * (n_val + 1), False),
                    **backward_counts(n_steps))
        if ops.counts() != want:
            raise AssertionError(f"consistency cli.train launches {ops.counts()} != {want}")
        if trained["steps"] != n_steps or not math.isfinite(trained["test_ct_loss"]):
            raise AssertionError(f"consistency cli.train: {trained}")
        ops.reset()
        t_start = time.perf_counter()
        sampled = cli_sample.main([f"run_dir={trained['run_dir']}", "sampler=consistency"])
        torch.cuda.synchronize()
        cli_sample_s = time.perf_counter() - t_start
        launches["consistency_sample"] = ops.counts()
        if ops.counts() != expected_counts(1, False) or sampled["viz"]:
            raise AssertionError(f"consistency cli.sample: launches {ops.counts()}, views "
                                 f"{sampled['viz']}")
        png = read_png(sampled["path"])
    finally:
        shutil.rmtree(root, ignore_errors=True)

    line = {"phase": "model_families", "nvidia_smi": smi, "batch": TRAIN_BATCH,
            "steps_per_turn": TURN_STEPS, "warmup_steps": TRAIN_WARMUP,
            "turns": list(FAMILY_TURNS), "step_img_per_s": img_per_s,
            "step_profiles": step_profiles, "launches_per_step": per_step,
            "grads_f32_vs_plain": {"batch": GRAD_BATCH, "tol": F32_GRAD_TOL, **grads},
            "input_sites_vs_plain": {"sites": len(sites),
                                     "worst": max(sites, key=lambda st: st["max_abs_err"] /
                                                  st["tol"])},
            "native_samplers": native,
            "native_f32_vs_plain": {"batch": FS_CHECK_BATCH, "tol": F32_CHAIN_TOL,
                                    **native_f32},
            "consistency_cli": {"train_seconds": cli_train_s, "sample_seconds": cli_sample_s,
                                "steps": n_steps, "val_batches": n_val,
                                "test_ct_loss": trained["test_ct_loss"],
                                "png_shape": list(png.shape)},
            "phase_seconds": time.perf_counter() - phase_start}
    emit(line)
    if out_dir is not None:
        (out_dir / "model_families.json").write_text(json.dumps(dict(line, sites=sites),
                                                                indent=1))
    bad = {k: v for k, v in grads.items() if not v["max_rel_err"] <= F32_GRAD_TOL
           or v["all_zero_grads"]}
    if bad:
        raise AssertionError(f"float32 family gradients, kernels vs plain: {bad}")
    bad = {k: v for k, v in native_f32.items()
           if not (v["finite"] and v["max_abs_diff"] <= F32_CHAIN_TOL)}
    if bad:
        raise AssertionError(f"float32 native chains, kernels vs plain: {bad}")
    return launches


def _block_counts(model):
    """(ResBlocks, AttentionBlocks) of a UNet: what a checkpointed backward
    runs again."""
    from probabilisticdeepdiffusionmodels_torch.models.unet import AttentionBlock, ResBlock

    mods = list(model.modules())
    return (sum(isinstance(m, ResBlock) for m in mods),
            sum(isinstance(m, AttentionBlock) for m in mods))


def nd_counts(model, backward=False):
    """Launches of one forward of a 1-D or 3-D UNet: GroupNorm (+SiLU) twice
    a ResBlock, once an attention norm and once the head; the attention
    kernel once an attention block; no fused conv.  ``backward``: and one
    backward, whose GroupNorm and attention gradients launch once a site."""
    n_res, n_attn = _block_counts(model)
    n_gn = 2 * n_res + n_attn + 1
    return {"gn_affine": 0, "gn_silu_conv3x3": 0, "qkv_attention": n_attn,
            "group_norm_silu": n_gn, **backward_counts(0),
            **({"qkv_attention_grad": n_attn, "group_norm_silu_grad": n_gn} if backward else {})}


def f32_vs_plain(torch, ops, model, x, t, *cond, target=None):
    """A float32 model's forward and the gradients of the MSE of its output
    against ``target`` (default: a seeded normal tensor), on the kernels
    against the plain versions (one copy of the model each):
    (forward max abs err over max(1, |ref|), worst gradient's max abs err
    over its reference's largest, its name, parameters with all-zero
    gradients, the kernels' launches)."""
    import copy

    if target is None:
        target = torch.randn(x.shape, device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(77))
    runs = []
    for plain in (False, True):
        m = copy.deepcopy(model)
        ctx = ops.plain_versions() if plain else contextlib.nullcontext()
        ops.reset()
        with ctx:
            out = m(x, t, *cond)
            (out.float() - target).square().mean().backward()
        torch.cuda.synchronize()
        runs.append((out.detach(), dict(m.named_parameters()), ops.counts()))
    (out_k, par_k, counts), (out_p, par_p, counts_p) = runs
    fwd = float((out_k - out_p).abs().max()) / max(1.0, float(out_p.abs().max()))
    worst, worst_name = 0.0, None
    for name, p in par_k.items():
        gp = par_p[name].grad
        rel = float((p.grad - gp).abs().max()) / max(1e-6, float(gp.abs().max()))
        if rel >= worst:
            worst, worst_name = rel, name
    zero = [name for name, p in par_p.items() if not p.grad.any()]
    if any(counts_p.values()):
        raise AssertionError(f"the plain versions launched kernels: {counts_p}")
    return {"fwd_rel_err": fwd, "grad_max_rel_err": worst, "worst_param": worst_name,
            "all_zero_grads": zero, "launches": counts}


def trace_kernels(path):
    """This repository's kernels in a Chrome trace written by
    ``utils.profiling.trace``: kernel name -> launches."""
    events = json.loads(pathlib.Path(path).read_text())["traceEvents"]
    out = {}
    for ev in events:
        name = str(ev.get("name", ""))
        if ev.get("cat") == "kernel" and any(n in name for n in OWN_KERNELS):
            key = next(n for n in OWN_KERNELS if n in name)
            out[key] = out.get(key, 0) + 1
    return out


def model_extras_phase(torch, F, ops, gen, smi, per_site, out_dir=None):
    """The model extras (``model_extras``).  (1) Super-resolution on the
    CIFAR-10 UNet at full width (``model.name=superres``: the wrapped UNet
    sees 6 channels), bf16: the batch-128 forward with its launches, each
    kernel against its plain version at every site of it (``check_sites``),
    the float32 forward and eps-MSE gradients at batch 4 on the kernels
    against the plain versions, the train step beside the eps step in turns,
    the 100-step chain conditioned on the low-res batch through
    ``engine.generate_images``, ``cli.train model.name=superres
    data.superres_factor=2`` (T cut to 100) and ``cli.profile`` on its run,
    whose traces name the kernels.  (2) ``use_checkpoint`` at the same
    width: the bf16 batch-128 train step with and without it in turns (img/s,
    peak memory), float32 gradients with dropout 0.1 with against without it
    (cuDNN deterministic), and one K = 4 fused replay of the checkpointed
    model with dropout against 4 eager steps and against the plain model's
    graph steps run eagerly.  (3) The 1-D and 3-D UNets: float32 forward and
    gradients on the kernels against the plain versions, every GroupNorm
    and attention site of the bf16 forward held against its plain version,
    one bf16 forward timed with its launches.  (4) The dense model on the
    card against the same weights on the CPU.  Returns the launches by
    path."""
    import shutil

    import numpy as np
    import yaml

    from probabilisticdeepdiffusionmodels_torch.cli import profile as cli_profile
    from probabilisticdeepdiffusionmodels_torch.cli import train as cli_train
    from probabilisticdeepdiffusionmodels_torch.config import load_config
    from probabilisticdeepdiffusionmodels_torch.core import DiffusionTables, NoiseSchedule
    from probabilisticdeepdiffusionmodels_torch.core.diffusion import q_sample
    from probabilisticdeepdiffusionmodels_torch.engine import AdamChain, DiffusionEngine
    from probabilisticdeepdiffusionmodels_torch.models import get_model
    from probabilisticdeepdiffusionmodels_torch.train import TrainState
    from probabilisticdeepdiffusionmodels_torch.train.step import CapturedSteps

    phase_start = time.perf_counter()
    launches, bad = {}, []
    line = {"phase": "model_extras", "nvidia_smi": smi}
    tables = DiffusionTables.from_schedule(NoiseSchedule.create(1000, "linear"), "cuda")
    low_res = RESOLUTION // SR_FACTOR

    def low_of(x):
        b, h, w, c = x.shape
        return x.reshape(b, h // SR_FACTOR, SR_FACTOR, w // SR_FACTOR, SR_FACTOR, c).mean((2, 4))

    # (1) super-resolution: the bf16 forward at batch 128 and its sites
    sr = get_model(RESOLUTION, SR_CFG, device="cuda", seed=0)
    fill_zero_params(torch, sr, seed=80)
    x = torch.rand(TRAIN_BATCH, RESOLUTION, RESOLUTION, 3, device="cuda",
                   generator=gen) * 2.0 - 1.0
    low = low_of(x)
    t = torch.randint(1, 1001, (TRAIN_BATCH,), device="cuda", generator=gen)
    calls = {}
    ops.reset()
    with torch.no_grad(), ops.recording(calls):
        out = sr(x, t, low)
    torch.cuda.synchronize()
    launches["superres_forward_bf16"] = ops.counts()
    if ops.counts() != expected_counts(1, False) or not bool(torch.isfinite(out).all()):
        bad.append(f"superres forward: launches {ops.counts()}, finite "
                   f"{bool(torch.isfinite(out).all())}")
    # held against the plain versions, untimed (the CIFAR forward's sites are
    # the same kernels at the same designs, and timed; this timing was cut)
    sr_sites = hold_sites(torch, ops, calls)
    per_site.extend(sr_sites)
    del calls
    with torch.no_grad():
        fwd_ms = sync_time(torch, lambda: sr(x, t, low), min_ms=200.0, max_reps=20)
    line["superres"] = {"config": SR_CFG, "batch": TRAIN_BATCH, "low_res": low_res,
                        "forward_ms": fwd_ms, "sites": len(sr_sites),
                        "worst_site": max(sr_sites, key=lambda s: s["max_abs_err"] / s["tol"])}

    # float32 forward and gradients at a small batch, kernels against plain
    sr32 = get_model(RESOLUTION, dict(SR_CFG, compute_dtype="float32"), device="cuda", seed=0)
    sr32.load_state_dict(sr.state_dict())
    b4 = slice(0, SR_GRAD_BATCH)
    noise = torch.randn(x[b4].shape, device="cuda", generator=gen)
    x_t = q_sample(tables, x[b4], noise, t[b4])  # the eps-MSE of the train step
    f32 = f32_vs_plain(torch, ops, sr32.train(), x_t, t[b4], low[b4], target=noise)
    line["superres"]["f32_vs_plain"] = dict(f32, batch=SR_GRAD_BATCH, tol=F32_GRAD_TOL)
    if not (f32["launches"] == expected_counts(1, True) and f32["fwd_rel_err"] <= F32_GRAD_TOL
            and f32["grad_max_rel_err"] <= F32_GRAD_TOL and not f32["all_zero_grads"]):
        bad.append(f"superres float32 on the kernels vs plain: {f32}")
    del sr32

    # the train step beside the eps step, in turns
    step = family_step("eps", tables)
    steppers = {}
    for kind, cfg in (("eps", MODEL_CFG), ("superres", SR_CFG)):
        m = get_model(RESOLUTION, cfg, device="cuda", seed=0)
        state = TrainState(m, AdamChain(m.parameters(), 2e-4), 1000,
                           torch.Generator(device="cuda").manual_seed(81), ema_decay=0.9999)
        y = low if kind == "superres" else None
        for _ in range(TRAIN_WARMUP):
            step(state, x, y)
        steppers[kind] = (state, y)
    turns = {kind: [] for kind in steppers}
    for kind in SR_TURNS:
        state, y = steppers[kind]
        torch.cuda.synchronize()
        ops.reset()
        t_start = time.perf_counter()
        for _ in range(TURN_STEPS):
            metrics = step(state, x, y)
        torch.cuda.synchronize()
        turns[kind].append(TRAIN_BATCH * TURN_STEPS / (time.perf_counter() - t_start))
        launches[f"extras_train_step_{kind}"] = ops.counts()
        if ops.counts() != expected_counts(TURN_STEPS, True) or not math.isfinite(
                float(metrics["loss"])):
            bad.append(f"{kind} steps: launches {ops.counts()}, loss {float(metrics['loss'])}")
    line["superres"]["step_img_per_s"] = {"turns": list(SR_TURNS), **turns}
    del steppers, state

    # the 100-step chain conditioned on the low-res batch, through the engine
    engine = DiffusionEngine(dict(SR_CFG), {"lr": 2e-4}, clip_while_generating=True,
                             device="cuda")
    engine.state.model.load_state_dict(sr.state_dict())
    chain = []
    for rep in range(2):
        ops.reset()
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        imgs = engine.generate_images(n=TRAIN_BATCH, minibatch=TRAIN_BATCH, seed=rep,
                                      use_ema=False, num_sample_steps=SR_CHAIN_STEPS, y=low)
        chain.append(time.perf_counter() - t_start)
        launches["superres_chain"] = ops.counts()
        if (ops.counts() != expected_counts(SR_CHAIN_STEPS, False)
                or imgs.shape != (TRAIN_BATCH, RESOLUTION, RESOLUTION, 3)
                or not np.isfinite(imgs).all() or not np.abs(imgs).max() <= 1.0):
            bad.append(f"superres chain: launches {ops.counts()}, images {imgs.shape}")
    line["superres"]["chain"] = {"steps": SR_CHAIN_STEPS, "seconds": chain,
                                 "img_per_s": [TRAIN_BATCH / s for s in chain]}
    del engine, sr

    # the CLI: train (T cut to 100), then profile its run
    root = ROOT / "runs" / "chip_smoke_extras"
    shutil.rmtree(root, ignore_errors=True)
    args = SR_CLI_ARGS + [f"out_dir={root}", "run_name=superres"]
    train_loader, val_loader = cli_train.build_loaders(load_config("default", args))
    n_steps, n_val = len(train_loader), len(val_loader)
    if next(iter(train_loader))[1].shape != (TRAIN_BATCH, low_res, low_res, 3):
        bad.append("the superres loader's low-res batch has the wrong shape")
    try:
        ops.reset()
        t_start = time.perf_counter()
        trained, _ = _captured(lambda: cli_train.main(args))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t_start
        launches["superres_cli_train"] = ops.counts()
        want = dict(expected_counts(n_steps + 2 * n_val + SR_CLI_T, False),
                    **backward_counts(n_steps))
        if ops.counts() != want or trained["steps"] != n_steps or not all(
                math.isfinite(trained[k]) for k in ("best_val_loss", "test_nll")):
            bad.append(f"superres cli.train: launches {ops.counts()} != {want}, {trained}")
        run_dir = pathlib.Path(trained["run_dir"])
        rows = [json.loads(r) for r in (run_dir / "metrics.jsonl").read_text().splitlines()]
        epoch_s = next(r["epoch_time_s"] for r in rows if "epoch_time_s" in r)
        ops.reset()
        timings, printed = _captured(lambda: cli_profile.main(
            [f"run_dir={run_dir}"] + SR_PROFILE_ARGS))
        launches["superres_cli_profile"] = ops.counts()
        # a warm-up step and the traced steps; a warm-up chain and the traced one
        n_train = 1 + SR_PROFILE_STEPS
        want = dict(expected_counts(n_train + 2 * SR_PROFILE_SAMPLE_STEPS, False),
                    **backward_counts(n_train))
        saved = json.loads((run_dir / "profile" / "timings.json").read_text())
        traced = {name: trace_kernels(run_dir / "profile" / name / "trace.json")
                  for name in ("train_trace", "sample_trace")}
        if ops.counts() != want or saved != timings:
            bad.append(f"cli.profile: launches {ops.counts()} != {want}, timings {timings}")
        for name, must in (("train_trace", PROFILE_TRAIN_KERNELS),
                           ("sample_trace", PROFILE_SAMPLE_KERNELS)):
            if not all(traced[name].get(k) for k in must):
                bad.append(f"cli.profile's {name} names {traced[name]}, not all of {must}")
        print(printed.strip().splitlines()[0], flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    line["superres_cli"] = {"args": SR_CLI_ARGS, "steps": n_steps, "val_batches": n_val,
                            "train_seconds": train_s, "epoch_seconds": epoch_s,
                            "train_cli_img_per_s": n_steps * TRAIN_BATCH / epoch_s,
                            "test_nll": trained["test_nll"], "profile_timings": timings,
                            "profile_trace_kernels": traced}

    # (2) use_checkpoint at full width: bf16 steps in turns with peak memory
    steppers = {}
    for kind in ("plain", "checkpoint"):
        m = get_model(RESOLUTION, dict(MODEL_CFG, use_checkpoint=kind == "checkpoint"),
                      device="cuda", seed=0)
        state = TrainState(m, AdamChain(m.parameters(), 2e-4), 1000,
                           torch.Generator(device="cuda").manual_seed(82), ema_decay=0.9999)
        for _ in range(TRAIN_WARMUP):
            step(state, x)
        steppers[kind] = state
    n_res, n_attn = _block_counts(steppers["plain"].model)
    per_step = {"plain": expected_counts(1, True),
                "checkpoint": dict(expected_counts(1, True),
                                   gn_affine=PER_FORWARD["gn_affine"] + 2 * n_res,
                                   gn_silu_conv3x3=PER_FORWARD["gn_silu_conv3x3"] + 2 * n_res,
                                   qkv_attention=PER_FORWARD["qkv_attention"] + n_attn,
                                   group_norm_silu=PER_FORWARD["group_norm_silu"] + n_attn)}
    ckpt_turns = {kind: [] for kind in steppers}
    peak = {kind: 0 for kind in steppers}
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()  # both states, the batch, the phase's tensors
    for kind in CKPT_TURNS:
        state = steppers[kind]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset()
        t_start = time.perf_counter()
        for _ in range(TURN_STEPS):
            metrics = step(state, x)
        torch.cuda.synchronize()
        ckpt_turns[kind].append(TRAIN_BATCH * TURN_STEPS / (time.perf_counter() - t_start))
        peak[kind] = max(peak[kind], torch.cuda.max_memory_allocated())
        want = {k: TURN_STEPS * v for k, v in per_step[kind].items()}
        launches[f"extras_train_step_{kind}"] = ops.counts()
        if ops.counts() != want or not math.isfinite(float(metrics["loss"])):
            bad.append(f"{kind} steps: launches {ops.counts()} != {want}")
    line["use_checkpoint"] = {"step_img_per_s": {"turns": list(CKPT_TURNS), **ckpt_turns},
                              "max_memory_allocated_bytes": peak,
                              "allocated_before_turns_bytes": resident,
                              "launches_per_step": per_step}
    del steppers, state

    # float32 gradients with dropout, with against without checkpoints
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    cfg32 = dict(MODEL_CFG, compute_dtype="float32", dropout=CKPT_DROPOUT)
    plain32 = get_model(RESOLUTION, cfg32, device="cuda", seed=0)
    fill_zero_params(torch, plain32, seed=83)
    ckpt32 = get_model(RESOLUTION, dict(cfg32, use_checkpoint=True), device="cuda", seed=0)
    ckpt32.load_state_dict(plain32.state_dict())
    xg = x[:CKPT_GRAD_BATCH]
    grads, gens = [], []
    for m in (plain32.train(), ckpt32.train()):
        g = torch.Generator(device="cuda").manual_seed(84)
        (m(xg, t[:CKPT_GRAD_BATCH], generator=g).square().mean()).backward()
        grads.append({k: p.grad for k, p in m.named_parameters()})
        gens.append(g.get_state())
    worst = max(float((grads[1][k] - v).abs().max()) / max(1e-30, float(v.abs().max()))
                for k, v in grads[0].items())
    line["use_checkpoint"]["f32_dropout_grads"] = {
        "batch": CKPT_GRAD_BATCH, "dropout": CKPT_DROPOUT, "max_rel_err": worst,
        "tol": CKPT_SAME_TOL, "bits_equal": all(torch.equal(grads[1][k], v)
                                                for k, v in grads[0].items()),
        "generator_equal": torch.equal(gens[0], gens[1])}
    if not (worst <= CKPT_SAME_TOL and torch.equal(gens[0], gens[1])):
        bad.append(f"checkpointed float32 gradients: {line['use_checkpoint']}")
    del plain32, ckpt32, grads

    # one K = 4 replay of the checkpointed model with dropout, from one copy
    # of the state, against 4 eager steps and the plain model's graph steps
    def engine_of(cfg):
        e = DiffusionEngine(dict(cfg), {"lr": FUSED_LR}, ema=0.9999, device="cuda")
        fill_zero_params(torch, e.state.model, seed=85)
        e.state.ema_model.load_state_dict(e.state.model.state_dict())
        return e

    cfg_d = dict(MODEL_CFG, dropout=CKPT_DROPOUT)
    graph_e, eager_e = (engine_of(dict(cfg_d, use_checkpoint=True)) for _ in range(2))
    body_e = engine_of(cfg_d)
    xs = [torch.rand((FUSED_K, TRAIN_BATCH, RESOLUTION, RESOLUTION, 3), device="cuda",
                     generator=gen) * 2.0 - 1.0 for _ in range(2)]
    graph_e.training_steps(xs[0])
    copy_state(graph_e.state, eager_e.state)
    copy_state(graph_e.state, body_e.state)
    ops.reset()
    rows_g = graph_e.training_steps(xs[1])
    replay_counts = ops.counts()
    rows_e = torch.stack([eager_e.training_step(xi)["loss"] for xi in xs[1]])
    rows_b = CapturedSteps(body_e._train_step, body_e.state, xs[1], capture=False)(xs[1])
    vs_eager = compare_states(torch, graph_e.state, eager_e.state)
    vs_plain = compare_states(torch, graph_e.state, body_e.state)
    vs_eager["loss_rows_rel"] = _rows_rel(rows_g["loss"], rows_e)
    vs_plain["loss_rows_rel"] = _rows_rel(rows_g["loss"], rows_b["loss"])
    torch.backends.cudnn.deterministic = deterministic
    line["use_checkpoint"]["fused_replay"] = {
        "k": FUSED_K, "dropout": CKPT_DROPOUT, "vs_eager_checkpointed": vs_eager,
        "vs_plain_graph_steps_eagerly": vs_plain,
        "captures": sum(c.captures for c in graph_e._fused_step.graphs.values())}
    if line["use_checkpoint"]["fused_replay"]["captures"] != 1:
        bad.append(f"checkpointed fused steps: {line['use_checkpoint']['fused_replay']}")
    if any(replay_counts.values()):
        bad.append(f"the checkpointed replay ticked the launch counters {replay_counts}")
    if not fused_state_ok(vs_eager):
        bad.append(f"checkpointed replay vs eager steps: {vs_eager}")
    if not fused_state_ok(vs_plain, same=True):
        bad.append(f"checkpointed replay vs the plain model's graph steps: {vs_plain}")
    del graph_e, eager_e, body_e, xs

    # (3) the 1-D and 3-D UNets
    nd = {}
    for dims, (cfg, res, batch) in ND_CFGS.items():
        spatial = (res,) * dims
        m = get_model(res, cfg, device="cuda", seed=0)
        fill_zero_params(torch, m, seed=86 + dims)
        xn = torch.randn(batch, *spatial, cfg["in_channels"], device="cuda", generator=gen)
        tn = torch.randint(1, 1001, (batch,), device="cuda", generator=gen)
        m32 = get_model(res, dict(cfg, compute_dtype="float32"), device="cuda", seed=0)
        m32.load_state_dict(m.state_dict())
        f32 = f32_vs_plain(torch, ops, m32, xn, tn)
        del m32
        calls = {}
        ops.reset()
        with torch.no_grad(), ops.recording(calls):
            out = m(xn, tn)
        torch.cuda.synchronize()
        counts = ops.counts()
        sites = []
        check_sites(torch, F, ops, calls, sites, grads_timed=False)
        per_site.extend(sites)
        with torch.no_grad():
            ms = sync_time(torch, lambda: m(xn, tn), min_ms=200.0, max_reps=20)
        launches[f"extras_unet_{dims}d_forward_bf16"] = counts
        nd[f"{dims}d"] = {"config": cfg, "spatial": list(spatial), "batch": batch,
                          "forward_bf16_ms": ms, "launches": counts,
                          "f32_vs_plain": dict(f32, tol=F32_GRAD_TOL),
                          "sites": [{k: s.get(k) for k in ("kernel", "shape", "dtype", "design",
                                                           "max_abs_err", "tol", "ms",
                                                           "plain_ms")} for s in sites]}
        if counts != nd_counts(m) or not bool(torch.isfinite(out).all()):
            bad.append(f"{dims}-D forward: launches {counts} != {nd_counts(m)}")
        if f32["launches"] != nd_counts(m, backward=True):
            bad.append(f"{dims}-D float32 forward and backward launches {f32['launches']}")
        if not (f32["fwd_rel_err"] <= F32_GRAD_TOL and f32["grad_max_rel_err"] <= F32_GRAD_TOL
                and not f32["all_zero_grads"]):
            bad.append(f"{dims}-D float32 on the kernels vs plain: {f32}")
        del m, calls
    line["unet_nd"] = nd

    # (4) the dense model on the card against the same weights on the CPU
    cfg = yaml.safe_load((ROOT / PKG / "config" / "model" / "dense.yaml").read_text())
    dense = get_model(RESOLUTION, cfg, device="cuda", seed=0)
    dense_cpu = get_model(RESOLUTION, cfg, device="cpu", seed=0)
    dense_cpu.load_state_dict(dense.state_dict())
    side = cfg["resolution"]
    xd = torch.randn(DENSE_BATCH, side, side, cfg["in_channels"], generator=torch.Generator()
                     .manual_seed(87))
    td = torch.randint(1, 1001, (DENSE_BATCH,), generator=torch.Generator().manual_seed(88))
    with torch.no_grad():
        got = dense(xd.cuda(), td.cuda()).cpu()
        want = dense_cpu(xd, td)
    dense_err = float((got - want).abs().max()) / max(1.0, float(want.abs().max()))
    line["dense"] = {"config": cfg, "batch": DENSE_BATCH, "max_rel_err": dense_err,
                     "tol": DENSE_TOL, "device": str(next(dense.parameters()).device)}
    if not dense_err <= DENSE_TOL or got.shape != xd.shape:
        bad.append(f"dense on the card vs the CPU: {line['dense']}")

    line["launches"] = launches
    line["phase_seconds"] = time.perf_counter() - phase_start
    emit(line)
    if out_dir is not None:
        (out_dir / "model_extras.json").write_text(json.dumps(dict(line, sites=sr_sites),
                                                              indent=1, default=str))
    if bad:
        raise AssertionError("; ".join(bad))
    return launches


def _captured(fn):
    """(result, printed text) of ``fn()``, its standard output captured."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn()
    return result, buf.getvalue()


def _line(text, start):
    return next(line for line in text.splitlines() if line.startswith(start))


def _rel(got, want):
    """max |got - want| / max |want|."""
    return float((got - want).abs().max()) / max(1e-30, float(want.abs().max()))


def inception_check(torch):
    """InceptionV3 (random weights from a seeded generator) in float32 at
    batch 256 on the card against the same module on the CPU on the first
    64 of them, on the CPU's resize of 32x32 images; the card's resize against the CPU's; the
    forward's ms and img/s with TF32 off (the port's setting) and with it on
    (what cuDNN would do by default), each against the CPU."""
    from probabilisticdeepdiffusionmodels_torch.evals import inception as inc

    gen = torch.Generator().manual_seed(30)
    x01 = torch.rand(INCEPTION_BATCH, RESOLUTION, RESOLUTION, 3, generator=gen)
    cpu = inc.random_params(device="cpu")
    card = inc.random_params(device="cuda")
    x_cpu = inc.preprocess(x01)
    t_start = time.perf_counter()
    x_card = inc.preprocess(x01.cuda())
    torch.cuda.synchronize()
    resize_s = time.perf_counter() - t_start
    resize_err = float((x_card.cpu() - x_cpu).abs().max())
    t_start = time.perf_counter()
    want = inc.inception_pool_features(cpu, x_cpu[:INCEPTION_CPU_BATCH])
    cpu_s = time.perf_counter() - t_start
    x = x_cpu.cuda()
    out = {"batch": INCEPTION_BATCH, "resize_max_abs_diff": resize_err,
           "cpu_batch": INCEPTION_CPU_BATCH,
           "resize_tol": RESIZE_TOL, "resize_seconds": resize_s, "cpu_forward_seconds": cpu_s,
           "feature_abs_max": float(want.abs().max())}
    with inc.true_float32():
        got = inc.inception_pool_features(card, x).cpu()
        ms = sync_time(torch, lambda: inc.inception_pool_features(card, x), min_ms=500.0,
                       max_reps=10)
    out["tf32_off"] = {"max_rel_err": _rel(got[:INCEPTION_CPU_BATCH], want), "ms": ms,
                       "img_per_s": INCEPTION_BATCH / ms * 1e3}
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.no_grad():
            got_tf32 = card(x).cpu()
            ms = sync_time(torch, lambda: card(x), min_ms=500.0, max_reps=10)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    out["tf32_on"] = {"max_rel_err": _rel(got_tf32[:INCEPTION_CPU_BATCH], want), "ms": ms,
                      "img_per_s": INCEPTION_BATCH / ms * 1e3}
    if not (resize_err <= RESIZE_TOL and out["tf32_off"]["max_rel_err"] <= INCEPTION_REL_TOL
            and bool(torch.isfinite(got).all())):
        raise AssertionError(f"Inception on the card against the CPU: {out}")
    return out


def _ode_run(torch, family, root):
    """A run directory (config and checkpoint) of a fresh ``family`` engine
    at the CIFAR-10 UNet's full width, bf16, T cut to ODE_EVAL_T, as
    ``cli.train`` writes one."""
    from probabilisticdeepdiffusionmodels_torch.cli import train as cli_train
    from probabilisticdeepdiffusionmodels_torch.config import load_config
    from probabilisticdeepdiffusionmodels_torch.logging.sink import RunDir
    from probabilisticdeepdiffusionmodels_torch.train.checkpoint import CheckpointManager

    cfg = load_config("default", CLI_ARGS + [
        f"engine.prediction_type={family}", f"engine.diffusion_steps={ODE_EVAL_T}",
        "engine.ema=null", f"out_dir={root}", f"run_name=ode_{family}"])
    engine = cli_train.build_engine(cfg)
    fill_zero_params(torch, engine.state.model, seed=31)
    run = RunDir(str(root), cfg["run_name"])
    run.save_config(cfg)
    CheckpointManager(run.checkpoint_dir()).save(engine.state, 0, metrics={"val_loss": 0.0})
    return run.path


def ode_checks(torch, ops, root, launches):
    """The ODE likelihood of the flow and EDM families: float32 at batch 4
    on the kernels against the plain versions, then ``cli.eval ode_nll=true``
    on one bf16 batch of 128 with its launches asserted, and one profiled
    integration (device operations a probe evaluation, no copy to the
    host)."""
    from probabilisticdeepdiffusionmodels_torch.cli import eval as cli_eval
    from probabilisticdeepdiffusionmodels_torch.cli.sample import load_engine_from_run
    from probabilisticdeepdiffusionmodels_torch.cli.train import build_loaders
    from probabilisticdeepdiffusionmodels_torch.engine import DiffusionEngine

    gen = torch.Generator(device="cuda").manual_seed(32)
    x4 = torch.rand(ODE_CHECK_BATCH, RESOLUTION, RESOLUTION, 3, device="cuda",
                    generator=gen) * 2.0 - 1.0
    # a Heun step evaluates both ends: 2 forwards and their VJPs a step
    evals = 2 * ODE_CHECK_STEPS
    f32, cli = {}, {}
    for family in ("flow", "edm"):
        engine = DiffusionEngine(dict(MODEL_CFG, compute_dtype="float32"), {"lr": 2e-4},
                                 prediction_type=family, device="cuda")
        fill_zero_params(torch, engine.state.model, seed=33)
        ops.reset()
        got = engine.calculate_ode_likelihood(x4, seed=34, use_ema=False,
                                              n_steps=ODE_CHECK_STEPS)
        torch.cuda.synchronize()
        counts = ops.counts()
        with ops.plain_versions():
            want = engine.calculate_ode_likelihood(x4, seed=34, use_ema=False,
                                                   n_steps=ODE_CHECK_STEPS)
        if counts != expected_counts(evals, True) or ops.counts() != counts:
            raise AssertionError(f"float32 {family} ODE likelihood launches {counts}, then "
                                 f"{ops.counts()}")
        launches[f"ode_f32_{family}"] = counts
        f32[family] = {"rel_err": {k: _rel(got[k], want[k])
                                   for k in ("nll_bits_per_dim", "delta_logp")},
                       "nll_bits_per_dim": got["nll_bits_per_dim"].tolist(),
                       "finite": all(bool(torch.isfinite(v).all()) for v in got.values())}
        del engine

        run_dir = _ode_run(torch, family, root)
        argv = [f"run_dir={run_dir}", "ode_nll=true", f"ode_steps={ODE_EVAL_STEPS}",
                "use_train_data=false", "trainer.limit_test_batches=1"]
        timed = {}
        ops.reset()
        with timing_calls(DiffusionEngine, ("calculate_ode_likelihood", "test_step"), timed):
            result, _ = _captured(lambda: cli_eval.main(argv))
        counts = ops.counts()
        ode_calls = 2 * ODE_EVAL_STEPS
        want = dict(expected_counts(ODE_EVAL_T + ode_calls, False),
                    **backward_counts(ode_calls))
        if counts != want or not math.isfinite(result["test_ode_nll"]):
            raise AssertionError(f"cli.eval ode_nll {family}: launches {counts} != {want}, "
                                 f"{result}")
        launches[f"cli_eval_ode_{family}"] = counts
        engine, cfg = load_engine_from_run(run_dir)
        x = torch.as_tensor(next(iter(build_loaders(cfg)[1]))[0], device="cuda")
        prof = profile_device(torch, lambda: engine.calculate_ode_likelihood(x, n_steps=1))
        copies = [k["name"] for k in prof.pop("all") if "DtoH" in k["name"]]
        if copies:
            raise AssertionError(f"the {family} ODE likelihood copies to the host: {copies}")
        cli[family] = {"test_ode_nll": result["test_ode_nll"], "test_nll": result["test_nll"],
                       "ode_seconds": timed["calculate_ode_likelihood"][-1],
                       "vlb_seconds": timed["test_step"][-1],
                       "device_ops_per_probe_eval": prof["device_ops"] / 2,
                       "device_busy_ms_per_probe_eval": prof["device_busy_ms"] / 2,
                       "profiled_idle_share": prof["idle_share"], "host_copies": copies}
        del engine
    bad = {k: v for k, v in f32.items()
           if not (v["finite"] and max(v["rel_err"].values()) <= ODE_CHECK_TOL)}
    return {"f32_vs_plain": {"batch": ODE_CHECK_BATCH, "n_steps": ODE_CHECK_STEPS,
                             "tol": ODE_CHECK_TOL, **f32},
            "cli_eval": {"batch": TRAIN_BATCH, "ode_steps": ODE_EVAL_STEPS, "T": ODE_EVAL_T,
                         **cli}}, bad


def evals_phase(torch, ops, smi, run_dir, out_dir=None):
    """The FID family and the ODE likelihood on the card: Inception against
    the CPU, ``cli.fid_score`` on the cli run (the sampler's launches
    exact), ``cli.fid_debug``, and ``ode_checks``; returns the launches by
    path."""
    from probabilisticdeepdiffusionmodels_torch.cli import fid_debug as cli_fid_debug
    from probabilisticdeepdiffusionmodels_torch.cli import fid_score as cli_fid_score
    from probabilisticdeepdiffusionmodels_torch.engine import DiffusionEngine

    phase_start = time.perf_counter()
    line = {"phase": "evals", "nvidia_smi": smi, "inception": inception_check(torch)}
    launches = {}

    # cli.fid_score: 4 chains of 250 steps at batch 256, then the scores;
    # the CLI prints them rounded, so the dict it printed is recorded too
    timed, scores = {}, []
    real = cli_fid_score.compute_fid_from_engine

    def recording(*args, **kwargs):
        scores.append(real(*args, **kwargs))
        return scores[-1]

    ops.reset()
    cli_fid_score.compute_fid_from_engine = recording
    t_start = time.perf_counter()
    try:
        with timing_calls(DiffusionEngine, ("generate_images",), timed):
            rc, text = _captured(lambda: cli_fid_score.main([str(run_dir)] + FID_ARGV))
    finally:
        cli_fid_score.compute_fid_from_engine = real
    fid_s = time.perf_counter() - t_start
    launches["cli_fid_score"] = ops.counts()
    want = expected_counts(FID_SAMPLES // FID_MINIBATCH * FID_STEPS, False)
    if rc != 0 or launches["cli_fid_score"] != want:
        raise AssertionError(f"cli.fid_score: rc {rc}, launches {launches['cli_fid_score']} "
                             f"!= {want}")
    fid = dict(scores[0], printed_stamp=_line(text, "inception_weights:").split()[1],
               printed_fid=float(_line(text, "FID:").split()[1]),
               pipeline_line=_line(text, "FID pipeline:"), seconds=fid_s,
               sampled_img_per_s=FID_SAMPLES / fid_s,
               sampling_seconds=sum(timed["generate_images"]),
               chains=len(timed["generate_images"]), n=FID_SAMPLES, steps=FID_STEPS,
               minibatch=FID_MINIBATCH)
    line["fid_score"] = fid
    if not (math.isfinite(fid["fid"]) and fid["printed_fid"] == fid["fid"]
            and 0.0 <= fid["precision"] <= 1.0 and 0.0 <= fid["recall"] <= 1.0
            and math.isfinite(fid["kid_mean"]) and fid["is_mean"] >= 1.0 - 1e-6
            and fid["inception_weights"] == fid["printed_stamp"] == "random"):
        raise AssertionError(f"cli.fid_score: {fid}")

    # cli.fid_debug: the synthetic splits against each other
    t_start = time.perf_counter()
    rc, text = _captured(lambda: cli_fid_debug.main(FID_DEBUG_ARGS))
    floor = float(_line(text, "FID floor").split()[-1])
    line["fid_debug"] = {"fid_floor": floor, "seconds": time.perf_counter() - t_start,
                         "images_a_split": FID_DEBUG_N}
    if rc != 0 or not math.isfinite(floor):
        raise AssertionError(f"cli.fid_debug: rc {rc}, {text[-400:]}")

    root = CLI_ROOT / "ode"
    ode, bad = ode_checks(torch, ops, root, launches)
    line["ode_nll"] = ode
    line["launches"] = launches
    line["phase_seconds"] = time.perf_counter() - phase_start
    emit(line)
    if out_dir is not None:
        (out_dir / "evals.json").write_text(json.dumps(line, indent=1))
    if bad:
        raise AssertionError(f"float32 ODE likelihood, kernels vs plain: {bad}")
    return {k: v for k, v in launches.items() if not k.startswith("ode_f32")}


def consistency_distill_phase(torch, ops, gen, smi, run_dir, out_dir=None):
    """Consistency distillation at the CIFAR-10 UNet's full width: CD rounds
    (bf16, batch 128, 10 steps after 3) from the cli run's eps teacher and
    from an EDM teacher in turns beside the eps step, their launches
    asserted; each step's device operations and no copy to the host; the
    float32 gradients of one CD step of each teacher on the kernels against
    the plain versions; then ``cli.consistency`` on the cli run and
    ``cli.sample sampler=consistency`` on its output; returns the launches
    by path."""
    import copy

    from probabilisticdeepdiffusionmodels_torch.cli import consistency as cli_consistency
    from probabilisticdeepdiffusionmodels_torch.cli import sample as cli_sample
    from probabilisticdeepdiffusionmodels_torch.core import DiffusionTables, NoiseSchedule
    from probabilisticdeepdiffusionmodels_torch.core.diffusion import q_sample
    from probabilisticdeepdiffusionmodels_torch.engine import AdamChain, DiffusionEngine
    from probabilisticdeepdiffusionmodels_torch.models import get_model
    from probabilisticdeepdiffusionmodels_torch.train import TrainState
    from probabilisticdeepdiffusionmodels_torch.train.consistency import (
        consistency_distill_round,
        consistency_student,
        make_cd_step,
        make_teacher_denoiser,
    )

    phase_start = time.perf_counter()
    launches = {}
    per_step = dict(expected_counts(CD_FORWARDS, False),
                    **backward_counts(1))
    teachers = {"cd_eps": cli_sample.load_engine_from_run(run_dir)[0],
                "cd_edm": DiffusionEngine(dict(MODEL_CFG), {"lr": 2e-4}, prediction_type="edm",
                                          device="cuda")}
    fill_zero_params(torch, teachers["cd_edm"].state.model, seed=40)
    xb = torch.rand(TRAIN_BATCH, RESOLUTION, RESOLUTION, 3, device="cuda",
                    generator=gen) * 2.0 - 1.0
    students = {kind: consistency_student(t) for kind, t in teachers.items()}
    tables = DiffusionTables.from_schedule(NoiseSchedule.create(1000, "linear"), "cuda")
    m = get_model(RESOLUTION, MODEL_CFG, device="cuda", seed=0)
    eps_state = TrainState(m, AdamChain(m.parameters(), 2e-4), 1000,
                           torch.Generator(device="cuda").manual_seed(41), ema_decay=0.9999)
    eps_step = family_step("eps", tables)

    def run(kind, n):
        if kind == "eps":
            for _ in range(n):
                eps_step(eps_state, xb)
            return
        consistency_distill_round(students[kind], teachers[kind], [xb] * n, log_every=0)

    for kind in ("eps", "cd_eps", "cd_edm"):
        run(kind, TRAIN_WARMUP)
    img_per_s = {kind: [] for kind in ("eps", "cd_eps", "cd_edm")}
    for kind in CD_TURNS:
        torch.cuda.synchronize()
        ops.reset()
        t_start = time.perf_counter()
        run(kind, TURN_STEPS)
        torch.cuda.synchronize()
        img_per_s[kind].append(TRAIN_BATCH * TURN_STEPS / (time.perf_counter() - t_start))
        want = {k: TURN_STEPS * v for k, v in
                (expected_counts(1, True) if kind == "eps" else per_step).items()}
        if ops.counts() != want:
            raise AssertionError(f"{kind} launches {ops.counts()} != {want}")
        launches[f"round_{kind}" if kind != "eps" else "train_step_eps_cd_turns"] = ops.counts()
    profiles = {}
    for kind, teacher in teachers.items():
        student = students[kind]
        step = make_cd_step(make_teacher_denoiser(teacher), student.cm, student.tables)
        model = teacher.params(use_ema=True).eval()
        prof = profile_device(torch, lambda: step(student.state, model, xb))
        copies = [k["name"] for k in prof.pop("all") if "DtoH" in k["name"]]
        profiles[kind] = {"device_ops": prof["device_ops"],
                          "device_busy_ms": prof["device_busy_ms"], "host_copies": copies}
        if copies:
            raise AssertionError(f"the {kind} step copies to the host: {copies}")
    prof = profile_device(torch, lambda: eps_step(eps_state, xb))
    prof.pop("all")
    profiles["eps"] = {"device_ops": prof["device_ops"], "device_busy_ms": prof["device_busy_ms"]}
    del students, eps_state, m

    # float32 gradients of one CD step of each teacher at a small batch,
    # kernels against plain versions, the same draws
    xg = xb[:GRAD_BATCH].clone()
    grads = {}
    for kind, pt in (("cd_eps", "epsilon"), ("cd_edm", "edm")):
        teacher = DiffusionEngine(dict(MODEL_CFG, compute_dtype="float32"), {"lr": 2e-4},
                                  prediction_type=pt, device="cuda")
        fill_zero_params(torch, teacher.state.model, seed=42)
        student = consistency_student(teacher, use_ema_teacher=False)
        states = [TrainState(mm, AdamChain(mm.parameters(), 2e-4), 1000,
                             torch.Generator(device="cuda").manual_seed(43))
                  for mm in (copy.deepcopy(student.state.model),
                             copy.deepcopy(student.state.model))]
        step = make_cd_step(make_teacher_denoiser(teacher), student.cm, student.tables)
        ops.reset()
        loss_k = float(step(states[0], teacher.state.model, xg)["loss"])
        counts = ops.counts()
        with ops.plain_versions():
            loss_p = float(step(states[1], teacher.state.model, xg)["loss"])
        if counts != per_step or ops.counts() != counts:
            raise AssertionError(f"float32 {kind} step launches {counts}, then {ops.counts()}")
        named_p = dict(states[1].model.named_parameters())
        worst, worst_name = 0.0, None
        for name, p in states[0].model.named_parameters():
            rel = _rel(p.grad, named_p[name].grad) if named_p[name].grad.any() else 0.0
            if rel >= worst:
                worst, worst_name = rel, name
        zero = [name for name, p in named_p.items() if not p.grad.any()]
        grads[kind] = {"loss_kernels": loss_k, "loss_plain": loss_p, "max_rel_err": worst,
                       "worst_param": worst_name, "all_zero_grads": zero}
        del teacher, student, states

    # cli.consistency on the cli run (its 10 steps a pass over the synthetic
    # data, one validation batch), then its one-step grid
    root = CLI_ROOT / "cd"
    ops.reset()
    t_start = time.perf_counter()
    distilled, _ = _captured(lambda: cli_consistency.main(
        [f"run_dir={run_dir}", "epochs=1", f"out_dir={root}", "limit_test_batches=1"]))
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t_start
    launches["cli_consistency"] = ops.counts()
    n_steps = TRAIN_STEPS  # 1,280 synthetic images at batch 128
    # a CD step; one validation batch: 2 forwards for each of the live and
    # the EMA weights
    want = dict(expected_counts(CD_FORWARDS * n_steps + 4, False),
                **backward_counts(n_steps))
    if ops.counts() != want or not math.isfinite(distilled["test_ct_loss"]):
        raise AssertionError(f"cli.consistency launches {ops.counts()} != {want}, {distilled}")
    ops.reset()
    t_start = time.perf_counter()
    sampled, _ = _captured(lambda: cli_sample.main([f"run_dir={distilled['run_dir']}",
                                                     "sampler=consistency"]))
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t_start
    launches["cli_sample_consistency_distilled"] = ops.counts()
    if ops.counts() != expected_counts(1, False) or sampled["viz"]:
        raise AssertionError(f"cli.sample of the distilled run: launches {ops.counts()}")
    png = read_png(sampled["path"])

    line = {"phase": "consistency_distill", "nvidia_smi": smi, "batch": TRAIN_BATCH,
            "steps_per_turn": TURN_STEPS, "warmup_steps": TRAIN_WARMUP,
            "turns": list(CD_TURNS), "img_per_s": img_per_s, "step_profiles": profiles,
            "launches_per_cd_step": per_step,
            "grads_f32_vs_plain": {"batch": GRAD_BATCH, "tol": F32_GRAD_TOL, **grads},
            "cli_consistency": {"seconds": cli_s, "sample_seconds": sample_s,
                                "loss": distilled["loss"],
                                "test_ct_loss": distilled["test_ct_loss"],
                                "png_shape": list(png.shape)},
            "launches": launches, "phase_seconds": time.perf_counter() - phase_start}
    emit(line)
    if out_dir is not None:
        (out_dir / "consistency_distill.json").write_text(json.dumps(line, indent=1))
    bad = {k: v for k, v in grads.items() if not v["max_rel_err"] <= F32_GRAD_TOL
           or v["all_zero_grads"]}
    if bad:
        raise AssertionError(f"float32 CD gradients, kernels vs plain: {bad}")
    return launches


# this repository's kernels as the profiler names them
OWN_KERNELS = ("attn_fwd_wgmma_kernel", "attn_bf16_kernel", "attn_f32_kernel",
               "attn_bwd_dq_bf16_kernel",
               "attn_bwd_dkv_bf16_kernel", "attn_bwd_dq_f32_kernel", "attn_bwd_dkv_f32_kernel",
               "gn_silu_bwd_kernel", "gn_silu_bwd_sums_kernel", "gn_silu_bwd_resident_kernel",
               "gn_batch_sum_pdl_kernel", "conv_wgmma_kernel",
               "conv_narrow_f32_kernel", "conv_kernel<", "gn_moments_kernel", "gn_apply_kernel",
               "gn_affine_bwd_kernel", "gn_batch_sum_kernel", "gn_fold_bwd_kernel",
               "gn_fold_kernel", "dgrad_wgmma_kernel", "dgrad_pingpong_kernel",
               "attn_bwd_wgmma_kernel", "wgrad_wgmma_kernel",
               "wgrad9_wgmma_kernel", "grad_narrow_f32_kernel", "activate_kernel",
               "dgrad_general_kernel", "wgrad_general_kernel", "grad_finish_kernel")


def own_kernel_counts(kernels):
    """A profile's launches of this repository's kernels, by kernel name."""
    out = {}
    for k in kernels:
        if any("::" + n in k["name"] or k["name"].startswith(n) for n in OWN_KERNELS):
            out[k["name"]] = out.get(k["name"], 0) + k["calls"]
    return out


def copy_state(src, dst):
    """``dst`` (a TrainState) made a copy of ``src`` in place: every tensor
    keeps its address, so a graph captured on ``dst`` stays valid."""
    dst.step = src.step
    dst.model.load_state_dict(src.model.state_dict())
    if src.ema_model is not None:
        dst.ema_model.load_state_dict(src.ema_model.state_dict())
    so, do = src.optimizer, dst.optimizer
    so.init_state()
    do.init_state()
    for ps, pd in zip(so.params, do.params):
        for name in ("step", "exp_avg", "exp_avg_sq"):
            do.adam.state[pd][name].copy_(so.adam.state[ps][name])
    for a, b in zip(so.acc or [], do.acc or []):
        b.copy_(a)
    do.updates, do.mini_step = so.updates, so.mini_step
    for name in ("ring", "ring_pos", "count", "epoch_sum", "epoch_count"):
        getattr(dst.loss_history, name).copy_(getattr(src.loss_history, name))
    dst.generator.set_state(src.generator.get_state())


def compare_states(torch, got, want):
    """How far train state ``got`` is from ``want``: the largest absolute
    difference of the parameters and the EMA, each Adam moment's largest
    difference over the model's largest moment, the loss history's ring; and
    whether the counts (Adam's, the history's, the host's) and the
    generator are equal."""
    def worst(pairs):
        return max(float((a.detach().float() - b.detach().float()).abs().max()) for a, b in pairs)

    out = {"params": worst(zip(got.model.parameters(), want.model.parameters())),
           "ema": worst(zip(got.ema_model.parameters(), want.ema_model.parameters()))}
    sg = [got.optimizer.adam.state[p] for p in got.optimizer.params]
    sw = [want.optimizer.adam.state[p] for p in want.optimizer.params]
    for kind in ("exp_avg", "exp_avg_sq"):
        largest = max(float(s[kind].abs().max()) for s in sw)
        out[f"{kind}_rel"] = worst((g[kind], w[kind]) for g, w in zip(sg, sw)) / largest
    out["history_ring_max_abs"] = float((got.loss_history.ring - want.loss_history.ring)
                                        .abs().max())
    out["adam_counts_equal"] = all(torch.equal(g["step"], w["step"]) for g, w in zip(sg, sw))
    out["history_counts_equal"] = all(
        torch.equal(getattr(got.loss_history, n), getattr(want.loss_history, n))
        for n in ("count", "ring_pos", "epoch_count"))
    out["generator_equal"] = torch.equal(got.generator.get_state(), want.generator.get_state())
    out["host_counts"] = [[s.step, s.optimizer.updates, s.optimizer.mini_step]
                          for s in (got, want)]
    out["bits_equal"] = (out["params"] == out["ema"] == out["exp_avg_rel"]
                         == out["exp_avg_sq_rel"] == out["history_ring_max_abs"] == 0.0)
    return out


def fused_state_ok(d, same=False):
    """The fused_train gates on a ``compare_states`` result (with its loss
    rows' ``loss_rows_rel`` where it has them): the counts and the
    generator equal, the floats within the tolerances against eager steps,
    or within FUSED_SAME_TOL where ``same`` (the same arithmetic)."""
    p, m, rows = ((FUSED_SAME_TOL,) * 3 if same
                  else (FUSED_PARAM_TOL, FUSED_MOMENT_TOL, FUSED_LOSS_TOL))
    return (d["adam_counts_equal"] and d["history_counts_equal"] and d["generator_equal"]
            and d["host_counts"][0] == d["host_counts"][1] and d["params"] <= p
            and d["ema"] <= p and d["exp_avg_rel"] <= m and d["exp_avg_sq_rel"] <= m
            and d.get("loss_rows_rel", 0.0) <= rows
            and (not same or d["history_ring_max_abs"] <= FUSED_SAME_TOL))


def _rows_rel(a, b):
    """max |a - b| / |b| over two stacks of loss rows."""
    return float(((a.float() - b.float()).abs() / b.float().abs().clamp_min(1e-30)).max())


def profile_pair_gate(torch, run_e, run_g, tries=3, lower_bounds=False):
    """One replay's device operations (``run_g``) against K eager steps'
    (``run_e``) from profiles, and the problems found.  A profile can miss
    kernel records (seen once in a full command: a replay 12 own kernels
    short while its results matched the graph's steps run eagerly bit for
    bit), so where a pair of profiles differs, up to ``tries`` - 1 more
    pairs are taken; the gate needs a pair that agrees.  Every profile's
    counts are kept, and one that differs from its side's agreeing profile
    must count no kernel more, and must be short in device operations by at
    least its shortfall of own kernels: a dropped record lowers both.  That
    shortfall in device operations is taken from the side's most complete
    profile (the most device operations), not from the agreeing one, since
    the agreeing profile can itself have dropped records of other kernels
    (seen once: K eager steps with the same own kernels counted 8,232 and
    8,210 device operations in two profiles of one run).

    ``lower_bounds``: a weaker rule, for a path whose profiles drop records
    on both sides in most pairs (the one-rank NCCL mesh at batch 32: 1,086
    to 1,093 of 1,096 counted), so that a pair may agree below the truth.
    There every count is a lower bound: the gate takes a pair that agrees,
    or else each side's largest count of each kernel over its profiles,
    which must name the same kernels and be under 1% of the records apart
    in all; the other profiles are not held to the agreeing one.  It does
    not catch a replay that skips a few launches; the replay's results
    held to the graph's steps run eagerly do.
    Returns (the profile summary for the phase's line, problems)."""
    bad = []
    sides = {"eager_k_steps": [], "replay": []}
    for _ in range(tries):
        for side, run in (("eager_k_steps", run_e), ("replay", run_g)):
            prof = profile_device(torch, run)
            sides[side].append({"own": own_kernel_counts(prof["all"]),
                                "device_ops": prof["device_ops"], "prof": prof})
        if sides["eager_k_steps"][-1]["own"] == sides["replay"][-1]["own"]:
            break
    prof_e, prof_g = sides["eager_k_steps"][0]["prof"], sides["replay"][0]["prof"]
    own_e, own_g = sides["eager_k_steps"][-1]["own"], sides["replay"][-1]["own"]
    agree, apart = own_g == own_e, None
    if not agree and lower_bounds:
        own_e, own_g = ({name: max(pr["own"].get(name, 0) for pr in profs)
                         for name in set().union(*(pr["own"] for pr in profs))}
                        for profs in sides.values())
        apart = sum(abs(own_g.get(n, 0) - own_e.get(n, 0)) for n in set(own_g) | set(own_e))
        agree = set(own_g) == set(own_e) and apart <= 0.01 * sum(own_e.values())
    if not agree or not own_g:
        bad.append(f"a replay's kernels {own_g} != K eager steps' {own_e}")
    for side, profs in (() if lower_bounds else sides.items()):
        ref = profs[-1]
        most_ops = max(pr["device_ops"] for pr in profs)
        for i, pr in enumerate(profs[:-1]):
            more = {n: c for n, c in pr["own"].items() if c > ref["own"].get(n, 0)}
            short = sum(ref["own"].values()) - sum(pr["own"].values())
            if more or most_ops - pr["device_ops"] < short:
                bad.append(f"{side} profile {i}: kernels {more} above the agreeing profile's, "
                           f"or {short} own kernels short with device ops "
                           f"{pr['device_ops']} against the side's most, {most_ops}")
    copies = [x["name"] for x in prof_g["all"] if "DtoH" in x["name"]]
    if copies:
        bad.append(f"a replay copies to the host: {copies}")
    summary = {
        "eager_k_steps": {key: prof_e[key] for key in ("device_ops", "device_busy_ms",
                                                        "wall_ms", "idle_share")},
        "replay": {key: prof_g[key] for key in ("device_ops", "device_busy_ms", "wall_ms",
                                                "idle_share")},
        "own_kernels_eager_k_steps": own_e, "own_kernels_replay": own_g,
        "each_profile": {side: [{"own": pr["own"], "device_ops": pr["device_ops"]}
                                for pr in profs] for side, profs in sides.items()},
        "rule": "lower bounds" if lower_bounds else "a pair that agrees",
        "records_apart": apart, "replay_host_copies": copies, "replay_top": prof_g["top"],
        "replay_nccl_kernels": [x["name"] for x in prof_g["all"]
                                if "nccl" in x["name"].lower()]}
    return summary, bad


def fused_gate(torch, ops, gen, batch, line, bad, mesh=None, lower_bounds=False):
    """The fused-step gates on K = 4 train steps of bench_train.py's step as one
    captured CUDA graph (``engine.training_steps``) at the CIFAR-10 UNet's
    full width, bf16, at ``batch`` (on ``mesh``'s engines where given): from
    one copy of the state, one replayed chunk beside four eager steps and
    beside the graph's steps run eagerly, the same replay with a zeroed
    table row failing the gate, and in float32 on the kernels against eager
    steps on the plain versions; the GroupNorm counters of the capture
    stream zero after the capture and a replay; a replay's device operations
    against four eager steps' (``profile_pair_gate``, ``lower_bounds`` its
    rule).  Results go into
    ``line``, problems into ``bad``.  Returns (the graph's engine, the eager
    engine, the captured chunk, its two input chunks, the first chunk's
    seconds and launches)."""
    from probabilisticdeepdiffusionmodels_torch.engine import DiffusionEngine
    from probabilisticdeepdiffusionmodels_torch.ops import groupnorm
    from probabilisticdeepdiffusionmodels_torch.train.step import CapturedSteps

    k = FUSED_K

    def engine(cfg=MODEL_CFG):
        e = DiffusionEngine(dict(cfg), {"lr": FUSED_LR}, ema=0.9999, device="cuda", mesh=mesh)
        fill_zero_params(torch, e.state.model, seed=50)
        e.state.ema_model.load_state_dict(e.state.model.state_dict())
        return e

    def chunks(n, b):
        return [torch.rand((k, b, RESOLUTION, RESOLUTION, 3), device="cuda",
                           generator=gen) * 2.0 - 1.0 for _ in range(n)]

    def counters_zero(chunk):
        buf = groupnorm._counters.get((torch.cuda.current_device(), chunk.stream.cuda_stream))
        torch.cuda.synchronize()
        return None if buf is None else not bool(buf.any())

    # the warm-up and capture, then one replay beside eager steps, with
    # cuDNN's deterministic algorithms: its default weight gradients (the
    # plain versions' recompute) may sum in any order, and two runs of the
    # same steps are held to FUSED_SAME_TOL
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    graph_e, eager_e, body_e, start_e = engine(), engine(), engine(), engine()
    xs = chunks(2, batch)
    ops.reset()
    t_start = time.perf_counter()
    graph_e.training_steps(xs[0])
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t_start
    first_launches = ops.counts()
    chunk = next(iter(graph_e._fused_step.graphs.values()))
    zero_after_capture = counters_zero(chunk)
    if first_launches != expected_counts(2 * k, True):
        bad.append(f"warm-up and capture launched {first_launches}, expected "
                   f"{expected_counts(2 * k, True)} (K steps run, K captured)")
    for e in (eager_e, body_e, start_e):
        copy_state(graph_e.state, e.state)
    ops.reset()
    rows_g = graph_e.training_steps(xs[1])
    replay_counts = ops.counts()
    rows_e = torch.stack([eager_e.training_step(x)["loss"] for x in xs[1]])
    rows_b = CapturedSteps(body_e._train_step, body_e.state, xs[1], capture=False)(xs[1])
    zero_after_replay = counters_zero(chunk)
    vs_eager = compare_states(torch, graph_e.state, eager_e.state)
    vs_body = compare_states(torch, graph_e.state, body_e.state)
    vs_eager["loss_rows_rel"] = _rows_rel(rows_g["loss"], rows_e)
    vs_body["loss_rows_rel"] = _rows_rel(rows_g["loss"], rows_b["loss"])
    line["bf16_replay_vs_eager"] = vs_eager
    line["bf16_replay_vs_graph_steps_eagerly"] = vs_body
    line["gn_counters_zero"] = {"after_capture": zero_after_capture,
                                "after_replay": zero_after_replay}
    del body_e
    if any(replay_counts.values()):
        bad.append(f"a replay ticked the launch counters {replay_counts}: it ran eagerly")
    if not fused_state_ok(vs_eager):
        bad.append(f"bf16 replay vs eager steps: {vs_eager}")
    if not fused_state_ok(vs_body, same=True):
        bad.append(f"bf16 replay vs the graph's steps run eagerly: {vs_body}")
    if False in (zero_after_capture, zero_after_replay):
        bad.append(f"GroupNorm counters of the capture stream: {line['gn_counters_zero']}")

    # a planted fault: the same replay from the same state, with the table
    # row of the second update zeroed (its parameter step skipped), must
    # fail the gate against the eager steps
    copy_state(start_e.state, graph_e.state)
    del start_e
    opt = graph_e.state.optimizer
    real_scalars = opt.update_scalars

    def zeroed_row(n_steps):
        rows = real_scalars(n_steps)
        rows[1] = 0.0
        return rows

    opt.update_scalars = zeroed_row
    ops.reset()
    rows_f = graph_e.training_steps(xs[1])
    del opt.update_scalars
    fault = compare_states(torch, graph_e.state, eager_e.state)
    fault["loss_rows_rel"] = _rows_rel(rows_f["loss"], rows_e)
    fault["caught"] = not fused_state_ok(fault)
    line["planted_fault_zeroed_table_row"] = fault
    if any(ops.counts().values()) or chunk.captures != 1 or not fault["caught"]:
        bad.append(f"a replay with a zeroed table row passed the gate, or did not replay: "
                   f"{fault}, launches {ops.counts()}, captures {chunk.captures}")

    # float32 on the kernels (a replay) against eager steps on the plain versions
    cfg32 = dict(MODEL_CFG, compute_dtype="float32")
    g32, p32 = engine(cfg32), engine(cfg32)
    xs32 = chunks(2, GRAD_BATCH)
    g32.training_steps(xs32[0])
    copy_state(g32.state, p32.state)
    rows_g32 = g32.training_steps(xs32[1])["loss"]
    with ops.plain_versions():
        rows_p32 = torch.stack([p32.training_step(x)["loss"] for x in xs32[1]])
    vs_plain = compare_states(torch, g32.state, p32.state)
    vs_plain["loss_rows_rel"] = _rows_rel(rows_g32, rows_p32)
    line["f32_replay_kernels_vs_eager_plain"] = dict(vs_plain, batch=GRAD_BATCH)
    if not fused_state_ok(vs_plain):
        bad.append(f"float32 replay on the kernels vs eager plain steps: {vs_plain}")
    del g32, p32
    torch.backends.cudnn.deterministic = deterministic

    # one replay's device operations against K eager steps'
    line["profile"], problems = profile_pair_gate(
        torch, lambda: [eager_e.training_step(x) for x in xs[1]],
        lambda: graph_e.training_steps(xs[1]), lower_bounds=lower_bounds)
    bad.extend(problems)
    return graph_e, eager_e, chunk, xs, first_s, first_launches


def fused_train_phase(torch, ops, gen, smi, out_dir=None):
    """K = 4 train steps of bench_train.py's step as one captured CUDA graph
    (``engine.training_steps``) at the CIFAR-10 UNet's full width, bf16,
    batch 128: (a) from one copy of the state, one replayed chunk beside
    four eager steps and beside the graph's steps run eagerly, the same
    replay with a zeroed table row failing the gate, and in float32 on the
    kernels against eager steps on the plain versions;
    the GroupNorm counters of the capture stream zero after the capture and
    a replay; (b) the device operations of one replay against four eager
    steps' from profiles, this repository's kernels exactly K times one
    step's, no copy to the host, each mode's device busy ms and idle share;
    (c) img/s in turns, each mode's peak memory, and the capture's seconds; (d)
    ``cli.train trainer.fused_steps=4 data.device_resident=true`` beside the
    plain CLI (2 epochs of 10 steps: two chunks and a short chunk of two
    single steps each), one capture in the run, and 2 + 2 steps resumed
    from its checkpoint against 4 (eager: a checkpoint written after graph
    steps holds the host counts the eager path reads).  Returns the
    launches by path."""
    import contextlib

    from probabilisticdeepdiffusionmodels_torch.cli import train as cli_train
    from probabilisticdeepdiffusionmodels_torch.config import load_config
    from probabilisticdeepdiffusionmodels_torch.engine import DiffusionEngine
    from probabilisticdeepdiffusionmodels_torch.train.checkpoint import CheckpointManager
    from probabilisticdeepdiffusionmodels_torch.train.step import CapturedSteps

    phase_start = time.perf_counter()
    k, launches, line = FUSED_K, {}, {"phase": "fused_train", "nvidia_smi": smi, "k": FUSED_K,
                                      "batch": TRAIN_BATCH}

    def chunks(n, batch):
        return [torch.rand((k, batch, RESOLUTION, RESOLUTION, 3), device="cuda",
                           generator=gen) * 2.0 - 1.0 for _ in range(n)]

    # (a) and (b)
    bad = []
    graph_e, eager_e, chunk, xs, first_s, launches["fused_train_first_chunk"] = fused_gate(
        torch, ops, gen, TRAIN_BATCH, line, bad)

    # (c) img/s in turns, each turn FUSED_CHUNKS chunks
    turns = {"eager": [], "fused": []}
    peak, reserved = {}, {}
    for mode in FUSED_TURNS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset()
        t_start = time.perf_counter()
        for c in range(FUSED_CHUNKS):
            if mode == "fused":
                graph_e.training_steps(xs[c % 2])
            else:
                for x in xs[c % 2]:
                    eager_e.training_step(x)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t_start
        want = expected_counts(k * FUSED_CHUNKS, True) if mode == "eager" else {
            n: 0 for n in ops.counts()}
        if ops.counts() != want:
            bad.append(f"{mode} turn launches {ops.counts()} != {want}")
        turns[mode].append({"img_per_s": TRAIN_BATCH * k * FUSED_CHUNKS / seconds,
                            "seconds": seconds})
        peak[mode] = max(peak.get(mode, 0), torch.cuda.max_memory_allocated())
        reserved[mode] = max(reserved.get(mode, 0), torch.cuda.max_memory_reserved())
    line["turns"] = {"order": list(FUSED_TURNS), "chunks_per_turn": FUSED_CHUNKS, **turns}
    # both engines resident; the graph's intermediates sit in its private
    # pool, reserved (not allocated) between replays
    line["max_memory_allocated_bytes"] = peak
    line["max_memory_reserved_bytes"] = reserved
    line["first_chunk_seconds"] = first_s
    line["capture_seconds"] = chunk.capture_seconds
    del eager_e

    # (c2) a replay's device work a step with the gradients captured in the
    # designs the shapes select (the graph above) and with the conv's,
    # attention's and GroupNorm's in the designs before their last
    # redesigns, by name (a second engine captured with them), each from two
    # profiles of a replay
    line["replay_by_conv_grad_design"] = replays = {}

    def replay_work(e):
        profs = [profile_device(torch, lambda: e.training_steps(xs[1])) for _ in range(2)]
        return {"device_ms_per_step": [p["device_busy_ms"] / k for p in profs],
                "idle_share": [p["idle_share"] for p in profs],
                "device_ops": max(p["device_ops"] for p in profs)}

    replays["selected"] = replay_work(graph_e)
    del graph_e, chunk
    parent_e = DiffusionEngine(dict(MODEL_CFG), {"lr": FUSED_LR}, ema=0.9999, device="cuda")
    fill_zero_params(torch, parent_e.state.model, seed=50)
    names = ("gn_silu_conv3x3_grad", "qkv_attention_grad", "group_norm_silu_grad")
    before = {n: ops.wrappers[n].launches for n in names}
    with swapped_designs(ops, parent_designs(ops)):
        parent_e.training_steps(xs[0])  # warm-up and capture
    moved = {n: ops.wrappers[n].launches - before[n] for n in names}
    if moved != {n: 2 * k * PER_BACKWARD[n] for n in names}:
        bad.append(f"the parent designs' capture counted {moved}")
    replays["parent_designs"] = replay_work(parent_e)
    del parent_e
    # (c3) and with attention's and GroupNorm's gradients captured as the
    # parent ran them (recompute by name: autograd through the plain versions)
    rc_e = DiffusionEngine(dict(MODEL_CFG), {"lr": FUSED_LR}, ema=0.9999, device="cuda")
    fill_zero_params(torch, rc_e.state.model, seed=50)
    names = ("qkv_attention_grad", "group_norm_silu_grad")
    before = {n: ops.wrappers[n].launches for n in names}
    with swapped_designs(ops, ATTN_GN_RECOMPUTE):
        rc_e.training_steps(xs[0])  # warm-up and capture
    moved = {n: ops.wrappers[n].launches - before[n] for n in names}
    if any(moved.values()):
        bad.append(f"the attention / GroupNorm recompute capture counted {moved}")
    replays["attn_gn_recompute"] = replay_work(rc_e)
    del rc_e

    # (d) the CLI with fused steps and the device-resident loader
    root = CLI_ROOT / "fused"
    base = CLI_ARGS + FUSED_CLI_ARGS + [f"out_dir={root}"]
    fused_args = [f"trainer.fused_steps={k}", "data.device_resident=true"]
    cli, run_dirs = {}, {}
    for name, extra in (("plain", []), ("fused", fused_args)):
        captures = {}
        ops.reset()
        ctx = (timing_calls(CapturedSteps, ("_warm_up_and_capture",), captures)
               if extra else contextlib.nullcontext())
        with ctx:
            result, _ = _captured(lambda: cli_train.main(base + extra + [f"run_name={name}"]))
        run_dir = run_dirs[name] = pathlib.Path(result["run_dir"])
        rows = [json.loads(r) for r in (run_dir / "metrics.jsonl").read_text().splitlines()]
        epoch_s = [r["epoch_time_s"] for r in rows if "epoch_time_s" in r]
        cli[name] = {"steps": result["steps"], "epoch_seconds": epoch_s,
                     "epoch_img_per_s": [1280 / s for s in epoch_s],
                     "best_val_loss": result["best_val_loss"],
                     "captures": len(captures.get("_warm_up_and_capture", []))}
        launches[f"cli_train_{name}_2_epochs"] = ops.counts()
    # two epochs of 10 batches: a fused epoch runs 2 chunks and 2 single
    # steps; the wrappers count the first chunk's warm-up and capture and the
    # single steps; 10 validation batches an epoch on the EMA and live weights
    counted = 2 * k + 2 * 2
    want = dict(expected_counts(counted + 2 * 2 * 10, False),
                **backward_counts(counted))
    if (cli["fused"]["captures"] != 1 or cli["fused"]["steps"] != 20
            or launches["cli_train_fused_2_epochs"] != want
            or not math.isfinite(cli["fused"]["best_val_loss"])):
        bad.append(f"cli.train fused: {cli['fused']}, launches "
                   f"{launches['cli_train_fused_2_epochs']} != {want}")

    # from the fused run's checkpoint (written after graph steps), 2 + 2
    # eager steps through a second checkpoint against 4
    cfg = load_config("default", base + fused_args + ["run_name=resume"])
    ckpt = CheckpointManager(run_dirs["fused"] / "checkpoints")
    xs4 = chunks(1, TRAIN_BATCH)[0]

    def restored(manager):
        e = cli_train.build_engine(cfg)
        manager.restore(e.state)
        return e

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    straight = restored(ckpt)
    for x in xs4:
        straight.training_step(x)
    first = restored(ckpt)
    for x in xs4[:2]:
        first.training_step(x)
    mid = CheckpointManager(root / "resume_mid")
    mid.save(first.state, first.state.step)
    del first
    resumed = restored(mid)
    for x in xs4[2:]:
        resumed.training_step(x)
    resume = compare_states(torch, resumed.state, straight.state)
    torch.backends.cudnn.deterministic = deterministic
    line["resume_2_plus_2_vs_4"] = resume
    if not fused_state_ok(resume, same=True):
        bad.append(f"2 + 2 fused steps resumed vs 4: {resume}")
    del straight, resumed
    line["cli"] = cli
    line["launches"] = launches
    line["phase_seconds"] = time.perf_counter() - phase_start
    emit(line)
    if out_dir is not None:
        (out_dir / "fused_train.json").write_text(json.dumps(line, indent=1))
    if bad:
        raise AssertionError("; ".join(bad))
    return launches


def distill_reflow_phase(torch, ops, gen, smi, run_dir, flow_run, out_dir=None):
    """Progressive distillation and reflow at the CIFAR-10 UNet's full width,
    bf16, batch 128: the distil step (from the cli run's eps teacher, T
    1000 -> 500) and the reflow step (on couplings of the evals phase's flow
    run, T = 100) beside the eps step in turns, launches asserted, each
    step's device operations and no copy to the host, the couplings'
    seconds; the float32 gradients of one distil and one reflow step on the
    kernels against the plain versions; ``cli.distill`` (one round, one
    epoch, the NLL on one batch) and ``cli.reflow`` (256 couplings) with
    their launches, each student's run read by ``cli.sample``.  Returns the
    launches by path."""
    import copy

    from probabilisticdeepdiffusionmodels_torch.cli import distill as cli_distill
    from probabilisticdeepdiffusionmodels_torch.cli import reflow as cli_reflow
    from probabilisticdeepdiffusionmodels_torch.cli import sample as cli_sample
    from probabilisticdeepdiffusionmodels_torch.core import DiffusionTables, NoiseSchedule
    from probabilisticdeepdiffusionmodels_torch.core.diffusion import q_sample
    from probabilisticdeepdiffusionmodels_torch.engine import AdamChain, DiffusionEngine
    from probabilisticdeepdiffusionmodels_torch.models import get_model
    from probabilisticdeepdiffusionmodels_torch.train import TrainState
    from probabilisticdeepdiffusionmodels_torch.train.distill import (
        halved_student,
        make_distill_step,
        teacher_eps_fn,
    )
    from probabilisticdeepdiffusionmodels_torch.train.reflow import (
        generate_couplings,
        make_reflow_step,
        reflow_student,
    )

    phase_start = time.perf_counter()
    launches, bad = {}, []
    teacher = cli_sample.load_engine_from_run(run_dir)[0]
    flow_teacher = cli_sample.load_engine_from_run(flow_run)[0]
    student, rstudent = halved_student(teacher), reflow_student(flow_teacher)
    dstep = make_distill_step(teacher_eps_fn(teacher), student.tables, teacher.tables)
    rstep = make_reflow_step(rstudent.tables, rstudent.flow)
    xb = torch.rand(TRAIN_BATCH, RESOLUTION, RESOLUTION, 3, device="cuda",
                    generator=gen) * 2.0 - 1.0

    # the couplings: 2 chains of the 50-step flow ODE at batch 128
    ops.reset()
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    z, x = generate_couplings(flow_teacher, REFLOW_COUPLINGS,
                              torch.Generator(device="cuda").manual_seed(52),
                              minibatch=TRAIN_BATCH)
    torch.cuda.synchronize()
    coupling_s = time.perf_counter() - t_start
    launches["reflow_couplings"] = ops.counts()
    want = expected_counts(REFLOW_COUPLINGS // TRAIN_BATCH * REFLOW_GEN_STEPS, False)
    if ops.counts() != want or not bool(torch.isfinite(x).all()):
        bad.append(f"couplings: launches {ops.counts()} != {want}")

    tables = DiffusionTables.from_schedule(NoiseSchedule.create(1000, "linear"), "cuda")
    m = get_model(RESOLUTION, MODEL_CFG, device="cuda", seed=0)
    eps_state = TrainState(m, AdamChain(m.parameters(), 2e-4), 1000,
                           torch.Generator(device="cuda").manual_seed(53), ema_decay=0.9999)
    eps_step = family_step("eps", tables)
    per_step = {"eps": expected_counts(1, True), "reflow": expected_counts(1, True),
                "distill": dict(expected_counts(DISTILL_FORWARDS, False), **backward_counts(1))}

    def one(kind, i=0):
        if kind == "eps":
            return eps_step(eps_state, xb)
        if kind == "distill":
            return dstep(student.state, xb)
        lo = (i % 2) * TRAIN_BATCH
        return rstep(rstudent.state, x[lo:lo + TRAIN_BATCH], z[lo:lo + TRAIN_BATCH])

    for kind in ("eps", "distill", "reflow"):
        for i in range(TRAIN_WARMUP):
            one(kind, i)
    img_per_s = {kind: [] for kind in ("eps", "distill", "reflow")}
    for kind in DR_TURNS:
        torch.cuda.synchronize()
        ops.reset()
        t_start = time.perf_counter()
        for i in range(TURN_STEPS):
            one(kind, i)
        torch.cuda.synchronize()
        img_per_s[kind].append(TRAIN_BATCH * TURN_STEPS / (time.perf_counter() - t_start))
        want = {n: TURN_STEPS * v for n, v in per_step[kind].items()}
        if ops.counts() != want:
            bad.append(f"{kind} launches {ops.counts()} != {want}")
        launches[f"round_{kind}" if kind != "eps" else "train_step_eps_dr_turns"] = ops.counts()
    profiles = {}
    for kind in ("eps", "distill", "reflow"):
        prof = profile_device(torch, lambda: one(kind))
        copies = [c["name"] for c in prof.pop("all") if "DtoH" in c["name"]]
        profiles[kind] = {"device_ops": prof["device_ops"],
                          "device_busy_ms": prof["device_busy_ms"],
                          "wall_ms": prof["wall_ms"], "host_copies": copies}
        if copies:
            bad.append(f"the {kind} step copies to the host: {copies}")
    del student, rstudent, eps_state, m

    # float32 gradients of one distil and one reflow step, kernels vs plain
    xg, zg = xb[:GRAD_BATCH].clone(), z[:GRAD_BATCH].clone()
    t_s = torch.randint(1, 501, (GRAD_BATCH,), device="cuda", generator=gen)
    t_f = torch.rand(GRAD_BATCH, device="cuda", generator=gen)
    noise = torch.randn(xg.shape, device="cuda", generator=gen)
    grads = {}
    for kind, pt in (("distill", "epsilon"), ("reflow", "flow")):
        t32 = DiffusionEngine(dict(MODEL_CFG, compute_dtype="float32"), {"lr": 2e-4},
                              prediction_type=pt, device="cuda",
                              **({"diffusion_steps": 100} if pt == "flow" else {}))
        fill_zero_params(torch, t32.state.model, seed=54)
        s32 = (halved_student if kind == "distill" else reflow_student)(t32,
                                                                         use_ema_teacher=False)
        states = [TrainState(mm, AdamChain(mm.parameters(), 2e-4), s32.diffusion_steps,
                             torch.Generator(device="cuda").manual_seed(55))
                  for mm in (copy.deepcopy(s32.state.model), copy.deepcopy(s32.state.model))]
        if kind == "distill":
            st = make_distill_step(teacher_eps_fn(t32, use_ema_teacher=False), s32.tables,
                                   t32.tables)

            def run(state):
                return st(state, xg, t=t_s, noise=noise)
        else:
            st = make_reflow_step(s32.tables, s32.flow)

            def run(state):
                return st(state, xg, zg, t=t_f)
        ops.reset()
        loss_k = float(run(states[0])["loss"])
        counts = ops.counts()
        with ops.plain_versions():
            loss_p = float(run(states[1])["loss"])
        want = per_step[kind]
        if counts != want or ops.counts() != counts:
            bad.append(f"float32 {kind} step launches {counts}, then {ops.counts()}")
        named_p = dict(states[1].model.named_parameters())
        worst, worst_name = 0.0, None
        for name, p in states[0].model.named_parameters():
            rel = _rel(p.grad, named_p[name].grad) if named_p[name].grad.any() else 0.0
            if rel >= worst:
                worst, worst_name = rel, name
        zero = [name for name, p in named_p.items() if not p.grad.any()]
        grads[kind] = {"loss_kernels": loss_k, "loss_plain": loss_p, "max_rel_err": worst,
                       "worst_param": worst_name, "all_zero_grads": zero}
        if not worst <= F32_GRAD_TOL or zero:
            bad.append(f"float32 {kind} gradients, kernels vs plain: {grads[kind]}")
        del t32, s32, states

    # cli.distill: one round, one epoch of 10 steps, the NLL at T = 500 on
    # one batch; cli.reflow: 256 couplings, one epoch of 2 steps, the NLL at
    # T = 100 on one batch; each student read by cli.sample
    root = CLI_ROOT / "distill_reflow"
    cli = {}
    n_chains = REFLOW_COUPLINGS // TRAIN_BATCH  # the couplings' chains and the steps an epoch
    half = teacher.diffusion_steps // 2  # the student's T and its NLL's forwards
    runs = {
        "cli_distill": (lambda: cli_distill.main(
            [f"run_dir={run_dir}", "epochs=1", f"out_dir={root}", "limit_test_batches=1"]),
            dict(expected_counts(DISTILL_FORWARDS * TRAIN_STEPS + half, False),
                 **backward_counts(TRAIN_STEPS))),
        "cli_reflow": (lambda: cli_reflow.main(
            [f"run_dir={flow_run}", f"n_couplings={REFLOW_COUPLINGS}",
             f"batch_size={TRAIN_BATCH}", f"minibatch_gen={TRAIN_BATCH}", "epochs=1",
             f"out_dir={root}", "limit_test_batches=1"]),
            dict(expected_counts(n_chains * REFLOW_GEN_STEPS + n_chains + ODE_EVAL_T, False),
                 **backward_counts(n_chains))),
    }
    samplers = {"cli_distill": (["sampler=ddim", "num_sample_steps=50"], 50),
                "cli_reflow": (["sampler=flow", "num_sample_steps=4"], 4)}
    for name, (fn, want) in runs.items():
        ops.reset()
        t_start = time.perf_counter()
        result, _ = _captured(fn)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t_start
        launches[name] = ops.counts()
        if name == "cli_distill":
            result = result[half]
        if ops.counts() != want or not all(math.isfinite(v) for k_, v in result.items()
                                           if k_ != "run_dir"):
            bad.append(f"{name}: launches {ops.counts()} != {want}, {result}")
        argv, n_forwards = samplers[name]
        ops.reset()
        sampled, _ = _captured(lambda: cli_sample.main(
            [f"run_dir={result['run_dir']}", "regular_viz=false"] + argv))
        launches[f"cli_sample_{name[4:]}_student"] = ops.counts()
        png = read_png(sampled["path"])
        if ops.counts() != expected_counts(n_forwards, False):
            bad.append(f"cli.sample of the {name} student: launches {ops.counts()}")
        cli[name] = {"seconds": seconds, "loss": result["loss"], "test_nll": result["test_nll"],
                     "run": pathlib.Path(result["run_dir"]).name,
                     "sample_png_shape": list(png.shape)}

    line = {"phase": "distill_reflow", "nvidia_smi": smi, "batch": TRAIN_BATCH,
            "steps_per_turn": TURN_STEPS, "warmup_steps": TRAIN_WARMUP,
            "turns": list(DR_TURNS), "img_per_s": img_per_s, "step_profiles": profiles,
            "couplings": {"n": REFLOW_COUPLINGS, "flow_steps": REFLOW_GEN_STEPS,
                          "seconds": coupling_s, "img_per_s": REFLOW_COUPLINGS / coupling_s},
            "grads_f32_vs_plain": {"batch": GRAD_BATCH, "tol": F32_GRAD_TOL, **grads},
            "cli": cli, "launches": launches,
            "phase_seconds": time.perf_counter() - phase_start}
    emit(line)
    if out_dir is not None:
        (out_dir / "distill_reflow.json").write_text(json.dumps(line, indent=1))
    if bad:
        raise AssertionError("; ".join(bad))
    return launches


# the parallel phase: the data-parallel and FSDP engines at full width
PAR_TURNS = ("plain", "dp", "fsdp", "fsdp", "dp", "plain")
PAR_F32_BATCH, PAR_F32_STEPS, PAR_F32_TOL = 8, 2, 1e-6  # one-rank NCCL vs plain, float32
PAR_GLOO_BATCH = 8          # two gloo ranks on cuda:0: the global batch, float32
PAR_GLOO_TOL = 1e-5         # of the largest parameter: 2 ranks vs one process
PAR_CHAIN_STEPS, PAR_CHAIN_TOL = 10, 1e-5  # chain steps: cut from 20
PAR_FID_IMAGES, PAR_FID_REL_TOL = 64, 1e-6
NATIVE_BATCH = 128          # the CIFAR batch the native transform is timed on
# model parallelism on the same phase
TP_F32_BATCH, TP_F32_STEPS = 8, 2      # the 1x2 tp mesh's float32 steps, global batch
TP_BF16_BATCH, TP_BF16_STEPS = 8, 2    # its bf16 steps for time and launches, after one
TP_CHAIN_STEPS = 10                    # DDIM from the tp parameters against one process
MESH4_CFG = dict(MODEL_CFG, model_channels=64, channel_mult=[1, 2], num_res_blocks=1,
                 attention_resolutions=[16], num_heads=2, compute_dtype="float32")
# config/model/unet_celebahq.yaml, the configuration JAX's spatial_sharding
# docstring names, in float32 at 256x256
SPATIAL_CFG = dict(name="unet", in_channels=3, model_channels=128, num_res_blocks=3,
                   attention_resolutions=[16, 8], channel_mult=[1, 1, 2, 2, 4, 4], num_heads=4,
                   compute_dtype="float32")
SPATIAL_RES, SPATIAL_BATCH, SPATIAL_STEPS = 256, 2, 4
SPATIAL_FWD_TOL = 1e-5      # of the largest output: the float32 forward, 2 ranks vs one
MESH_FUSED_BATCH = 32       # K = 4 fused steps on the one-rank NCCL mesh


def _engine(mesh=None, mode="replicated", cfg=None):
    """bench_train.py's engine: linear T=1000, Adam 2e-4, EMA 0.9999."""
    from probabilisticdeepdiffusionmodels_torch.engine import DiffusionEngine

    return DiffusionEngine(dict(cfg or MODEL_CFG), {"lr": 2e-4}, diffusion_steps=1000,
                           resolution=RESOLUTION, ema=0.9999, seed=0, device="cuda",
                           mesh=mesh, param_sharding=mode)


def _params(engine):
    return {k: v.detach().clone() for k, v in engine.params().state_dict().items()}


def _max_diff(a, b):
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in b)


def _gloo_ranks(rank, device):
    """Two ranks sharing one card over gloo: the DP and FSDP steps, the
    batch-sharded chain and the FID statistics of the full-width model in
    float32, each held against one process on the card (rank 0 computes
    that too); each rank's seconds."""
    import torch

    from probabilisticdeepdiffusionmodels_torch.evals.fid import (_make_feature_fn,
                                                                  compute_statistics)
    from probabilisticdeepdiffusionmodels_torch.evals.inception import random_params
    from probabilisticdeepdiffusionmodels_torch.parallel import make_mesh

    t_start = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(device="cuda")
    cfg = dict(MODEL_CFG, compute_dtype="float32")
    gen = torch.Generator().manual_seed(11)
    xs = [torch.randn(PAR_GLOO_BATCH, RESOLUTION, RESOLUTION, 3, generator=gen)
          for _ in range(2)]
    out = {"rank": rank}

    def two_steps(engine):
        for x in xs:
            engine.training_step(x)
        return _params(engine)

    ref = two_steps(_engine(cfg=cfg)) if rank == 0 else None
    for mode in ("replicated", "fsdp"):
        got = two_steps(_engine(mesh, mode, cfg))
        if rank == 0:
            scale = max(float(v.abs().max()) for v in ref.values())
            out[f"{mode}_max_abs_diff"] = _max_diff(got, ref)
            out[f"{mode}_tol"] = PAR_GLOO_TOL * scale
    del ref
    chain = _engine(mesh, cfg=cfg).generate_images(n=PAR_GLOO_BATCH, minibatch=PAR_GLOO_BATCH,
                                                   num_sample_steps=PAR_CHAIN_STEPS, seed=3)
    if rank == 0:
        one = _engine(cfg=cfg).generate_images(n=PAR_GLOO_BATCH, minibatch=PAR_GLOO_BATCH,
                                               num_sample_steps=PAR_CHAIN_STEPS, seed=3)
        out["chain_max_abs_diff"] = float(abs(chain - one).max())
        out["chain_finite"] = bool(torch.isfinite(torch.as_tensor(chain)).all())
    feat = _make_feature_fn(random_params(torch.Generator().manual_seed(0), device="cuda"))
    images = [torch.rand(PAR_FID_IMAGES // 2 + 3 * i, RESOLUTION, RESOLUTION, 3,
                         generator=gen).numpy() for i in range(2)]
    mu, cov = compute_statistics(images, feature_fn=feat, mesh=mesh)
    if rank == 0:
        mu1, cov1 = compute_statistics(images, feature_fn=feat)
        out["fid_images"] = sum(len(b) for b in images)
        out["fid_mu_rel"] = float(abs(mu - mu1).max() / abs(mu1).max())
        out["fid_cov_rel"] = float(abs(cov - cov1).max() / abs(cov1).max())
    # fused steps capture their collectives, which gloo's cannot be
    try:
        _engine(mesh, cfg=cfg).training_steps(xs[0][None].expand(2, *xs[0].shape))
        out["fused_gloo_refusal"] = None
    except RuntimeError as e:
        out["fused_gloo_refusal"] = str(e)
    seconds = [None, None]
    import torch.distributed as dist

    dist.all_gather_object(seconds, time.perf_counter() - t_start)
    out["rank_seconds"] = seconds
    return out


def chain_gain(diffusion_steps, steps):
    """The most the ancestral chain of the linear schedule respaced to
    ``steps`` moves its endpoint for a unit error of the model's output at
    every step (clipping aside): the sum over steps of each step's gain on
    eps times the later steps' gains on x_t."""
    import numpy as np

    from probabilisticdeepdiffusionmodels_torch.core.schedules import NoiseSchedule
    from probabilisticdeepdiffusionmodels_torch.sample.sampler import (respaced_schedule,
                                                                       space_timesteps)

    sched, _ = respaced_schedule(NoiseSchedule.create(diffusion_steps, "linear"),
                                 space_timesteps(diffusion_steps, steps))
    b = np.asarray(sched.betas, np.float64)
    ab = np.cumprod(1.0 - b)
    ab_prev = np.concatenate([[1.0], ab[:-1]])
    c_x0 = np.sqrt(ab_prev) * b / (1.0 - ab)
    c_xt = np.sqrt(1.0 - b) * (1.0 - ab_prev) / (1.0 - ab)
    on_eps = c_x0 * np.sqrt(1.0 - ab) / np.sqrt(ab)
    on_x = c_x0 / np.sqrt(ab) + c_xt
    return float(sum(on_eps[k] * np.prod(on_x[:k]) for k in range(len(b))))


def _tp_ranks(rank, device):
    """Two ranks sharing one card over gloo, a 1x2 data x model mesh, the
    CIFAR-10 UNet at full width under ``param_sharding="tp"``: float32 steps
    and a DDIM chain from the tp weights against one process (rank 0
    computes it); bf16 steps with their launches and each conv site's Cout
    and design; ``training_steps`` refused on a CUDA gloo mesh; then the
    spatial phase: ``unet_celebahq`` at 256x256 in float32, the height split
    over the two ranks, its forward and a respaced chain against one
    process, the halo bytes and each rank's seconds, every kernel against
    its plain version at every site, the folding consumers of the float32
    and of the bf16 forward also against their first design (``gn_fold``)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from probabilisticdeepdiffusionmodels_torch.engine import DiffusionEngine
    from probabilisticdeepdiffusionmodels_torch.models import get_model
    from probabilisticdeepdiffusionmodels_torch.parallel import make_mesh, make_mesh_2d, spatial

    t_start = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"rank": rank}
    ops = Ops()
    mesh = make_mesh_2d(1, 2, device="cuda")
    cfg32 = dict(MODEL_CFG, compute_dtype="float32")
    gen = torch.Generator().manual_seed(21)

    # float32: two steps against one process
    xs = [torch.randn(TP_F32_BATCH, RESOLUTION, RESOLUTION, 3, generator=gen)
          for _ in range(TP_F32_STEPS)]
    tp = _engine(mesh, "tp", cfg32)
    for x in xs:
        tp.training_step(x)
    got = tp.state.sync.state_dict("model")
    if rank == 0:
        one = _engine(cfg=cfg32)
        for x in xs:
            one.training_step(x)
        ref = _params(one)
        out["tp_f32_max_abs_diff"] = _max_diff(got, ref)
        out["tp_f32_tol"] = PAR_GLOO_TOL * max(float(v.abs().max()) for v in ref.values())
        del one, ref
    # DDIM from the tp layout of one set of (filled) weights
    src = _engine(cfg=cfg32)
    fill_zero_params(torch, src.state.model, seed=60)
    tp.state.sync.load_full("model", src.state.model.state_dict())
    kw = dict(n=4, minibatch=4, ddim=True, num_sample_steps=TP_CHAIN_STEPS, seed=3,
              use_ema=False)
    chain = tp.generate_images(**kw)
    if rank == 0:
        want = src.generate_images(**kw)
        out["tp_chain_max_abs_diff"] = float(abs(chain - want).max())
        # of the largest pixel: random weights leave the chain unclipped
        out["tp_chain_tol"] = PAR_CHAIN_TOL * max(1.0, float(abs(want).max()))
    del tp, src, got

    # bf16: launches, the conv's sites, time
    tpb = _engine(mesh, "tp")
    xb = torch.randn(TP_BF16_BATCH, RESOLUTION, RESOLUTION, 3, generator=gen).cuda()
    calls = {}
    with ops.recording(calls):
        tpb.training_step(xb)
    convs = [e for e in calls.values() if e["name"] == "gn_silu_conv3x3"]
    out["tp_conv_sites"] = sorted({(int(e["args"][3].shape[2]), design(ops, e["name"], e["args"]))
                                   for e in convs})
    # every kernel against its plain version at the sites of this rank's
    # step (its Cout slices), untimed
    out["tp_sites"] = hold_sites(torch, ops, calls)
    del calls, convs
    torch.cuda.synchronize()
    ops.reset()
    t0 = time.perf_counter()
    for _ in range(TP_BF16_STEPS):
        metrics = tpb.training_step(xb)
    torch.cuda.synchronize()
    out["tp_bf16_step_ms"] = (time.perf_counter() - t0) / TP_BF16_STEPS * 1e3
    out["tp_bf16_img_per_s"] = TP_BF16_BATCH / out["tp_bf16_step_ms"] * 1e3
    out["tp_bf16_launches"] = ops.counts()
    out["tp_bf16_loss_finite"] = math.isfinite(float(metrics["loss"]))
    del tpb
    torch.cuda.empty_cache()

    # spatial: unet_celebahq at 256x256, float32
    smesh = make_mesh(device="cuda")
    es = DiffusionEngine(dict(SPATIAL_CFG), {"lr": 2e-4}, diffusion_steps=1000,
                         resolution=SPATIAL_RES, seed=0, device="cuda", mesh=smesh,
                         clip_while_generating=True)
    model = es.state.model.eval()
    fill_zero_params(torch, model, seed=61)
    sgen = torch.Generator(device="cuda").manual_seed(22)
    x = torch.randn(SPATIAL_BATCH, SPATIAL_RES, SPATIAL_RES, 3, device="cuda", generator=sgen)
    t = torch.full((SPATIAL_BATCH,), 500, device="cuda")
    fwd = spatial.sharded_forward(model, smesh)
    calls = {}
    spatial.halo.sent_bytes = 0
    with ops.recording(calls):
        y = fwd(x, t)
    out["spatial_halo_bytes_per_forward"] = spatial.halo.sent_bytes
    torch.cuda.synchronize()
    ops.reset()
    t0 = time.perf_counter()
    fwd(x, t)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    out["spatial_fwd_launches"] = ops.counts()
    # every kernel against its plain version at this rank's slab sites, the
    # slab ops on both ranks at once (each sums over the two); the folding
    # consumers held and timed on rank 0 (beside gn_fold and the consumer
    # fed its (a, off), by name) for the kernels line
    out["spatial_sites"] = hold_sites(torch, ops, {k: e for k, e in calls.items()
                                                   if e["name"] not in SLAB_ONLY})
    if rank == 0:
        ops.reset()
        with torch.no_grad():
            ref = model(x, t)
        out["one_process_fwd_launches"] = ops.counts()
        out["spatial_fwd_max_abs_diff"] = float((y - ref).abs().max())
        out["spatial_fwd_tol"] = SPATIAL_FWD_TOL * float(ref.abs().max())
        del ref
        out["fold_sites"], out["fold_summary"] = [], {}
        fold_sites(torch, F, ops, calls, out["fold_sites"], out["fold_summary"], launches=5,
                   replays=2)
    del calls
    # one sharded forward's device operations and device ms, in the design
    # that folds in the consumers and in the first (gn_fold) by name; the
    # copies (the first design's clone, the gloo all-reduce's host copies)
    # counted apart
    designs = {}
    for label in ("fold_in_consumer", "gn_fold"):
        with gn_fold_slabs(ops, spatial) if label == "gn_fold" else contextlib.nullcontext():
            prof = profile_device(torch, lambda: fwd(x, t))
        copies = sum(k["calls"] for k in prof["all"] if "memcpy" in k["name"].lower())
        d = designs.setdefault(label, {"device_ops": [], "device_ops_no_copies": [],
                                       "device_busy_ms": [], "fold_kernel_calls": []})
        d["device_ops"].append(prof["device_ops"])
        d["device_ops_no_copies"].append(prof["device_ops"] - copies)
        d["device_busy_ms"].append(prof["device_busy_ms"])
        d["fold_kernel_calls"].append(sum(k["calls"] for k in prof["all"]
                                          if "gn_fold_kernel" in k["name"]))
    out["spatial_fwd_designs"] = designs
    # bf16: the sharded forward of the same weights against one process's
    model16 = get_model(SPATIAL_RES, dict(SPATIAL_CFG, compute_dtype="bfloat16"),
                        device="cuda", seed=0)
    model16.load_state_dict(model.state_dict())
    calls16 = {}
    ops.reset()
    with ops.recording(calls16):
        y16 = spatial.sharded_forward(model16, smesh)(x, t)
    out["spatial_bf16_fwd_launches"] = ops.counts()
    if rank == 0:
        with torch.no_grad():
            ref16 = model16(x, t)
        out["spatial_bf16_fwd_max_abs_diff"] = float((y16.float() - ref16.float()).abs().max())
        out["spatial_bf16_fwd_tol"] = BF16_FORWARD_TOL * max(1.0, float(ref16.float().abs().max()))
        out["spatial_bf16_fwd_finite"] = bool(torch.isfinite(y16).all())
        del ref16
        # its folding consumers (wgmma's at the convs) held and timed as the
        # float32 ones are
        out["bf16_fold_sites"], out["bf16_fold_summary"] = [], {}
        fold_sites(torch, F, ops, calls16, out["bf16_fold_sites"], out["bf16_fold_summary"],
                   timed=False, launches=5, replays=2)
    del model16, y16, calls16
    torch.cuda.synchronize()
    ops.reset()
    t0 = time.perf_counter()
    kw = dict(n=SPATIAL_BATCH, minibatch=SPATIAL_BATCH, num_sample_steps=SPATIAL_STEPS, seed=4,
              use_ema=False)
    imgs = es.generate_images(shard_mode="spatial", **kw)
    chain_s = time.perf_counter() - t0
    out["spatial_chain_launches"] = ops.counts()
    if rank == 0:
        one = DiffusionEngine(dict(SPATIAL_CFG), {"lr": 2e-4}, diffusion_steps=1000,
                              resolution=SPATIAL_RES, seed=0, device="cuda",
                              clip_while_generating=True)
        one.state.model.load_state_dict(model.state_dict())
        want = one.generate_images(**kw)
        out["spatial_chain_max_abs_diff"] = float(abs(imgs - want).max())
        out["spatial_chain_finite"] = bool(np.isfinite(imgs).all())
        # the forward's gate carried through the chain: an error e of the
        # model's output moves the endpoint by up to chain_gain * e (the
        # first of these steps divides the output by sqrt(alpha_bar_1000))
        out["spatial_chain_gain"] = chain_gain(1000, SPATIAL_STEPS)
        out["spatial_chain_tol"] = out["spatial_chain_gain"] * out["spatial_fwd_tol"]
        del one
    seconds = [None, None]
    dist.all_gather_object(seconds, {"forward": forward_s, "chain": chain_s,
                                     "rank": time.perf_counter() - t_start})
    out["rank_seconds"] = seconds
    return out


def _mesh4_ranks(rank, device):
    """Four ranks sharing one card over gloo, a 2x2 data x model mesh, a
    64-channel UNet under tp, float32: two steps of a global batch of 8
    against one process (rank 0 computes it)."""
    import torch

    from probabilisticdeepdiffusionmodels_torch.parallel import make_mesh_2d

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh_2d(2, 2, device="cuda")
    gen = torch.Generator().manual_seed(23)
    xs = [torch.randn(PAR_GLOO_BATCH, RESOLUTION, RESOLUTION, 3, generator=gen) for _ in range(2)]
    tp = _engine(mesh, "tp", MESH4_CFG)
    for x in xs:
        tp.training_step(x)
    got = tp.state.sync.state_dict("model")
    if rank != 0:
        return None
    one = _engine(cfg=MESH4_CFG)
    for x in xs:
        one.training_step(x)
    ref = _params(one)
    return {"max_abs_diff": _max_diff(got, ref),
            "tol": PAR_GLOO_TOL * max(float(v.abs().max()) for v in ref.values())}


def parallel_phase(torch, ops, smi, out_dir=None):
    """Data parallelism on the card (``parallel``): A. the plain, DP and
    FSDP engines on a one-rank NCCL group at full width (bf16, batch 128)
    in turns, img/s, launches a step, the all-reduce's CUDA-event ms, a
    profiled DP step with no copy to the host, and float32 at batch 8 against
    plain; B. two ranks sharing cuda:0 over gloo against one process; C.
    ``cli.train trainer.devices=2`` refused on a one-card machine; D. the
    native transform against numpy; E. K = 4 fused steps on the one-rank
    NCCL mesh under fused_train's gates (``fused_gate``); F. tensor parallelism and the spatial
    chain on two gloo ranks (``_tp_ranks``); G. a 2x2 mesh on four
    (``_mesh4_ranks``).  Returns the launches by path (the spatial chain's,
    the fold's included, under ``spatial_chain``) and the fold kernel's
    summary for the kernels line."""
    import numpy as np
    import torch.distributed as dist

    from probabilisticdeepdiffusionmodels_torch.cli import train as cli_train
    from probabilisticdeepdiffusionmodels_torch.data.transforms import Transform
    from probabilisticdeepdiffusionmodels_torch.parallel import make_mesh, spawn
    from probabilisticdeepdiffusionmodels_torch.parallel.runtime import free_port

    t_phase = time.perf_counter()
    line = {"phase": "parallel", "nvidia_smi": smi}
    launches = {}

    # A. one-rank NCCL, full width
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0, device_id=torch.device("cuda", 0))
    try:
        mesh = make_mesh(1, device="cuda")
        engines = {"plain": _engine(), "dp": _engine(mesh), "fsdp": _engine(mesh, "fsdp")}
        gen = torch.Generator(device="cuda").manual_seed(12)
        xb = torch.randn(TRAIN_BATCH, RESOLUTION, RESOLUTION, 3, device="cuda", generator=gen)
        expected = expected_counts(TURN_STEPS, True)
        img_s = {name: [] for name in engines}
        for name in PAR_TURNS:
            engine = engines[name]
            for _ in range(TRAIN_WARMUP):
                engine.training_step(xb)
            torch.cuda.synchronize()
            ops.reset()
            t_start = time.perf_counter()
            for _ in range(TURN_STEPS):
                metrics = engine.training_step(xb)
            torch.cuda.synchronize()
            img_s[name].append(TRAIN_BATCH * TURN_STEPS / (time.perf_counter() - t_start))
            if ops.counts() != expected:
                raise AssertionError(f"{name} step launches {ops.counts()} != {expected}")
            launches[f"{name}_step_bf16"] = ops.counts()
            if not math.isfinite(float(metrics["loss"])):
                raise AssertionError(f"{name} step loss {float(metrics['loss'])}")
        line["img_per_s"] = img_s
        line["launches_per_pass"] = launches["dp_step_bf16"]
        # the bucket one step all-reduces: every gradient and the loss
        n_params = sum(p.numel() for p in engines["dp"].state.model.parameters())
        bucket = torch.zeros(n_params + 1, device="cuda")
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        for _ in range(3):
            dist.all_reduce(bucket)
        events[0].record()
        for _ in range(10):
            dist.all_reduce(bucket)
        events[1].record()
        torch.cuda.synchronize()
        line["all_reduce"] = {"bytes": bucket.numel() * 4, "ms": events[0].elapsed_time(events[1])
                              / 10}
        prof = profile_device(torch, lambda: engines["dp"].training_step(xb), top=15)
        kernels = prof.pop("all")
        to_host = [k for k in kernels if "DtoH" in k["name"]]
        line["dp_step_profile"] = dict(prof, collective=[k for k in kernels
                                                         if "nccl" in k["name"].lower()])
        if to_host:
            raise AssertionError(f"the DP step copies to the host: {to_host}")
        del engines, bucket
        torch.cuda.empty_cache()

        # float32 at batch 8: parameters after 2 steps against plain
        torch.backends.cudnn.deterministic = True
        try:
            cfg32 = dict(MODEL_CFG, compute_dtype="float32")
            x8 = [torch.randn(PAR_F32_BATCH, RESOLUTION, RESOLUTION, 3, device="cuda",
                              generator=gen) for _ in range(PAR_F32_STEPS)]
            after = {}
            for name, engine in (("plain", _engine(cfg=cfg32)), ("dp", _engine(mesh, cfg=cfg32)),
                                 ("fsdp", _engine(mesh, "fsdp", cfg32))):
                for x in x8:
                    engine.training_step(x)
                after[name] = _params(engine)
                del engine
            line["f32_max_abs_diff"] = {name: _max_diff(after[name], after["plain"])
                                        for name in ("dp", "fsdp")}
            line["f32_tol"] = PAR_F32_TOL
            if not max(line["f32_max_abs_diff"].values()) <= PAR_F32_TOL:
                raise AssertionError(f"one-rank float32: {line['f32_max_abs_diff']}")
            del after
        finally:
            torch.backends.cudnn.deterministic = False
        # E. K = 4 fused steps on the one-rank NCCL mesh under fused_train's
        # gates, the profile's rule the weaker one of lower bounds (its
        # profiles drop records on both sides): the graph records the mesh's
        # collectives, a replay runs them (one rank's launch no collective
        # kernel, so this shows the capture, not the collectives' work)
        t_start = time.perf_counter()
        fused, bad = {"k": FUSED_K, "batch": MESH_FUSED_BATCH}, []
        held = fused_gate(torch, ops, gen, MESH_FUSED_BATCH, fused, bad, mesh=mesh,
                          lower_bounds=True)
        fused["capture_seconds"] = held[2].capture_seconds
        fused["first_chunk_seconds"], launches["fused_mesh_first_chunk"] = held[-2:]
        del held
        fused["seconds"] = time.perf_counter() - t_start
        line["fused_mesh"] = fused
        torch.cuda.empty_cache()
        if bad:
            raise AssertionError("; ".join(bad))
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    # B. two ranks on cuda:0 over gloo
    t_start = time.perf_counter()
    gloo = spawn(_gloo_ranks, 2, (), device="cuda:0", backend="gloo", join_timeout=400)
    gloo["seconds"] = time.perf_counter() - t_start
    line["gloo_2_ranks"] = gloo
    for mode in ("replicated", "fsdp"):
        if not gloo[f"{mode}_max_abs_diff"] <= gloo[f"{mode}_tol"]:
            raise AssertionError(f"2 gloo ranks, {mode}: {gloo}")
    if not (gloo["chain_max_abs_diff"] <= PAR_CHAIN_TOL and gloo["chain_finite"]
            and max(gloo["fid_mu_rel"], gloo["fid_cov_rel"]) <= PAR_FID_REL_TOL):
        raise AssertionError(f"2 gloo ranks: {gloo}")
    if "NCCL" not in (gloo["fused_gloo_refusal"] or ""):
        raise AssertionError(f"fused steps on a CUDA gloo mesh: {gloo['fused_gloo_refusal']}")

    # F. tensor parallelism and spatial sharding, two ranks on cuda:0
    t_start = time.perf_counter()
    tp = spawn(_tp_ranks, 2, (), device="cuda:0", backend="gloo", join_timeout=400)
    tp["seconds"] = time.perf_counter() - t_start
    fold_summary = tp.pop("fold_summary")
    line["model_parallel_2_ranks"] = tp
    problems = []
    for key in ("tp_f32", "tp_chain", "spatial_fwd", "spatial_chain", "spatial_bf16_fwd"):
        if not tp[f"{key}_max_abs_diff"] <= tp[f"{key}_tol"]:
            problems.append(f"{key}: {tp[f'{key}_max_abs_diff']} > {tp[f'{key}_tol']}")
    tp_counts = tp["tp_bf16_launches"]
    if tp_counts != expected_counts(TP_BF16_STEPS, True) or not tp["tp_bf16_loss_finite"]:
        problems.append(f"tp bf16 steps launched {tp_counts}")
    launches["tp_step_bf16"] = tp_counts
    halves = [d for cout, d in tp["tp_conv_sites"] if cout == MODEL_CFG["model_channels"] // 2]
    if not halves or set(halves) != {"wgmma"}:
        problems.append(f"tp conv sites (Cout, design): {tp['tp_conv_sites']}")
    # a sharded forward launches one process's moments, attention and
    # GroupNorm kernels, a folding conv for each conv (and no conv fed (a,
    # off)), one fold + apply a GroupNorm, and no gn_fold; the chain one
    # forward a step; the bf16 forward the same counts
    one = tp["one_process_fwd_launches"]
    want = dict(one, gn_silu_conv3x3=0, gn_silu_conv3x3_fold=one["gn_silu_conv3x3"],
                gn_fold_apply=one["group_norm_silu"])
    if (tp["spatial_fwd_launches"] != want
            or not all(n for k, n in one.items() if k not in PER_BACKWARD)):
        problems.append(f"a spatial forward launched {tp['spatial_fwd_launches']}, one "
                        f"process {one}, want {want}")
    if tp["spatial_bf16_fwd_launches"] != want:
        problems.append(f"a bf16 spatial forward launched {tp['spatial_bf16_fwd_launches']}")
    if not tp["spatial_bf16_fwd_finite"]:
        problems.append("the bf16 spatial forward is not finite")
    designs = tp["spatial_fwd_designs"]
    # (the profiler may drop records: the first design's count at most the
    # fold's launches, none in the design that folds in the consumers)
    if (any(designs["fold_in_consumer"]["fold_kernel_calls"])
            or not 0 < designs["gn_fold"]["fold_kernel_calls"][0] <= (
                want["gn_affine"] + want["group_norm_silu"])):
        problems.append(f"gn_fold kernels in the profiles: {designs}")
    chain_want = {k: SPATIAL_STEPS * n for k, n in want.items()}
    if not tp["spatial_chain_finite"] or tp["spatial_chain_launches"] != chain_want:
        problems.append(f"spatial chain: finite {tp['spatial_chain_finite']}, launches "
                        f"{tp['spatial_chain_launches']} != {chain_want}")
    if problems:
        raise AssertionError(f"model parallelism on 2 gloo ranks: {problems}")
    launches["spatial_chain"] = tp["spatial_chain_launches"]

    # G. a 2x2 mesh on four ranks
    t_start = time.perf_counter()
    four = spawn(_mesh4_ranks, 4, (), device="cuda:0", backend="gloo", join_timeout=300)
    four["seconds"] = time.perf_counter() - t_start
    line["mesh_2x2_4_ranks"] = four
    if not four["max_abs_diff"] <= four["tol"]:
        raise AssertionError(f"2x2 mesh on 4 gloo ranks: {four}")

    # C. more ranks than cards
    try:
        cli_train.main(CLI_ARGS + ["trainer.devices=2", f"out_dir={CLI_ROOT}_dp"])
        raise AssertionError("cli.train trainer.devices=2 ran on a one-card machine")
    except RuntimeError as e:
        line["cli_devices_2"] = str(e).splitlines()[0]
    if torch.cuda.device_count() != 1 or "CUDA devices" not in line["cli_devices_2"]:
        raise AssertionError(f"cli.train trainer.devices=2: {line['cli_devices_2']}")

    # D. the native transform against numpy on a CIFAR batch
    raw = np.random.default_rng(0).integers(0, 256, (NATIVE_BATCH, RESOLUTION, RESOLUTION, 3),
                                            dtype=np.uint8)
    tf = Transform(flip=True, crop=True, crop_size=32, crop_padding=4, normalize="cifar")
    timing = {}
    for executor, native in (("native", True), ("numpy", False), ("native", True)):
        t_start = time.perf_counter()
        for i in range(20):
            out = tf(raw, np.random.default_rng(i), use_native=native)
        timing.setdefault(executor, []).append((time.perf_counter() - t_start) / 20 * 1e3)
        if tf.executor != executor:
            raise AssertionError(f"asked for {executor}, ran {tf.executor}")
    same = np.array_equal(tf(raw, np.random.default_rng(0)).view(np.uint32),
                          tf(raw, np.random.default_rng(0), use_native=False).view(np.uint32))
    line["native_transform"] = {"batch": NATIVE_BATCH, "ms": timing, "bit_for_bit": same}
    if not same:
        raise AssertionError("the native transform differs from numpy")
    line["seconds"] = time.perf_counter() - t_phase
    emit(line)
    if out_dir is not None:
        (out_dir / "parallel.json").write_text(json.dumps(line, indent=1))
    return launches, fold_summary


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
        LINES_OUT.append(args.out / "lines.jsonl")
        LINES_OUT[0].write_text("")

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
    # the same forward through the slab path on a world of one rank (the
    # identity sum): the folding consumers at every site, held and timed
    # beside gn_fold + the consumer fed (a, off)
    slab_calls, slab_summary = {}, {}
    from probabilisticdeepdiffusionmodels_torch.parallel import spatial

    ops.reset()
    with torch.no_grad(), spatial.one_rank(), ops.recording(slab_calls):
        y_slab = model(x128, t128)
    slab_launches = ops.counts()
    with torch.no_grad():
        y_whole = model(x128, t128)
    fold_sites(torch, F, ops, slab_calls, per_site, slab_summary, timed=False)
    want_slab = dict(expected_counts(1, False), gn_silu_conv3x3=0,
                     gn_silu_conv3x3_fold=PER_FORWARD["gn_silu_conv3x3"],
                     gn_fold_apply=PER_FORWARD["group_norm_silu"])
    emit({"phase": "slab_fold_one_rank", "launches": slab_launches,
          "max_abs_diff_vs_forward": float((y_slab.float() - y_whole.float()).abs().max()),
          "tol": BF16_FORWARD_TOL * max(1.0, float(y_whole.float().abs().max())),
          "summary": slab_summary})
    if slab_launches != want_slab:
        raise AssertionError(f"one-rank slab forward launched {slab_launches} != {want_slab}")
    if not float((y_slab.float() - y_whole.float()).abs().max()) <= (
            BF16_FORWARD_TOL * max(1.0, float(y_whole.float().abs().max()))):
        raise AssertionError("one-rank slab forward: off the forward")
    del slab_calls, y_slab, y_whole
    # the float32 rows: one float32 batch-128 forward's kernels, timed
    f32_summary = f32_kernels(torch, F, ops, model, x128, t128, per_site)

    # 4. main path: 20-step sampler, bf16, batch 32, on the kernels
    sched, tmap = respaced_schedule(NoiseSchedule.create(1000, "linear"),
                                    space_timesteps(1000, STEPS))
    tables = DiffusionTables.from_schedule(sched, "cuda")
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
    # copies and casts (the UNet no longer casts its unread features, 33 a
    # forward of a bf16 model fed float32 x)
    copies = [k for k in all_kernels if "copy" in k["name"].lower()]
    prof["copy_ops"] = sum(k["calls"] for k in copies)
    prof["copy_ms"] = sum(k["ms"] for k in copies)
    # the device's idle share of the unprofiled forward: its CUDA-event time
    # against the device time the profiler summed
    prof["idle_share_unprofiled"] = 1.0 - prof["device_busy_ms"] / fwd_ms
    emit(dict(phase="forward_bf16_profile", **prof))

    # the headline metric: the 250-step bench.py chain, bf16, batch 128
    sched250, tmap250 = respaced_schedule(NoiseSchedule.create(1000, "linear"),
                                          space_timesteps(1000, BENCH_STEPS))
    tables250 = DiffusionTables.from_schedule(sched250, "cuda")
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

    # 8. the command-line entry points; 9, 10 and 12 read the first run they write
    cli_launches, cli_run = cli_phase(torch, ops, smi, train_passes, args.out)
    try:
        # 9. the FID family and the ODE likelihood
        cli_launches.update(evals_phase(torch, ops, smi, cli_run, args.out))
        # 10. consistency distillation
        cli_launches.update(consistency_distill_phase(torch, ops, gen, smi, cli_run, args.out))
        # 11. K train steps as one CUDA graph, the device-resident loader
        cli_launches.update(fused_train_phase(torch, ops, gen, smi, args.out))
        # 12. progressive distillation and reflow
        cli_launches.update(distill_reflow_phase(torch, ops, gen, smi, cli_run, FLOW_RUN,
                                                 args.out))
    finally:
        shutil.rmtree(CLI_ROOT, ignore_errors=True)

    # 13. the IDDPM configuration, its visualization and its objectives
    cli_launches.update(iddpm_phase(torch, ops, smi, args.out))

    # 14. the fast samplers, encoder reuse, guidance, inpainting, inversion
    cli_launches.update(fast_samplers_phase(torch, ops, model, gen, smi, args.out))

    # 15. the EDM, flow and consistency families
    cli_launches.update(model_families_phase(torch, ops, gen, smi, args.out))

    # 16. super-resolution, use_checkpoint, the 1-D and 3-D UNets, the dense model
    cli_launches.update(model_extras_phase(torch, F, ops, gen, smi, per_site, args.out))

    # 17. data parallelism: DP and FSDP on a one-rank NCCL group, two gloo
    # ranks on one card, the CLI's devices, the native transform
    par_launches, fold_summary = parallel_phase(torch, ops, smi, args.out)
    cli_launches.update(par_launches)
    summary.update(fold_summary)

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
    # the folding consumers run on the spatially sharded path only (the fold
    # alone, their first design, on no path: every path's gate above)
    for name in SLAB_ONLY:
        main_launches[name] = cli_launches["spatial_chain"][name]
        by_path[name] = {"spatial_chain": main_launches[name]}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
         "launches": main_launches[name], "launches_by_path": by_path[name],
         "max_abs_err": s["max_abs_err"], "ms": s["ms"],
         "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
         "bound_by": "bytes" if s["bytes_ms"] >= s["ops_ms"] else "operations",
         "library_ms": s["library_ms"],
         # without the host's launch cost, where it was measured (the probe)
         "device_ms": s.get("device_ms"), "library_device_ms": s.get("library_device_ms"),
         # the conv's gradient: the parent's path (autograd through the
         # recomputed plain version), wrapper-inclusive
         "recompute_ms": s.get("recompute_ms"),
         # the designs that ran at the sites, and each design's device-only
         # ms summed over them where both were timed by name
         "design": s.get("design"), "design_device_ms": s.get("design_device_ms"),
         # [shape, the design that ran there, calls a forward] at each site
         "site_designs": s.get("site_designs"),
         # the conv's gradient: each design's kernels by name, device-only,
         # and the library's weight and input products alone beside the
         # weight product's bound
         "design_kernel_device_ms": s.get("design_kernel_device_ms"),
         "library_weight_ms": s.get("library_weight_ms"),
         "library_input_ms": s.get("library_input_ms"),
         "wgrad_bound_ms": s.get("wgrad_bound_ms"), "dgrad_bound_ms": s.get("dgrad_bound_ms"),
         # the folding consumers: the consumer fed gn_fold's (a, off) and
         # gn_fold alone (their first design), device-only, at the same sites
         "fed_device_ms": s.get("fed_device_ms"),
         "gn_fold_device_ms": s.get("gn_fold_device_ms"),
         # the same kernel's sums over a float32 batch-128 forward's calls
         # (the shipped configs' default dtype), device-only, where it ran
         "float32": f32_summary.get(F32_ROWS.get(name, name))}
        for name, s in summary.items()]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
