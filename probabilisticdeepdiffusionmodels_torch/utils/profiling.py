"""Profiling and FLOP estimation, the counterpart of
``probabilisticdeepdiffusionmodels_tpu/utils/profiling.py``:

  * ``trace(logdir)``: ``torch.profiler`` over the host and, where a card is
    present, the device; on exit the events go to ``logdir/trace.json``, a
    Chrome trace (chrome://tracing, Perfetto);
  * ``unet_flops``: the analytic FLOP count of one 2-D UNet forward from its
    construction plan (convs and attention products), a copy of JAX's;
  * ``step_timer``: wall-clock seconds of a block, synchronising the device
    before the clock stops.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Optional, Sequence

import torch

__all__ = ["trace", "unet_flops", "step_timer"]


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; yields the ``torch.profiler.profile`` object and
    writes ``logdir/trace.json`` when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = Path(logdir)
    path.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(path / "trace.json"))


def unet_flops(
    resolution: int,
    in_channels: int,
    model_channels: int,
    num_res_blocks: int,
    attention_resolutions: Sequence[int],
    channel_mult: Sequence[int],
    num_heads: int = 1,
    learn_sigma: bool = False,
) -> int:
    """FLOPs (mul+add = 2) of one forward pass of the 2-D UNet, from its
    block plan.  attention_resolutions are image-side lengths as in configs."""
    attention_ds = [resolution // r for r in attention_resolutions]
    conv = lambda hw, cin, cout, k: 2 * hw * cin * cout * k * k
    total = 0

    def resblock(hw, cin, cout, emb):
        n = conv(hw, cin, cout, 3) + conv(hw, cout, cout, 3)
        n += 2 * emb * cout  # emb proj
        if cin != cout:
            n += conv(hw, cin, cout, 1)
        return n

    def attn(hw, c):
        # the qkv and proj products and the two attention products
        return conv(hw, c, 3 * c, 1) + conv(hw, c, c, 1) + 2 * 2 * hw * hw * c

    emb_dim = model_channels * 4
    side = resolution
    hw = side * side
    total += conv(hw, in_channels, model_channels, 3)
    ch = model_channels
    ds = 1
    chans = [model_channels]
    for level, mult in enumerate(channel_mult):
        for _ in range(num_res_blocks):
            total += resblock(hw, ch, mult * model_channels, emb_dim)
            ch = mult * model_channels
            if ds in attention_ds:
                total += attn(hw, ch)
            chans.append(ch)
        if level != len(channel_mult) - 1:
            total += conv(hw // 4, ch, ch, 3)
            chans.append(ch)
            side //= 2
            hw = side * side
            ds *= 2

    total += resblock(hw, ch, ch, emb_dim) + attn(hw, ch) + resblock(hw, ch, ch, emb_dim)

    for level, mult in list(enumerate(channel_mult))[::-1]:
        for i in range(num_res_blocks + 1):
            total += resblock(hw, ch + chans.pop(), model_channels * mult, emb_dim)
            ch = model_channels * mult
            if ds in attention_ds:
                total += attn(hw, ch)
            if level and i == num_res_blocks:
                side *= 2
                hw = side * side
                total += conv(hw, ch, ch, 3)
                ds //= 2

    out_ch = in_channels * (2 if learn_sigma else 1)
    total += conv(hw, model_channels, out_ch, 3)
    return total


class step_timer:
    """``with step_timer(result) as t: ...``; then ``t.seconds``.  On exit
    the device of ``result`` (a tensor), or the current card where there is
    one and ``result`` is None, is synchronised before the clock stops."""

    def __init__(self, result=None):
        self.result = result
        self.seconds: Optional[float] = None

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        r = self.result
        if isinstance(r, torch.Tensor):
            if r.is_cuda:
                torch.cuda.synchronize(r.device)
        elif torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self.t0
        return False
