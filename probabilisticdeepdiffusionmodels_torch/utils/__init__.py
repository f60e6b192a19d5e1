"""Profiling helpers (``utils.profiling``)."""

from .profiling import step_timer, trace, unet_flops

__all__ = ["trace", "unet_flops", "step_timer"]
