"""Sampling: the ancestral loop (full, respaced, with encoder reuse), DDIM,
DPM-Solver++, Heun, RePaint inpainting and DDIM inversion over the schedule
tables; the native loops of the EDM, flow and consistency models; the eps
views of v / x0 / EDM / flow models and classifier-free guidance."""

from .sampler import (
    consistency_sample_loop,
    ddim_invert_loop,
    ddim_sample_loop,
    dpmpp_sample_loop,
    edm_sample_loop,
    flow_sample_loop,
    heun_sample_loop,
    inpaint_sample_loop,
    make_cfg_apply_fn,
    make_edm_to_eps_apply_fn,
    make_flow_to_eps_apply_fn,
    make_v_to_eps_apply_fn,
    make_x0_to_eps_apply_fn,
    p_sample_loop,
    respaced_schedule,
    space_timesteps,
)
