from .sampler import (
    make_v_to_eps_apply_fn,
    make_x0_to_eps_apply_fn,
    p_sample_loop,
    respaced_schedule,
    space_timesteps,
)
