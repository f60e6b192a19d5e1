from .sampler import p_sample_loop, respaced_schedule, space_timesteps
