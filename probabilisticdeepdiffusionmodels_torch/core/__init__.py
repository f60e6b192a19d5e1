from .schedules import (
    NoiseSchedule,
    get_betas,
    linear_betas,
    cosine_alpha_bar,
    betas_for_alpha_bar,
)
from .diffusion import (
    DiffusionTables,
    gather,
    expand_to,
    expand_to_mask,
    q_mean_std,
    q_sample,
    q_posterior,
    xstart_from_epsilon,
    model_mean_from_epsilon,
    p_step,
    mean_flat,
    timestep_embedding,
)
