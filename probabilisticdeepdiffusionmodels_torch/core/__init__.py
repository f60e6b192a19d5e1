"""The diffusion math: schedules, the table-driven forward and reverse
process, and the continuous-time families (``edm``, ``flow``,
``consistency``: their preconditioning, time draws and grids)."""

from .schedules import (
    NoiseSchedule,
    get_betas,
    linear_betas,
    cosine_alpha_bar,
    betas_for_alpha_bar,
    mixed_alpha_bar,
    rescale_zero_terminal_snr,
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
    v_target,
    eps_from_v,
    eps_from_xstart,
    min_snr_weight,
    model_mean_from_epsilon,
    p_step,
    learned_logvar,
    mean_flat,
    normal_kl,
    approx_standard_normal_cdf,
    discretized_gaussian_log_likelihood,
    timestep_embedding,
)
from .edm import EDMConfig, edm_denoise, karras_sigma_grid, loss_weight, precond
from .flow import TIME_SCALE, FlowConfig, flow_time_grid, interpolate, sample_t, vp_t_to_flow_t
from .consistency import ConsistencyConfig, cm_apply, cm_metric, cm_precond, pair_weight
