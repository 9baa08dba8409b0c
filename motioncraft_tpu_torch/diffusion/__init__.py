from .gaussian import (GaussianDiffusion, build_diffusion, create_diffusion,
                       model_timesteps, p_mean_variance, predict_eps_from_xstart,
                       predict_xstart_from_eps, q_posterior_mean_variance)
from .sampling import SampleResult, ddim_sample_loop, ddim_step
from .schedules import get_named_beta_schedule, space_timesteps
