from .gaussian import (GaussianDiffusion, build_diffusion, create_diffusion,
                       model_timesteps, p_mean_variance, predict_eps_from_xstart,
                       predict_xstart_from_eps, q_posterior_mean_variance, q_sample,
                       training_losses)
from .samplers import (LossSecondMomentResampler, UniformSampler,
                       create_named_schedule_sampler)
from .sampling import SampleResult, ddim_sample_loop, ddim_step
from .schedules import get_named_beta_schedule, space_timesteps
