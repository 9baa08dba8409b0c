from .gaussian import (GaussianDiffusion, build_diffusion, create_diffusion,
                       model_timesteps, p_mean_variance, predict_eps_from_xstart,
                       predict_xstart_from_eps, q_posterior_mean_variance, q_sample,
                       training_losses, undo)
from .samplers import (LossSecondMomentResampler, UniformSampler,
                       create_named_schedule_sampler)
from .sampling import (Outpainting, RepaintConfig, Replay, SampleResult, ddim_sample_loop,
                       ddim_sample_loop_harmonize, ddim_step, generator_randn,
                       harmonize_schedule, p_sample_loop, p_sample_step)
from .schedules import get_named_beta_schedule, get_schedule_jump_cjm_ddim, space_timesteps
from .stepcache import StepCacheConfig, flags_from_errors, load_flags, pattern_flags
