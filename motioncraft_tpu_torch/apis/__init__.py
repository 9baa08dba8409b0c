from .factory import (PROMOTED_MODULES, bf16_cast_, build_flagship,  # noqa: F401
                      flagship_m2d_cfg, flagship_t2m_cfg, int8_quantize_, make_text_batch, make_train_batch,
                      tiny_t2m_cfg)
from .eval_hook import EvalHook  # noqa: F401
from .test import mesh_sample, multi_host_test, single_device_test  # noqa: F401
from .train import make_train_step, set_random_seed, train_model  # noqa: F401
from .windowed import (denormalize, num_windows, windowed_sample,  # noqa: F401
                       windowed_sample_batch)
