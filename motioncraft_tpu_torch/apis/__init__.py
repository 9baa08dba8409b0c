from .factory import (PROMOTED_MODULES, bf16_cast_, flagship_m2d_cfg,  # noqa: F401
                      flagship_t2m_cfg, int8_quantize_, make_text_batch, make_train_batch,
                      tiny_t2m_cfg)
from .eval_hook import EvalHook  # noqa: F401
from .test import multi_host_test, single_device_test  # noqa: F401
from .train import make_train_step, set_random_seed, train_model  # noqa: F401
from .windowed import (denormalize, num_windows, windowed_sample,  # noqa: F401
                       windowed_sample_batch)
