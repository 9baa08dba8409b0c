from .factory import (flagship_t2m_cfg, make_text_batch, make_train_batch,  # noqa: F401
                      tiny_t2m_cfg)
from .eval_hook import EvalHook  # noqa: F401
from .test import multi_host_test, single_device_test  # noqa: F401
from .train import make_train_step, set_random_seed, train_model  # noqa: F401
