from .factory import flagship_t2m_cfg, make_text_batch, tiny_t2m_cfg  # noqa: F401
from .test import single_device_test  # noqa: F401
