"""Text-to-motion data: datasets, pipelines and the batcher (PyTorch port of
motioncraft_tpu/data; host-side numpy)."""

from . import pipelines  # noqa: F401  (registers PIPELINES)
from .datasets import (BaseMotionDataset, ConcatDataset, RepeatDataset,  # noqa: F401
                       TextMotionDataset)
from .loader import DataLoader, RoundUpSampler, build_dataloader, collate  # noqa: F401
