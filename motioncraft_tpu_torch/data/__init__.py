"""Text-to-motion and music-to-dance data: datasets, pipelines and the
batcher (PyTorch port of motioncraft_tpu/data; host-side numpy)."""

from . import pipelines  # noqa: F401  (registers PIPELINES)
from .datasets import (BaseMotionDataset, ConcatDataset,  # noqa: F401
                       FinedanceMotionDataset, RepeatDataset, TextMotionDataset,
                       finedance_split, finedance_to_smplx322)
from .loader import DataLoader, RoundUpSampler, build_dataloader, collate  # noqa: F401
