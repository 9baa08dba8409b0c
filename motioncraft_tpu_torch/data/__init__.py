"""Text-to-motion, music-to-dance and speech-to-gesture data: datasets,
pipelines, the batcher and the BEAT2 recordings (PyTorch port of
motioncraft_tpu/data; host-side numpy)."""

from . import pipelines  # noqa: F401  (registers PIPELINES)
from .datasets import (BaseMotionDataset, ConcatDataset,  # noqa: F401
                       FinedanceMotionDataset, RepeatDataset, SpeechMotionDataset,
                       TextMixMotionDataset, TextMotionDataset, beat2_pose_to_smplx322,
                       build_mixed_dataset, finedance_split, finedance_to_smplx322)
from .loader import (DataLoader, RankRows, RoundUpSampler, build_dataloader,  # noqa: F401
                     collate)
