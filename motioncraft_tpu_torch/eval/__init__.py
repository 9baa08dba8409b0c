"""Evaluation: the SMPL-X contrastive evaluator model, the evaluators of
each text-to-motion metric, the metric math, the gesture metrics
(gesture_metrics.py) and the S2G skeleton-conv embedding model
(s2g_fid.py) (PyTorch port of motioncraft_tpu/eval)."""

from . import models  # noqa: F401  (registers the two T2MContrastiveModel evaluators)
from . import s2g_fid  # noqa: F401  (registers VAESKConv)
from .evaluators import (BaseEvaluator, DiversityEvaluator, FIDEvaluator,  # noqa: F401
                         MatchingScoreEvaluator, MultiModalityEvaluator,
                         PrecisionEvaluator, build_evaluator, build_evaluator_model)
from .metrics import (calculate_activation_statistics, calculate_diversity,  # noqa: F401
                      calculate_frechet_distance, calculate_multimodality,
                      calculate_top_k, euclidean_distance_matrix,
                      get_metric_statistics)
