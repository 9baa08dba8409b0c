from . import attentions  # noqa: F401  (registers STMA, EfficientSelfAttention)
from . import losses  # noqa: F401  (registers MSELoss)
from .architecture import MotionDiffusion  # noqa: F401
from .stmogen import PoseDecoder, PoseEncoder, STMoGenTransformer  # noqa: F401
from .text_encoder import ClipTextModel, TextEncoder  # noqa: F401
from .tokenizer import tokenize  # noqa: F401
