from . import attentions  # noqa: F401  (registers STMA, SAMI, the Efficient and Base attentions)
from . import losses  # noqa: F401  (registers MSELoss, MSELossWithGMOF, GANLoss)
from . import vae_actor  # noqa: F401  (registers the VAEs, ACTOR and InterCLIP)
from .architecture import MotionDiffusion  # noqa: F401
from .baselines import (FineMoGenTransformer, MCMTransformer, MDMTransformer,  # noqa: F401
                        MotionDiffuseTransformer)
from .controlnet import ControlT2MBlock, ControlT2MHalf  # noqa: F401
from .stmogen import PoseDecoder, PoseEncoder, STMoGenTransformer  # noqa: F401
from .text_encoder import ClipTextModel, TextEncoder  # noqa: F401
from .tokenizer import tokenize  # noqa: F401
