from .optim import AdaBelief, Adafactor, Lamb  # noqa: F401
from .optimizers import build_optimizers  # noqa: F401
from .train_state import TrainState, build_lr_schedule, build_optimizer, freeze  # noqa: F401
