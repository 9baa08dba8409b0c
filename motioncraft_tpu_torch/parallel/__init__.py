from .train_state import TrainState, build_lr_schedule, build_optimizer, freeze  # noqa: F401
