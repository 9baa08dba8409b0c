from .server import MotionGenServer  # noqa: F401
