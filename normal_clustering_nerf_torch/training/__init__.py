from .trainer import Trainer  # noqa: F401
