from .loop import TrainConfig, Trainer

__all__ = ["TrainConfig", "Trainer"]
