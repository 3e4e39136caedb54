from .loop import TrainConfig, Trainer, functional_loss

__all__ = ["TrainConfig", "Trainer", "functional_loss"]
