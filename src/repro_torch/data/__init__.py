from .pipeline import DataConfig, SyntheticLM, global_batch_for_test

__all__ = ["DataConfig", "SyntheticLM", "global_batch_for_test"]
