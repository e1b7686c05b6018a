from repro_torch.train.trainer import TrainerConfig, TrainLoop

__all__ = ["TrainerConfig", "TrainLoop"]
