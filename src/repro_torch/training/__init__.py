from repro_torch.training.train_loop import TrainConfig, TrainState, make_train_step, train_loop

__all__ = ["TrainConfig", "TrainState", "make_train_step", "train_loop"]
