"""Training stack of the port: train-step builder (remat, grad
accumulation, compression) and the training loop with checkpoint /
restart and straggler monitoring (``repro.train``)."""
from repro_torch.train.loop import TrainLoopConfig, train_loop
from repro_torch.train.step import (
    TrainConfig,
    TrainState,
    init_train_state,
    make_train_step,
)

__all__ = ["TrainConfig", "TrainLoopConfig", "TrainState", "init_train_state",
           "make_train_step", "train_loop"]
