"""Training: the train and eval steps, the train state, the timestep
samplers, checkpoints and the training loop (``train.loop``, which imports
the engine and is not loaded here)."""

from .checkpoint import CheckpointManager
from .samplers import (
    LossHistory,
    importance_probs,
    importance_weights,
    sample_importance,
    sample_uniform,
)
from .state import TrainState, ema_update
from .step import global_norm, make_eval_step, make_train_step
