"""Training: the train and eval steps (and K of them as one CUDA graph), the
train state, the timestep samplers, checkpoints, and the modules that import
the engine and are not loaded here: the training loop (``train.loop``),
consistency (``train.consistency``), progressive distillation
(``train.distill``) and reflow (``train.reflow``)."""

from .checkpoint import CheckpointManager
from .samplers import (
    LossHistory,
    importance_probs,
    importance_weights,
    sample_importance,
    sample_uniform,
)
from .state import TrainState, ema_update
from .step import (
    CapturedSteps,
    global_norm,
    make_eval_step,
    make_fused_train_step,
    make_train_step,
)
