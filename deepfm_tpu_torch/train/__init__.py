from .optimizer import build_lr_schedule, build_optimizer, schedule_value  # noqa: F401
from .step import (TrainState, create_train_state, eval_step,  # noqa: F401
                   predict_step, sigmoid_cross_entropy, train_step)
