"""Training: the train state, the curriculum flags, and the train / eval
steps of both phases. The checkpoint format, the epoch loop and the CLIs
are not ported yet."""

from densefusion_tpu_torch.train.state import (
    TrainState, Curriculum, create_train_state, make_optimizer,
)
from densefusion_tpu_torch.train.steps import (
    make_pose_train_step, make_refine_train_step, make_eval_step,
)

__all__ = ["TrainState", "Curriculum", "create_train_state",
           "make_optimizer", "make_pose_train_step",
           "make_refine_train_step", "make_eval_step"]
