"""Training: the train state and curriculum flags, the train / eval steps of
both phases, checkpoints in the JAX package's format, and the curriculum
trainer (``Trainer``) that ``cli.train`` drives."""

from densefusion_tpu_torch.train.state import (
    TrainState, Curriculum, GradAccum, create_train_state, make_optimizer,
)
from densefusion_tpu_torch.train.steps import (
    make_pose_train_step, make_refine_train_step, make_eval_step,
)
from densefusion_tpu_torch.train.checkpoint import (
    REFINE_MATURITY_STEPS, clamp_refine_iters, load_checkpoint,
    load_models, load_state_dicts, peek_config, peek_curriculum, refine_step_count,
    refiner_is_trained, save_checkpoint,
)
from densefusion_tpu_torch.train.loop import (
    RestartRequested, Trainer, build_dataset,
)

__all__ = ["TrainState", "Curriculum", "GradAccum", "create_train_state",
           "make_optimizer", "make_pose_train_step",
           "make_refine_train_step", "make_eval_step",
           "REFINE_MATURITY_STEPS", "clamp_refine_iters", "load_checkpoint",
           "load_models", "load_state_dicts", "peek_config", "peek_curriculum",
           "refine_step_count", "refiner_is_trained", "save_checkpoint",
           "RestartRequested", "Trainer", "build_dataset"]
