"""Training: the train state and curriculum flags, the train / eval steps of
both phases, checkpoints in the JAX package's format, the curriculum
trainer (``Trainer``) that ``cli.train`` drives, and SegNet's train state,
steps and checkpoints (``cli.train_seg``)."""

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
from densefusion_tpu_torch.train.seg import (
    SegTrainState, create_seg_train_state, load_seg_latest, load_segnet,
    make_seg_eval_step, make_seg_train_step, save_seg_latest, save_segnet,
)

__all__ = ["TrainState", "Curriculum", "GradAccum", "create_train_state",
           "make_optimizer", "make_pose_train_step",
           "make_refine_train_step", "make_eval_step",
           "REFINE_MATURITY_STEPS", "clamp_refine_iters", "load_checkpoint",
           "load_models", "load_state_dicts", "peek_config", "peek_curriculum",
           "refine_step_count", "refiner_is_trained", "save_checkpoint",
           "RestartRequested", "Trainer", "build_dataset",
           "SegTrainState", "create_seg_train_state", "load_seg_latest",
           "load_segnet", "make_seg_eval_step", "make_seg_train_step",
           "save_seg_latest", "save_segnet"]
