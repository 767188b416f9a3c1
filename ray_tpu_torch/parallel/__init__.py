from ray_tpu_torch.parallel.mesh import (TrainState, default_optimizer,
                                         make_eval_step, make_train_step)

__all__ = ["TrainState", "default_optimizer", "make_eval_step",
           "make_train_step"]
