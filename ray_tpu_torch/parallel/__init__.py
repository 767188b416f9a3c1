from ray_tpu_torch.parallel.mesh import (TrainState, default_optimizer,
                                         make_eval_step, make_train_step,
                                         numpy_template, state_from_numpy,
                                         state_to_numpy)

__all__ = ["TrainState", "default_optimizer", "make_eval_step",
           "make_train_step", "numpy_template", "state_from_numpy",
           "state_to_numpy"]
