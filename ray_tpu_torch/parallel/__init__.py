from ray_tpu_torch.models.llama import MeshAxes
from ray_tpu_torch.parallel.mesh import (DeviceMesh, MeshSpec, ShardAdamW,
                                         TrainState, default_optimizer, make_eval_step,
                                         make_mesh, make_train_step,
                                         numpy_template, state_from_numpy,
                                         state_to_numpy)

__all__ = ["DeviceMesh", "MeshAxes", "MeshSpec", "ShardAdamW", "TrainState",
           "default_optimizer", "make_eval_step", "make_mesh",
           "make_train_step", "numpy_template", "state_from_numpy",
           "state_to_numpy"]
