"""Distributed training: SPMD worker groups on gang-scheduled slices.

The port's copy of ``ray_tpu/train/__init__.py``, exporting what the port
has: the Train-v2 analog (reference: python/ray/train/v2/ — TrainController
at v2/_internal/execution/controller/controller.py:105, WorkerGroup at
worker_group/worker_group.py:113), with ``TorchTrainer`` driving
``ray_tpu_torch.parallel.make_train_step`` in each worker, the durable
async checkpoint plane (``ckptio``), the goodput ledger, and the
host-plane collectives over the controller-wired gradient ring
(``allreduce_gradients``, ``reduce_scatter_gradients``,
``allgather_params``, ZeRO-1's ``ShardedOptimizer``), and pipeline
parallelism (``Pipeline`` over ``PipelineStageActor`` stages, its
schedules from ``compile_schedule``), and the host-only gradient-boosted
trees (``BoostingTrainer``, numpy over the object plane).
"""

from ray_tpu_torch.train.api import (Checkpoint, CheckpointConfig,
                                     FailureConfig, Result, RunConfig,
                                     ScalingConfig, await_regroup,
                                     ensure_torch_distributed, get_context,
                                     get_dataset_shard, report)
from ray_tpu_torch.train.boosting import (BoostingConfig, BoostingModel,
                                          BoostingTrainer)
from ray_tpu_torch.train.ckptio import (AsyncCheckpointer, CkptError,
                                        preempted,
                                        restore as restore_checkpoint)
from ray_tpu_torch.train.collective import (PeerLostError,
                                            allgather_params,
                                            allreduce_gradients,
                                            reduce_scatter_gradients)
from ray_tpu_torch.train.pipeline import (Pipeline, PipelineStageActor,
                                          bubble_fraction,
                                          compile_schedule)
from ray_tpu_torch.train.reshard import ReshardError
from ray_tpu_torch.train.trainer import (SklearnTrainer, TorchTrainer,
                                         get_controller)
from ray_tpu_torch.train.zero import ShardedOptimizer

__all__ = [
    "AsyncCheckpointer",
    "BoostingConfig", "BoostingModel", "BoostingTrainer",
    "Checkpoint", "CheckpointConfig", "CkptError",
    "FailureConfig", "PeerLostError",
    "Pipeline", "PipelineStageActor",
    "Result", "ReshardError",
    "RunConfig", "ScalingConfig", "ShardedOptimizer", "SklearnTrainer",
    "allgather_params", "allreduce_gradients", "await_regroup",
    "bubble_fraction", "compile_schedule",
    "ensure_torch_distributed",
    "get_context", "get_dataset_shard", "preempted",
    "reduce_scatter_gradients", "report", "restore_checkpoint",
    "TorchTrainer", "get_controller",
]
