"""Trainers: TorchTrainer.

The port's copy of ``ray_tpu/train/trainer.py``. Reference: JaxTrainer at
train/v2/jax/jax_trainer.py:20 (SPMD JAX on TPU slices via
jax.distributed), TorchTrainer at train/v2/torch/torch_trainer.py. Here
torch is the native path: ``TorchTrainer`` is the counterpart of both the
JAX package's ``JaxTrainer`` (the controller loop over a worker group
whose train_fns drive ``make_train_step`` on their cards) and its gloo
``TorchTrainer`` (the controller sets torchrun's env itself, so the
wrapper that translated the jax.distributed env goes). The trainer wires
scaling config, gang scheduling, distributed bootstrap, the
report/checkpoint plane, and Data shards into the controller loop.
``SklearnTrainer`` waits for the port's ``data/`` (ROADMAP.md, Queue 1
item 8.5d).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.train.api import Result, RunConfig, ScalingConfig
from ray_tpu_torch.train.controller import TrainController


class BaseTrainer:
    def __init__(self, train_loop_per_worker: Callable,
                 *, train_loop_config: Optional[Dict[str, Any]] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None):
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets

    def fit(self) -> Result:
        import uuid

        import ray_tpu_torch
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        # The controller runs as a NAMED ACTOR (reference:
        # v2/api/data_parallel_trainer.py:179 launches the controller
        # actor) so training outlives driver thread churn and can be
        # monitored from elsewhere via get_controller(name). num_cpus=0:
        # it must never steal a slot from the worker gang it manages.
        run_name = self.run_config.name or f"run-{uuid.uuid4().hex[:8]}"
        # expose the (possibly generated) name so get_controller works
        # for unnamed runs too
        self.run_config.name = run_name

        def _create(actor_name):
            return ray_tpu_torch.remote(TrainController).options(
                name=actor_name, num_cpus=0,
                max_concurrency=4).remote(
                self.train_loop_per_worker,
                scaling=self.scaling_config,
                run_config=self.run_config,
                train_loop_config=self.train_loop_config,
                datasets=self.datasets)

        try:
            ctrl = _create(f"__train_ctrl_{run_name}")
        except Exception as e:
            if "taken" not in str(e):
                raise
            # concurrent run reusing the name: still run, under a
            # uniquified controller name (monitoring resolves the first)
            ctrl = _create(
                f"__train_ctrl_{run_name}-{uuid.uuid4().hex[:6]}")
        try:
            return ray_tpu_torch.get(ctrl.run.remote())
        except BaseException:
            # Interrupted (Ctrl-C / driver error): give the controller a
            # chance to tear down its worker gang + placement group —
            # there is no parent-child fate-sharing, so a hard kill here
            # would leak the whole group.
            try:
                ray_tpu_torch.get(ctrl.stop.remote(), timeout=60)
            except Exception:
                pass
            raise
        finally:
            ray_tpu_torch.kill(ctrl)


def get_controller(run_name: str):
    """Handle to a live training run's controller actor (call
    `.status.remote()` from any driver attached to the cluster)."""
    import ray_tpu_torch
    return ray_tpu_torch.get_actor(f"__train_ctrl_{run_name}")


class TorchTrainer(BaseTrainer):
    """SPMD torch training over a gang-scheduled worker group: one worker
    per host (``ScalingConfig(use_gpu=True)``: one per card), each
    running train_fn with torchrun's env set (MASTER_ADDR, MASTER_PORT,
    RANK, WORLD_SIZE, LOCAL_RANK) and, for multi-worker GPU groups or
    ``torch_distributed=True``, a joined torch.distributed world
    (reference: jax_trainer.py:20 and train/torch/config.py)."""


class SklearnTrainer(BaseTrainer):
    """Fits an sklearn estimator on a ``data`` dataset inside a train
    worker (``ray_tpu/train/trainer.py``): waits for the port's
    ``data/`` (ROADMAP.md, Queue 1 item 8.5d)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "SklearnTrainer needs the port's data/ datasets, not ported "
            "yet (ROADMAP.md, Queue 1 item 8.5d)")
