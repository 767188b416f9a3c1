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
``SklearnTrainer`` fits an sklearn estimator on a ``data`` dataset in
one worker, as the reference's does.
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
    """Fit an sklearn estimator on a ray_tpu_torch.data dataset inside a
    train worker, with cross-validation metrics reported through the
    normal report plane and the fitted model persisted as the run's
    checkpoint (reference: train/sklearn/sklearn_trainer.py — fit on
    one remote worker, parallelize internally via joblib).

    Feature columns are taken in the DATASET's column order (minus the
    label; recorded in metrics["feature_columns"]) — build prediction
    inputs in that order. ``n_jobs`` > 1 fans cross-validation out
    over the cluster through util/joblib_backend. On multi-node
    clusters set ``run_config.storage_path`` (a shared mount or a
    memory://-style URI) so the checkpoint is readable off-worker;
    without it the model directory lives on the worker's node.

        res = SklearnTrainer(
            estimator=RandomForestClassifier(),
            datasets={"train": ds}, label_column="y").fit()
        model = pickle.load(open(os.path.join(
            res.checkpoint.as_directory(), "model.pkl"), "rb"))
    """

    def __init__(self, *, estimator, label_column: str,
                 datasets: Dict[str, Any],
                 cv: int = 0,
                 scoring: Optional[str] = None,
                 n_jobs: Optional[int] = None,
                 run_config: Optional[RunConfig] = None):
        if "train" not in (datasets or {}):
            raise ValueError("SklearnTrainer needs datasets={'train': ...}")
        est, label, cv_, scoring_, n_jobs_ = (estimator, label_column,
                                              cv, scoring, n_jobs)

        def train_fn():
            import contextlib
            import os
            import pickle
            import tempfile

            import numpy as np

            from ray_tpu_torch import train as _train
            from ray_tpu_torch.util.storage import is_remote
            ctx = _train.get_context()
            it = ctx.get_dataset_shard("train")
            Xs, ys = [], []
            cols = None
            for b in it.iter_batches(batch_size=None):
                ys.append(np.asarray(b[label]))
                if cols is None:
                    # dataset column order, NOT sorted: with 10+
                    # columns a lexicographic sort would scramble
                    # f0,f1,f10,f2... vs prediction-time inputs
                    cols = [k for k in b if k != label]
                Xs.append(np.column_stack(
                    [np.asarray(b[c]) for c in cols]))
            X, y = np.concatenate(Xs), np.concatenate(ys)
            metrics: Dict[str, Any] = {"n_samples": int(len(X)),
                                       "feature_columns": cols}
            if cv_ and cv_ > 1:
                from sklearn.model_selection import cross_val_score
                if n_jobs_ is not None and n_jobs_ != 1:
                    from joblib import parallel_backend

                    from ray_tpu_torch.util.joblib_backend import \
                        register_ray_tpu
                    register_ray_tpu()
                    backend = parallel_backend("ray_tpu_torch")
                else:
                    backend = contextlib.nullcontext()
                with backend:
                    scores = cross_val_score(est, X, y, cv=cv_,
                                             scoring=scoring_,
                                             n_jobs=n_jobs_)
                metrics["cv_mean"] = float(scores.mean())
                metrics["cv_std"] = float(scores.std())
            est.fit(X, y)
            metrics["train_score"] = float(est.score(X, y))
            sp = ctx._storage_path
            local_shared = sp and not is_remote(sp)
            if local_shared:
                os.makedirs(sp, exist_ok=True)
            d = tempfile.mkdtemp(prefix="sk_ckpt_",
                                 dir=sp if local_shared else None)
            with open(os.path.join(d, "model.pkl"), "wb") as f:
                pickle.dump(est, f)
            _train.report(metrics,
                          checkpoint=_train.Checkpoint.from_directory(d))
            if sp and is_remote(sp):
                # report() uploaded the dir and rewrote the checkpoint
                # to its storage URI — the local staging copy is dead
                import shutil
                shutil.rmtree(d, ignore_errors=True)

        super().__init__(train_fn,
                         scaling_config=ScalingConfig(num_workers=1),
                         run_config=run_config, datasets=datasets)
