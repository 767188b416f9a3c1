"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu.

The counterpart of ``ray_tpu``'s runtime (``init``/``remote``/``get``,
actors, the shared-memory object plane, placement groups), its Llama
decoder, paged KV pool, ``LLMEngine`` with the prefill->decode handoff,
the serve plane that puts engines behind a controller, replicas, a
router and an HTTP proxy (``serve``, ``serve.llm``), ``make_train_step``
and the train library that drives it (``TorchTrainer``, async
checkpoints, the goodput ledger), compiled actor DAGs over shared-memory
rings (``dag``) and streaming datasets with batch LLM inference
(``data``, ``data.llm``), and RLlib's algorithms (``rllib``: PPO,
IMPALA/APPO, DQN, SAC, BC, multi-agent PPO) with their learners on the
card behind CPU env runners, Tune's sweeps over trials (``tune``), and
the host-only tools around them (the ``ray-tpu-torch`` CLI in
``scripts``, the ``/metrics`` endpoint and dashboard, live profiling,
postmortem bundles, job submission, the autoscaler, and the cluster
launcher with its GCP TPU slice provider in ``launcher`` and
``providers``), with hand-written
Hopper kernels in place of the Pallas TPU kernels on those paths. It imports torch and numpy, never jax
and never ``ray_tpu``. Submodules load lazily; the runtime's processes
import torch only when a task does.
"""

from ray_tpu_torch.version import __version__

# the public runtime API, as ``ray_tpu`` exports it at top level
_API = (
    "init", "shutdown", "is_initialized", "remote", "get", "put", "wait",
    "kill", "cancel", "get_actor", "method", "nodes", "cluster_resources",
    "available_resources", "timeline", "ObjectRef", "ObjectRefGenerator",
    "ActorHandle",
    "free", "get_async", "placement_group", "remove_placement_group",
    "PlacementGroup",
    "RayTpuError", "TaskError", "ActorError", "ActorDiedError",
    "WorkerCrashedError", "ObjectLostError", "GetTimeoutError",
)

_SUBMODULES = ("api", "autoscaler", "bridge", "config", "dag", "data",
               "job_submission", "llm", "models", "ops", "parallel",
               "rllib", "runtime", "serve", "train", "tune", "util")


def __getattr__(name):
    import importlib
    if name in _API:
        return getattr(importlib.import_module("ray_tpu_torch.api"), name)
    if name in _SUBMODULES:
        return importlib.import_module(f"ray_tpu_torch.{name}")
    raise AttributeError(
        f"module 'ray_tpu_torch' has no attribute {name!r}")
