"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu.

The counterpart of ``ray_tpu``'s runtime (``init``/``remote``/``get``,
actors, the shared-memory object plane, placement groups), its Llama
decoder, paged KV pool, ``LLMEngine`` with the prefill->decode handoff,
the serve plane that puts engines behind a controller, replicas, a
router and an HTTP proxy (``serve``, ``serve.llm``), ``make_train_step``
and the train library that drives it (``TorchTrainer``, async
checkpoints, the goodput ledger), compiled actor DAGs over shared-memory
rings (``dag``) and streaming datasets with batch LLM inference
(``data``, ``data.llm``), with hand-written Hopper kernels in
place of the Pallas TPU kernels on those paths. It imports torch and numpy, never jax
and never ``ray_tpu``. Submodules load lazily; the runtime's processes
import torch only when a task does.
"""

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

_SUBMODULES = ("api", "bridge", "config", "dag", "data", "llm", "models",
               "ops", "parallel", "runtime", "serve", "train", "util")


def __getattr__(name):
    import importlib
    if name in _API:
        return getattr(importlib.import_module("ray_tpu_torch.api"), name)
    if name in _SUBMODULES:
        return importlib.import_module(f"ray_tpu_torch.{name}")
    raise AttributeError(
        f"module 'ray_tpu_torch' has no attribute {name!r}")
