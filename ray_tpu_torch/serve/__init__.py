"""ray_tpu_torch.serve — online serving on the cluster runtime.

Capability analog of python/ray/serve (reference: serve/api.py,
_private/controller.py, _private/proxy.py, request_router/pow_2_router.py,
serve/batching.py). Deployments are replica actor groups reconciled by a
controller actor; handles route with power-of-two-choices; ``@serve.batch``
coalesces requests for batched model replicas; an asyncio HTTP proxy serves
JSON ingress. ``serve.llm`` deploys the port's ``LLMEngine``.

The port's copy of ``ray_tpu/serve``, over the port's runtime; its
processes (controller, proxy, replicas) import no device package until a
replica's class does.
"""

from ray_tpu_torch.serve.api import (Application, Deployment, delete,
                                     deployment, get_deployment_handle,
                                     proxy_address, run, shutdown, status)
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.fault import (DeadlineExceeded, ReplicaDraining,
                                       current_deadline_ts)
from ray_tpu_torch.serve.handle import DeploymentHandle
from ray_tpu_torch.serve.multiplex import (get_multiplexed_model_id,
                                           multiplexed)

__all__ = [
    "Application", "DeadlineExceeded", "Deployment", "DeploymentHandle",
    "ReplicaDraining", "batch", "current_deadline_ts", "delete",
    "deployment", "get_deployment_handle", "get_multiplexed_model_id",
    "multiplexed", "proxy_address", "run", "shutdown", "status",
]
