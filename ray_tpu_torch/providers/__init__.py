"""Cloud node providers for the autoscaler.

The pluggable counterpart of the reference's provider tree (reference:
python/ray/autoscaler/_private/{gcp,aws,kuberay}/node_provider.py).
TPU-first, the one that matters is GCP's queued-resources API for TPU
slices: ray_tpu_torch.providers.gcp. The port's copy of
``ray_tpu/providers/__init__.py``.
"""

from ray_tpu_torch.providers.gcp import (GCPClient,
                                         TPUQueuedResourceProvider,
                                         TPUSliceAutoscaler)

__all__ = ["GCPClient", "TPUQueuedResourceProvider", "TPUSliceAutoscaler"]
