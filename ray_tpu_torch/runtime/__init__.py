"""Cluster runtime: control service, node agents, workers, object plane.

The TPU-native re-design of the reference's C++ two-plane runtime
(reference: src/ray/gcs, src/ray/raylet, src/ray/core_worker — see
SURVEY.md §1): a head control service + per-host node agents + worker
processes, built for the TPU regime — few, homogeneous, gang-scheduled
hosts where XLA owns intra-slice communication — rather than for
millions of tiny heterogeneous tasks.
"""

from ray_tpu_torch.runtime.ids import ActorID, NodeID, ObjectID, TaskID
