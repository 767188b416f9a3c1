"""The port's chunked ring allreduce (ray_tpu_torch/dag/ring.py
RingReducer: the header relay, reduce-scatter, allgather, int8 blocks,
peer death) held to the JAX package's own tests.

``tests/test_ring_allreduce.py`` runs here unedited
(``_torch_ported.py``), with every ``ray_tpu`` name rewritten to
``ray_tpu_torch``. No test is left out.
"""

from _torch_ported import adopt, ported

adopt(ported("test_ring_allreduce"), globals())
