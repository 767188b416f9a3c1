"""The port's standalone reduce-scatter and allgather (dag/ring.py, the
DAG's collective group, the impl resolution) held to the JAX package's
own tests.

``tests/test_zero_collective_ops.py`` runs here unedited
(``_torch_ported.py``), with every ``ray_tpu`` name rewritten to
``ray_tpu_torch``. No test is left out.
"""

from _torch_ported import adopt, ported

adopt(ported("test_zero_collective_ops"), globals())
