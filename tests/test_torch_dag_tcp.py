"""The port's cross-node compiled-DAG channels (ray_tpu_torch.dag's
TcpChannel edges and same-remote-node lazy shm rings) held to the JAX
package's own tests.

``tests/test_dag_tcp.py`` runs here unedited (``_torch_ported.py``), with
every ``ray_tpu`` name rewritten to ``ray_tpu_torch``.
"""

from _torch_ported import adopt, ported

adopt(ported("test_dag_tcp"), globals())
