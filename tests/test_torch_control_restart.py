"""The port's control-plane restart (``runtime/persistence.py``'s
``FileStore``, ``cluster_utils.Cluster.restart_head``) held to the JAX
package's own tests.

``tests/test_control_restart.py`` runs here unedited
(``_torch_ported.py``, ``ray_tpu`` rewritten to ``ray_tpu_torch``, no
other rename).
"""

from _torch_ported import adopt, ported

adopt(ported("test_control_restart"), globals())
