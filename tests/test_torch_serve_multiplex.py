"""The port's model multiplexing (``@serve.multiplexed``, the per-replica
LRU, model-affine routing) held to the JAX package's own tests.

``tests/test_serve_multiplex.py`` runs here unedited
(``_torch_ported.py``), with every ``ray_tpu`` name rewritten to
``ray_tpu_torch``. No other name is renamed and no test is left out.
"""

from _torch_ported import adopt, ported
from ray_tpu_torch.serve import api as serve_api

# The proxy binds an ephemeral port here: the JAX package's serve tests,
# which may run at the same time in another test worker, bind 8000.
serve_api.DEFAULT_HTTP_PORT = 0

adopt(ported("test_serve_multiplex"), globals())
