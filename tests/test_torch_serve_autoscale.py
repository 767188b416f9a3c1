"""The port's SLO-driven replica autoscaler (``serve/autoscale.py``, fed
by the health plane's burn advice, actuated by the controller) held to
the JAX package's own tests.

``tests/test_zz_autoscale.py`` runs here unedited (``_torch_ported.py``),
with every ``ray_tpu`` name rewritten to ``ray_tpu_torch``. No other name
is renamed and no test is left out; its end-to-end walk keeps its
``slow`` mark.
"""

from _torch_ported import adopt, ported
from ray_tpu_torch.serve import api as serve_api

# The proxy binds an ephemeral port here: the JAX package's serve tests,
# which may run at the same time in another test worker, bind 8000.
serve_api.DEFAULT_HTTP_PORT = 0

adopt(ported("test_zz_autoscale"), globals())
