"""The port's dashboard (``util/dashboard.py``, served by
``util/metrics.MetricsServer`` on each node's metrics port) held to the
JAX package's own test.

``tests/test_dashboard.py`` runs here unedited (``_torch_ported.py``,
``ray_tpu`` rewritten to ``ray_tpu_torch``, no other rename).
"""

from _torch_ported import adopt, ported

adopt(ported("test_dashboard"), globals())
