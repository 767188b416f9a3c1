"""The port's health plane (``util/health.py``: SLO burn rates, alerts,
the proxy's shed advisory) held to the JAX package's own tests.

``tests/test_zz_health.py`` runs here unedited (``_torch_ported.py``,
``ray_tpu`` rewritten to ``ray_tpu_torch``, no other rename), with the
metrics HTTP endpoint (``metrics_port=0``), its ``_wants_json`` and the
``scripts.py`` CLI. Nothing is left out.
"""

from _torch_ported import adopt, ported

adopt(ported("test_zz_health"), globals())
