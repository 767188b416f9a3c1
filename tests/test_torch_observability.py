"""The port's cluster observability (events, metrics push, state views,
the metrics HTTP endpoint) held to the JAX package's own tests.

``tests/test_observability.py`` runs here unedited
(``_torch_ported.py``, ``ray_tpu`` rewritten to ``ray_tpu_torch``, no
other rename). Nothing is left out.
"""

from _torch_ported import adopt, ported

adopt(ported("test_observability"), globals())
