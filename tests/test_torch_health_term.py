"""The port's health plane across a SIGTERM'd head held to the JAX
package's own test.

``tests/test_zz_health_term.py`` runs here unedited
(``_torch_ported.py``, ``ray_tpu`` rewritten to ``ray_tpu_torch``, no
other rename).
"""

from _torch_ported import adopt, ported

adopt(ported("test_zz_health_term"), globals())
