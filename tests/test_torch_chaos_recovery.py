"""The port's recovery from a killed head under load held to the JAX
package's own chaos test.

``tests/test_chaos_recovery.py`` runs here unedited
(``_torch_ported.py``, ``ray_tpu`` rewritten to ``ray_tpu_torch``, no
other rename).
"""

from _torch_ported import adopt, ported

adopt(ported("test_chaos_recovery"), globals())
