"""The port's reshard planner (``train/reshard.py``) held to the JAX
package's own tests.

``tests/test_zz_reshard_plan.py`` runs here unedited
(``_torch_ported.py``, ``ray_tpu`` rewritten to ``ray_tpu_torch``, no
other rename).
"""

from _torch_ported import adopt, ported

adopt(ported("test_zz_reshard_plan"), globals())
