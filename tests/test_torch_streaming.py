"""The port's streaming generator tasks (``num_returns="streaming"``,
``ray_tpu_torch/api.py``) held to the JAX package's own tests.

``tests/test_streaming.py`` runs here unedited (``_torch_ported.py``,
``ray_tpu`` rewritten to ``ray_tpu_torch``, no other rename); each of
its tests is a test of the port under this file's id.
"""

from _torch_ported import adopt, ported

adopt(ported("test_streaming"), globals())
