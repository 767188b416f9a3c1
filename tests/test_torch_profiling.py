"""The port's live profiling (``util/profiling.py`` and its RPCs on the
worker, the agent and the head's ``profile_target``) held to the JAX
package's own tests.

``tests/test_profiling.py`` runs here unedited (``_torch_ported.py``,
``ray_tpu`` rewritten to ``ray_tpu_torch``, no other rename). Nothing is
left out.
"""

from _torch_ported import adopt, ported

adopt(ported("test_profiling"), globals())
