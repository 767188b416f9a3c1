"""The port's task spans and timeline (``ray_tpu_torch.timeline``) held
to the JAX package's own tracing tests.

``tests/test_tracing.py`` runs here unedited (``_torch_ported.py``,
``ray_tpu`` rewritten to ``ray_tpu_torch``, no other rename). The
file is named for task tracing because ``test_torch_tracing.py`` holds
the engine's request spans.
"""

from _torch_ported import adopt, ported

adopt(ported("test_tracing"), globals())
