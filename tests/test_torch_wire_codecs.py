"""The port's wire codecs (the int4/int8 blocks, the bf16 cast), error
feedback and codec="auto" (dag/ring.py, dag/tuner.py,
train/collective.py, train/zero.py) held to the JAX package's own tests.

``tests/test_zz_wire_codecs.py`` runs here unedited
(``_torch_ported.py``), with every ``ray_tpu`` name rewritten to
``ray_tpu_torch``. No test is left out.
"""

from _torch_ported import adopt, ported

adopt(ported("test_zz_wire_codecs"), globals())
