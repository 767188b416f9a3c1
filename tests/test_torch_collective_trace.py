"""The port's collective tracing (dag/ring.py _RingTrace: round and chunk
spans, straggler attribution, the flight recorder) and its timeline and
state views held to the JAX package's own tests.

``tests/test_zz_collective_trace.py`` runs here unedited
(``_torch_ported.py``), with every ``ray_tpu`` name rewritten to
``ray_tpu_torch``. No test is left out.
"""

from _torch_ported import adopt, ported

adopt(ported("test_zz_collective_trace"), globals())
