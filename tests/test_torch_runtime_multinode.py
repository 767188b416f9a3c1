"""The port's multi-node runtime (spillback, cross-node objects, node death,
placement groups over several agents) held to the JAX package's own
``tests/test_runtime_multinode.py``, run here unedited with every
``ray_tpu`` name rewritten to ``ray_tpu_torch`` (``_torch_ported.py``)."""

from _torch_ported import adopt, ported

adopt(ported("test_runtime_multinode"), globals())
