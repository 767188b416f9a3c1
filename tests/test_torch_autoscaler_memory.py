"""The port's autoscaler reconciler and memory monitor
(``ray_tpu_torch/autoscaler.py``, the agent's OOM killer and worker
cgroups) held to the JAX package's own tests.

``tests/test_autoscaler_memory.py`` runs here unedited
(``_torch_ported.py``, ``ray_tpu`` rewritten to ``ray_tpu_torch``), with
no other rename. Nothing is left out; ``test_cgroup_kernel_memory_cap``
skips itself, as in the JAX package's run, where the host has no
writable cgroup memory controller.
"""

from _torch_ported import adopt, ported

adopt(ported("test_autoscaler_memory"), globals())
