"""The port's runtime core (ray_tpu_torch.init/remote/get/put/wait, actors,
the shared-memory object plane, placement groups, the control, agent and
worker processes) held to the JAX package's own runtime tests.

``tests/test_nested_blocking.py`` and ``tests/test_runtime_core.py`` run
here unedited, with every ``ray_tpu`` name rewritten to
``ray_tpu_torch`` (``_torch_ported.py``): each reference test is a test
of the port under this file's id. The nested-blocking tests boot and
stop their own clusters, so they come first; the core tests then share
the module-scoped ``cluster`` fixture, and so does the last test here,
which checks that no process of the port's cluster loads jax, ml_dtypes
or the JAX package.
"""

import sys

import ray_tpu_torch
from _torch_ported import adopt, ported

adopt(ported("test_nested_blocking"), globals())
adopt(ported("test_runtime_core"), globals())


def test_workers_load_no_jax_or_ray_tpu(cluster):
    """A task, an actor method and a nested task each report their
    worker's modules that belong to jax, ml_dtypes or the JAX package
    (``ray_tpu`` and ``ray_tpu.*``; ``ray_tpu_torch`` is the port):
    none. The driver here has jax loaded (the test harness imports it),
    so this also shows that nothing of the driver's modules reaches a
    worker through pickled functions."""
    assert "jax" in sys.modules     # the driver side of the claim

    def foreign():
        import sys
        return sorted(m for m in sys.modules if m.split(".")[0] in
                      ("jax", "jaxlib", "ml_dtypes", "ray_tpu"))

    @ray_tpu_torch.remote
    def task_modules():
        return foreign()

    @ray_tpu_torch.remote
    def nested_modules():
        return ray_tpu_torch.get(task_modules.remote(), timeout=60)

    @ray_tpu_torch.remote
    class Probe:
        def modules(self):
            return foreign()

    probe = Probe.remote()
    got = ray_tpu_torch.get([task_modules.remote(), nested_modules.remote(),
                             probe.modules.remote()], timeout=120)
    assert got == [[], [], []]
    ray_tpu_torch.kill(probe)
