"""The port's in-place elastic reshape (the controller's N-1 re-form,
``train.await_regroup``, ZeRO peer mirrors and ``ShardedOptimizer.
reshard``) under chaos, held to the JAX package's own tests.

``tests/test_zz_elastic_chaos.py`` runs here unedited
(``_torch_ported.py``), with ``ray_tpu`` rewritten to ``ray_tpu_torch``
and one whole word renamed from the JAX API to the port's:

    JaxTrainer -> TorchTrainer

Its optimizer states are optax's, which the port's ZeRO plane takes as
any numpy pytree; its slow checkpoint-restore test imports jax inside
its train_fn, which the port's workers may do in a test.
"""

from _torch_ported import adopt, ported

adopt(ported("test_zz_elastic_chaos", rename={"JaxTrainer": "TorchTrainer"}),
      globals())
