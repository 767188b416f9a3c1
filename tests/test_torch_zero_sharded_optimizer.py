"""The port's ZeRO-1 ShardedOptimizer (ray_tpu_torch/train/zero.py) held to
the JAX package's own tests. They wrap optax transformations in the test
process; the port itself imports no optax.

``tests/test_zero_sharded_optimizer.py`` runs here unedited
(``_torch_ported.py``), with every ``ray_tpu`` name rewritten to
``ray_tpu_torch`` and ``JaxTrainer`` renamed to ``TorchTrainer``. No
test is left out.
"""

from _torch_ported import adopt, ported

RENAME = {"JaxTrainer": "TorchTrainer"}
adopt(ported("test_zero_sharded_optimizer", rename=RENAME), globals())
