"""The port's elastic GROW path (a one-worker group widened from its
latest checkpoint when capacity arrives mid-run) held to the JAX
package's own test.

``tests/test_train_elastic.py`` runs here unedited
(``_torch_ported.py``), with ``ray_tpu`` rewritten to ``ray_tpu_torch``
and one whole word renamed from the JAX API to the port's:

    JaxTrainer -> TorchTrainer
"""

from _torch_ported import adopt, ported

adopt(ported("test_train_elastic", rename={"JaxTrainer": "TorchTrainer"}),
      globals())
