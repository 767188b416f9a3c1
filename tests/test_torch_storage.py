"""The port's pluggable storage (``util/storage.py``) under the train
library's checkpoints and the object store's remote spill, held to the
JAX package's own tests.

``tests/test_storage.py`` runs here unedited (``_torch_ported.py``,
``ray_tpu`` rewritten to ``ray_tpu_torch``) with one rename of the JAX
API to the port's: ``JaxTrainer`` -> ``TorchTrainer`` (the trainer the
test's train_fn runs under; the train_fn itself touches no framework).
"""

from _torch_ported import adopt, ported

adopt(ported("test_storage", rename={"JaxTrainer": "TorchTrainer"}),
      globals())
