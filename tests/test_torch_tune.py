"""The port's Tune (``ray_tpu_torch/tune/``: variants, grid/random and
TPE search, FIFO/ASHA/PBT, ``Tuner.fit``/``restore``, trainer trials)
held to the JAX package's own tests.

``tests/test_tune.py`` runs here through ``_torch_ported.py``
(``ray_tpu`` rewritten to ``ray_tpu_torch``) with one rename:
``JaxTrainer`` -> ``TorchTrainer`` (its trainer trials run the port's
trainer). Nothing is left out.
"""

from _torch_ported import adopt, ported

adopt(ported("test_tune", rename={"JaxTrainer": "TorchTrainer"}),
      globals())
