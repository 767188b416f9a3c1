"""The port's forensics plane (``util/forensics.py``: the ledger, the
cross-rank audit, postmortem bundles; the train controller's stall
watchdog and worker-death audit) held to the JAX package's own tests.

``tests/test_zz_forensics.py`` runs here through ``_torch_ported.py``
(``ray_tpu`` rewritten to ``ray_tpu_torch``) with one rename:
``JaxTrainer`` -> ``TorchTrainer``. Nothing is left out. Named late in
the alphabet as its reference is, so the suite's earlier files keep
their place in the run.
"""

from _torch_ported import adopt, ported

adopt(ported("test_zz_forensics", rename={"JaxTrainer": "TorchTrainer"}),
      globals())
