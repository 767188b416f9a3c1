"""The port's ring-of-rings (dag/ring.py HierarchicalReducer), the in-situ
tuner (dag/tuner.py), bucketed gradient sync and the controller's
hierarchical wiring held to the JAX package's own tests.

``tests/test_zz_hier_collective.py`` runs here unedited
(``_torch_ported.py``), with every ``ray_tpu`` name rewritten to
``ray_tpu_torch`` and ``JaxTrainer`` renamed to ``TorchTrainer``. No
test is left out.
"""

from _torch_ported import adopt, ported

RENAME = {"JaxTrainer": "TorchTrainer"}
adopt(ported("test_zz_hier_collective", rename=RENAME), globals())
