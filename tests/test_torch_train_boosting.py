"""The port's gradient-boosted trees (``train/boosting.py``: numpy on
the host, histograms over the object plane) held to the JAX package's
own tests.

``tests/test_train_boosting.py`` runs here unedited
(``_torch_ported.py``, ``ray_tpu`` rewritten to ``ray_tpu_torch``, no
other rename). Nothing is left out.
"""

from _torch_ported import adopt, ported

adopt(ported("test_train_boosting"), globals())
