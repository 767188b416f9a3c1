"""The port's state views (``util/state.py``) and host collective
group (``util/collective.py``) held to the JAX package's own tests.

``tests/test_state_collective.py`` runs here through
``_torch_ported.py`` (``ray_tpu`` rewritten to ``ray_tpu_torch``) with
its two shared-memory ring name prefixes renamed: ``rtgs-test`` ->
``rtgs-torch-test`` and ``rtgs-kill`` -> ``rtgs-torch-kill``. The
reference names its rings' segments with fixed prefixes, so this copy
and the reference, running at once in two test workers, would attach
each other's segments. Nothing is left out.
"""

from _torch_ported import adopt, ported

adopt(ported("test_state_collective", rename={
    "rtgs-test": "rtgs-torch-test", "rtgs-kill": "rtgs-torch-kill"}),
    globals())
