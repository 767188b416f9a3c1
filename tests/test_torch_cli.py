"""The port's command line (``ray_tpu_torch/scripts.py``, run as
``python -m ray_tpu_torch.scripts``) held to the JAX package's own
tests.

``tests/test_cli.py`` runs here through ``_torch_ported.py``
(``ray_tpu`` rewritten to ``ray_tpu_torch``) with one rename:
``RAY_TPU_SESSION_DIR`` -> ``RAY_TPU_TORCH_SESSION_DIR``, the port's own
session directory variable (``scripts.session_dir``). Nothing is left
out.
"""

from _torch_ported import adopt, ported

adopt(ported("test_cli", rename={
    "RAY_TPU_SESSION_DIR": "RAY_TPU_TORCH_SESSION_DIR"}), globals())
