"""The port's checkpoint plane under chaos (SIGKILL mid-shard-write and
mid-manifest-commit leave no torn checkpoint; the SIGTERM grace window
flushes the watched save; a whole-group preemption resumes budget-free
from the grace-window checkpoint) held to the JAX package's own tests.

``tests/test_zz_ckpt_chaos.py`` runs here unedited
(``_torch_ported.py``), with ``ray_tpu`` rewritten to ``ray_tpu_torch``
and one whole word renamed from the JAX API to the port's:

    JaxTrainer -> TorchTrainer

Its subprocess victims import ``ray_tpu_torch`` from the repo root, as
the originals import ``ray_tpu``.
"""

from _torch_ported import adopt, ported

adopt(ported("test_zz_ckpt_chaos", rename={"JaxTrainer": "TorchTrainer"}),
      globals())
