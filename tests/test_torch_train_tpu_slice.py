"""TPU slice scheduling on the port (``util/tpu.py``'s
``slice_placement_group`` and ``TorchTrainer(use_tpu=True)`` over
simulated TPU hosts) held to the JAX package's own tests.

``tests/test_train_tpu_slice.py`` runs here unedited
(``_torch_ported.py``), with ``ray_tpu`` rewritten to ``ray_tpu_torch``
and these whole words renamed from the JAX API to the port's:

    JaxTrainer               -> TorchTrainer
    JAX_COORDINATOR_ADDRESS  -> MASTER_ADDR

Nothing is left out.
"""

from _torch_ported import adopt, ported

adopt(ported("test_train_tpu_slice", rename={
    "JaxTrainer": "TorchTrainer",
    "JAX_COORDINATOR_ADDRESS": "MASTER_ADDR"}), globals())
