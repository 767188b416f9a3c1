"""The port's train library (ray_tpu_torch/train: TorchTrainer, the
controller and worker actors, report, checkpoint tracking, failure
restarts, elastic sizing) held to the JAX package's own tests.

``tests/test_train.py`` runs here unedited (``_torch_ported.py``), with
``ray_tpu`` rewritten to ``ray_tpu_torch`` and these whole words
renamed from the JAX API to the port's:

    JaxTrainer               -> TorchTrainer
    JAX_COORDINATOR_ADDRESS  -> MASTER_ADDR
    JAX_NUM_PROCESSES        -> WORLD_SIZE
    JAX_PROCESS_ID           -> RANK

"""

from _torch_ported import adopt, ported

RENAME = {"JaxTrainer": "TorchTrainer",
          "JAX_COORDINATOR_ADDRESS": "MASTER_ADDR",
          "JAX_NUM_PROCESSES": "WORLD_SIZE",
          "JAX_PROCESS_ID": "RANK"}
adopt(ported("test_train", rename=RENAME), globals())
