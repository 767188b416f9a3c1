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

Left out, each for the ROADMAP.md Queue 1 item it waits for:

- test_allreduce_gradients_rides_controller_wired_ring,
  test_allreduce_gradients_single_worker_is_identity: item 13 (the
  controller-wired gradient ring, ``allreduce_gradients``);
- test_collectives_barrier_broadcast: item 13 (``train/collective.py``
  and its rendezvous actor).
"""

from _torch_ported import adopt, ported

RENAME = {"JaxTrainer": "TorchTrainer",
          "JAX_COORDINATOR_ADDRESS": "MASTER_ADDR",
          "JAX_NUM_PROCESSES": "WORLD_SIZE",
          "JAX_PROCESS_ID": "RANK"}
SKIP = {
    "test_allreduce_gradients_rides_controller_wired_ring":
        "Queue 1 item 13: the gradient ring",
    "test_allreduce_gradients_single_worker_is_identity":
        "Queue 1 item 13: allreduce_gradients",
    "test_collectives_barrier_broadcast":
        "Queue 1 item 13: train/collective.py's rendezvous",
}

adopt(ported("test_train", rename=RENAME), globals(), skip=SKIP)
