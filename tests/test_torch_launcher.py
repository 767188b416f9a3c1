"""The port's cluster launcher (``ray_tpu_torch/launcher.py``, and
``python -m ray_tpu_torch.scripts up``/``down``) held to the JAX
package's own tests.

``tests/test_launcher.py`` runs here unedited (``_torch_ported.py``,
``ray_tpu`` rewritten to ``ray_tpu_torch``), with these whole words
renamed:

    RAY_TPU_SESSION_DIR      -> RAY_TPU_TORCH_SESSION_DIR
    tests.test_provider_gcp  -> _torch_ported_test_provider_gcp

the first the port's own session directory variable
(``scripts.session_dir``), the second the port's run of
``tests/test_provider_gcp.py``, whose fake queued-resources API
(``FakeTPUApi``) the cloud-slice test imports. Nothing is left out.

``test_up_puts_the_card_on_the_worker_node`` is the port's own: how a
cluster config maps onto a GPU host, with an ``nvidia-smi`` on ``PATH``
that lists one H100 (``util/accelerators.py`` ``NvidiaGPUPlugin``).
"""

import os

import ray_tpu_torch as rt
from ray_tpu_torch import launcher

from _torch_ported import adopt, ported

ported("test_provider_gcp")     # registers _torch_ported_test_provider_gcp
adopt(ported("test_launcher", rename={
    "RAY_TPU_SESSION_DIR": "RAY_TPU_TORCH_SESSION_DIR",
    "tests.test_provider_gcp": "_torch_ported_test_provider_gcp"}),
    globals())


H100 = "NVIDIA H100 80GB HBM3"


def test_up_puts_the_card_on_the_worker_node(tmp_path, monkeypatch):
    """A head whose ``resources: {GPU: 0}`` overrides detection and a
    worker that detects the card: the cluster holds one GPU, on the
    worker, labelled with the card's name, and a task asking for it runs
    there."""
    smi = tmp_path / "bin" / "nvidia-smi"
    smi.parent.mkdir()
    smi.write_text(f"#!/bin/sh\necho '{H100}'\n")
    smi.chmod(0o755)
    monkeypatch.setenv("PATH", f"{smi.parent}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    cfg = {"cluster_name": "gpumap",
           "head": {"num_cpus": 1, "resources": {"GPU": 0}},
           "workers": [{"num_cpus": 1, "labels": {"zone": "g"}}]}
    state = launcher.up(cfg)
    try:
        head, worker = (n["node_id"] for n in state["nodes"])
        rt.init(address=state["address"], num_cpus=0)
        try:
            nodes = {n["node_id"].hex(): n for n in rt.nodes()
                     if n["alive"]}
            assert rt.cluster_resources()["GPU"] == 1.0
            assert nodes[head]["resources_total"]["GPU"] == 0
            assert nodes[worker]["resources_total"]["GPU"] == 1.0
            assert nodes[worker]["labels"]["gpu_model"] == H100
            assert nodes[worker]["labels"]["zone"] == "g"

            @rt.remote(num_gpus=1, num_cpus=0)
            def where():
                return os.environ["RAY_TPU_NODE_ID"]

            assert rt.get(where.remote(), timeout=60) == worker
        finally:
            rt.shutdown()
    finally:
        assert launcher.down(cfg) == []
