"""The port's GCP TPU provider (``ray_tpu_torch/providers/gcp.py``: the
queued-resources client, the slice provider and the slice autoscaler)
held to the JAX package's own tests, and its join script's repair.

``tests/test_provider_gcp.py`` runs here unedited (``_torch_ported.py``,
``ray_tpu`` rewritten to ``ray_tpu_torch``), with no other rename.
Nothing is left out.

``test_join_script_registers_a_routable_node_host`` is the port's own:
the JAX package's join script starts its node without ``--node-host``,
so the node registers loopback with the head; the port's script passes
the host's own routable address. The test runs the script's node command
on this host against a local head and checks what the node registers.
"""

import asyncio
import ipaddress
import json
import os
import pathlib
import re
import signal
import subprocess
import sys
import time

import ray_tpu_torch as rt
from ray_tpu_torch import api, scripts
from ray_tpu_torch.providers.gcp import GCPClient, TPUQueuedResourceProvider

from _torch_ported import adopt, ported

_MOD = ported("test_provider_gcp")
adopt(_MOD, globals())

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_join_script_registers_a_routable_node_host(tmp_path):
    """The startup script of a slice created over a fake transport passes
    ``--node-host``; its node command, run here without the log
    redirection, joins a local head with the script's labels, registering
    a non-loopback address on which the node's agent answers."""
    fake = _MOD.FakeTPUApi()
    rt.init(num_cpus=1)
    proc = None
    try:
        head = "%s:%d" % api._g.ctx.head_addr
        prov = TPUQueuedResourceProvider(
            GCPClient("proj", "us-central2-b", request=fake.request), head)
        handle = asyncio.run(prov.launch(
            {"TPU": 8.0}, {"tpu_pod_type": "v5e-16", "slice_for_pg": "ab"}))
        node = fake.resources[handle]["tpu"]["node_spec"][0]["node"]
        script = node["metadata"]["startup-script"]
        assert re.search(r"--node-host \S", script), script
        labels = json.loads(re.search(r"--labels '([^']*)'", script)[1])
        assert labels["autoscaler_handle"] == handle
        # the script as a slice host runs it, but in the foreground, with
        # this interpreter, its output to the test, not to /var/log
        local = re.sub(r"\s*>>\s*\S+ 2>&1 &\s*$", "\n", script)
        local = local.replace("python3 -m", f"exec {sys.executable} -m")
        assert "2>&1 &" not in local, local
        env = dict(os.environ, PYTHONPATH=str(ROOT),
                   RAY_TPU_TORCH_SESSION_DIR=str(tmp_path))
        proc = subprocess.Popen(["bash", "-c", local], cwd=ROOT, env=env,
                                stdout=subprocess.PIPE, text=True,
                                start_new_session=True)
        info = None
        for line in proc.stdout:
            if line.startswith("RAY_TPU_NODE_READY "):
                info = json.loads(line.split(" ", 1)[1])
                break
        assert info is not None, proc.wait(timeout=30)
        host = info["agent_addr"].rsplit(":", 1)[0]
        assert not ipaddress.ip_address(host).is_loopback, host
        assert not ipaddress.ip_address(host).is_unspecified, host
        deadline = time.monotonic() + 30
        while True:
            row = next((n for n in rt.nodes()
                        if n["node_id"].hex() == info["node_id"]), None)
            if row is not None and row["alive"] or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.2)
        assert row is not None and row["alive"], row
        assert row["addr"][0] == host, row["addr"]
        assert labels.items() <= row["labels"].items(), row["labels"]
        # the head reaches the node's agent at the registered address
        assert scripts._call_head("%s:%d" % tuple(row["addr"]),
                                  "ping") is not None
    finally:
        if proc is not None:
            try:
                os.killpg(proc.pid, signal.SIGTERM)
            except ProcessLookupError:
                pass
            proc.wait(timeout=30)
        rt.shutdown()
