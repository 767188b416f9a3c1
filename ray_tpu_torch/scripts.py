"""The session-dir protocol of the ``ray-tpu`` command line.

The part of ``ray_tpu/scripts.py`` that the port's runtime reads: where
a host records the node processes it started (``session_dir``,
``_node_files``), and the command that starts one (``_node_cmd``).
``init(address=...)`` reads these records to attach to a node started on
this host (``api._local_cli_node``). The port keeps its records under a
directory of its own (``RAY_TPU_TORCH_SESSION_DIR``, default
``<tmp>/ray_tpu_torch_sessions``), so a port driver never attaches to a
node of the JAX package on the same host, nor the other way round. The
CLI itself (``start``/``stop``/``status``/``list``) is not ported yet
(ROADMAP Queue 1 item 17).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile


def session_dir() -> str:
    return (os.environ.get("RAY_TPU_TORCH_SESSION_DIR")
            or os.path.join(tempfile.gettempdir(), "ray_tpu_torch_sessions"))


def _node_files():
    sd = session_dir()
    if not os.path.isdir(sd):
        return []
    return sorted(os.path.join(sd, f)
                  for f in os.listdir(sd) if f.endswith(".json"))


def _node_cmd(info_file: str, *, head: bool, address=None,
              host: str = "127.0.0.1", port: int = 0, node_host=None,
              num_cpus=None, resources=None, labels=None,
              system_config=None, metrics_port=None) -> list:
    cmd = [sys.executable, "-m", "ray_tpu_torch.node",
           "--info-file", info_file]
    if head:
        cmd += ["--head", "--host", host, "--port", str(port)]
    else:
        cmd += ["--address", address]
    if node_host:
        cmd += ["--node-host", node_host]
    if num_cpus is not None:
        cmd += ["--num-cpus", str(num_cpus)]
    if resources:
        cmd += ["--resources",
                resources if isinstance(resources, str)
                else json.dumps(resources)]
    if labels:
        cmd += ["--labels",
                labels if isinstance(labels, str) else json.dumps(labels)]
    if system_config:
        cmd += ["--system-config", system_config]
    if metrics_port is not None:
        cmd += ["--metrics-port", str(metrics_port)]
    return cmd
