"""Long-running node process: the deploy unit behind ``ray-tpu start``.

The reference boots a head as a constellation of processes (GCS, raylet,
dashboard...) wired by its node supervisor (reference:
python/ray/_private/node.py:1359, _private/services.py:1497). Here one
process hosts the control service (head only) plus a node agent on a
single asyncio loop — the same topology `cluster_utils.Cluster` builds
in-process, promoted to a real OS process with signal-driven shutdown.

Run directly (`python -m ray_tpu_torch.node --head ...`) or, normally, via the
``ray-tpu start`` CLI which daemonizes it and records a session dir.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import sys
import uuid
from typing import Dict, Optional

from ray_tpu_torch.config import Config


def _auto_resources(num_cpus: Optional[float],
                    resources: Optional[Dict[str, float]]) -> Dict[str, float]:
    """CPU count plus every accelerator plugin's detected devices
    (reference: _private/accelerators/ manager registry feeding node
    resources — TPU first-class, NVIDIA GPUs for mixed clusters,
    vendor plugins via accelerators.register)."""
    from ray_tpu_torch.util import accelerators
    res = dict(resources or {})
    res.setdefault("CPU", float(num_cpus if num_cpus is not None
                                else (os.cpu_count() or 1)))
    for k, v in accelerators.detect_resources().items():
        res.setdefault(k, v)
    return res


def _auto_labels(labels: Optional[Dict[str, str]]) -> Dict[str, str]:
    from ray_tpu_torch.util import accelerators
    out = dict(accelerators.detect_labels())
    out.update(labels or {})
    return out


async def _amain(args) -> int:
    cfg = Config.from_env()
    if args.system_config:
        cfg.update(json.loads(args.system_config))
    if args.metrics_port is not None:
        cfg.metrics_port = args.metrics_port
    if not cfg.log_dir and args.info_file:
        # CLI-started nodes log workers beside their session record.
        cfg.log_dir = os.path.join(
            os.path.dirname(args.info_file), "logs",
            os.path.splitext(os.path.basename(args.info_file))[0])

    stop_ev = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop_ev.set)

    head = None
    if args.head:
        from ray_tpu_torch.runtime.control import ControlService
        head = ControlService(cfg)
        head_addr = await head.start(args.host, args.port)
        session_id = uuid.uuid4().hex[:16]
        await head.pool.call(head_addr, "kv_put", key="__session_id",
                             value=session_id.encode())
    else:
        host, port = args.address.rsplit(":", 1)
        head_addr = (host, int(port))
        from ray_tpu_torch.runtime import rpc
        pool = rpc.ConnectionPool()
        sid = await pool.call(head_addr, "kv_get", key="__session_id")
        await pool.close()
        if not sid:
            print(f"no cluster at {args.address}", file=sys.stderr)
            return 1
        session_id = sid.decode()

    from ray_tpu_torch.runtime.agent import NodeAgent
    agent = NodeAgent(
        head_addr,
        resources=_auto_resources(args.num_cpus,
                                  json.loads(args.resources or "{}")),
        labels=_auto_labels(json.loads(args.labels or "{}")),
        config=cfg, session_id=session_id,
        env_extra={"PYTHONPATH": os.pathsep.join(sys.path)})
    agent_addr = await agent.start(host=args.node_host)

    info = {
        "address": f"{head_addr[0]}:{head_addr[1]}",
        "node_id": agent.node_id.hex(),
        "agent_addr": f"{agent_addr[0]}:{agent_addr[1]}",
        "session_id": session_id,
        "pid": os.getpid(),
        "resources": agent.resources_total,
    }
    ma = getattr(agent, "metrics_addr", None)
    if ma is not None:
        info["metrics_addr"] = f"{ma[0]}:{ma[1]}"
    if cfg.log_dir:
        info["log_dir"] = cfg.log_dir
    if args.info_file:
        tmp = args.info_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump(info, f)
        os.replace(tmp, args.info_file)
    print("RAY_TPU_NODE_READY " + json.dumps(info), flush=True)

    await stop_ev.wait()
    # Graceful drain: tell the head this node is leaving so its objects /
    # actors are handled as a drain, not a death.
    try:
        await agent.pool.call(head_addr, "drain_node",
                              node_id=agent.node_id, timeout=5.0)
    except Exception:
        pass
    try:
        await asyncio.wait_for(agent.stop(), 15)
    except Exception:
        pass
    if head is not None:
        try:
            await asyncio.wait_for(head.stop(), 10)
        except Exception:
            pass
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ray_tpu_torch.node")
    p.add_argument("--head", action="store_true")
    p.add_argument("--address", help="head host:port (worker nodes)")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind host for the head control service "
                        "(0.0.0.0 for real multi-host)")
    p.add_argument("--node-host", default="127.0.0.1",
                   help="bind host for this node's agent/workers")
    p.add_argument("--port", type=int, default=6379)
    p.add_argument("--num-cpus", type=float, default=None)
    p.add_argument("--resources", help="JSON dict of extra resources")
    p.add_argument("--labels", help="JSON dict of node labels")
    p.add_argument("--system-config", help="JSON config overrides")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="Prometheus /metrics port (0 = ephemeral)")
    p.add_argument("--info-file", help="write node info JSON here when up")
    args = p.parse_args(argv)
    if not args.head and not args.address:
        p.error("one of --head / --address is required")
    from ray_tpu_torch.runtime.rpc import new_event_loop
    loop = new_event_loop()
    asyncio.set_event_loop(loop)
    return loop.run_until_complete(_amain(args))


if __name__ == "__main__":
    sys.exit(main())
