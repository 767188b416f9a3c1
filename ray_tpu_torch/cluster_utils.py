"""Multi-node-without-a-cluster: several node agents in one process.

The reference's primary distributed-test mechanism (reference:
python/ray/cluster_utils.py:137 Cluster.add_node) — real control service,
real agents, real RPC and worker subprocesses, fake machine boundary. Each
`add_node` starts another NodeAgent with its own resources/labels on the
shared event-loop thread.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ray_tpu_torch.config import Config
from ray_tpu_torch.runtime import rpc


class Cluster:
    def __init__(self, config: Optional[Config] = None):
        self.config = config or Config.from_env()
        self.elt = rpc.EventLoopThread("ray_tpu_cluster")
        from ray_tpu_torch.runtime.control import ControlService
        self.head = ControlService(self.config)
        self.head_addr = self.elt.run(self.head.start(
            self.config.head_host, self.config.head_port))
        import uuid
        self.session_id = uuid.uuid4().hex[:16]
        self.elt.run(self._put_session())
        self.agents: List = []

    async def _put_session(self):
        await self.head.pool.call(self.head_addr, "kv_put",
                                  key="__session_id",
                                  value=self.session_id.encode())

    @property
    def address(self) -> str:
        return f"{self.head_addr[0]}:{self.head_addr[1]}"

    def add_node(self, num_cpus: float = 1,
                 resources: Optional[Dict[str, float]] = None,
                 labels: Optional[Dict[str, str]] = None):
        from ray_tpu_torch.api import _driver_pythonpath
        from ray_tpu_torch.runtime.agent import NodeAgent
        res = dict(resources or {})
        res.setdefault("CPU", float(num_cpus))
        agent = NodeAgent(self.head_addr, resources=res, labels=labels,
                          config=self.config, session_id=self.session_id,
                          env_extra={"PYTHONPATH": _driver_pythonpath()})
        self.elt.run(agent.start())
        self.agents.append(agent)
        return agent

    def restart_head(self):
        """Crash-restart the control service on the same address. With
        ``config.control_persist_dir`` set, the new instance replays the
        persisted tables and agents rejoin on their next heartbeat
        (reference: GCS restart + NotifyGCSRestart,
        gcs/store_client/redis_store_client.h:126)."""
        from ray_tpu_torch.runtime.control import ControlService
        host, port = self.head_addr
        self.elt.run(self.head.stop(), timeout=15)
        self.head = ControlService(self.config)
        self.head_addr = self.elt.run(self.head.start(host, port))
        return self.head

    def remove_node(self, agent) -> None:
        self.agents.remove(agent)
        self.elt.run(agent.stop(), timeout=15)
        self.elt.run(self.head.pool.call(
            self.head_addr, "drain_node", node_id=agent.node_id))

    def kill_node(self, agent) -> None:
        """Simulate node death: stop the agent WITHOUT telling the head —
        the health checker must notice."""
        self.agents.remove(agent)
        self.elt.run(agent.stop(), timeout=15)

    def shutdown(self) -> None:
        for agent in list(self.agents):
            try:
                self.elt.run(agent.stop(), timeout=15)
            except Exception:
                pass
        self.agents.clear()
        try:
            self.elt.run(self.head.stop(), timeout=10)
        except Exception:
            pass
        self.elt.stop()
