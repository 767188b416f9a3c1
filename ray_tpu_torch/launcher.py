"""One-command cluster bring-up: ``ray-tpu-torch up cluster.yaml``.

The analog of the reference's ``ray up`` (reference:
python/ray/autoscaler/_private/commands.py create_or_update_cluster):
one YAML describes the head, optional extra LOCAL nodes (dev boxes,
simulation), and optional CLOUD TPU slices; ``up`` boots the head,
joins the local nodes, and creates the slices with join startup
scripts; ``down`` deletes the slices and stops the local processes.

YAML shape::

    cluster_name: demo
    head:
      port: 6379            # optional (0 = ephemeral)
      num_cpus: 8           # optional resource overrides
      resources: {widget: 2}
      labels: {role: head}
    workers:                # optional local nodes joined to the head
      - num_cpus: 4
        labels: {zone: a}
    provider:               # optional TPU slices via queued resources
      type: gcp
      project: my-proj
      zone: us-central2-b
      pod_type: v5e-16
      slices: 2
      runtime_version: v2-alpha-tpuv5-lite

Cluster state (head address, node pids, slice handles) persists in the
session dir so ``down`` can find everything without the cloud being
queried first.

The port's copy of ``ray_tpu/launcher.py``: import paths change, and
the state lives in the port's session dir (``scripts.session_dir``,
``RAY_TPU_TORCH_SESSION_DIR``). On a GPU host the YAML passes through
unchanged: a node's ``resources`` override what it detects
(``node._auto_resources`` only sets a key the YAML left out), so
``resources: {GPU: 0}`` keeps the cards off the head, and a node that
does not override detects them through ``util/accelerators.py``'s
``NvidiaGPUPlugin`` (``GPU: <count>`` and the label ``gpu_model``), as
``ray-tpu-torch start`` does.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional


def _session_dir() -> str:
    from ray_tpu_torch.scripts import session_dir
    return session_dir()


def _state_path(name: str) -> str:
    return os.path.join(_session_dir(), f"cluster-{name}.json")


def load_config(path: str) -> dict:
    import yaml
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    if not isinstance(cfg, dict):
        raise ValueError(f"{path}: cluster config must be a mapping")
    cfg.setdefault("cluster_name", "default")
    return cfg




def _slice_provider(cfg: dict, head_address: str, gcp_client=None):
    from ray_tpu_torch.providers.gcp import (GCPClient,
                                             TPUQueuedResourceProvider)
    prov = cfg.get("provider") or {}
    if prov.get("type") != "gcp":
        raise ValueError(f"unknown provider type {prov.get('type')!r}")
    client = gcp_client or GCPClient(prov["project"], prov["zone"])
    return TPUQueuedResourceProvider(
        client, head_address,
        runtime_version=prov.get("runtime_version",
                                 "v2-alpha-tpuv5-lite"),
        default_pod_type=prov.get("pod_type", "v5e-8"),
        name_prefix=cfg.get("cluster_name", "ray-tpu"))


def up(cfg: dict, *, gcp_client=None) -> dict:
    """Boot the cluster described by ``cfg``; idempotent-ish: an
    existing state file for the name is an error (run ``down`` first).
    Returns the recorded state."""
    name = cfg["cluster_name"]
    sp = _state_path(name)
    if os.path.exists(sp):
        raise RuntimeError(
            f"cluster {name!r} already has state at {sp}; "
            "run `ray-tpu-torch down` first")
    from ray_tpu_torch.scripts import start_node
    head_cfg = cfg.get("head") or {}
    # Cloud slices must reach the head over the network: with a
    # provider section, loopback can't be the bind host.
    host = head_cfg.get("host", "127.0.0.1")
    if cfg.get("provider") and not head_cfg.get("host"):
        host = _routable_host()
    head = start_node(
        head=True, host=host, port=int(head_cfg.get("port", 0)),
        num_cpus=head_cfg.get("num_cpus"),
        resources=head_cfg.get("resources"),
        labels=head_cfg.get("labels"))
    state = {"cluster_name": name, "address": head["address"],
             "nodes": [head], "slice_handles": []}
    try:
        for w in cfg.get("workers") or []:
            state["nodes"].append(start_node(
                head=False, address=head["address"],
                num_cpus=w.get("num_cpus"),
                resources=w.get("resources"),
                labels=w.get("labels")))
        if cfg.get("provider"):
            provider = _slice_provider(cfg, head["address"], gcp_client)
            n_slices = int((cfg.get("provider") or {}).get("slices", 1))
            import asyncio
            for i in range(n_slices):
                handle = asyncio.run(provider.launch(
                    {}, {"slice_index": str(i)}))
                state["slice_handles"].append(handle)
    except BaseException as boot_err:
        # partial bring-up must not leak processes/slices; anything the
        # rollback could NOT clean (a slice whose delete failed) is
        # persisted so a later `down` can retry with its handle
        errors = _teardown(state, cfg, gcp_client=gcp_client)
        if state.get("slice_handles"):
            state["nodes"] = []
            os.makedirs(_session_dir(), exist_ok=True)
            with open(sp, "w") as f:
                json.dump(state, f, indent=2)
        if errors:
            raise RuntimeError(
                f"cluster bring-up failed ({boot_err}); rollback left: "
                + "; ".join(errors)) from boot_err
        raise
    os.makedirs(_session_dir(), exist_ok=True)
    with open(sp, "w") as f:
        json.dump(state, f, indent=2)
    return state


def _routable_host() -> str:
    """A non-loopback address cloud slices can dial. gethostname
    resolution is NOT enough (Debian maps it to 127.0.1.1); the
    UDP-connect trick reads the address of the default route. No
    routable address at all is a hard error — slices joining loopback
    would silently never form a cluster."""
    import socket
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect(("8.8.8.8", 80))   # no packets sent (UDP)
            addr = s.getsockname()[0]
        finally:
            s.close()
    except OSError:
        addr = ""
    if not addr or addr.startswith("127."):
        raise ValueError(
            "cannot auto-detect a routable head address for cloud "
            "slices to join; set head.host in the cluster YAML")
    return addr


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    # our reaped-or-not children: a zombie counts as dead
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split()[2] != "Z"
    except OSError:
        return True


def _teardown(state: dict, cfg: Optional[dict],
              gcp_client=None) -> List[str]:
    errors: List[str] = []
    if state.get("slice_handles"):
        if not (cfg and cfg.get("provider")):
            # wiping handles we cannot terminate would orphan
            # still-billing slices — keep them and surface it
            errors.append(
                "state records cloud slices but the config has no "
                "provider section; restore it and re-run down")
        else:
            import asyncio
            provider = _slice_provider(cfg, state.get("address", ""),
                                       gcp_client)
            remaining: List[str] = []
            for h in state["slice_handles"]:
                try:
                    asyncio.run(provider.terminate(h))
                except Exception as e:  # noqa: BLE001 — keep going
                    errors.append(f"slice {h}: {e}")
                    remaining.append(h)
            state["slice_handles"] = remaining
    import signal
    nodes = list(reversed(state.get("nodes") or []))  # workers first
    for n in nodes:
        try:
            os.killpg(os.getpgid(n["pid"]), signal.SIGTERM)
        except (OSError, ProcessLookupError):
            pass  # already gone
    # Grace window: poll liveness (works whether or not the nodes are
    # OUR children — `down` usually runs in a different process than
    # `up`); reap children opportunistically so zombies don't read as
    # alive; escalate to SIGKILL past the window.
    deadline = time.monotonic() + 10.0
    pending = {n["pid"] for n in nodes}
    while pending and time.monotonic() < deadline:
        for pid in list(pending):
            try:
                os.waitpid(pid, os.WNOHANG)
            except ChildProcessError:
                pass                # not our child: liveness poll only
            if not _pid_alive(pid):
                pending.discard(pid)
        if pending:
            time.sleep(0.1)
    for pid in pending:
        try:
            os.killpg(os.getpgid(pid), signal.SIGKILL)
            errors.append(f"node pid {pid} ignored SIGTERM; killed")
        except (OSError, ProcessLookupError):
            pass
    # Drop the per-node session records: the rest of the CLI
    # (`ray-tpu-torch status` default address, `stop`) trusts them, and a
    # dead cluster's files would point it at gone pids/ports.
    for n in nodes:
        f = n.get("info_file")
        if f:
            try:
                os.unlink(f)
            except OSError:
                pass
    return errors


def down(cfg: dict, *, gcp_client=None) -> List[str]:
    """Tear down a cluster previously brought up with ``up``. If any
    cloud slice could not be deleted, its handle is RE-persisted (the
    state file survives, holding only the survivors) so a later `down`
    can retry — losing the handle of a still-billing slice is worse
    than a leftover file."""
    name = cfg["cluster_name"]
    sp = _state_path(name)
    if not os.path.exists(sp):
        raise RuntimeError(f"no recorded state for cluster {name!r}")
    with open(sp) as f:
        state = json.load(f)
    errors = _teardown(state, cfg, gcp_client=gcp_client)
    if state.get("slice_handles"):
        state["nodes"] = []
        with open(sp, "w") as f:
            json.dump(state, f, indent=2)
    else:
        os.unlink(sp)
    return errors
