"""Worker cgroup isolation: kernel-enforced per-worker memory limits.

Analog of the reference's cgroup setup for workers (reference:
src/ray/common/cgroup2/* — cgroup manager the raylet uses to cage
worker processes): each spawned worker lands in its own cgroup with
`memory.max` (v2) / `memory.limit_in_bytes` (v1) set, so a runaway
worker is OOM-killed by the KERNEL at its own cap instead of dragging
the node to the global OOM killer. Complements the userspace memory
monitor in agent.py (which acts on softer thresholds and can choose
victims by policy).

Everything degrades gracefully: no root / no controller -> no cgroups,
workers run unconfined (a one-line event records that).
"""

from __future__ import annotations

import os
from typing import Optional

_V2_ROOT = "/sys/fs/cgroup"
_V1_MEM_ROOT = "/sys/fs/cgroup/memory"


def _write(path: str, value: str) -> None:
    with open(path, "w") as f:
        f.write(value)


def detect() -> Optional[str]:
    """'v2', 'v1', or None if memory limits can't be enforced here.
    Probe dirs are per-pid so concurrent agents can't race each other
    into a false negative."""
    probe_name = f".raytpu-probe-{os.getpid()}"
    try:
        ctrl = os.path.join(_V2_ROOT, "cgroup.controllers")
        if os.path.exists(ctrl):
            with open(ctrl) as f:
                has_mem = "memory" in f.read().split()
            if has_mem:
                probe = os.path.join(_V2_ROOT, probe_name)
                os.makedirs(probe, exist_ok=True)
                try:
                    # memory.max only exists in the child when the
                    # controller is enabled via subtree_control —
                    # cgroup.controllers alone doesn't prove that.
                    if os.path.exists(os.path.join(probe, "memory.max")):
                        return "v2"
                finally:
                    os.rmdir(probe)
        if os.path.isdir(_V1_MEM_ROOT):
            probe = os.path.join(_V1_MEM_ROOT, probe_name)
            os.makedirs(probe, exist_ok=True)
            os.rmdir(probe)
            return "v1"
    except OSError:
        pass
    return None


class WorkerCgroup:
    """One cgroup confining one worker process."""

    def __init__(self, path: str, version: str):
        self.path = path
        self.version = version

    @classmethod
    def create(cls, name: str, memory_bytes: int,
               version: Optional[str] = None) -> Optional["WorkerCgroup"]:
        version = version or detect()
        if version is None or memory_bytes <= 0:
            return None
        try:
            if version == "v2":
                path = os.path.join(_V2_ROOT, f"raytpu-{name}")
                os.makedirs(path, exist_ok=True)
                _write(os.path.join(path, "memory.max"),
                       str(memory_bytes))
            else:
                path = os.path.join(_V1_MEM_ROOT, f"raytpu-{name}")
                os.makedirs(path, exist_ok=True)
                _write(os.path.join(path, "memory.limit_in_bytes"),
                       str(memory_bytes))
                # no swap escape hatch where the knob exists
                try:
                    _write(os.path.join(
                        path, "memory.memsw.limit_in_bytes"),
                        str(memory_bytes))
                except OSError:
                    pass
            return cls(path, version)
        except OSError:
            return None

    def add_pid(self, pid: int) -> bool:
        try:
            _write(os.path.join(self.path, "cgroup.procs"), str(pid))
            return True
        except OSError:
            return False

    def remove(self) -> None:
        """Best-effort teardown (the worker must already be dead — a
        cgroup with live members can't be removed)."""
        try:
            os.rmdir(self.path)
        except OSError:
            pass


def sweep_stale(version: Optional[str] = None) -> int:
    """Remove empty leftover raytpu-* cgroups (agents that stopped
    before their reap tasks ran leave them behind). Only empty groups
    can be rmdir'd, so this can never touch a live worker."""
    version = version or detect()
    if version is None:
        return 0
    root = _V2_ROOT if version == "v2" else _V1_MEM_ROOT
    n = 0
    try:
        names = os.listdir(root)
    except OSError:
        return 0
    import time
    for name in names:
        if not name.startswith("raytpu-"):
            continue
        full = os.path.join(root, name)
        try:
            # Age gate: a concurrent agent may be between create() and
            # add_pid() — only reap dirs old enough to be true leftovers.
            if time.time() - os.stat(full).st_mtime < 60:
                continue
            os.rmdir(full)
            n += 1
        except OSError:
            pass  # still has members or already gone
    return n
