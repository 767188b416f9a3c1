"""TPU topology detection + atomic slice reservation.

Capability analog of the reference's TPU support (reference:
python/ray/_private/accelerators/tpu.py:303 TPUAcceleratorManager,
util/tpu.py:407 SlicePlacementGroup, :637 slice_placement_group,
:199-223 MEGASCALE env vars). Detection reads the TPU VM environment
(env vars / device files); scheduling-side, slices are reserved as a gang
of per-host bundles carrying TPU resources + topology labels.

Unlike the reference's marker-resource trick (`TPU-{pod}-head` races with
autoscaling — flagged in SURVEY.md §7 hard parts), reservation here is one
STRICT_SPREAD placement group over label-selected hosts, atomic via the
control service's 2-phase prepare/commit.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

# chips per host for common TPU VM types
_CHIPS_PER_HOST = {"v2": 4, "v3": 4, "v4": 4, "v5e": 8, "v5p": 4, "v6e": 8}

# hosts for (generation, chip-count) pod types, e.g. v5e-32 -> 32/8 = 4 hosts


def num_tpu_chips_on_host() -> int:
    """Count local TPU chips (reference: tpu.py accel device scan)."""
    env = os.environ.get("TPU_CHIPS_PER_HOST")
    if env:
        return int(env)
    chips = len(glob.glob("/dev/accel*"))
    if chips:
        return chips
    if glob.glob("/dev/vfio/*"):
        return len(glob.glob("/dev/vfio/[0-9]*"))
    return 0


def tpu_pod_type() -> Optional[str]:
    """e.g. 'v5e-32' — from env (TPU VMs export these) or metadata."""
    for var in ("TPU_ACCELERATOR_TYPE", "ACCELERATOR_TYPE"):
        v = os.environ.get(var)
        if v:
            return v.lower().replace("litepod-", "e-")
    return None


def tpu_worker_id() -> Optional[int]:
    v = os.environ.get("TPU_WORKER_ID")
    return int(v) if v is not None else None


def tpu_name() -> Optional[str]:
    return os.environ.get("TPU_NAME")


def pod_hosts(pod_type: str) -> int:
    """Host count for a pod type like 'v5e-32' (chips / chips-per-host)."""
    gen, _, chips = pod_type.partition("-")
    chips_per_host = _CHIPS_PER_HOST.get(gen, 4)
    n = int(chips)
    return max(1, n // chips_per_host)


def chips_per_host(pod_type: str) -> int:
    gen = pod_type.partition("-")[0]
    return _CHIPS_PER_HOST.get(gen, 4)


def node_tpu_labels() -> Dict[str, str]:
    labels = {}
    if tpu_pod_type():
        labels["tpu-pod-type"] = tpu_pod_type()
    if tpu_name():
        labels["tpu-name"] = tpu_name()
    if tpu_worker_id() is not None:
        labels["tpu-worker-id"] = str(tpu_worker_id())
    return labels


def get_megascale_env_vars(coordinator_addr: str, num_slices: int,
                           slice_id: int, port: int = 8081) -> Dict[str, str]:
    """Multi-slice DCN coordination env (reference: util/tpu.py:199-223)."""
    return {
        "MEGASCALE_COORDINATOR_ADDRESS": f"{coordinator_addr}:{port}",
        "MEGASCALE_NUM_SLICES": str(num_slices),
        "MEGASCALE_SLICE_ID": str(slice_id),
        "MEGASCALE_PORT": str(port),
    }


@dataclass
class SlicePlacementGroup:
    """A whole TPU slice reserved atomically: one bundle per host, each
    holding every chip on that host (reference: util/tpu.py:407)."""
    pg: "object"                      # api.PlacementGroup
    pod_type: str
    num_hosts: int
    chips_per_host: int
    head_bundle_index: int = 0

    @property
    def placement_group(self):
        return self.pg

    def bundle(self, host_rank: int) -> int:
        return host_rank

    def ready(self, timeout: float = 120.0) -> bool:
        return self.pg.ready(timeout)


def slice_placement_group(pod_type: Optional[str] = None,
                          num_hosts: Optional[int] = None,
                          chips: Optional[int] = None,
                          name: Optional[str] = None) -> SlicePlacementGroup:
    """Reserve a full slice as a STRICT_SPREAD gang of per-host bundles
    (reference: util/tpu.py:637 slice_placement_group)."""
    from ray_tpu_torch import api
    if pod_type is None:
        pod_type = tpu_pod_type() or "v5e-8"
    cph = chips if chips is not None else chips_per_host(pod_type)
    hosts = num_hosts if num_hosts is not None else pod_hosts(pod_type)
    bundles = [{"TPU": float(cph)} for _ in range(hosts)]
    pg = api.placement_group(bundles, strategy="STRICT_SPREAD", name=name)
    return SlicePlacementGroup(pg=pg, pod_type=pod_type, num_hosts=hosts,
                               chips_per_host=cph)
