"""GCP TPU node provider: queued-resource slices for the autoscaler.

Reference: python/ray/autoscaler/_private/gcp/node_provider.py (GCE
instances + TPU VMs via googleapiclient) and the KubeRay provider. Here
the provider targets the TPU **queued resources** API — the way real
TPU capacity is obtained (slice-granular, queue-until-available, which
matches the control plane's patient PENDING placement groups) — through
a minimal injectable REST client, so everything is unit-testable
offline with a fake transport and runs against the live API with the
default one.

Shape of the integration:

- ``TPUQueuedResourceProvider`` creates/deletes/lists queued resources
  (one queued resource == one TPU slice == `pod_hosts(pod_type)`
  cluster nodes once the VMs boot and run the startup script that
  joins them to the head).
- ``TPUSliceAutoscaler`` extends the core reconciler with a SLICE pass:
  every PENDING placement group whose bundles are all-TPU (the shape
  ``slice_placement_group`` emits) becomes one queued-resource create
  of the matching topology; the slice is deleted when its motivating
  placement group no longer exists. CPU-shaped demand still flows
  through the base class (a LocalNodeProvider or a second cloud
  provider can serve it).

The port's copy of ``ray_tpu/providers/gcp.py``: import paths, and the
join script, which starts ``ray_tpu_torch.node`` with the slice host's
own routable address as ``--node-host`` (a node left at the loopback
default registers an address that a remote head cannot reach). The TPU
naming stays: a TPU slice is what the queued-resources API creates.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.autoscaler import Autoscaler, AutoscalerConfig, NodeProvider
from ray_tpu_torch.util import tpu as tpu_util

# GCE accelerator-type naming: v5e pods are "v5litepod-N"; every other
# generation uses its own prefix verbatim.
_ACCEL_NAME = {"v5e": "v5litepod"}


def accelerator_type(pod_type: str) -> str:
    """'v5e-16' -> 'v5litepod-16', 'v4-8' -> 'v4-8'."""
    gen, _, chips = pod_type.partition("-")
    return f"{_ACCEL_NAME.get(gen, gen)}-{chips}"


def pod_type_for(chips: int, chips_per_host: float,
                 generation: str = "v5e") -> str:
    """The pod type a pending slice PG implies: total chips across its
    bundles, named under the configured generation."""
    del chips_per_host  # topology is fully determined by total chips
    return f"{generation}-{int(chips)}"


class TransientAPIError(RuntimeError):
    """A rate-limit (429) / server-blip API failure that outlived the
    client's quick retries: the caller should back off and try again
    later — it is NOT a permanent failure."""


class GCPClient:
    """Minimal REST transport for tpu.googleapis.com.

    ``request(method, url, body) -> (status, dict)`` is injectable —
    tests pass a fake; production uses urllib with a bearer token from
    ``token_supplier`` (defaults to the GCE metadata server, the
    ambient credential on any GCP VM)."""

    API = "https://tpu.googleapis.com/v2"
    METADATA_TOKEN_URL = ("http://metadata.google.internal/computeMetadata/"
                          "v1/instance/service-accounts/default/token")

    def __init__(self, project: str, zone: str,
                 request: Optional[Callable] = None,
                 token_supplier: Optional[Callable[[], str]] = None):
        self.project = project
        self.zone = zone
        self._request = request or self._urllib_request
        self._token_supplier = token_supplier or self._metadata_token
        self._token: Tuple[str, float] = ("", 0.0)

    # --- transport -----------------------------------------------------

    def _metadata_token(self) -> str:
        import urllib.request
        tok, exp = self._token
        if tok and time.monotonic() < exp - 60:
            return tok
        req = urllib.request.Request(
            self.METADATA_TOKEN_URL, headers={"Metadata-Flavor": "Google"})
        with urllib.request.urlopen(req, timeout=10) as r:
            data = json.loads(r.read().decode())
        self._token = (data["access_token"],
                       time.monotonic() + float(data.get("expires_in", 300)))
        return self._token[0]

    def _urllib_request(self, method: str, url: str,
                        body: Optional[dict]) -> Tuple[int, dict]:
        import urllib.error
        import urllib.request
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            url, data=data, method=method,
            headers={"Authorization": f"Bearer {self._token_supplier()}",
                     "Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                payload = r.read().decode()
                return r.status, (json.loads(payload) if payload else {})
        except urllib.error.HTTPError as e:  # structured API errors
            try:
                return e.code, json.loads(e.read().decode())
            except Exception:
                return e.code, {"error": str(e)}

    def _parent(self) -> str:
        return f"projects/{self.project}/locations/{self.zone}"

    # Transient API statuses worth an immediate short retry: rate
    # limits and server-side blips. Anything else is surfaced to the
    # reconciler, which applies its own longer, non-blocking backoff.
    RETRYABLE = frozenset({429, 500, 502, 503, 504})

    def _call(self, method: str, url: str,
              body: Optional[dict]) -> Tuple[int, dict]:
        """_request with two quick exponential retries on transient
        statuses/transport errors — absorbs blips without stalling the
        reconcile loop for long (sustained 429s are the RECONCILER's
        problem: it backs off per-PG without blocking)."""
        delay = 0.5
        last_exc: Optional[Exception] = None
        for attempt in range(3):
            try:
                status, resp = self._request(method, url, body)
                last_exc = None
            except Exception as e:  # noqa: BLE001 — network blip
                last_exc = e
                status, resp = 599, {"error": str(e)}
            transient = status in self.RETRYABLE or status == 599
            if not transient or attempt == 2:
                if last_exc is not None:
                    raise TransientAPIError(str(last_exc)) from last_exc
                return status, resp
            time.sleep(delay)
            delay *= 2
        return status, resp  # pragma: no cover — loop always returns

    # --- queued resources ----------------------------------------------

    def create_queued_resource(self, qr_id: str, node: dict) -> dict:
        """POST a queued-resource create; `node` is the TPU node spec
        (acceleratorType, runtimeVersion, metadata with the join
        script, labels)."""
        url = (f"{self.API}/{self._parent()}/queuedResources"
               f"?queued_resource_id={qr_id}")
        body = {"tpu": {"node_spec": [{"parent": self._parent(),
                                       "node_id": qr_id,
                                       "node": node}]}}
        status, resp = self._call("POST", url, body)
        if status in self.RETRYABLE:
            raise TransientAPIError(
                f"create_queued_resource {qr_id}: {status} {resp}")
        if status >= 300:
            raise RuntimeError(f"create_queued_resource {qr_id}: "
                               f"{status} {resp}")
        return resp

    def delete_queued_resource(self, qr_id: str) -> None:
        url = (f"{self.API}/{self._parent()}/queuedResources/{qr_id}"
               f"?force=true")
        status, resp = self._call("DELETE", url, None)
        if status in self.RETRYABLE:
            raise TransientAPIError(
                f"delete_queued_resource {qr_id}: {status} {resp}")
        if status >= 300 and status != 404:
            raise RuntimeError(f"delete_queued_resource {qr_id}: "
                               f"{status} {resp}")

    def list_queued_resources(self) -> List[dict]:
        url = f"{self.API}/{self._parent()}/queuedResources"
        status, resp = self._call("GET", url, None)
        if status >= 300:
            raise RuntimeError(f"list_queued_resources: {status} {resp}")
        return resp.get("queuedResources", [])


_DEAD_QR_STATES = {"FAILED", "SUSPENDED", "SUSPENDING", "DELETING"}

# The node's agent registers the address it binds with the head, and
# the node binds loopback unless told otherwise, which a remote head
# cannot dial: the script reads the host's first non-loopback IPv4
# address at boot and passes it as --node-host.
_JOIN_SCRIPT = """#!/bin/bash
# ray_tpu_torch slice bootstrap: every TPU VM host joins the head as a node.
NODE_HOST=$(hostname -I | tr ' ' '\\n' | grep -E '^[0-9]+([.][0-9]+){{3}}$' \\
    | grep -v '^127[.]' | head -n 1)
if [ -z "$NODE_HOST" ]; then
    echo "no routable IPv4 address on this host" >> {log_file}
    exit 1
fi
python3 -m ray_tpu_torch.node --address {head_address} \\
    --node-host "$NODE_HOST" \\
    --labels '{labels_json}' >> {log_file} 2>&1 &
"""
_JOIN_LOG = "/var/log/ray_tpu_torch_node.log"


class TPUQueuedResourceProvider(NodeProvider):
    """TPU slices via queued resources. One launch() == one slice; the
    pod type rides labels["tpu_pod_type"] (the slice autoscaler sets
    it) or falls back to ``default_pod_type``."""

    def __init__(self, client: GCPClient, head_address: str,
                 runtime_version: str = "v2-alpha-tpuv5-lite",
                 default_pod_type: str = "v5e-8",
                 name_prefix: str = "ray-tpu"):
        self.client = client
        self.head_address = head_address
        self.runtime_version = runtime_version
        self.default_pod_type = default_pod_type
        self.name_prefix = name_prefix
        self._n = 0

    async def launch(self, resources: Dict[str, float],
                     labels: Dict[str, str]) -> str:
        pod_type = labels.get("tpu_pod_type", self.default_pod_type)
        self._n += 1
        qr_id = f"{self.name_prefix}-{pod_type}-{self._n}-" \
                f"{int(time.time()) % 100000}"
        node_labels = {**labels, "autoscaler_handle": qr_id,
                       "ray-tpu-cluster": "true"}
        node = {
            "acceleratorType": accelerator_type(pod_type),
            "runtimeVersion": self.runtime_version,
            "labels": {k.replace("_", "-"): str(v)[:62]
                       for k, v in node_labels.items()},
            "metadata": {
                "startup-script": _JOIN_SCRIPT.format(
                    head_address=self.head_address,
                    labels_json=json.dumps(node_labels),
                    log_file=_JOIN_LOG),
            },
        }
        self.client.create_queued_resource(qr_id, node)
        return qr_id

    async def terminate(self, handle: str) -> None:
        self.client.delete_queued_resource(handle)

    async def alive_handles(self) -> List[str]:
        out = []
        for qr in self.client.list_queued_resources():
            state = (qr.get("state") or {}).get("state", "")
            name = qr.get("name", "").rsplit("/", 1)[-1]
            if name.startswith(self.name_prefix) and \
                    state not in _DEAD_QR_STATES:
                out.append(name)
        return out

    def handle_labels(self, handle: str) -> Dict[str, str]:
        """Labels of one live queued resource (slice bookkeeping)."""
        for qr in self.client.list_queued_resources():
            name = qr.get("name", "").rsplit("/", 1)[-1]
            if name == handle:
                specs = ((qr.get("tpu") or {}).get("node_spec")
                         or (qr.get("tpu") or {}).get("nodeSpec") or [])
                if specs:
                    return dict((specs[0].get("node") or {})
                                .get("labels") or {})
        return {}


@dataclass
class SliceScalerConfig(AutoscalerConfig):
    generation: str = "v5e"
    max_slices: int = 4
    # a slice whose motivating PG vanished is deleted after this grace
    slice_idle_timeout_s: float = 60.0


class TPUSliceAutoscaler(Autoscaler):
    """Reconciler with a TPU-slice pass on top of the CPU-shaped base.

    Pending all-TPU STRICT_SPREAD placement groups (the shape
    ``slice_placement_group`` emits — SURVEY §7's "slice reservation
    races autoscaling" hard part) map 1:1 to queued-resource creates of
    the matching topology; slices whose PG is gone are deleted after a
    grace period."""

    def __init__(self, head_address: str,
                 slice_provider: TPUQueuedResourceProvider,
                 config: Optional[SliceScalerConfig] = None,
                 base_provider: Optional[NodeProvider] = None):
        super().__init__(head_address,
                         base_provider or _NullProvider(),
                         config or SliceScalerConfig())
        self.slice_provider = slice_provider
        self._pg_slices: Dict[str, str] = {}     # pg hex -> qr handle
        self._slice_orphaned_at: Dict[str, float] = {}
        # pg hex -> (next_attempt_monotonic, current_delay): create
        # failures (quota 429s, API errors) back off exponentially per
        # PG WITHOUT blocking the reconcile loop — a transient failure
        # must not be indistinguishable from a permanent one, and a
        # sustained quota error must not hammer the API every pass.
        self._create_backoff: Dict[str, Tuple[float, float]] = {}
        self.CREATE_BACKOFF_INITIAL_S = 5.0
        self.CREATE_BACKOFF_MAX_S = 300.0

    async def reconcile_once(self) -> dict:
        actions = await super().reconcile_once()
        actions.update(await self._reconcile_slices())
        return actions

    @staticmethod
    def _slice_pgs(pgs) -> Dict[str, str]:
        """pg hex -> pod-type-determining chip count for PENDING
        all-TPU gangs."""
        out = {}
        for pg in pgs:
            bundles = pg.get("bundles") or []
            if pg.get("state") != "PENDING" or not bundles:
                continue
            if not all(float(b.get("TPU", 0)) > 0 for b in bundles):
                continue
            out[_pg_hex(pg["pg_id"])] = bundles
        return out

    async def _reconcile_slices(self) -> dict:
        cfg: SliceScalerConfig = self.config  # type: ignore[assignment]
        actions = {"slices_created": 0, "slices_deleted": 0}
        pgs = await self.pool.call(self.head_addr, "list_pgs",
                                   timeout=10.0)
        live_pg_ids = {_pg_hex(p["pg_id"]) for p in pgs
                       if p.get("state") != "REMOVED"}
        pending = self._slice_pgs(pgs)

        handles = set(await self.slice_provider.alive_handles())
        self._pg_slices = {pg: h for pg, h in self._pg_slices.items()
                           if h in handles}
        claimed = set(self._pg_slices.values())
        # Re-learn pg->slice claims from cloud labels (restart safety).
        for h in handles - claimed:
            pg = self.slice_provider.handle_labels(h).get("slice-for-pg") \
                or self.slice_provider.handle_labels(h).get("slice_for_pg")
            if pg:
                self._pg_slices.setdefault(pg, h)
        claimed = set(self._pg_slices.values())

        # create: one slice per unclaimed pending slice-PG (failures
        # back off per PG — see _create_backoff)
        now0 = time.monotonic()
        actions["slice_create_errors"] = 0
        for pg_hex, bundles in pending.items():
            if pg_hex in self._pg_slices:
                continue
            if len(handles) >= cfg.max_slices:
                break
            next_try, delay = self._create_backoff.get(pg_hex, (0.0, 0.0))
            if now0 < next_try:
                continue
            chips = int(sum(float(b["TPU"]) for b in bundles))
            pod_type = pod_type_for(chips, 0, cfg.generation)
            per_host = {"TPU": float(max(float(b["TPU"])
                                         for b in bundles))}
            try:
                handle = await self.slice_provider.launch(
                    per_host, {"tpu_pod_type": pod_type,
                               "slice_for_pg": pg_hex})
            except Exception as e:  # noqa: BLE001 — transient OR quota
                new_delay = min(
                    self.CREATE_BACKOFF_MAX_S,
                    max(self.CREATE_BACKOFF_INITIAL_S, delay * 2))
                self._create_backoff[pg_hex] = (now0 + new_delay,
                                                new_delay)
                actions["slice_create_errors"] += 1
                actions.setdefault("slice_create_last_error",
                                   f"{type(e).__name__}: {e}")
                continue
            self._create_backoff.pop(pg_hex, None)
            self._pg_slices[pg_hex] = handle
            handles.add(handle)
            actions["slices_created"] += 1
        # PGs that got a slice (or vanished) drop their backoff record
        for pg_hex in list(self._create_backoff):
            if pg_hex not in pending or pg_hex in self._pg_slices:
                del self._create_backoff[pg_hex]

        # delete: slices whose motivating PG no longer exists
        now = time.monotonic()
        by_handle = {h: pg for pg, h in self._pg_slices.items()}
        for h in list(handles):
            pg = by_handle.get(h)
            if pg is not None and pg in live_pg_ids:
                self._slice_orphaned_at.pop(h, None)
                continue
            since = self._slice_orphaned_at.setdefault(h, now)
            if now - since < cfg.slice_idle_timeout_s:
                continue
            await self.slice_provider.terminate(h)
            self._slice_orphaned_at.pop(h, None)
            if pg is not None:
                self._pg_slices.pop(pg, None)
            actions["slices_deleted"] += 1
        return actions


class _NullProvider(NodeProvider):
    """Base-provider stub when only TPU slices are autoscaled: CPU
    launches are recorded (visible in tests/metrics) but create
    nothing."""

    def __init__(self):
        self.ignored_launches = 0

    async def launch(self, resources, labels) -> str:
        self.ignored_launches += 1
        return f"null-{self.ignored_launches}"

    async def terminate(self, handle: str) -> None:
        pass

    async def alive_handles(self) -> List[str]:
        return []


def _pg_hex(v) -> str:
    return v.hex() if hasattr(v, "hex") else str(v)
