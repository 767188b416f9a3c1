"""Device-resident tensor transport: the RDT analog, on ``torch``.

The port's counterpart of ``ray_tpu/runtime/device_store.py``
(reference: python/ray/experimental/rdt/tensor_transport_manager.py:37 —
there, GPU objects move device-to-device over pluggable transports with
a host-staged object-plane fallback). A ``TensorRef`` is a picklable
handle to a tensor parked in the producing process's ``DeviceStore``
(on the card, or on the CPU where the producer works there). Resolving
it

- in the SAME process returns the parked tensor itself (no copy; it
  stays in device memory), or a ``.to(device)`` copy when another device
  is asked for;
- in a DIFFERENT process fetches the bytes from the owner over one RPC
  (``fetch_tensor``, runtime/core.py) and moves them onto the consumer's
  device: one host hop.

bf16 has no numpy dtype, so the owner ships it as ``uint16`` bits and
the consumer views them back: the bits arrive unchanged. The
reference's ``sharding=`` argument (re-lay a resolved array onto a
mesh) has no counterpart until the port's meshes exist (ROADMAP Queue 1
items 11-12); ``device=`` takes its place.

Handles are small, so they ride tasks, actor calls and the object plane
for free; the tensor bytes move at most once, only when a process
boundary is actually crossed.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device

# Identifies THIS process's store. A uuid, not os.getpid(): pids repeat
# across nodes and containers, and a pid collision would misroute a
# remote ref to the local-store branch.
_PROC_ID = uuid.uuid4().hex

# Backstop TTL for parked tensors whose consumer never resolves or
# frees them (request rejected downstream, consumer crashed): without
# it every abandoned handoff would pin device memory forever.
DEFAULT_TTL_S = 600.0


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A parked tensor as a host array for the wire: bf16 as ``uint16``
    bits, every other dtype as itself."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def _from_host(host: np.ndarray, dtype: str) -> torch.Tensor:
    """The inverse of ``_to_host`` for a handle of dtype ``dtype``: a CPU
    tensor over the fetched array's bytes."""
    if dtype == "bfloat16":
        return torch.from_numpy(host.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(host)


class TensorRef:
    """Picklable handle to a tensor parked in some process's
    DeviceStore. ``resolve()`` returns a ``torch.Tensor``."""

    __slots__ = ("tid", "shape", "dtype", "owner_proc", "owner_addr")

    def __init__(self, tid: str, shape: tuple, dtype: str,
                 owner_proc: str, owner_addr: Optional[Tuple[str, int]]):
        self.tid = tid
        self.shape = shape
        self.dtype = dtype
        self.owner_proc = owner_proc
        self.owner_addr = tuple(owner_addr) if owner_addr else None

    def __reduce__(self):
        return (TensorRef, (self.tid, self.shape, self.dtype,
                            self.owner_proc, self.owner_addr))

    def __repr__(self):
        return (f"TensorRef({self.tid[:8]}, shape={self.shape}, "
                f"dtype={self.dtype})")

    def resolve(self, device=None) -> torch.Tensor:
        return _store().get(self, device=device)

    def free(self) -> None:
        """Release the parked tensor. Cross-process: best-effort RPC to
        the owner."""
        if self.owner_proc == _PROC_ID:
            _store().drop(self.tid)
            return
        if self.owner_addr is None:
            return
        try:
            from ray_tpu_torch import api
            api._run(api._g.ctx.pool.call(
                self.owner_addr, "free_tensor", tid=self.tid,
                timeout=10.0))
        except Exception:
            pass


class DeviceStore:
    """Per-process registry of tensors addressable by TensorRef."""

    def __init__(self, ttl_s: float = DEFAULT_TTL_S):
        # tid -> (tensor, deadline)
        self._tensors: Dict[str, Tuple[torch.Tensor, float]] = {}
        self._lock = threading.Lock()
        self._ttl_s = ttl_s

    def _purge_expired_locked(self):
        now = time.monotonic()
        dead = [t for t, (_a, dl) in self._tensors.items() if dl < now]
        for t in dead:
            del self._tensors[t]

    def _lookup(self, tid: str) -> Optional[torch.Tensor]:
        with self._lock:
            self._purge_expired_locked()
            ent = self._tensors.get(tid)
        return None if ent is None else ent[0]

    # -- producer side ---------------------------------------------------

    def put(self, t: torch.Tensor, ttl_s: Optional[float] = None
            ) -> TensorRef:
        """Park a tensor (on the card or the CPU) and hand back its
        handle."""
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"put_device parks torch tensors, got "
                            f"{type(t).__name__}")
        tid = uuid.uuid4().hex
        deadline = time.monotonic() + (ttl_s or self._ttl_s)
        with self._lock:
            self._purge_expired_locked()
            self._tensors[tid] = (t, deadline)
        addr = None
        try:
            from ray_tpu_torch import api
            if api._g.ctx is not None:
                addr = api._g.ctx.addr
        except Exception:
            pass
        return TensorRef(tid, tuple(t.shape), _dtype_name(t),
                         _PROC_ID, addr)

    def drop(self, tid: str) -> None:
        with self._lock:
            self._tensors.pop(tid, None)

    # -- accounting ------------------------------------------------------

    def live_count(self) -> int:
        """Parked (unexpired) tensors in this store — the invariant a
        schedule-owned transport must hold: after a handoff drains, this
        returns to its value before it (a consumer frees each tensor as
        it takes it, so steady-state memory is O(in-flight handoffs),
        never O(requests))."""
        with self._lock:
            self._purge_expired_locked()
            return len(self._tensors)

    def live_bytes(self) -> int:
        """Total bytes of parked (unexpired) tensors."""
        with self._lock:
            self._purge_expired_locked()
            return int(sum(t.numel() * t.element_size()
                           for t, _dl in self._tensors.values()))

    def stats(self) -> Dict[str, int]:
        return {"live_count": self.live_count(),
                "live_bytes": self.live_bytes()}

    # -- consumer side ---------------------------------------------------

    def get(self, ref: TensorRef, device=None) -> torch.Tensor:
        """Resolve to a tensor. Same process: the parked tensor itself
        (``.to(device)`` only when another device is asked for). Cross
        process: one fetch RPC, then onto ``device`` (``None``: the
        card, raising without one, as every entry point of the port)."""
        if ref.owner_proc == _PROC_ID:
            t = self._lookup(ref.tid)
            if t is None:
                raise KeyError(f"tensor {ref.tid[:8]} freed or unknown")
            return t if device is None else t.to(resolve_device(device))
        if ref.owner_addr is None:
            raise KeyError(
                f"tensor {ref.tid[:8]} lives in process "
                f"{ref.owner_proc[:8]} with no reachable owner address")
        dev = resolve_device(device)
        from ray_tpu_torch import api
        host = api._run(api._g.ctx.pool.call(
            ref.owner_addr, "fetch_tensor", tid=ref.tid, timeout=300.0))
        if host is None:
            raise KeyError(f"tensor {ref.tid[:8]} freed at its owner")
        return _from_host(host, ref.dtype).to(dev)

    # -- owner-side RPC handlers -----------------------------------------

    def host_bytes(self, tid: str) -> Optional[np.ndarray]:
        """Stage a parked tensor to host for a cross-process fetch (the
        numpy array rides the RPC's pickle-5 zero-copy frames; bf16 as
        ``uint16`` bits)."""
        t = self._lookup(tid)
        if t is None:
            return None
        return _to_host(t)


_STORE: Optional[DeviceStore] = None
_STORE_LOCK = threading.Lock()


def _store() -> DeviceStore:
    global _STORE
    if _STORE is None:
        with _STORE_LOCK:
            if _STORE is None:
                _STORE = DeviceStore()
    return _STORE


def put_device(t: torch.Tensor, ttl_s: Optional[float] = None) -> TensorRef:
    """Public entry: park a tensor, get a shippable handle. ``ttl_s``
    bounds how long an unresolved handle pins the tensor (a dead
    consumer cannot leak device memory past the bound)."""
    return _store().put(t, ttl_s=ttl_s)


def get_device(ref: TensorRef, device=None) -> torch.Tensor:
    return _store().get(ref, device=device)
