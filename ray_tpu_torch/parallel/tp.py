"""The tensor-parallel mesh of the serving engine.

Counterpart of the ``("tensor",)`` ``jax.sharding.Mesh`` that
``ray_tpu/serve/llm.py`` builds over a replica's local devices. One
process owns every shard, as the JAX engine does under GSPMD: the engine
keeps one shard of the weights and of the KV per mesh device and runs
the two reductions of each layer itself, through ``all_reduce`` and
``all_gather`` here.

Both collectives take the shards' partial tensors in shard order, move
each to the first shard's device with ``.to()``, combine them there in
that order (a sum or a concatenation), and put the result back on every
shard's device with ``.to()``, which is a no-op where the device is the
same. The order never varies, so the result is deterministic. No
``torch.distributed`` group and no NCCL is involved.

A device may appear more than once: ``TensorMesh(("cpu",) * 2)`` in the
CPU tests and ``TensorMesh(("cuda:0",) * 2)`` on a one-card machine
stand in for the JAX tests' virtual CPU devices
(``--xla_force_host_platform_device_count``): every shard has the real
per-shard shapes, and shards that share a device run one after the
other on its current stream.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ray_tpu_torch.parallel.mesh import DeviceMesh


class TensorMesh:
    """``devices`` in shard order (repeats allowed), one axis named
    ``axis``: the one-axis ``parallel.mesh.DeviceMesh``, whose
    collectives these are. ``shape[axis]`` is the tensor-parallel size,
    as ``mesh.shape[axis]`` reads on a JAX mesh."""

    def __init__(self, devices: Sequence, axis: str = "tensor"):
        self._mesh = DeviceMesh(list(devices), (axis,))
        self.devices: Tuple[torch.device, ...] = self._mesh.devices
        self.axis = axis
        self.shape = self._mesh.shape

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return (f"TensorMesh({[str(d) for d in self.devices]}, "
                f"axis={self.axis!r})")

    def all_reduce(self, parts: Sequence[torch.Tensor]
                   ) -> List[torch.Tensor]:
        """The sum of the shards' partials, added in shard order, on
        every shard's device."""
        return self._mesh.all_reduce(parts, self.axis)

    def all_gather(self, parts: Sequence[torch.Tensor],
                   dim: int) -> List[torch.Tensor]:
        """The shards' parts concatenated along ``dim`` in shard order,
        on every shard's device."""
        return self._mesh.all_gather(parts, self.axis, dim)
