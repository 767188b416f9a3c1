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

from typing import Callable, List, Sequence, Tuple

import torch


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        # the name tensors report, so shards compare equal to them
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class TensorMesh:
    """``devices`` in shard order (repeats allowed), one axis named
    ``axis``. ``shape[axis]`` is the tensor-parallel size, as
    ``mesh.shape[axis]`` reads on a JAX mesh."""

    def __init__(self, devices: Sequence, axis: str = "tensor"):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices: Tuple[torch.device, ...] = tuple(
            _device(d) for d in devices)
        self.axis = axis
        self.shape = {axis: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return (f"TensorMesh({[str(d) for d in self.devices]}, "
                f"axis={self.axis!r})")

    def _collect(self, parts: Sequence[torch.Tensor],
                 combine: Callable[[List[torch.Tensor]], torch.Tensor]
                 ) -> List[torch.Tensor]:
        if len(parts) != self.size:
            raise ValueError(f"{len(parts)} parts for a mesh of "
                             f"{self.size} shards")
        dst = self.devices[0]
        out = combine([p.to(dst) for p in parts])
        return [out.to(d) for d in self.devices]

    def all_reduce(self, parts: Sequence[torch.Tensor]
                   ) -> List[torch.Tensor]:
        """The sum of the shards' partials, added in shard order, on
        every shard's device."""
        def add(ps):
            total = ps[0]
            for p in ps[1:]:
                total = total + p
            return total
        return self._collect(parts, add)

    def all_gather(self, parts: Sequence[torch.Tensor],
                   dim: int) -> List[torch.Tensor]:
        """The shards' parts concatenated along ``dim`` in shard order,
        on every shard's device."""
        return self._collect(parts, lambda ps: torch.cat(ps, dim))
