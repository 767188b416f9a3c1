"""DataIterator: batch iteration with framework conversion + device staging.

Reference: python/ray/data/iterator.py (iter_batches, iter_torch_batches at
:309). The port's copy of ``ray_tpu/data/iterator.py``, whose
``iter_jax_batches`` (host numpy batches onto devices with
jax.device_put, the next batch's copy issued before the current one is
yielded) becomes ``iter_device_batches``: torch tensors on a device (the
card unless the caller asks for the CPU), each copied from pinned host
memory on a side stream while the consumer computes on the previous
batch — the usual input-pipeline trick the scaling book prescribes.
torch is imported only inside the iterators, so a map task that never
asks for tensors does not load it.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional

import numpy as np

from ray_tpu_torch.data.block import Block, block_num_rows, block_to_pandas
from ray_tpu_torch.data.dataset import _rebatch


class DataIterator:
    def __init__(self, block_gen: Callable[[], Iterator[Block]]):
        self._block_gen = block_gen

    def iter_blocks(self) -> Iterator[Block]:
        return self._block_gen()

    def iter_batches(self, *, batch_size: int = 256,
                     batch_format: str = "numpy",
                     drop_last: bool = False):
        for b in _rebatch(self._block_gen(), batch_size):
            if drop_last and block_num_rows(b) < batch_size:
                continue
            if batch_format == "pandas":
                yield block_to_pandas(b)
            elif batch_format == "rows":
                from ray_tpu_torch.data.block import block_rows
                yield list(block_rows(b))
            else:
                yield b

    def iter_torch_batches(self, *, batch_size: int = 256,
                           drop_last: bool = False,
                           dtypes: Optional[dict] = None):
        import torch
        for b in self.iter_batches(batch_size=batch_size,
                                   drop_last=drop_last):
            out = {}
            for k, v in b.items():
                t = torch.from_numpy(np.ascontiguousarray(v))
                if dtypes and k in dtypes:
                    t = t.to(dtypes[k])
                out[k] = t
            yield out

    def iter_device_batches(self, *, batch_size: int = 256,
                            drop_last: bool = True,
                            device=None,
                            prefetch: int = 1,
                            sharding=None):
        """Device-resident batches: dicts of torch tensors on ``device``
        (None is the CUDA device, through ``_device.resolve_device``;
        "cpu" gives CPU tensors). On a card each column is copied from
        pinned host memory with ``non_blocking=True`` on a copy stream;
        with prefetch>=1 the NEXT batch's copy is issued before the
        current one is yielded, so the host->device copy overlaps
        downstream compute, and the consumer's current stream waits on a
        batch's copy when the batch is yielded.

        ``sharding=`` a ``parallel.mesh.DeviceMesh`` (the reference's mesh
        placement) yields each batch already split for the mesh's train
        step: per column, the list of every mesh shard's block on the
        shard's device (``models.llama.shard_batch``: rows over (data,
        fsdp), the sequence over context), one copy per distinct block
        and device, each copy on its device's copy stream as above."""
        import torch

        from ray_tpu_torch._device import resolve_device
        if sharding is not None:
            from ray_tpu_torch.models.llama import MeshAxes, shard_batch
            from ray_tpu_torch.parallel.mesh import DeviceMesh
            if not isinstance(sharding, DeviceMesh):
                raise TypeError("sharding= takes a DeviceMesh "
                                "(parallel.mesh.make_mesh), not "
                                f"{type(sharding).__name__}")
            if device is not None:
                raise ValueError("pass either a device or a sharding")
            devs = sharding.devices
        else:
            devs = (resolve_device(device),)
        streams = {d: torch.cuda.Stream(d) for d in devs
                   if d.type == "cuda"}

        def copy(x, dev):
            if dev.type != "cuda":
                return x.to(dev)
            with torch.cuda.stream(streams[dev]):
                return x.contiguous().pin_memory().to(dev, non_blocking=True)

        def put(b):
            host = {k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in b.items()}
            out = ({k: copy(v, devs[0]) for k, v in host.items()}
                   if sharding is None
                   else shard_batch(host, sharding, MeshAxes(), move=copy))
            done = {}
            for dev, stream in streams.items():
                done[dev] = torch.cuda.Event()
                done[dev].record(stream)
            return out, done

        def ready(item):
            out, done = item
            for dev, event in done.items():
                consumer = torch.cuda.current_stream(dev)
                consumer.wait_event(event)
                for col in out.values():
                    for t in (col if isinstance(col, list) else [col]):
                        if t.device == dev:
                            # allocated on the copy stream, used on the
                            # consumer's: the allocator must wait for both
                            t.record_stream(consumer)
            return out

        it = self.iter_batches(batch_size=batch_size, drop_last=drop_last)
        buf = []
        for b in it:
            buf.append(put(b))
            if len(buf) > max(prefetch, 0):
                yield ready(buf.pop(0))
        for item in buf:
            yield ready(item)

    def materialize(self):
        from ray_tpu_torch.data.dataset import Dataset, _Op
        blocks = [b for b in self._block_gen() if block_num_rows(b)]
        return Dataset([_Op("from_blocks", "source", None,
                            {"blocks": blocks})])

    def count(self) -> int:
        return sum(block_num_rows(b) for b in self._block_gen())
