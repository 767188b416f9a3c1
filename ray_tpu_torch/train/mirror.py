"""Peer-mirror blobs in shared memory.

A ZeRO rank's in-memory peer checkpoint (``train/zero.py``
``ShardedOptimizer._snapshot``) holds the elementwise optimizer state of
its shard: at Llama-3-8B widths with 2 layers over two workers, two f32
moments of 743,450,624 elements, 5.95 GB. Inside an actor call's frame
such a blob would be copied several times on each side (serialization,
the RPC frame, its read). Here its leaves are staged ONCE into one POSIX
shared-memory segment (for a tensor, its device-to-host copy lands
straight in the segment's pages) and the blob crosses the actor call as
the segment's name: the successor maps the segment and unlinks the name,
so the pages then live in the successor's mapping alone and outlive the
sender. The reference ships the numpy leaves inside the call; the blob's
keys and the successor's store are the same.

A segment nobody took is unlinked by whoever still holds its name: the
sender when its ``MirrorLeaves`` was never pickled and is collected, or
when it posts the next mirror (``discard``). A segment posted to a
successor that dies before mapping it, by a sender that dies too, stays
in ``/dev/shm`` until the host reclaims it.
"""

from __future__ import annotations

import mmap
import os
import uuid
import weakref
from typing import List, Optional, Sequence, Tuple

import numpy as np

_DIR = "/dev/shm"
_ALIGN = 64
# The sender's mapping is populated when it is made: one kernel call
# allocates the segment's pages, where a copy into an unpopulated
# mapping takes a fault on every 4 KiB page (tmpfs gets no huge pages).
_POPULATE = getattr(mmap, "MAP_POPULATE", 0)

Layout = List[Tuple[int, str, int]]     # (byte offset, dtype str, count)


class MirrorLeaves(list):
    """Flat numpy arrays over one shared-memory segment. Pickles as the
    segment's name and layout; unpickling maps the segment read-only and
    unlinks its name (``_attach``). A mapped copy (``name`` None)
    pickles as a plain list of its arrays."""

    def __init__(self, arrays, name: Optional[str], layout: Layout):
        super().__init__(arrays)
        self.name = name
        self.layout = layout
        # the sender's cleanup: unlink on collection unless pickled
        self._handed = {"v": name is None}
        if name is not None:
            weakref.finalize(self, _unlink_unless, name, self._handed)

    @property
    def nbytes(self) -> int:
        return int(sum(a.nbytes for a in self))

    def __reduce__(self):
        if self.name is None:
            return (list, (list(self),))
        self._handed["v"] = True
        return (_attach, (self.name, self.layout))


def _unlink_unless(name: str, handed: dict) -> None:
    if not handed["v"]:
        _unlink(name)


def _unlink(name: str) -> None:
    try:
        os.unlink(os.path.join(_DIR, name))
    except FileNotFoundError:
        pass


def _views(mm: mmap.mmap, layout: Layout) -> list:
    return [np.frombuffer(mm, dtype=np.dtype(dt), count=n, offset=off)
            for off, dt, n in layout]


def _host_dtype(leaf) -> np.dtype:
    from ray_tpu_torch.train.collective import _np_dtype
    return _np_dtype(leaf)


def stage(leaves: Sequence) -> MirrorLeaves:
    """One flat copy of each leaf (numpy, jax or torch on any device; a
    sub-32-bit float tensor widened to f32) in a new shared-memory
    segment: the copies are the snapshot, taken once, so later updates
    of the live leaves never reach them."""
    from ray_tpu_torch.dag.ring import _numel, _tensor_type
    layout: Layout = []
    off = 0
    for leaf in leaves:
        dt = _host_dtype(leaf)
        n = _numel(leaf)
        layout.append((off, dt.str, n))
        off += (n * dt.itemsize + _ALIGN - 1) // _ALIGN * _ALIGN
    name = f"rtt-mirror-{uuid.uuid4().hex[:20]}"
    path = os.path.join(_DIR, name)
    fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
    try:
        os.ftruncate(fd, max(off, 1))
        mm = mmap.mmap(fd, max(off, 1),
                       flags=mmap.MAP_SHARED | _POPULATE)
    except BaseException:
        os.close(fd)
        _unlink(name)
        raise
    os.close(fd)
    out = MirrorLeaves(_views(mm, layout), name, layout)
    t_type = _tensor_type()
    for dst, leaf in zip(out, leaves):
        if t_type is not None and isinstance(leaf, t_type):
            import torch
            torch.from_numpy(dst).copy_(leaf.detach().reshape(-1))
        else:
            np.copyto(dst, np.asarray(leaf).reshape(-1), casting="same_kind")
    return out


def _attach(name: str, layout: Layout) -> MirrorLeaves:
    """The successor's side of the crossing: map the segment read-only
    and unlink its name. The arrays keep the mapping alive."""
    path = os.path.join(_DIR, name)
    fd = os.open(path, os.O_RDONLY)
    try:
        mm = mmap.mmap(fd, os.fstat(fd).st_size, prot=mmap.PROT_READ)
    finally:
        os.close(fd)
    _unlink(name)
    return MirrorLeaves(_views(mm, layout), None, layout)


def discard(name: Optional[str]) -> None:
    """Unlink a posted segment its successor has not taken (a no-op once
    it has)."""
    if name:
        _unlink(name)
