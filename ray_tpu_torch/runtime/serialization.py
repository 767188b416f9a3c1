"""Serialization: cloudpickle control path + out-of-band zero-copy buffers.

The analog of the reference's SerializationContext + pickle5 out-of-band
support (reference: python/ray/_private/serialization.py): values are
pickled with protocol 5; large contiguous buffers (numpy arrays, CPU
torch tensors, bytes) are split out so the object plane can place them in
shared memory without a copy, and readers can map them back zero-copy.
A CPU tensor travels as its bytes, dtype and shape (``_reduce_tensor``),
so bfloat16, which numpy lacks, crosses as itself. As under torch's own
reduce with ``pickle``, one tensor object pickled twice arrives as one
object, while distinct tensors that share a storage (views of one
buffer) arrive as independent copies.
"""

from __future__ import annotations

import copyreg
import io
import pickle
import sys
from dataclasses import dataclass
from typing import Any, Callable, List, Optional

import cloudpickle

# Buffers >= this ride out-of-band; smaller ones stay inline in the pickle.
OOB_THRESHOLD = 8 * 1024


@dataclass
class Serialized:
    """A serialized value: a pickle stream + out-of-band buffers."""
    inband: bytes
    buffers: List[memoryview]

    @property
    def total_bytes(self) -> int:
        return len(self.inband) + sum(b.nbytes for b in self.buffers)

    @property
    def frame_nbytes(self) -> int:
        """Exact size of the to_bytes()/write_into() frame."""
        n = 1 + len(self.buffers)
        return 4 + 8 * n + len(self.inband) + sum(
            b.nbytes for b in self.buffers)

    def write_into(self, dst) -> int:
        """Write the frame directly into a writable buffer (e.g. a
        shared-memory mapping) with one memcpy per chunk via numpy —
        bytearray slice-assignment from a memoryview is >10x slower than
        np copies on this path, and an intermediate bytes() would double
        the traffic."""
        import struct

        import numpy as np
        lens = [len(self.inband)] + [b.nbytes for b in self.buffers]
        head = struct.pack(f"<I{len(lens)}Q", len(lens), *lens)
        out = np.frombuffer(dst, dtype=np.uint8)
        off = 0
        for chunk in (head, self.inband, *self.buffers):
            mv = memoryview(chunk)
            if mv.ndim != 1 or mv.format != "B":
                mv = mv.cast("B")
            n = mv.nbytes
            if n:
                out[off:off + n] = np.frombuffer(mv, dtype=np.uint8)
            off += n
        del out  # release the exported view so the shm segment can close
        return off

    def to_bytes(self) -> bytes:
        """Flatten to one contiguous frame: [n][len0..lenN][inband][bufs]."""
        out = bytearray(self.frame_nbytes)
        self.write_into(out)
        return bytes(out)

    @classmethod
    def from_buffer(cls, buf) -> "Serialized":
        """Zero-copy parse of a to_bytes() frame (buf: bytes/memoryview)."""
        import struct
        mv = memoryview(buf)
        (n,) = struct.unpack_from("<I", mv, 0)
        lens = struct.unpack_from(f"<{n}Q", mv, 4)
        off = 4 + 8 * n
        inband = bytes(mv[off:off + lens[0]])
        off += lens[0]
        buffers = []
        for ln in lens[1:]:
            buffers.append(mv[off:off + ln])
            off += ln
        return cls(inband, buffers)


def _rebuild_tensor(buf, dtype: str, shape: tuple):
    """A CPU tensor from ``buf`` (the frame's out-of-band buffer, or the
    in-band bytes of a small one), viewed as ``dtype``. torch has no
    read-only tensors, so a read-only buffer (a sealed object in the
    node's shared memory, a stored ``bytes`` frame) is copied once: a
    tensor over it would let an in-place op overwrite the object for
    every later reader. A writable buffer (a ring slot read with
    ``compile(zero_copy=True)``) is viewed without a copy."""
    import torch
    mv = memoryview(buf).cast("B")
    if not mv.nbytes:
        flat = torch.empty(0, dtype=torch.uint8)
    else:
        flat = torch.frombuffer(bytearray(mv) if mv.readonly else mv,
                                dtype=torch.uint8)
    return flat.view(getattr(torch, dtype)).reshape(shape)


def _reduce_tensor(t):
    """Pickle a plain CPU tensor as its bytes (a PickleBuffer, so a large
    one rides out of band like a numpy array, with no copy into the
    pickle stream) plus its dtype and shape; bf16 keeps its dtype. Any
    other tensor (on a card, requiring grad, a subclass, sparse,
    quantized, with a conj/neg bit) keeps torch's own reduce."""
    import torch
    if t.device.type != "cpu" or t.layout != torch.strided or \
            t.requires_grad or t.is_quantized or t.is_conj() or \
            t.is_neg():
        return t.__reduce_ex__(pickle.HIGHEST_PROTOCOL)
    flat = t.contiguous().reshape(-1).view(torch.uint8).numpy()
    return (_rebuild_tensor,
            (pickle.PickleBuffer(flat), str(t.dtype).split(".")[-1],
             tuple(t.shape)))


class _TensorDispatch:
    """A pickler's dispatch table: copyreg's, with ``_reduce_tensor`` for
    ``torch.Tensor`` (the exact type, so subclasses such as parameters
    keep torch's reduce). Read per pickled type; nothing is copied."""

    def __init__(self, tensor_t):
        self.tensor_t = tensor_t

    def __getitem__(self, cls):
        if cls is self.tensor_t:
            return _reduce_tensor
        return copyreg.dispatch_table[cls]


_DISPATCH: Optional[_TensorDispatch] = None


def _pickle_dumps(value: Any, buffer_callback) -> bytes:
    """``pickle.dumps(protocol 5)``; once this process has loaded torch,
    through a pickler whose dispatch table sends plain CPU tensors out of
    band (``_reduce_tensor``). The table is this pickler's own, so
    torch.save and every other pickler keep torch's reduce."""
    global _DISPATCH
    if _DISPATCH is None:
        torch = sys.modules.get("torch")
        if torch is None:
            return pickle.dumps(value, protocol=5,
                                buffer_callback=buffer_callback)
        _DISPATCH = _TensorDispatch(torch.Tensor)
    f = io.BytesIO()
    p = pickle.Pickler(f, protocol=5, buffer_callback=buffer_callback)
    p.dispatch_table = _DISPATCH
    p.dump(value)
    return f.getvalue()


def serialize(value: Any) -> Serialized:
    """C-pickler fast path with a cloudpickle fallback. Plain data
    (ints, strings, dicts, numpy arrays — the overwhelming majority of
    task args/results) pickles several times faster through the stdlib
    C pickler than through cloudpickle's Python-level dispatch. Two
    cases still need cloudpickle: values the C pickler refuses
    (lambdas, closures, locally-defined classes), and values it pickles
    BY REFERENCE into the driver's ``__main__`` — the receiving worker
    has a different __main__, so those must ship by value. The latter
    is detected by scanning the (small) payload for the module name —
    a false positive merely pays the cloudpickle price."""
    buffers: List[memoryview] = []

    def buffer_callback(pb: pickle.PickleBuffer):
        mv = pb.raw()
        if mv.nbytes < OOB_THRESHOLD:
            return True  # keep small buffers inband
        buffers.append(mv)
        return False

    try:
        inband = _pickle_dumps(value, buffer_callback)
        # b"_main__" covers both __main__ and __mp_main__ (the main
        # module's name in multiprocessing-spawned drivers; cloudpickle
        # by-values both)
        if b"_main__" not in inband:
            return Serialized(inband, buffers)
    except Exception:  # noqa: BLE001 — C pickler refused; go rich
        pass
    buffers.clear()
    inband = cloudpickle.dumps(value, protocol=5,
                               buffer_callback=buffer_callback)
    return Serialized(inband, buffers)


def deserialize(s: Serialized) -> Any:
    return pickle.loads(s.inband, buffers=[memoryview(b) for b in s.buffers])


def dumps_oob(value: Any) -> bytes:
    return serialize(value).to_bytes()


def loads_oob(data) -> Any:
    return deserialize(Serialized.from_buffer(data))


# --- function registry -----------------------------------------------------
# Task functions are pickled once per (function, process) and cached by
# content digest, so hot-loop submissions ship a 16-byte key instead of the
# closure (reference ships a function table in GCS:
# python/ray/_private/function_manager.py).

class FunctionCache:
    def __init__(self):
        self._by_fn: dict = {}
        self._by_digest: dict = {}
        self._payloads: dict = {}

    def digest_for(self, fn: Callable) -> bytes:
        key = id(fn)
        hit = self._by_fn.get(key)
        if hit is not None:
            return hit
        import hashlib
        payload = cloudpickle.dumps(fn, protocol=5)
        digest = hashlib.blake2b(payload, digest_size=16).digest()
        self._by_fn[key] = digest
        self._by_digest[digest] = fn
        self._payloads[digest] = payload
        return digest

    def payload_for(self, digest: bytes) -> bytes:
        return self._payloads[digest]

    def resolve(self, digest: bytes, payload: Optional[bytes]) -> Callable:
        fn = self._by_digest.get(digest)
        if fn is None:
            if payload is None:
                raise KeyError(f"unknown function digest {digest.hex()}")
            fn = pickle.loads(payload)
            self._by_digest[digest] = fn
        return fn

    def has(self, digest: bytes) -> bool:
        return digest in self._by_digest
