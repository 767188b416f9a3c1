"""Binary IDs for cluster entities.

Equivalent of the reference's ID types (reference: src/ray/common/id.h) —
fixed-width random identifiers with cheap hashing and hex rendering.
"""

from __future__ import annotations

import os


class BaseID:
    SIZE = 16
    __slots__ = ("_bin",)

    def __init__(self, binary: bytes):
        if len(binary) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} needs {self.SIZE} bytes, "
                f"got {len(binary)}")
        self._bin = binary

    @classmethod
    def generate(cls):
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def from_hex(cls, h: str):
        return cls(bytes.fromhex(h))

    @classmethod
    def nil(cls):
        return cls(b"\x00" * cls.SIZE)

    def binary(self) -> bytes:
        return self._bin

    def hex(self) -> str:
        return self._bin.hex()

    def is_nil(self) -> bool:
        return self._bin == b"\x00" * self.SIZE

    def __hash__(self):
        return hash((type(self).__name__, self._bin))

    def __eq__(self, other):
        return type(other) is type(self) and other._bin == self._bin

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()[:12]})"

    # IDs travel inside pickled messages constantly; keep them tiny.
    def __reduce__(self):
        return (type(self), (self._bin,))


class NodeID(BaseID):
    pass


class WorkerID(BaseID):
    pass


class JobID(BaseID):
    SIZE = 8


class TaskID(BaseID):
    pass


class ObjectID(BaseID):
    pass


class ActorID(BaseID):
    pass


class PlacementGroupID(BaseID):
    pass
