"""Out-of-jit collectives for host values: allreduce/allgather/barrier.

Analog of the reference's `ray.util.collective` (reference:
python/ray/util/collective/collective.py — its NCCL/GLOO groups), scoped
correctly for TPU: TENSOR collectives belong to XLA over ICI inside jit
(psum/all_gather in ray_tpu_torch.parallel); this module covers the
control-plane cases the reference's gloo group served — averaging host
metrics, exchanging small numpy state, rendezvous — via a named actor.

    g = CollectiveGroup("trainers", rank=r, world_size=w)
    avg = g.allreduce(np.array([loss]), op="mean")
    all_stats = g.allgather({"rank": r})
    g.barrier()

The port's copy of ``ray_tpu/util/collective.py``, unchanged but for
import paths.
"""

from __future__ import annotations

import time
import uuid
from typing import Any, List

import numpy as np

import ray_tpu_torch


class _GroupActor:
    """Runs at max_concurrency=1: actor-serialized calls are the
    synchronization — contribute/fetch never interleave, so the
    last-arriver reduce is race-free without locks."""

    def __init__(self):
        self._contrib: dict = {}   # (seq) -> {rank: value}
        self._result: dict = {}    # (seq) -> reduced value
        self._fetched: dict = {}   # (seq) -> set of ranks that read it

    def contribute(self, seq: str, rank: int, world: int, value,
                   op: str):
        slot = self._contrib.setdefault(seq, {})
        slot[rank] = value
        if len(slot) < world:
            return False
        vals = [slot[r] for r in sorted(slot)]
        if op == "gather":
            out = vals
        else:
            acc = np.asarray(vals[0], dtype=np.float64)
            for v in vals[1:]:
                a = np.asarray(v, dtype=np.float64)
                if op in ("sum", "mean"):
                    acc = acc + a
                elif op == "max":
                    acc = np.maximum(acc, a)
                elif op == "min":
                    acc = np.minimum(acc, a)
                else:
                    raise ValueError(f"unknown op {op!r}")
            if op == "mean":
                acc = acc / world
            out = acc
        self._result[seq] = out
        del self._contrib[seq]
        return True

    def fetch(self, seq: str, rank: int, world: int):
        if seq in self._result:
            out = self._result[seq]
            got = self._fetched.setdefault(seq, set())
            got.add(rank)
            if len(got) >= world:
                # every rank has read it — free the entry so long-lived
                # groups don't grow the detached actor unboundedly
                del self._result[seq]
                del self._fetched[seq]
            return ("ok", out)
        return ("pending", None)


class CollectiveGroup:
    """world_size ranks synchronizing through one named actor. Every
    rank must call the same collectives in the same order."""

    def __init__(self, name: str, rank: int, world_size: int,
                 generation: str = "0"):
        self.name = name
        self.rank = int(rank)
        self.world_size = int(world_size)
        self._n = 0
        # generation disambiguates reuse of a group name across runs —
        # a restarted rank re-joining with a fresh call counter must not
        # be satisfied by the previous incarnation's cached results.
        # Pass a fresh value (e.g. a controller-assigned attempt id) on
        # every (re)start of the group; "0" is only safe when the group
        # name itself is unique per run.
        self._gen = generation
        actor_name = f"__collective_{name}"
        try:
            self._actor = ray_tpu_torch.get_actor(actor_name)
        except ValueError:
            self._actor = ray_tpu_torch.remote(_GroupActor).options(
                name=actor_name, get_if_exists=True,
                lifetime="detached").remote()

    def _seq(self, kind: str) -> str:
        self._n += 1
        return f"{self._gen}:{kind}:{self._n}"

    def _run(self, kind: str, value, op: str, timeout: float):
        seq = self._seq(kind)
        ray_tpu_torch.get(self._actor.contribute.remote(
            seq, self.rank, self.world_size, value, op), timeout=timeout)
        deadline = time.monotonic() + timeout
        delay = 0.005
        while time.monotonic() < deadline:
            status, out = ray_tpu_torch.get(
                self._actor.fetch.remote(seq, self.rank,
                                         self.world_size),
                timeout=timeout)
            if status == "ok":
                return out
            time.sleep(delay)
            delay = min(delay * 2, 0.1)
        raise TimeoutError(
            f"collective {seq} on group {self.name!r} timed out "
            f"({self.world_size} ranks expected)")

    # --- API -----------------------------------------------------------

    def allreduce(self, value, op: str = "sum",
                  timeout: float = 120.0) -> np.ndarray:
        """Elementwise reduction of numpy-compatible values across all
        ranks. op: sum | mean | max | min."""
        if op not in ("sum", "mean", "max", "min"):
            # validate client-side: a bad op discovered only by the
            # last arriver would strand every other rank until timeout
            raise ValueError(f"unknown op {op!r}")
        return np.asarray(self._run("ar", np.asarray(value), op,
                                    timeout))

    def allgather(self, value: Any, timeout: float = 120.0) -> List[Any]:
        """Every rank's value, ordered by rank."""
        return self._run("ag", value, "gather", timeout)

    def barrier(self, timeout: float = 120.0) -> None:
        self._run("bar", 0, "gather", timeout)

    def broadcast(self, value: Any = None, root: int = 0,
                  timeout: float = 120.0) -> Any:
        """Value from `root` to everyone (other ranks pass None)."""
        return self._run("bc", value, "gather", timeout)[root]


def new_group(name: str = None, *, rank: int, world_size: int
              ) -> CollectiveGroup:
    return CollectiveGroup(name or uuid.uuid4().hex[:8], rank,
                           world_size)
