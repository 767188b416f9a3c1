"""A 3 -> 2 elastic reshape of ZeRO-1 state in one process, one thread per
rank, driven through the port's train plane only (no jax, no optax, no
ray_tpu): ``tests/test_torch_elastic.py`` holds its results and
``tests/test_torch_isolation.py`` runs it in a fresh process.

Three ``TrainContext``s over a ring of lazy shm edges (the specs the
controller builds) each run ``ShardedOptimizer(ShardAdamW(device="cpu"))``
for a few updates, each rank mirroring its shard to its ring successor
through a stand-in actor handle: the blob crosses by pickle, as an actor
call carries it, so the successor maps the shared-memory segment. Rank 2
is then lost: the survivors get the controller's rewire payload (rank 0
holds rank 2's mirror and contributes it), ``await_regroup``, and
``reshard`` their state over a fresh 2-ring.
"""

import pickle
import threading
import uuid
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ray_tpu_torch import train
from ray_tpu_torch.parallel import ShardAdamW, default_optimizer
from ray_tpu_torch.train.api import TrainContext, set_context
from ray_tpu_torch.train.zero import ShardedOptimizer

SIZES = ((7, 5), (11,), (3, 3, 2))      # 64 elements: uneven shards
STEPS = 2


class Peer:
    """Stands in for the successor's worker actor: ``store_mirror.remote``
    pickles the blob as the runtime would and keeps the latest per
    (group, rank), as ``TrainWorker.store_mirror`` does."""

    def __init__(self):
        self.store = {}
        self.lock = threading.Lock()
        peer = self

        class _Method:
            @staticmethod
            def remote(gid, rank, step, blob):
                got = pickle.loads(pickle.dumps(blob))
                with peer.lock:
                    peer.store[(gid, int(rank))] = got
                return True
        self.store_mirror = _Method


def ring_specs(n: int, gid: str, timeout_s: float = 30.0) -> list:
    edges = [{"name": f"rtgs-{gid[:12]}-{r}", "nslots": 4,
              "slot_bytes": 1 << 16, "lazy": True} for r in range(n)]
    return [{"rank": r, "size": n, "op": "mean", "timeout_s": timeout_s,
             "own": r, "tune": False, "group": gid[:12],
             "to_next": edges[r], "from_prev": edges[(r - 1) % n]}
            for r in range(n)]


def params(seed: int = 0) -> list:
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g) for s in SIZES]


def grads(step: int, rank: int) -> list:
    g = torch.Generator().manual_seed(1000 + 10 * step + rank)
    return [torch.randn(s, generator=g) for s in SIZES]


def _all(fns):
    with ThreadPoolExecutor(len(fns)) as ex:
        futs = [ex.submit(f) for f in fns]
        return [f.result(timeout=60) for f in futs]


def reshape_3_to_2(mirror: bool = True):
    """Returns ``(old, new)``: the three ranks' ShardAdamW states after
    STEPS updates, and the two survivors' states after ``reshard`` (an
    exception a survivor's reshard raised is returned in its place)."""
    gid0, gid1 = uuid.uuid4().hex, uuid.uuid4().hex
    peers = [Peer() for _ in range(3)]
    specs = ring_specs(3, gid0)
    ctxs = [TrainContext(r, 3, r, 0, None, group_id=gid0,
                         grad_sync=specs[r],
                         mirror_peer=peers[(r + 1) % 3]) for r in range(3)]
    opts = [ShardedOptimizer(
        ShardAdamW(default_optimizer(1e-2, warmup_steps=1,
                                     total_steps=10), device="cpu"),
        mirror_interval_steps=1 if mirror else 0) for _ in range(3)]

    def run(r):
        set_context(ctxs[r])
        p = params()
        state = opts[r].init(p)
        for step in range(STEPS):
            p, state = opts[r].update(grads(step, r), state, p)
        return state

    try:
        old = _all([lambda r=r: run(r) for r in range(3)])
    finally:
        for c in ctxs:
            c.close_gradient_sync()
    specs2 = ring_specs(2, gid1)
    held = peers[0].store.get((gid0, 2))
    lost = {2: {"old_rank": 2, "old_size": 3, "old_nodes": None,
                "holder": 0 if held is not None else None}}
    for j in range(2):
        ctxs[j].apply_rewire({
            "rank": j, "world_size": 2, "group_id": gid1,
            "grad_sync": specs2[j], "lost": lost,
            "recovered": [held] if j == 0 and held is not None else [],
            "mirror_peer": peers[1 - j]})

    def regroup(j):
        set_context(ctxs[j])
        train.await_regroup(timeout_s=10)
        try:
            return opts[j].reshard(old[j])
        except Exception as e:   # noqa: BLE001 — the caller checks it
            return e

    try:
        new = _all([lambda j=j: regroup(j) for j in range(2)])
    finally:
        for c in ctxs[:2]:
            c.close_gradient_sync()
    return old, new


def check_bitwise(old, new) -> None:
    """The survivors' new shards, concatenated, are bitwise the old
    three: f32 moments on the CPU, the update count untouched."""
    for name in ("mu", "nu"):
        got = torch.cat([getattr(s, name) for s in new])
        want = torch.cat([getattr(s, name) for s in old])
        assert all(getattr(s, name).dtype == torch.float32
                   and getattr(s, name).device.type == "cpu" for s in new)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert [s.count for s in new] == [STEPS, STEPS]
    assert sum(int(np.prod(s)) for s in SIZES) == \
        sum(s.mu.numel() for s in new)
