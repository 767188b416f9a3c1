"""Train worker actor: hosts the user's train_fn on one host of the group.

The port's copy of ``ray_tpu/train/worker.py``: the group joins a
torch.distributed world (``init_torch_distributed``) where the JAX
package's joins jax.distributed, and hands its TrainContext the
controller's gradient-sync ring spec and its ring successor (the peer
that stores this rank's ZeRO shard mirrors); the peer-mirror store and
the in-place rewire of the elastic reshape are the reference's, and so
are the forensics poll summary and dump. Like every
runtime worker, it imports no device package until the train_fn does.

Reference: v2/_internal/execution/worker_group/worker.py + thread_runner.py
— the train_fn runs on a thread inside the actor so the actor stays
responsive to poll/report/health calls (our actor runs methods with
max_concurrency > 1 for the same reason).
"""

from __future__ import annotations

import os
import socket
import threading
import traceback
from typing import Any, Dict, Optional

import cloudpickle

from ray_tpu_torch.train.api import Checkpoint, TrainContext, set_context


def _goodput_anatomy():
    """This rank's rolling step anatomy for poll() — never raises
    (poll is the liveness probe; observability must not break it)."""
    try:
        from ray_tpu_torch.util import goodput
        return goodput.anatomy()
    except Exception:   # noqa: BLE001
        return None


def _forensics_summary():
    """In-flight collective rows for poll() — never raises, tiny
    (full ledgers only move on an explicit forensics_dump pull)."""
    try:
        from ray_tpu_torch.util import forensics
        return forensics.poll_summary()
    except Exception:   # noqa: BLE001
        return None


def _card_of(local_rank: int) -> str:
    """The card a worker of ``local_rank`` owns: the local_rank-th entry
    of the node's CUDA_VISIBLE_DEVICES, or card ``local_rank`` when the
    node sets none. Refuses once this process has initialised CUDA,
    because the driver reads CUDA_VISIBLE_DEVICES only at that point."""
    import sys
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        raise RuntimeError(
            "CUDA is already initialised in this worker: it can no "
            "longer be pinned to its own card")
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    if vis is None:
        return str(local_rank)
    cards = [c.strip() for c in vis.split(",") if c.strip()]
    if local_rank >= len(cards):
        raise RuntimeError(
            f"worker of local rank {local_rank} has no card of its own: "
            f"CUDA_VISIBLE_DEVICES={vis!r}")
    return cards[local_rank]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class TrainWorker:
    """One per host in the worker group (SPMD: one process per host, all
    chips on the host belong to it — the JAX process model)."""

    def __init__(self, rank: int, world_size: int, local_rank: int = 0,
                 node_rank: Optional[int] = None):
        self.rank = rank
        self.world_size = world_size
        self.local_rank = local_rank
        self.node_rank = node_rank if node_rank is not None else rank
        self.ctx: Optional[TrainContext] = None
        self._thread: Optional[threading.Thread] = None
        self._result: Any = None
        self._error: Optional[str] = None
        self._done = threading.Event()
        self._group_id = ""
        # In-memory peer-checkpoint store: ring predecessors mirror
        # their ZeRO shard snapshots here ((group_id, from_rank) ->
        # blob, latest wins) so a lost rank's segment is
        # reconstructable WITHOUT touching storage (the controller
        # reads the inventory off poll() and assigns contributions at
        # rewire time). A blob's leaves are this process's mapping of
        # the shared-memory segment the predecessor staged them into
        # (train/mirror.py), so they outlive the predecessor.
        self._mirrors: dict = {}

    def get_address(self) -> Dict[str, Any]:
        return {"host": socket.gethostbyname(socket.gethostname()),
                "port": _free_port(), "pid": os.getpid(),
                "node_id": os.environ.get("RAY_TPU_NODE_ID", "")}

    def set_rank(self, rank: int, node_rank: Optional[int] = None) -> bool:
        """Final rank assignment AFTER topology sort (the controller orders
        workers by (node, pid) so ranks are ICI-contiguous; the provisional
        constructor rank is positional only)."""
        self.rank = rank
        self.node_rank = node_rank if node_rank is not None else rank
        return True

    def setup_env(self, env: Dict[str, str], use_gpu: bool = False) -> bool:
        """Distributed bootstrap env, set BEFORE train_fn imports torch:
        torchrun's MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE and
        LOCAL_RANK, which ``init_process_group`` reads (the counterpart
        of the JAX package's JAX_COORDINATOR_ADDRESS route). A
        ``use_gpu`` worker is pinned to its own card: CUDA_VISIBLE_DEVICES
        becomes the LOCAL_RANK-th card this process may see, so its
        ``cuda`` (device 0) is that card and no two workers of a host
        share one."""
        os.environ.update(env)
        if use_gpu:
            os.environ["CUDA_VISIBLE_DEVICES"] = _card_of(
                int(env["LOCAL_RANK"]))
        return True

    def init_torch_distributed(self) -> bool:
        """Explicit ``torch.distributed.init_process_group`` (the
        multi-process path): joins the rank-0 store and blocks until the
        whole group is present (reference: v2/jax/config.py:96-107
        on_start, with jax.distributed in place of torch's)."""
        from ray_tpu_torch.train import api as train_api

        # Idempotent: a no-op if the train_fn (or a prior call) already
        # joined — init_process_group raises on double-init.
        return train_api.ensure_torch_distributed()

    def start_train_fn(self, fn_payload: bytes,
                       train_loop_config: Optional[dict],
                       resume_checkpoint: Optional[Checkpoint],
                       dataset_shards: Optional[dict] = None,
                       storage_path: Optional[str] = None,
                       group_id: str = "",
                       grad_sync: Optional[dict] = None,
                       mirror_peer: Any = None) -> bool:
        fn = cloudpickle.loads(fn_payload)
        self._group_id = group_id
        self._mirrors.clear()       # a fresh incarnation starts clean
        self.ctx = TrainContext(
            rank=self.rank, world_size=self.world_size,
            local_rank=self.local_rank, node_rank=self.node_rank,
            resume_checkpoint=resume_checkpoint,
            dataset_shards=dataset_shards,
            storage_path=storage_path,
            group_id=group_id,
            grad_sync=grad_sync,
            mirror_peer=mirror_peer)

        def run():
            set_context(self.ctx)
            from ray_tpu_torch.util import forensics, goodput
            goodput.set_rank(self.rank)
            forensics.set_rank(self.rank)
            forensics.set_meta(group_id=group_id)
            try:
                if train_loop_config is not None:
                    self._result = fn(train_loop_config)
                else:
                    self._result = fn()
            except BaseException as e:  # noqa: BLE001
                self._error = "".join(traceback.format_exception(e))
            finally:
                # gradient-sync ring channels must not outlive the
                # train_fn — a restarted incarnation wires fresh ones
                try:
                    self.ctx.close_gradient_sync()
                except Exception:
                    pass
                self.ctx.close_mirror()
                self._done.set()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return True

    def poll(self) -> Dict[str, Any]:
        """Drain new reports + running state (reference:
        worker_group.py:609 poll_status). ``mirrors`` is this worker's
        peer-checkpoint inventory for the CURRENT incarnation
        ({mirrored_rank: step}) — the controller's reshape decision
        reads it to know which lost segments have a surviving copy."""
        from ray_tpu_torch.train import ckptio
        reports = self.ctx.drain_reports() if self.ctx else []
        mirrors = {r: int(blob.get("step", 0))
                   for (gid, r), blob in list(self._mirrors.items())
                   if gid == self._group_id}
        return {"done": self._done.is_set(), "error": self._error,
                "reports": reports, "rank": self.rank,
                "mirrors": mirrors,
                # advance preemption notice: this process received
                # SIGTERM and is inside its grace window
                # (runtime/worker.py routes the signal through
                # ckptio.fire_preemption) — the controller recovers
                # proactively instead of treating the coming death
                # as a crash
                "preempted": ckptio.preempted(),
                # rolling step-anatomy summary (util/goodput.py): p50
                # per category over the window — the controller's
                # straggler detector compares these across the ring
                "goodput": _goodput_anatomy(),
                # pipeline-topology flag: the controller's reshape gate
                # must NOT re-form a ring around a lost pipeline stage
                # (its parameters exist nowhere else — restart instead)
                "pipeline": bool(self.ctx.pipeline_group)
                if self.ctx else False,
                # in-flight collective descriptors + per-group issue
                # counters (util/forensics.py): the stall watchdog's
                # cheap signal — the controller only pulls full
                # ledgers (forensics_dump) when one of these ages
                # past forensics_stall_timeout_s
                "forensics": _forensics_summary()}

    def forensics_dump(self) -> Dict[str, Any]:
        """Everything this worker contributes to a postmortem bundle:
        full collective ledger, thread stacks, goodput rows, HBM
        snapshot, registered engine state (util/forensics.local_dump).
        Runs on the actor thread, so it works while the train_fn
        thread is parked inside a hung collective — that is the whole
        point."""
        from ray_tpu_torch.util import forensics
        return forensics.local_dump()

    # --- elastic reshape -------------------------------------------------

    def store_mirror(self, group_id: str, from_rank: int, step: int,
                     blob: dict) -> bool:
        """Accept a ring predecessor's in-memory shard snapshot
        (latest per (incarnation, rank) wins — there is no history to
        keep, the newest mirror is strictly the best recovery)."""
        self._mirrors[(group_id, int(from_rank))] = blob
        return True

    def rewire(self, payload: dict) -> bool:
        """Adopt a reshaped incarnation IN PLACE: new rank / world
        size / gradient-sync spec, plus the mirror blobs of lost ranks
        this worker was assigned to contribute to the reshard
        collective. Returns False when an assigned mirror is missing
        (inventory raced a restart) — the controller falls back to a
        full checkpoint-restore restart."""
        if self.ctx is None:
            return False
        old_gid = payload.get("old_group_id", "")
        recovered = []
        for d in payload.get("contribute", ()):
            blob = self._mirrors.get((old_gid, int(d)))
            if blob is None:
                return False
            recovered.append(blob)
        payload = dict(payload, recovered=recovered)
        self.rank = int(payload["rank"])
        self.world_size = int(payload["world_size"])
        self._group_id = payload["group_id"]
        # prune mirror generations nobody can recover from anymore
        # (older than the incarnation being recovered right now)
        keep = {old_gid, self._group_id}
        self._mirrors = {k: v for k, v in self._mirrors.items()
                         if k[0] in keep}
        self.ctx.apply_rewire(payload)
        return True

    def join(self) -> Dict[str, Any]:
        self._done.wait()
        return self.poll()

    def shutdown(self) -> bool:
        return True
