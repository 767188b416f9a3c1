"""Train user-facing API: configs, per-worker context, report().

The port's copy of ``ray_tpu/train/api.py``: ``ScalingConfig`` gains
``use_gpu`` and bootstraps ``torch.distributed`` (``torch_distributed``,
``ensure_torch_distributed``) where the JAX package bootstraps
jax.distributed. The controller-wired gradient-sync ring
(``gradient_sync_ring``, dag/ring.py) and the in-place elastic reshape
(``await_regroup``, the peer mirrors of ZeRO shards) are the
reference's.

Reference surface: ScalingConfig (train/v2/api/config.py:31), RunConfig/
FailureConfig/CheckpointConfig (v2/api/config.py), ray.train.report
(v2/api/train_fn_utils.py:23), Checkpoint (train/_checkpoint.py).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, ClassVar, Dict, List, Optional, Tuple, Union


@dataclass
class ScalingConfig:
    """num_workers may be an int or (min, max) for elastic scaling
    (reference: v2/api/config.py:78)."""
    num_workers: Union[int, Tuple[int, int]] = 1
    use_tpu: bool = False
    use_gpu: bool = False                   # one CUDA card per worker
    topology: Optional[str] = None          # e.g. "v5e-32" (pod type)
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"
    # Elastic GROW: how often the running group checks whether new
    # capacity allows more workers, and how long the capacity must be
    # sustained before paying a restart-from-checkpoint (reference:
    # v2/_internal/execution/scaling_policy/elastic.py:29 resize
    # decisions in both directions). 0 disables grow checks.
    elastic_grow_interval_s: float = 5.0
    # Elastic SHRINK without restart: on worker loss the controller
    # re-forms the surviving ranks into an N-1 ring (fresh incarnation
    # id) and the train_fn reshards ZeRO optimizer state over it
    # (train/reshard.py) instead of the group restarting from the last
    # disk checkpoint. Requires an elastic num_workers range, survivors
    # >= min_workers, and no torch.distributed world (a process group
    # cannot shrink in place — those groups keep the restart path).
    elastic_reshard: bool = True
    # Ring timeout for the controller-wired gradient-sync ring. Also
    # bounds how long a survivor can stay blocked on a dead neighbor
    # before surfacing PeerLostError when the controller has NOT yet
    # aborted the ring (the rewire abort usually cuts this to ~0.25 s).
    sync_timeout_s: float = 300.0
    # Whether the controller runs torch.distributed's
    # init_process_group on every worker before train_fn starts (the
    # counterpart of the JAX package's jax_distributed, reference:
    # _JaxBackend.on_start at v2/jax/config.py:96-124). "auto" = only
    # for multi-worker GPU groups; True forces it (e.g. multi-process
    # gloo groups on the CPU); False leaves bootstrap to the env route
    # (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE) / train_fn.
    torch_distributed: Union[bool, str] = "auto"

    def __post_init__(self):
        if isinstance(self.torch_distributed, str) and \
                self.torch_distributed != "auto":
            raise ValueError(
                f"torch_distributed must be True, False or 'auto', got "
                f"{self.torch_distributed!r}")

    def wants_torch_distributed(self) -> bool:
        if self.torch_distributed == "auto":
            return self.use_gpu and self.max_workers > 1
        return bool(self.torch_distributed)

    def worker_resources(self) -> Dict[str, float]:
        if self.resources_per_worker:
            return dict(self.resources_per_worker)
        if self.use_tpu:
            from ray_tpu_torch.util import tpu as tpu_util
            cph = (tpu_util.chips_per_host(self.topology)
                   if self.topology else
                   max(1, tpu_util.num_tpu_chips_on_host()))
            return {"TPU": float(cph)}
        if self.use_gpu:
            return {"GPU": 1.0}
        return {"CPU": 1.0}

    @property
    def min_workers(self) -> int:
        if isinstance(self.num_workers, tuple):
            return self.num_workers[0]
        return self.num_workers

    @property
    def max_workers(self) -> int:
        if isinstance(self.num_workers, tuple):
            return self.num_workers[1]
        return self.num_workers

    @property
    def elastic(self) -> bool:
        return isinstance(self.num_workers, tuple)


@dataclass
class FailureConfig:
    """Retry budget for worker-group failures (reference:
    v2/_internal/execution/failure_handling/default.py:24).

    ``reset_after_clean_reports``: after this many consecutive clean
    reports (no failure in between), the consumed failure count resets
    to zero — a week-long job with rare preemptions spends its budget
    per incident burst, not cumulatively over its whole life. 0 keeps
    the budget strictly cumulative."""
    max_failures: int = 0
    reset_after_clean_reports: int = 0


@dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"


@dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(
        default_factory=CheckpointConfig)


@dataclass
class Checkpoint:
    """A directory handle on shared OR remote storage (reference:
    train/_checkpoint.py; storage at train/_internal/storage.py — the
    reference accepts any pyarrow-filesystem URI the same way).

    ``path`` is either a local directory or a storage URI
    (memory://..., gs://... — util/storage.py). ``as_directory()``
    always returns a local directory, downloading once per process for
    remote checkpoints.

    ``managed`` marks a checkpoint the durable checkpoint plane
    (train/ckptio.py) already persisted and pointer-committed:
    ``report()`` must register it with the controller WITHOUT
    re-uploading or re-writing the resume pointer — the plane's
    two-phase commit already made it durable, and a second pointer
    write could move the pointer BACKWARD past a newer commit."""
    path: str
    metrics: Dict[str, Any] = field(default_factory=dict)
    managed: bool = False

    # per-PROCESS download memo: a machine-global cache would serve
    # stale content when a reused URI's data changes across runs
    _downloads: ClassVar[Dict[str, str]] = {}

    def as_directory(self) -> str:
        """Local directory with the checkpoint contents. Remote URIs
        download once per process (URIs are assumed write-once — reuse
        a name with different bytes and the first download wins)."""
        from ray_tpu_torch.util import storage as _st
        if not _st.is_remote(self.path):
            return self.path
        cached = Checkpoint._downloads.get(self.path)
        if cached is not None and os.path.isdir(cached):
            return cached
        import atexit
        import shutil
        import tempfile
        import time as _time
        st, root = _st.get_storage(self.path)
        # brief grace for an in-flight rank-0 upload (the .complete
        # marker is written last); proceed after it for compatibility
        # with checkpoints persisted before markers existed
        for _ in range(20):
            if st.exists(f"{root}/.complete"):
                break
            _time.sleep(0.1)
        tmp = tempfile.mkdtemp(prefix="rt_ckpt_")
        atexit.register(shutil.rmtree, tmp, ignore_errors=True)
        n = st.download_dir(root, tmp)
        if n == 0:
            raise FileNotFoundError(
                f"checkpoint {self.path} is empty or missing in storage")
        Checkpoint._downloads[self.path] = tmp
        return tmp

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path=os.path.abspath(path))


@dataclass
class Result:
    metrics: Dict[str, Any]
    checkpoint: Optional[Checkpoint]
    metrics_history: List[Dict[str, Any]]
    error: Optional[BaseException] = None


class TrainContext:
    """Per-worker context, created by the worker actor before train_fn runs
    (reference: v2 TrainContext / train.get_context)."""

    def __init__(self, rank: int, world_size: int, local_rank: int,
                 node_rank: int, resume_checkpoint: Optional[Checkpoint],
                 dataset_shards: Optional[Dict[str, Any]] = None,
                 storage_path: Optional[str] = None,
                 group_id: str = "",
                 grad_sync: Optional[dict] = None,
                 mirror_peer: Any = None):
        self.rank = rank
        self.world_size = world_size
        self.local_rank = local_rank
        self.node_rank = node_rank
        # Controller-assigned generation id, unique per worker-group
        # incarnation: namespaces rendezvous keys so a restarted group never
        # observes barrier arrivals / broadcast values from the previous
        # incarnation via the long-lived __train_rendezvous actor.
        self.group_id = group_id
        self._resume = resume_checkpoint
        self._reports: "queue.Queue" = queue.Queue()
        self._seq = 0
        self._dataset_shards = dataset_shards or {}
        self._storage_path = storage_path
        # Controller-built ring channel spec for host-plane gradient
        # sync (train.allreduce_gradients): rank r -> rank (r+1)%N over
        # shm (same node) / TCP (cross node). Attached lazily — groups
        # that never allreduce host gradients pay nothing.
        self._grad_sync = grad_sync
        self._grad_ring = None
        # Train-step tag for collective tracing: bumped once per
        # completed gradient sync (an allreduce, or the allgather half
        # closing a reduce-scatter/allgather pair), stamped onto the
        # ring's spans so timeline lanes and straggler rows say WHICH
        # step a slow round belongs to.
        self.collective_step = 0
        # --- elastic reshape state (controller-driven; see
        # await_regroup) ---
        # generation bumps once per in-place rewire, so stale cached
        # group objects (optimizer rings) can detect they predate the
        # current incarnation.
        self.generation = 0
        self._regroup_evt = threading.Event()
        self._rewire_payload: Optional[dict] = None
        # Ring-successor worker actor handle: the in-memory
        # peer-checkpoint target this rank mirrors its ZeRO shard to
        # (train/zero.py mirror_interval_steps). None for world 1.
        self._mirror_peer = mirror_peer
        # The last mirror this rank posted: the call's result ref (see
        # wait_mirror) and the name of its blob's shared-memory segment,
        # unlinked when a newer mirror replaces it (train/mirror.py).
        self._mirror_ref = None
        self._mirror_name: Optional[str] = None
        # Mirror blobs of LOST ranks this worker must contribute to the
        # next reshard collective (assigned by the controller's rewire).
        self._recovered_mirrors: list = []
        self._lost_info: dict = {}
        # Pipeline-parallel group id: the controller's reshape gate
        # reads it off poll() (a pipeline cannot re-form in place
        # around a lost stage). Nothing sets it until the pipelines
        # are ported (ROADMAP.md, Queue 1 item 13c).
        self.pipeline_group: Optional[str] = None

    # -- elastic reshape ---------------------------------------------------

    def apply_rewire(self, payload: dict) -> None:
        """Called on the WORKER ACTOR thread when the controller
        re-forms the group around a lost worker: stash the new identity
        and wake await_regroup(). The in-flight collective (if any) is
        aborted so a survivor blocked on the dead neighbor surfaces
        PeerLostError in ~0.25 s instead of the full ring timeout."""
        self._rewire_payload = payload
        ring = self._grad_ring
        if ring is not None:
            try:
                ring.abort()
            except Exception:   # noqa: BLE001 — wake-up is best-effort
                pass
        self._regroup_evt.set()

    def await_regroup(self, timeout_s: Optional[float] = None) -> dict:
        """Block until the controller has re-formed the group, then
        swap in the new incarnation: rank, world size, generation id,
        gradient-sync ring spec, and mirror assignments. The elastic
        recovery entrypoint for train_fns::

            try:
                params, state = opt.update(grads, state, params)
            except train.PeerLostError:
                info = train.await_regroup(timeout_s=60)
                state = opt.reshard(state)
                continue            # retry the interrupted step

        Raises TimeoutError when no rewire arrives in ``timeout_s``
        (the controller chose a full restart instead — let the error
        propagate so the restart path takes over)."""
        # clear BEFORE consuming the payload: a second rewire landing
        # between read and clear would have its wakeup erased (payload
        # stashed, event cleared) and the next await_regroup would
        # block its full timeout despite a pending rewire. The inverse
        # race — event still set with the payload already consumed —
        # is a spurious wakeup; loop back to the wait.
        deadline = None if timeout_s is None \
            else time.monotonic() + timeout_s
        while True:
            left = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            if not self._regroup_evt.wait(left):
                raise TimeoutError(
                    "no group rewire arrived within "
                    f"{timeout_s}s (controller restarting instead?)")
            self._regroup_evt.clear()
            payload, self._rewire_payload = self._rewire_payload, None
            if payload is not None:
                break
        # the old ring's channels belong to the dead incarnation
        self.close_gradient_sync()
        self.rank = int(payload["rank"])
        self.world_size = int(payload["world_size"])
        self.group_id = payload["group_id"]
        self._grad_sync = payload.get("grad_sync")
        self._mirror_peer = payload.get("mirror_peer")
        self._recovered_mirrors = list(payload.get("recovered") or [])
        self._lost_info = dict(payload.get("lost") or {})
        self.generation += 1
        # any error-feedback residual was accumulated against the old
        # incarnation's wire: drop it here so the next compensated
        # round starts provably zeroed even if a caller bypasses the
        # (group_id, generation) rekey (train/collective.ErrorFeedback)
        self._grad_ef = None
        return {"rank": self.rank, "world_size": self.world_size,
                "generation": self.generation,
                "group_id": self.group_id,
                "lost": dict(self._lost_info)}

    def mirror_shard(self, blob: dict) -> bool:
        """Ship one in-memory peer-checkpoint blob to this rank's ring
        successor, fire-and-forget (an actor call posted off the step
        path; mirroring is best-effort — a miss only means a fallback
        to checkpoint restore if THIS rank's segment is lost later).
        A blob's leaves that live in a shared-memory segment
        (train/mirror.py) cross as the segment's name; the previous
        posted segment is unlinked here, since the newest mirror
        replaces it in the successor's store."""
        peer = self._mirror_peer
        if peer is None:
            return False
        try:
            ref = peer.store_mirror.remote(
                self.group_id, self.rank, int(blob.get("step", 0)), blob)
        except Exception:   # noqa: BLE001 — best-effort by contract
            return False
        from ray_tpu_torch.train import mirror
        mirror.discard(self._mirror_name)
        self._mirror_ref = ref
        self._mirror_name = getattr(blob.get("leaves"), "name", None)
        return True

    def wait_mirror(self, timeout_s: Optional[float] = None) -> bool:
        """Block until the last posted mirror has landed in the ring
        successor's store: True once it did, False when none was
        posted or the call failed or timed out. A rank about to leave
        the group on purpose calls this so its newest shard is not
        lost with it."""
        ref = self._mirror_ref
        if ref is None:
            return False
        import ray_tpu_torch
        try:
            return bool(ray_tpu_torch.get(ref, timeout=timeout_s))
        except Exception:   # noqa: BLE001 — a failed mirror is a miss
            return False

    def close_mirror(self) -> None:
        """Unlink this rank's last posted mirror segment if its
        successor never took it (train_fn end: the group is done)."""
        from ray_tpu_torch.train import mirror
        mirror.discard(self._mirror_name)
        self._mirror_name = None

    def take_recovered_mirrors(self) -> list:
        """Mirror blobs of lost ranks assigned to this worker for the
        next reshard collective (consumed once)."""
        out, self._recovered_mirrors = self._recovered_mirrors, []
        return out

    def lost_info(self) -> dict:
        """The last rewire's lost-rank records ({old_rank: {old_rank,
        old_size, holder}}): ``holder`` None means no surviving
        in-memory mirror of that rank's shard exists anywhere — a
        sharded optimizer must refuse to reshard (the segment would
        materialize as zeros) and let the restart path recover."""
        return dict(self._lost_info)

    # -- user API --
    def get_world_size(self) -> int:
        return self.world_size

    def get_world_rank(self) -> int:
        return self.rank

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_node_rank(self) -> int:
        return self.node_rank

    def get_checkpoint(self) -> Optional[Checkpoint]:
        return self._resume

    def gradient_sync_ring(self):
        """The lazily-attached chunked ring for host-plane gradient
        allreduce across the group (dag/ring.py RingReducer, or its
        ring-of-rings HierarchicalReducer); raises when the controller
        didn't wire one (world_size == 1 groups short-circuit in
        allreduce_gradients before reaching here)."""
        if self._grad_ring is None:
            if self._grad_sync is None:
                raise RuntimeError(
                    "host-plane gradient sync is not wired for this "
                    "worker group (controller predates it, or "
                    "world_size == 1)")
            from ray_tpu_torch.dag.ring import (HierarchicalReducer,
                                                RingReducer)
            cls = HierarchicalReducer \
                if self._grad_sync.get("role") == "hier" else RingReducer
            # a rewire landing while this thread is still INSIDE the
            # attach has no ring to abort() — the regroup event is the
            # only signal that can reach it, so the blocking attach
            # wait polls it and bails instead of waiting out the sync
            # timeout against a dead incarnation's specs
            self._grad_ring = cls.from_spec(
                self._grad_sync, abort=self._regroup_evt.is_set)
        return self._grad_ring

    def close_gradient_sync(self) -> None:
        """Release the ring's channels (worker teardown; shm segments
        must not outlive the group incarnation that named them)."""
        ring, self._grad_ring = self._grad_ring, None
        if ring is not None:
            ring.close()

    def shard_bounds(self, total: int,
                     rank: Optional[int] = None) -> Tuple[int, int]:
        """The (lo, hi) slice of a flat length-``total`` parameter
        space owned by ``rank`` (default: this worker) under the
        collective plane's contiguous N-way split — exactly the shard
        ``reduce_scatter_gradients`` returns and ``allgather_params``
        expects, and the slice a ZeRO-1 ``ShardedOptimizer`` keeps
        moments for. Ownership follows the controller's shard map in
        the ring spec (the ``own`` rotation, identity by default);
        world_size == 1 owns everything."""
        n = self.world_size
        r = self.rank if rank is None else int(rank)
        if not 0 <= r < n:
            raise ValueError(f"rank {r} out of range for {n} workers")
        if n == 1:
            return 0, total
        gs = self._grad_sync or {}
        if gs.get("role") == "hier":
            # two-level topology: ownership follows the NESTED split
            # (inter split by node, intra split of the node segment —
            # dag/ring.py hier_seg_bounds), which is what the wired
            # HierarchicalReducer's reduce-scatter actually hands out
            from ray_tpu_torch.dag.ring import hier_seg_bounds
            return hier_seg_bounds(total, gs["nodes"], r)
        own_self = gs.get("own", self.rank)
        seg = (r + (own_self - self.rank)) % n
        return total * seg // n, total * (seg + 1) // n

    def get_dataset_shard(self, name: str = "train"):
        shard = self._dataset_shards.get(name)
        if shard is None:
            raise KeyError(f"no dataset shard named {name!r}")
        return shard

    def trace_step(self, name: str = "train_step"):
        """Context manager tracing ONE training step as a request-plane
        trace: mints a root trace context (or joins the ambient one),
        binds it so nested task submissions join, and records a root
        span tagged with the CURRENT ``collective_step`` — the same tag
        the ring tracer stamps on this step's collective rounds, so
        ``ray-tpu trace <id>`` pulls the step's ring lanes into the
        waterfall next to the step span. Usage::

            with ctx.trace_step() as trace_id:
                grads = compute(...)
                params, state = opt.update(grads, state, params)
        """
        import contextlib

        from ray_tpu_torch.util import devmon, goodput, tracing

        @contextlib.contextmanager
        def _span():
            # the step span doubles as the goodput ledger's step
            # window: subsystems (ring wait, ckpt stall, compile,
            # stamped compute) attribute into it, step_end pins the
            # sum-to-wall identity. Re-entrant, so a nested
            # trace_step depth-counts instead of opening a new row.
            goodput.step_begin(self.collective_step, rank=self.rank)
            # join the ambient trace as a CHILD span (nested
            # trace_step, or a step opened inside a traced request);
            # only the outermost mint is the trace's root
            ambient = tracing.current_context()
            if ambient is not None:
                tctx = tracing.TraceContext(ambient.trace_id,
                                            tracing.new_span_id())
                parent, root = ambient.span_id, False
            else:
                tctx = tracing.mint_context()
                parent, root = "", True
            if tctx is None:            # request tracing disabled —
                # the duty-cycle window still records (devmon has its
                # own RAY_TPU_DEVMON switch; tracing off must not
                # silently zero the train plane's duty signal)
                t0 = time.time()
                try:
                    yield None
                finally:
                    devmon.record_device_window(name, t0, time.time())
                    goodput.step_end()
                return
            tok = tracing.set_request_context(tctx)
            step = self.collective_step
            t0, ok = time.time(), False
            try:
                yield tctx.trace_id
                ok = True
            finally:
                tracing.reset_request_context(tok)
                # the step interval doubles as a duty window for
                # util/devmon.py. NOTE: unlike engine prefill/decode
                # windows (block_until_ready-bounded), a step window
                # includes the step's HOST work — it is an UPPER bound
                # on device time; a duty of ~1.0 here means "steps
                # back-to-back", not necessarily "MXU busy".
                devmon.record_device_window(name, t0, time.time(),
                                            trace=tctx.trace_id)
                extra = {}
                if root:
                    # the outermost step span IS the trace's root —
                    # train-step traces are few and hand-opened, so
                    # they always surface (unlike serve QPS, which
                    # the proxy tail-samples)
                    extra.update(root=True, keep="train",
                                 status="ok" if ok else "error")
                tracing.record_request_span(
                    "train", name, tctx, parent, t0, time.time(),
                    span_id=tctx.span_id, error=not ok,
                    step=step, rank=self.rank, **extra)
                goodput.step_end()
        return _span()

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None) -> None:
        self._seq += 1
        if checkpoint is not None and getattr(checkpoint, "managed",
                                              False):
            # ckptio-managed checkpoints are ALREADY durable (shards +
            # manifest + pointer, committed by the plane's two-phase
            # protocol) — re-persisting here would be wasted bytes at
            # best and a pointer regression at worst
            pass
        elif checkpoint is not None and self._storage_path:
            # Durable BEFORE report() returns: a crash right after report
            # must not lose the checkpoint (reference: report() persists to
            # storage synchronously — train/_internal/storage.py).
            import json
            from ray_tpu_torch.util import storage as _st
            if _st.is_remote(self._storage_path):
                # Remote storage (memory:// kv:// gs://): upload the
                # checkpoint dir, then report the remote URI — the
                # local dir on this (ephemeral) machine is not the
                # durable copy (reference: storage.py persist_...).
                # Rank 0 uploads; other ranks report the same URI
                # without re-shipping identical bytes (N uploads of one
                # checkpoint, racing per-file, would both waste the
                # head's bandwidth and risk torn mixes).
                # NOTE: multi-HOST sharded checkpoints should report
                # per-rank distinct names (or checkpoint via a library
                # like orbax that writes shared storage directly) —
                # rank 0's directory is what becomes durable here.
                name = os.path.basename(checkpoint.path.rstrip("/"))
                uri = f"{self._storage_path.rstrip('/')}/{name}"
                if self.rank == 0:
                    st, root = _st.get_storage(self._storage_path)
                    st.upload_dir(checkpoint.path, f"{root}/{name}")
                    # marker LAST: readers treat its absence as
                    # "upload in flight", not a torn checkpoint
                    st.put_bytes(f"{root}/{name}/.complete", b"1")
                    st.put_bytes(
                        f"{root}/_latest_checkpoint.json",
                        json.dumps({"path": uri,
                                    "metrics": dict(metrics)}).encode())
                checkpoint = Checkpoint(path=uri,
                                        metrics=dict(checkpoint.metrics))
            else:
                # Atomic AND durable (tmp + fsync + rename + dir
                # fsync, util/storage.py): a crash mid-write must
                # leave the previous pointer intact, and a crash
                # right after the rename must not evaporate the new
                # one — the resume pointer is the restart path's
                # single source of truth.
                _st.atomic_write_json(
                    os.path.join(self._storage_path,
                                 "_latest_checkpoint.json"),
                    {"path": checkpoint.path,
                     "metrics": dict(metrics)})
        self._reports.put({"seq": self._seq, "metrics": dict(metrics),
                           "checkpoint": checkpoint})

    # -- controller side --
    def drain_reports(self) -> List[dict]:
        out = []
        while True:
            try:
                out.append(self._reports.get_nowait())
            except queue.Empty:
                return out


_context = threading.local()


def set_context(ctx: Optional[TrainContext]) -> None:
    _context.value = ctx


def get_context() -> TrainContext:
    ctx = getattr(_context, "value", None)
    if ctx is None:
        raise RuntimeError("ray_tpu_torch.train.get_context() outside a train_fn")
    return ctx


def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    """Report metrics (+ optional checkpoint) from inside train_fn
    (reference: v2/api/train_fn_utils.py:23)."""
    get_context().report(metrics, checkpoint)


def get_dataset_shard(name: str = "train"):
    return get_context().get_dataset_shard(name)


def await_regroup(timeout_s: Optional[float] = None) -> dict:
    """Block until the controller re-forms the worker group after a
    peer loss (elastic reshape), then adopt the new rank/world size —
    see TrainContext.await_regroup for the recovery loop idiom."""
    return get_context().await_regroup(timeout_s)


def torch_distributed_initialized() -> bool:
    """True once this process has joined a torch.distributed world."""
    import sys
    dist = sys.modules.get("torch.distributed")
    return dist is not None and dist.is_available() \
        and dist.is_initialized()


def ensure_torch_distributed() -> bool:
    """Join the torch.distributed world from the controller-provided env
    (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, torchrun's names) if
    this process hasn't already: NCCL when the process sees a CUDA
    card, gloo otherwise. The controller runs it itself for multi-worker
    GPU groups (see ScalingConfig.torch_distributed), so a train_fn
    calling this is a no-op there; on torch_distributed=False groups it
    is the opt-in bootstrap. Returns True if distributed is active."""
    if torch_distributed_initialized():
        return True
    if not os.environ.get("MASTER_ADDR"):
        return False
    missing = [k for k in ("MASTER_PORT", "RANK", "WORLD_SIZE")
               if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"MASTER_ADDR is set but {missing} are not — the "
            f"torch.distributed env route needs all four")
    import torch
    import torch.distributed as dist
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend,
        init_method=f"tcp://{os.environ['MASTER_ADDR']}:"
                    f"{os.environ['MASTER_PORT']}",
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]))
    return True

