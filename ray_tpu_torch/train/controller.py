"""Train controller: worker-group lifecycle state machine.

The port's copy of ``ray_tpu/train/controller.py``: the bootstrap sets
torchrun's env and joins torch.distributed (``_bootstrap_distributed``);
restart-from-checkpoint, elastic grow, preemption recovery and the
goodput straggler detector are the JAX package's, and so is the
gradient-sync ring spec each worker's TrainContext attaches
(``_grad_sync_specs``: a flat ring, or a ring-of-rings across nodes),
and so is the in-place N-1 reshape on a worker loss (``_plan_reshape``,
``_reshape``: the survivors re-form the ring and reshard their ZeRO
state from the peer mirrors, each rank's ring successor holding its
mirror). The forensics audit of the survivors and its stall watchdog
wait for ROADMAP.md's Queue 1 item 17.

Reference: v2/_internal/execution/controller/controller.py:105
(TrainController.run), worker_group/worker_group.py:113 (create on a
placement group, rank-sorted), scaling_policy/{fixed,elastic}.py,
failure_handling/default.py:24. The loop: decide group size → gang-reserve
→ spawn rank-ordered workers → distributed bootstrap → run train_fn →
poll → on failure consult the policy (restart whole group from the latest
checkpoint, resize if elastic) → finish.
"""

from __future__ import annotations

import re
import time
from typing import Any, Callable, Dict, List, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch import api
from ray_tpu_torch.train.api import (Checkpoint, FailureConfig, Result, RunConfig,
                               ScalingConfig)
from ray_tpu_torch.train.checkpoint import CheckpointManager
from ray_tpu_torch.train.worker import TrainWorker
from ray_tpu_torch.util import events


def train_metrics() -> dict:
    """Get-or-create the controller's elasticity series (process-global
    registry, head-aggregated like every other pushed metric).

      train_restarts_total  group recoveries, tagged kind=reshard
                            (in-place N-1 re-form) | restart (teardown
                            + restore from the latest checkpoint) |
                            preempt (advance-notice preemption —
                            either flavor, budget-free)
      train_lost_steps      reports lost by the LAST recovery: 0 for a
                            reshard (survivors keep live state),
                            reports-since-last-checkpoint for a restore
    """
    from ray_tpu_torch.util import metrics as m
    return {
        "restarts": m.Counter(
            "train_restarts_total",
            "Worker-group recoveries performed by the train "
            "controller, tagged kind=reshard (elastic in-place "
            "re-form at N-1), kind=restart (full teardown + "
            "checkpoint restore), or kind=preempt (advance-notice "
            "preemption recovery — reshape or restore, without "
            "consuming the failure budget)",
            tag_keys=("kind",)),
        "lost_steps": m.Gauge(
            "train_lost_steps",
            "Progress reports lost by the last recovery: 0 when the "
            "group resharded in place (survivors keep live state), "
            "else the reports since the last registered checkpoint "
            "that the restore will replay"),
    }


_FLIGHT_RE = re.compile(r"\[collective flight recorder: ([^\]\s]+)\]")


def _flight_path(err: BaseException) -> Optional[str]:
    """The collective flight-recorder dump path riding a failure, when
    one was written: the attribute for in-process errors, else fished
    out of the relayed traceback text (worker errors reach the
    controller as strings)."""
    p = getattr(err, "flight_recorder_path", None)
    if p:
        return str(p)
    m = _FLIGHT_RE.search(str(err))
    return m.group(1) if m else None


class TrainGroupError(RuntimeError):
    pass


class _ResizeRequested(Exception):
    """Internal: the elastic policy wants a different group size; the
    run loop restarts from the latest checkpoint WITHOUT consuming a
    failure budget (a resize is not a failure)."""

    def __init__(self, target: int):
        super().__init__(f"elastic resize to {target} workers")
        self.target = target


class _PreemptRestart(Exception):
    """Internal: every lost rank had ADVANCE preemption notice (its
    SIGTERM grace window flushed a final checkpoint / mirrored its
    shard) and no in-place reshape is possible — restart from the
    latest checkpoint WITHOUT consuming the failure budget.
    Preemption with notice is scheduled capacity loss, not a fault
    of the job (run() still guards against a notice loop that never
    makes progress)."""

    def __init__(self, cause: BaseException):
        super().__init__(f"preemption restart: {cause}")
        self.cause = cause


class TrainController:
    def __init__(self, train_fn: Callable,
                 scaling: ScalingConfig,
                 run_config: RunConfig,
                 train_loop_config: Optional[dict] = None,
                 datasets: Optional[dict] = None):
        self.train_fn_payload = cloudpickle.dumps(train_fn, protocol=5)
        self.scaling = scaling
        self.run_config = run_config
        self.train_loop_config = train_loop_config
        self.datasets = datasets or {}
        self.ckpt_manager = CheckpointManager(
            run_config.storage_path, run_config.checkpoint_config)
        self.metrics_history: List[Dict[str, Any]] = []
        self._workers: List = []
        self._pg = None
        self._stop_requested = False
        self._m = train_metrics()
        self._group_id = ""
        self._failures = 0            # consumed failure budget
        self._clean_reports = 0       # reports since the last failure
        # ranks that reported preemption notice (SIGTERM grace window
        # running — train/ckptio.py preempted() off poll()) -> the
        # monotonic deadline after which the controller recovers
        # PROACTIVELY instead of waiting out a 60 s poll timeout on a
        # dying worker
        self._preempt_notice: Dict[int, float] = {}
        # True between a budget-free preemption restart and the first
        # report after it: a SECOND preemption restart with no
        # progress in between stops being free (a notice loop on a
        # flapping machine must not restart forever)
        self._preempt_unvalidated = False
        # True between a reshape and the first report of the reshaped
        # incarnation: a failure in that window is the SAME incident
        # (the reshard didn't take — e.g. no mirrors to rebuild from,
        # or a train_fn with no await_regroup loop), so the follow-up
        # restart must not consume a second failure-budget unit
        self._reshape_unvalidated = False
        self._reports_since_ckpt = 0  # the restore path's replay cost
        # last seen peer-checkpoint inventory per CURRENT rank index
        # ({mirrored_rank: step}) — the reshape decision reads it
        self._last_mirrors: Dict[int, Dict[int, int]] = {}
        # ranks that reported an active pipeline-parallel group on
        # their last poll — the reshape gate reads it (a pipeline
        # cannot shrink in place)
        self._last_pipeline: Dict[int, bool] = {}

    # --- scaling policy (reference: scaling_policy/fixed.py, elastic.py) ---

    def _decide_num_workers(self) -> int:
        want = self.scaling.max_workers
        if not self.scaling.elastic:
            return want
        res = self.scaling.worker_resources()
        key = next((k for k in ("TPU", "GPU") if k in res), "CPU")
        per = res.get(key, 1.0)
        total = ray_tpu_torch.available_resources().get(key, 0.0)
        feasible = int(total // per) if per else want
        n = max(self.scaling.min_workers, min(want, feasible))
        return n

    def _grow_target(self) -> Optional[int]:
        """While a group runs: can spare capacity host MORE workers?
        Returns the larger world size, or None. The running group's own
        resources are leased, so `available` counts only headroom
        (reference: elastic.py resizes up when the cluster grows)."""
        if not self.scaling.elastic:
            return None
        current = len(self._workers)
        if current >= self.scaling.max_workers:
            return None
        res = self.scaling.worker_resources()
        try:
            avail = ray_tpu_torch.available_resources()
        except Exception:
            return None
        # headroom must satisfy EVERY resource the worker needs — a
        # TPU-rich/CPU-starved cluster must not trigger a restart the
        # new placement group can never place
        extra = min(
            (int(avail.get(k, 0.0) // v) for k, v in res.items() if v),
            default=0)
        target = min(self.scaling.max_workers, current + extra)
        return target if target > current else None

    # --- group lifecycle ---

    def _create_group(self, num_workers: int):
        res = self.scaling.worker_resources()
        bundles = [dict(res) for _ in range(num_workers)]
        strategy = ("STRICT_SPREAD" if self.scaling.use_tpu
                    else self.scaling.placement_strategy)
        self._pg = api.placement_group(bundles, strategy=strategy)
        if not self._pg.ready(timeout=120):
            raise TrainGroupError(
                f"placement group for {num_workers} workers "
                f"({res} each) not schedulable")
        WorkerActor = ray_tpu_torch.remote(TrainWorker)
        self._workers = [
            WorkerActor.options(
                resources={k: v for k, v in res.items()},
                placement_group=self._pg,
                placement_group_bundle_index=i,
                max_concurrency=4,
            ).remote(rank=i, world_size=num_workers)
            for i in range(num_workers)
        ]
        # Rank-by-topology: reference sorts workers by TPU pod / node id
        # (worker_group.py:790,866) so ranks are ICI-contiguous. Ranks are
        # re-assigned post-sort so list position == world rank everywhere.
        infos = ray_tpu_torch.get(
            [w.get_address.remote() for w in self._workers], timeout=120)
        order = sorted(range(num_workers),
                       key=lambda i: (infos[i]["node_id"], infos[i]["pid"]))
        self._workers = [self._workers[i] for i in order]
        self._infos = [infos[i] for i in order]
        ray_tpu_torch.get([w.set_rank.remote(i)
                     for i, w in enumerate(self._workers)], timeout=60)
        return infos

    def _bootstrap_distributed(self, num_workers: int):
        """Set torchrun's env on every worker (MASTER_ADDR/MASTER_PORT
        at rank 0's address, RANK, WORLD_SIZE, LOCAL_RANK), where the JAX
        package sets jax.distributed's (reference: _JaxBackend.on_start,
        v2/jax/config.py:96-124)."""
        coord = self._infos[0]
        sets = []
        for rank, w in enumerate(self._workers):
            env = {
                "MASTER_ADDR": coord["host"],
                "MASTER_PORT": str(coord["port"]),
                "RANK": str(rank),
                "WORLD_SIZE": str(num_workers),
                "LOCAL_RANK": str(sum(
                    1 for i in range(rank)
                    if self._infos[i]["node_id"] ==
                    self._infos[rank]["node_id"])),
            }
            if self.scaling.use_tpu and self.scaling.topology:
                env["TPU_ACCELERATOR_TYPE"] = self.scaling.topology
            sets.append(w.setup_env.remote(env, self.scaling.use_gpu))
        ray_tpu_torch.get(sets, timeout=60)
        # Execute the actual multi-process handshake when the group spans
        # processes: every worker calls init_process_group and blocks
        # until the whole group (rank 0's store first) is present — so
        # the calls MUST be issued in parallel and rank 0 must be among
        # them (reference: v2/jax/config.py:96-107 on_start).
        if self.scaling.wants_torch_distributed():
            oks = ray_tpu_torch.get(
                [w.init_torch_distributed.remote() for w in self._workers],
                timeout=300)
            if not all(oks):
                # A False means that worker saw no MASTER_ADDR and formed
                # no world — wrong world size with locally-truncated
                # collectives. Fail fast.
                raise TrainGroupError(
                    f"torch.distributed bootstrap incomplete: {oks}")

    def _recover_latest_checkpoint(self):
        """Restart path: recover the durably-persisted latest
        checkpoint pointer (written by report() / the ckptio commit
        coordinator before a crash), speaking BOTH formats: a legacy
        directory pointer, and a ckptio manifest checkpoint
        (train/ckptio.py). Tolerant by construction — a corrupt,
        empty, or missing pointer, or a pointer naming a torn/partial
        checkpoint, falls back to scanning storage for the newest
        COMPLETE manifest checkpoint (else a clean start). It never
        raises for bad checkpoint CONTENT; only an unreachable remote
        storage backend still surfaces loudly (a transient transport
        error must not silently restart training from step 0)."""
        import json
        import os
        sp = self.run_config.storage_path
        if not sp:
            return
        from ray_tpu_torch.train import ckptio
        from ray_tpu_torch.util import storage as _st
        data = None
        if _st.is_remote(sp):
            last = None
            raw = None
            for attempt in range(3):
                try:
                    st, root = _st.get_storage(sp)
                    raw = st.get_bytes(f"{root}/_latest_checkpoint.json")
                    last = None
                    break
                except Exception as e:  # noqa: BLE001 — retried
                    last = e
                    import time
                    time.sleep(0.5 * (attempt + 1))
            if last is not None:
                raise RuntimeError(
                    f"cannot read checkpoint pointer from {sp}: "
                    f"{last}") from last
            if raw is not None:
                try:
                    data = json.loads(raw)
                except Exception:   # noqa: BLE001 — torn pointer
                    data = None     # fall back to the manifest scan
        else:
            try:
                with open(os.path.join(
                        sp, "_latest_checkpoint.json")) as f:
                    data = json.load(f)
            except Exception:       # noqa: BLE001 — missing/corrupt
                data = None
        path = data.get("path") if isinstance(data, dict) else None
        resolved = None
        metrics: dict = {}
        # deep (re-hash) validation when ckpt_verify_hash: a shard
        # bit-rotted AFTER commit would otherwise pass the existence
        # check here, then fail every rank's restore() hash check —
        # and the restart loop would re-resolve the same corrupt
        # checkpoint until the failure budget dies, never reaching
        # the older complete one the scan below would have found
        from ray_tpu_torch.config import get_config
        deep = bool(getattr(get_config(), "ckpt_verify_hash", True))
        if isinstance(path, str) and path:
            if ckptio.is_manifest_dir(path):
                if ckptio.validate_checkpoint(path, deep=deep):
                    resolved = path
                    metrics = data.get("metrics") or {}
                # else: pointer names a torn/corrupt manifest
                # checkpoint — scan below for an older complete one
                # instead of resuming into a crash loop
            else:
                # legacy directory pointer: trusted as before
                resolved = path
                metrics = data.get("metrics") or {}
        if resolved is None:
            found = ckptio.find_latest_complete(sp, deep=deep)
            if found is not None:
                resolved, man = found
                metrics = dict(
                    (man.get("user_meta") or {}).get("metrics") or {})
        if resolved is None:
            return
        known = {c.path for c in self.ckpt_manager._tracked}
        if resolved not in known:
            self.ckpt_manager.register(
                Checkpoint(path=resolved,
                           managed=ckptio.is_manifest_dir(resolved)),
                metrics)
        self.ckpt_manager.pointer_target = resolved

    def _grad_sync_specs(self, group_id: str):
        """Ring channel specs for host-plane gradient sync
        (train.allreduce_gradients — the dag collective plane's chunked
        ring, dag/ring.py): one directed edge rank r -> rank (r+1)%N.
        Ranks are already topology-sorted (_create_group), so adjacent
        ranks are co-located whenever possible: same-node pairs get a
        lazily-created shm ring (consumer creates at attach), only
        genuinely cross-node pairs pay TCP (endpoint negotiated via the
        control KV). Workers attach lazily on their first allreduce.

        Each spec also carries the incarnation's SHARD MAP: ``own`` is
        the contiguous segment of the flat parameter space this rank
        owns after a reduce-scatter (the ZeRO-1 optimizer-state shard
        — train/zero.py), identity rotation rank->segment today.
        TrainContext.shard_bounds and the ring validate against it, so
        a restarted/resized incarnation re-derives a consistent
        ownership split from its own spec instead of assuming one.

        When the group spans more than one node AND some node hosts
        two or more ranks (and Config.collective_hierarchy allows it),
        the specs describe a TWO-LEVEL topology instead — per-node shm
        intra rings, one TCP ring over the node leaders, intra
        broadcast (dag/ring.py HierarchicalReducer): cross-node wire
        traffic drops to ~1/ranks-per-node, and wire codecs apply on
        the cross-node leg only."""
        n = len(self._workers)
        if n < 2:
            return [None] * n
        from ray_tpu_torch.config import get_config
        from ray_tpu_torch.dag.channel import new_tcp_spec
        cfg = get_config()
        # 4 MB slots (the dag compiler's default): chunk frames are
        # clamped to the slot, and header/error frames (layout sig
        # scales with leaf count) need headroom beyond one chunk
        nslots, slot_bytes = 4, 4 << 20
        tune = bool(getattr(cfg, "collective_tuner", True))
        groups = self._node_groups()
        hier = self._wants_hier(groups)
        if hier:
            return self._hier_sync_specs(group_id, groups, nslots,
                                         slot_bytes, tune)
        edges = []
        for r in range(n):
            if self._infos[r]["node_id"] == \
                    self._infos[(r + 1) % n]["node_id"]:
                edges.append({"name": f"rtgs-{group_id[:12]}-{r}",
                              "nslots": nslots,
                              "slot_bytes": slot_bytes, "lazy": True})
            else:
                edges.append(new_tcp_spec(nslots, slot_bytes))
        return [{"rank": r, "size": n, "op": "mean",
                 "timeout_s": float(self.scaling.sync_timeout_s),
                 "own": r, "tune": tune,
                 # collective spans/flight dumps tag this group id, so
                 # timeline lanes and post-mortems name the incarnation
                 "group": group_id[:12],
                 "to_next": edges[r], "from_prev": edges[(r - 1) % n]}
                for r in range(n)]

    def _node_groups(self) -> List[list]:
        """Contiguous per-node rank grouping [(node_id, [ranks])...]
        of the CURRENT worker list (ranks are topology-sorted, so
        same-node ranks are adjacent)."""
        groups: List[list] = []
        for r in range(len(self._workers)):
            nid = self._infos[r]["node_id"]
            if groups and groups[-1][0] == nid:
                groups[-1][1].append(r)
            else:
                groups.append([nid, [r]])
        return groups

    def _wants_hier(self, groups: List[list]) -> bool:
        """True when _grad_sync_specs would wire the two-level
        topology for this grouping — the ONE condition, shared with
        the reshape path so the recorded old split can't drift from
        the specs that were actually wired."""
        from ray_tpu_torch.config import get_config
        return getattr(get_config(), "collective_hierarchy",
                       "auto") != "flat" \
            and len(self._workers) >= 2 and len(groups) > 1 \
            and max(len(g[1]) for g in groups) > 1

    def _hier_sync_specs(self, group_id: str, groups: List[list],
                         nslots: int, slot_bytes: int,
                         tune: bool) -> List[dict]:
        """Ring-of-rings channel specs via the shared builder
        (dag/ring.py build_hier_specs): one lazy-shm intra ring per
        node (consumer creates at attach, names unique per incarnation
        + node + position), one TCP ring over the first rank of each
        node (the elected leader — leaders are on distinct nodes by
        construction, so every inter edge genuinely crosses nodes).
        The tuner flag rides the INTER sub-ring: that leg owns the
        cross-node wire the auto-tuner exists to optimize."""
        from ray_tpu_torch.dag.channel import new_tcp_spec
        from ray_tpu_torch.dag.ring import build_hier_specs
        gid = group_id[:12]
        return build_hier_specs(
            [len(ranks) for _, ranks in groups],
            lambda i, j: {"name": f"rtgi-{gid}-{i}-{j}",
                          "nslots": nslots,
                          "slot_bytes": slot_bytes, "lazy": True},
            lambda i: new_tcp_spec(nslots, slot_bytes),
            op="mean", timeout_s=float(self.scaling.sync_timeout_s),
            group=gid, tune=tune)

    def _start_train(self):
        self._recover_latest_checkpoint()
        shards = self._split_datasets(len(self._workers))
        # Fresh generation id per group incarnation: restarted groups must
        # not see rendezvous state (barriers/broadcasts) left behind by the
        # previous incarnation in the detached __train_rendezvous actor —
        # and gradient-sync shm segment names must be unique per
        # incarnation so a restarted ring never attaches a stale segment.
        import uuid
        group_id = uuid.uuid4().hex
        self._group_id = group_id
        self._preempt_notice = {}
        self._straggler_det = self._make_straggler_detector()
        self._straggler_last = -1
        self._straggler_since = None   # wall-clock start of the
        #                                current straggler episode
        self._last_mirrors = {}
        self._last_pipeline = {}
        sync = self._grad_sync_specs(group_id)
        refs = []
        n = len(self._workers)
        for i, w in enumerate(self._workers):
            # ring successor = the in-memory peer-checkpoint target
            # (train/zero.py mirror_interval_steps): a lost rank's
            # shard survives on the next rank over
            peer = self._workers[(i + 1) % n] if n > 1 else None
            refs.append(w.start_train_fn.remote(
                self.train_fn_payload, self.train_loop_config,
                self.ckpt_manager.latest, shards[i],
                self.run_config.storage_path, group_id, sync[i],
                peer))
        ray_tpu_torch.get(refs, timeout=120)

    def _split_datasets(self, n: int) -> List[Optional[dict]]:
        if not self.datasets:
            return [None] * n
        per_worker: List[dict] = [dict() for _ in range(n)]
        for name, ds in self.datasets.items():
            if hasattr(ds, "streaming_split"):
                shards = ds.streaming_split(n)
                for i in range(n):
                    per_worker[i][name] = shards[i]
            else:
                for i in range(n):
                    per_worker[i][name] = ds
        return per_worker

    def _teardown_group(self):
        for w in self._workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self._workers = []
        if self._pg is not None:
            try:
                api.remove_placement_group(self._pg)
            except Exception:
                pass
            self._pg = None

    # --- main loop ---

    def stop(self) -> None:
        """Cooperative teardown for an interrupted fit(): flag the run
        loop to exit and release the worker gang + placement group (the
        runtime has no parent-child fate-sharing to do this on kill)."""
        self._stop_requested = True
        self._teardown_group()

    def history(self, cursor: int = 0) -> List[Dict[str, Any]]:
        """Reports from `cursor` on — lets monitors (e.g. tune trials
        streaming to a scheduler) tail the run incrementally."""
        return list(self.metrics_history[cursor:])

    def status(self) -> dict:
        """Live view for external monitors (the controller runs as a
        named actor; see trainer.get_controller)."""
        restarts = self._m["restarts"]._values
        return {
            "reports": len(self.metrics_history),
            "latest_metrics": (self.metrics_history[-1]
                               if self.metrics_history else {}),
            "num_workers": len(self._workers),
            # this controller's group recoveries by kind (its process's
            # train_restarts_total) and the reports the last one lost
            # (train_lost_steps)
            "restarts": {dict(k).get("kind", ""): v
                         for k, v in list(restarts.items())},
            "lost_steps": self._m["lost_steps"]._values.get((), 0.0),
        }

    def run(self) -> Result:
        self._failures = 0
        max_failures = self.run_config.failure_config.max_failures
        resize_to: Optional[int] = None
        while True:
            if self._stop_requested:
                return Result(
                    metrics=(self.metrics_history[-1]
                             if self.metrics_history else {}),
                    checkpoint=self.ckpt_manager.best(),
                    metrics_history=list(self.metrics_history),
                    error=TrainGroupError("stopped"))
            try:
                # A grow decision carries its target explicitly: right
                # after teardown the old group's resources may not have
                # released yet, so re-deriving the size from
                # available_resources() would undershoot (the patient
                # placement group absorbs the release lag instead).
                n = resize_to if resize_to is not None \
                    else self._decide_num_workers()
                resize_to = None
                self._create_group(n)
                self._bootstrap_distributed(n)
                self._start_train()
                self._poll_until_done()
                return Result(
                    metrics=(self.metrics_history[-1]
                             if self.metrics_history else {}),
                    checkpoint=self.ckpt_manager.best(),
                    metrics_history=list(self.metrics_history))
            except _ResizeRequested as rr:
                # elastic grow: not a failure — restart the group at the
                # new size from the latest checkpoint
                self._teardown_group()
                resize_to = rr.target
                continue
            except _PreemptRestart as pr:
                # advance-notice preemption with no reshape available:
                # restart from the latest checkpoint (which includes
                # any grace-window flush that committed) WITHOUT
                # spending the failure budget — unless the LAST
                # recovery was also a preemption restart and nothing
                # reported since (a flapping machine's notice loop
                # must not restart for free forever)
                self._teardown_group()
                if self._preempt_unvalidated:
                    self._failures += 1
                    self._clean_reports = 0
                    if self._failures > max_failures:
                        return Result(
                            metrics=(self.metrics_history[-1]
                                     if self.metrics_history else {}),
                            checkpoint=self.ckpt_manager.best(),
                            metrics_history=list(self.metrics_history),
                            error=pr.cause)
                self._preempt_unvalidated = True
                self._record_recovery(
                    "preempt", pr.cause,
                    lost=self._reports_since_ckpt)
                self._reports_since_ckpt = 0
                continue
            except (api.RayTpuError, TrainGroupError) as e:
                # RayTpuError covers actor death, worker crash, task errors
                # AND placement failures (create_pg raising) — all of them
                # consult the failure policy rather than escaping fit().
                if self._reshape_unvalidated:
                    # the failed reshape already consumed this
                    # incident's unit — escalating to a restart is the
                    # same incident, not a new failure
                    self._reshape_unvalidated = False
                else:
                    self._failures += 1
                self._clean_reports = 0
                self._teardown_group()
                if self._failures > max_failures:
                    # budget exhausted: no recovery is performed, so
                    # train_restarts_total must not count one
                    return Result(
                        metrics=(self.metrics_history[-1]
                                 if self.metrics_history else {}),
                        checkpoint=self.ckpt_manager.best(),
                        metrics_history=list(self.metrics_history),
                        error=e)
                self._record_recovery("restart", e,
                                      lost=self._reports_since_ckpt)
                # the restore replays from the latest checkpoint, so
                # the replay debt is spent — start counting afresh
                self._reports_since_ckpt = 0
                # restart (possibly resized) from the latest checkpoint
                continue
            finally:
                if self._workers:
                    self._teardown_group()

    def _record_recovery(self, kind: str, cause: BaseException,
                         lost: int, dur: float = 0.0,
                         **fields) -> None:
        """Metrics + a budget-capped "train" event span + a log line
        for one group recovery; the collective flight-recorder dump
        path (when the failure wrote one) is stitched onto all three,
        so a restart log names the post-mortem file directly."""
        try:
            self._m["restarts"].inc(tags={"kind": kind})
            self._m["lost_steps"].set(lost)
        except Exception:
            pass
        flight = _flight_path(cause)
        events.record(
            "train", kind, ph="X", ts=time.time() - dur, dur=dur,
            group=self._group_id[:12], failures=self._failures,
            lost_reports=lost, flight=flight,
            error=str(cause)[:400], **fields)
        print(f"[train] group recovery kind={kind} "
              f"failures={self._failures} lost_reports={lost}"
              + (f" flight_recorder={flight}" if flight else "")
              + f": {str(cause)[:200]}")

    def _note_preempted(self, rank: int) -> None:
        """Record one rank's advance preemption notice (the worker's
        SIGTERM grace window is running): after grace + margin the
        controller recovers PROACTIVELY — killing the doomed worker
        and reshaping/restoring — instead of waiting out a 60 s poll
        timeout against a process the machine is about to take."""
        if rank in self._preempt_notice:
            return
        from ray_tpu_torch.config import get_config
        grace = float(getattr(get_config(), "preempt_grace_s", 5.0))
        self._preempt_notice[rank] = time.monotonic() + grace + 1.0
        events.record(
            "train", "preempt_notice", ph="i", ts=time.time(),
            rank=rank, grace_s=grace, group=self._group_id[:12])
        print(f"[train] rank {rank} reported preemption notice "
              f"(grace {grace}s) — will recover proactively")

    def _make_straggler_detector(self):
        """Online straggler detector over the ranks' polled goodput
        anatomies (util/goodput.py): knobs from config, the p50 window
        sized by the same goodput_straggler_window_steps the worker
        ledgers roll over."""
        from ray_tpu_torch.config import get_config
        from ray_tpu_torch.util import goodput
        cfg = get_config()
        win = int(getattr(cfg, "goodput_straggler_window_steps", 32))
        return goodput.StragglerDetector(
            z_threshold=float(getattr(cfg, "goodput_straggler_z",
                                      6.0)),
            min_steps=max(4, win // 4))

    def _note_goodput(self, polls: Dict[int, dict]) -> None:
        """Feed this poll batch's per-rank step anatomies to the
        straggler detector, publish the verdict on the
        goodput_straggler_rank gauge, and record a named-rank
        "goodput"/"straggler" event on each healthy->flagged
        transition (the health plane derives a gauge objective from
        the same metric, so a persistent straggler pages)."""
        det = getattr(self, "_straggler_det", None)
        if det is None:
            return
        try:
            for i, p in polls.items():
                an = p.get("goodput")
                if an:
                    det.observe(int(p.get("rank", i)), an)
            verdict = det.check()
            rank = int(verdict["rank"])
            from ray_tpu_torch.util import goodput
            goodput.goodput_metrics()["straggler"].set(float(rank))
            if rank != self._straggler_last and rank >= 0:
                events.record(
                    "goodput", "straggler", ph="i", ts=time.time(),
                    rank=rank, z=round(float(verdict["z"]), 2),
                    gap_s=round(float(verdict["gap_s"]), 6),
                    group=self._group_id[:12])
                print(f"[train] goodput straggler: rank {rank} p50 "
                      f"anatomy diverges (z={verdict['z']:.1f}, "
                      f"gap={verdict['gap_s'] * 1e3:.1f}ms)")
            self._straggler_last = rank
        except Exception:   # noqa: BLE001 — observability must not
            pass            # break the liveness loop

    def _poll_until_done(self, poll_s: float = 0.2):
        pending = set(range(len(self._workers)))
        grow_iv = self.scaling.elastic_grow_interval_s
        next_grow_check = time.monotonic() + grow_iv
        grow_seen: Optional[int] = None
        while pending:
            order = sorted(pending)
            refs = [self._workers[i].poll.remote() for i in order]
            dead: List[tuple] = []
            polls: Dict[int, dict] = {}
            try:
                results = ray_tpu_torch.get(refs, timeout=60)
                polls = dict(zip(order, results))
            except api.RayTpuError:
                # somebody in the batch died — isolate per worker so
                # the survivors' reports/mirror inventories still land
                # and the reshape path knows exactly who is gone
                for i, ref in zip(order, refs):
                    try:
                        polls[i] = ray_tpu_torch.get(ref, timeout=60)
                    except api.RayTpuError as e:
                        dead.append((i, e))
            if self._stop_requested:
                raise TrainGroupError("stop requested")
            self._note_goodput(polls)
            for i, p in sorted(polls.items()):
                for rep in p["reports"]:
                    self._handle_report(p["rank"], rep)
                if p.get("preempted"):
                    self._note_preempted(i)
                if p["error"]:
                    err = api.TaskError(
                        f"train_fn failed on rank {p['rank']}:\n"
                        f"{p['error']}")
                    if i in self._preempt_notice:
                        # a noticed rank's train_fn error (typically
                        # PeerLostError from a co-preempted peer) is
                        # part of the same scheduled capacity loss —
                        # route it through the dead/preempt_only
                        # accounting below, not the budgeted raise
                        try:
                            ray_tpu_torch.kill(self._workers[i])
                        except Exception:  # noqa: BLE001 — dying
                            pass
                        dead.append((i, err))
                        pending.discard(i)
                        continue
                    raise err
                self._last_mirrors[i] = dict(p.get("mirrors") or {})
                self._last_pipeline[i] = bool(p.get("pipeline"))
                if p["done"]:
                    pending.discard(i)
            # proactive preemption recovery: a noticed rank whose
            # grace window expired is as good as dead — take it down
            # NOW (its final flush already landed or never will) so
            # the reshape/restore starts before the OS reaps it
            dead_ranks = {i for i, _ in dead}
            for i, dl in sorted(self._preempt_notice.items()):
                if i in pending and i not in dead_ranks \
                        and time.monotonic() >= dl:
                    try:
                        ray_tpu_torch.kill(self._workers[i])
                    except Exception:   # noqa: BLE001 — already gone
                        pass
                    dead.append((i, api.TaskError(
                        f"rank {i} preempted (grace window expired)")))
            if dead:
                # every lost rank had advance notice -> this is
                # scheduled capacity loss, not a job fault: recover
                # without consuming the failure budget
                preempt_only = all(i in self._preempt_notice
                                   for i, _ in dead)
                # worker loss: reshape the surviving ranks in place
                # when the elastic policy allows it, else fall through
                # to the restart-from-checkpoint path in run() (the
                # reference's postmortem audit of the survivors waits
                # for the forensics plane, ROADMAP.md Queue 1 item 17)
                plan = self._plan_reshape(dead, pending)
                if plan is not None:
                    pending = self._reshape(plan, dead[0][1],
                                            free=preempt_only)
                    grow_seen = None
                    next_grow_check = time.monotonic() + grow_iv
                    continue
                if preempt_only:
                    raise _PreemptRestart(dead[0][1])
                raise dead[0][1]
            # elastic GROW: capacity that appeared mid-run (autoscaler
            # added a node, another job released one) widens the group.
            # Requires seeing the grow target on two consecutive checks
            # so a transient blip doesn't pay a restart-from-checkpoint.
            if pending and grow_iv > 0 and \
                    time.monotonic() >= next_grow_check:
                next_grow_check = time.monotonic() + grow_iv
                target = self._grow_target()
                if target is not None and target == grow_seen:
                    raise _ResizeRequested(target)
                grow_seen = target
            if pending:
                time.sleep(poll_s)

    # --- elastic reshape (worker loss without restart) -------------------

    def _plan_reshape(self, dead: List[tuple],
                      pending: set) -> Optional[dict]:
        """The in-place N-1 re-form decision AND its inputs, computed
        once: legal when the group is elastic, enough ranks survive,
        no torch.distributed world binds the group shape (a process
        group cannot shrink in place), and — when peer mirroring is
        active — every lost rank's shard has a surviving in-memory
        copy (otherwise a reshard would silently zero state; the
        checkpoint restore is strictly better). Returns None to take
        the restart path, else the plan _reshape() executes verbatim —
        the gate validates the exact assignment the executor ships, so
        the two can't drift."""
        if not (self.scaling.elastic
                and getattr(self.scaling, "elastic_reshard", True)):
            return None
        if self.scaling.wants_torch_distributed():
            return None
        if self.datasets:
            # dataset shards were streaming_split over the OLD world:
            # an in-place re-form would silently drop the dead rank's
            # shard for the rest of the run — the restart path
            # re-splits over the new size, so it is the correct one
            return None
        if any(self._last_pipeline.values()):
            # pipeline-topology group: each rank hosts a DISTINCT
            # stage's parameters, so an in-place N-1 re-form would
            # silently train a model with a stage missing — the
            # checkpoint restart is the only correct recovery
            return None
        dead_ranks = sorted({i for i, _ in dead})
        survivors = [i for i in range(len(self._workers))
                     if i not in dead_ranks]
        if len(survivors) < max(1, self.scaling.min_workers):
            return None
        # EVERY survivor must still be mid-train_fn: a rank whose
        # train_fn already returned would be wired into the new ring
        # but never call await_regroup/attach, hanging the others'
        # reshard collective for the full sync timeout
        if not set(survivors) <= pending:
            return None
        from ray_tpu_torch.train import reshard as _rs
        inventory = {i: self._last_mirrors.get(i, {})
                     for i in survivors}
        assign = _rs.assign_recovery(dead_ranks, inventory)
        if any(inventory.values()) \
                and any(h is None for h in assign.values()):
            return None             # a lost shard has no surviving copy
        return {"dead": dead_ranks, "survivors": survivors,
                "assign": assign}

    def _reshape(self, plan: dict, cause: BaseException,
                 free: bool = False):
        """Re-form the ring around the lost worker(s): survivors keep
        their processes and live state, adopt new ranks and a fresh
        incarnation id, and the train_fns reshard ZeRO optimizer
        shards over the new ring (train/reshard.py) — no placement
        group, no actor spawn, no checkpoint read. Consumes one unit
        of the failure budget like a restart would — EXCEPT when
        ``free`` (every lost rank had advance preemption notice:
        scheduled capacity loss spends no budget). Raises the cause
        when the budget is exhausted or a rewire fails (the run() loop
        then takes the restart path)."""
        max_failures = self.run_config.failure_config.max_failures
        if not free and self._failures + 1 > max_failures:
            raise cause             # run() counts + returns the error
        t0 = time.monotonic()
        dead = plan["dead"]
        survivors = plan["survivors"]
        assign = plan["assign"]
        for i in dead:
            try:
                ray_tpu_torch.kill(self._workers[i])
            except Exception:       # noqa: BLE001 — already dead
                pass
        old_group = self._group_id
        old_n = len(self._workers)
        # record the OLD incarnation's shard split BEFORE filtering:
        # a hierarchical group owned the nested hier_seg_bounds split,
        # and the reshard legality check must assess the lost rank's
        # segment under THAT split, not the flat one
        old_groups = self._node_groups()
        old_nodes = [len(g[1]) for g in old_groups] \
            if self._wants_hier(old_groups) else None
        # survivors keep their topology order, so adjacent new ranks
        # stay co-located wherever possible (same rule as create)
        self._workers = [self._workers[i] for i in survivors]
        self._infos = [self._infos[i] for i in survivors]
        self._last_mirrors = {}
        self._last_pipeline = {}
        # old rank indices (and their anatomy history) are now invalid
        self._straggler_det = self._make_straggler_detector()
        self._straggler_last = -1
        self._straggler_since = None
        n = len(self._workers)
        import uuid
        gid = uuid.uuid4().hex
        self._group_id = gid
        specs = self._grad_sync_specs(gid)
        lost = {int(d): {"old_rank": int(d), "old_size": old_n,
                         "old_nodes": old_nodes,
                         "holder": assign.get(d)} for d in dead}
        refs = []
        for j, w in enumerate(self._workers):
            contribute = [d for d in dead
                          if assign.get(d) == survivors[j]]
            refs.append(w.rewire.remote({
                "rank": j, "world_size": n, "group_id": gid,
                "old_group_id": old_group,
                "old_rank": survivors[j], "old_world_size": old_n,
                "grad_sync": specs[j],
                "contribute": contribute, "lost": lost,
                "mirror_peer": (self._workers[(j + 1) % n]
                                if n > 1 else None)}))
        # a rewire RPC failing (another death mid-reshape) propagates
        # as RayTpuError: run() counts it and restarts from checkpoint
        # — EXCEPT a free (preemption) reshape, whose fallback restart
        # must stay budget-free too (the capacity loss is still
        # scheduled, whether or not the in-place re-form worked out)
        try:
            oks = ray_tpu_torch.get(refs, timeout=120)
            if not all(oks):
                # an assigned mirror went missing (or a survivor never
                # started a train_fn): the restart path is the safe one
                raise cause
        except BaseException:
            if free:
                raise _PreemptRestart(cause) from None
            raise
        if not free:
            self._failures += 1
        self._clean_reports = 0
        self._reshape_unvalidated = True
        self._preempt_notice = {}   # old rank indices are now invalid
        self._record_recovery(
            "preempt" if free else "reshard", cause, lost=0,
            dur=time.monotonic() - t0,
            dead=dead, world=n, old_world=old_n, reshard=True)
        return set(range(n))

    def _handle_report(self, rank: int, rep: dict):
        # any report proves the (possibly reshaped) incarnation is
        # making progress — later failures are new incidents
        self._reshape_unvalidated = False
        self._preempt_unvalidated = False
        # Rank 0's metrics are canonical (SPMD: all ranks see the same
        # reduced values). Checkpoints ARE registered from any rank — a
        # distributed save may be reported by whichever rank coordinated it.
        if rank == 0:
            self.metrics_history.append(rep["metrics"])
            self._reports_since_ckpt += 1
        ckpt = rep.get("checkpoint")
        if ckpt is not None:
            self.ckpt_manager.register(ckpt, rep["metrics"])
            self._reports_since_ckpt = 0
            if self.run_config.storage_path:
                # the report path (or the ckptio commit, for managed
                # checkpoints) advanced the durable resume pointer to
                # this directory — retention must not delete it
                self.ckpt_manager.pointer_target = ckpt.path
        # failure-budget recovery: a sustained clean streak hands the
        # budget back (FailureConfig.reset_after_clean_reports), so a
        # long job with RARE preemptions spends max_failures per
        # incident burst instead of exhausting it cumulatively
        self._clean_reports += 1
        reset = self.run_config.failure_config.reset_after_clean_reports
        if reset > 0 and self._failures > 0 \
                and self._clean_reports >= reset:
            self._failures = 0
            self._clean_reports = 0
