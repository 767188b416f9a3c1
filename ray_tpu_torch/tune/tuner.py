"""Tuner: concurrent trials as actors + report plumbing.

Reference: python/ray/tune/tuner.py:43 (Tuner.fit), tune/execution/
tune_controller.py:65 (trial lifecycle loop), tune/trainable/ (report
path). Each trial runs the user trainable inside a dedicated actor; the
driver-side controller polls trial reports, feeds the scheduler, and
stops losers early.

The port's copy of ``ray_tpu/tune/tuner.py``. A trainer trial runs
``TorchTrainer.fit()`` in its trial actor and streams the run's reports
to the scheduler as the controller receives them; a gang's size is
counted in the first of TPU or GPU that its workers ask for, else CPU.
"""

from __future__ import annotations

import threading
import time
import traceback
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.tune.schedulers import STOP, Exploit, FIFOScheduler
from ray_tpu_torch.tune.search import generate_variants


class TrialStopped(Exception):
    """Raised inside a trainable when the scheduler stops the trial."""


_trial_local = threading.local()


def report(metrics: Optional[dict] = None, *, checkpoint: Optional[Any] = None,
           **kw) -> None:
    """Report metrics (and optionally a checkpoint) from inside a
    trainable (reference: tune.report / train.report)."""
    st = getattr(_trial_local, "state", None)
    m = dict(metrics or {})
    m.update(kw)
    if st is None:
        return  # running outside tune: no-op, keeps trainables testable
    with st.lock:
        st.iteration += 1
        m.setdefault("training_iteration", st.iteration)
        st.reports.append(m)
        if checkpoint is not None:
            st.checkpoint = checkpoint
        stop = st.stop
    if stop:
        raise TrialStopped()


def get_checkpoint() -> Any:
    """The checkpoint to resume from, inside a trainable: the trial's own
    last reported checkpoint, or — after a PBT exploit — the donor
    trial's checkpoint (reference: tune.get_checkpoint /
    train.get_checkpoint)."""
    st = getattr(_trial_local, "state", None)
    if st is None:
        return None
    with st.lock:
        return st.checkpoint


class _TrialState:
    def __init__(self):
        self.lock = threading.Lock()
        self.reports: List[dict] = []
        self.iteration = 0
        self.stop = False
        self.checkpoint = None
        self.status = "RUNNING"
        self.error: Optional[str] = None
        self.final_return = None


class _TrialActor:
    """Hosts one trial. run() executes the trainable on an executor
    thread; poll()/request_stop() are async so they stay responsive on
    the worker loop while the trainable runs (max_concurrency > 1)."""

    def __init__(self):
        self.state = _TrialState()

    def _reset_for_run(self, checkpoint: Any = None):
        st = self.state
        with st.lock:
            # restarts (PBT exploit) reuse the actor: clear the stop
            # latch, keep the report log (cursor continuity), and seed
            # the donor checkpoint for get_checkpoint()
            st.stop = False
            st.status = "RUNNING"
            if checkpoint is not None:
                st.checkpoint = checkpoint

    def _body(self, fn: Callable[[dict], Any], config: dict):
        st = self.state
        _trial_local.state = st
        try:
            out = fn(config)
            with st.lock:
                st.final_return = out
                st.status = "TERMINATED"
        except TrialStopped:
            with st.lock:
                st.status = "STOPPED"
        except BaseException:  # noqa: BLE001 — recorded, not raised
            with st.lock:
                st.error = traceback.format_exc()
                st.status = "ERROR"
        finally:
            _trial_local.state = None
        return True

    def run(self, fn: Callable[[dict], Any], config: dict,
            checkpoint: Any = None):
        self._reset_for_run(checkpoint)
        return self._body(fn, config)

    async def restart(self, fn: Callable[[dict], Any], config: dict,
                      checkpoint: Any = None) -> bool:
        """Exploit restart. Async so the status flips to RUNNING *on the
        actor loop, in call order* — a poll() sent after this call can
        never observe the previous run's terminal status — while the
        trainable body runs on the executor in the background."""
        import asyncio
        self._reset_for_run(checkpoint)
        loop = asyncio.get_running_loop()
        loop.run_in_executor(None, self._body, fn, config)
        return True

    async def poll(self, cursor: int) -> dict:
        st = self.state
        with st.lock:
            return {"reports": list(st.reports[cursor:]),
                    "cursor": len(st.reports),
                    "status": st.status,
                    "error": st.error}

    async def request_stop(self) -> bool:
        with self.state.lock:
            self.state.stop = True
        return True

    async def get_final(self) -> dict:
        st = self.state
        with st.lock:
            # Checkpoints/returns may hold arrays: ship via the object
            # plane (the reply itself is an object already).
            return {"checkpoint": st.checkpoint,
                    "final_return": st.final_return,
                    "last_report": st.reports[-1] if st.reports else {}}


@dataclass
class TuneConfig:
    """Reference: tune/tune_config.py."""
    metric: Optional[str] = None
    mode: str = "min"
    num_samples: int = 1
    max_concurrent_trials: Optional[int] = None
    scheduler: Any = None
    # a tune.search.Searcher (e.g. TPESearcher) that proposes configs
    # sequentially from observed results; None = pre-expanded
    # grid x random variants (reference: tune_config.py search_alg)
    search_alg: Any = None
    seed: Optional[int] = None
    resources_per_trial: Optional[Dict[str, float]] = None


@dataclass
class Result:
    """Reference: air/result.py."""
    config: dict
    metrics: dict
    error: Optional[str] = None
    checkpoint: Any = None
    all_reports: List[dict] = field(default_factory=list)
    status: str = "TERMINATED"


class ResultGrid:
    def __init__(self, results: List[Result], metric: Optional[str],
                 mode: str):
        self._results = results
        self._metric = metric
        self._mode = mode

    def __len__(self):
        return len(self._results)

    def __iter__(self):
        return iter(self._results)

    def __getitem__(self, i):
        return self._results[i]

    @property
    def errors(self) -> List[Result]:
        return [r for r in self._results if r.error]

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        scored = [r for r in self._results
                  if not r.error and metric in r.metrics]
        if not scored:
            raise ValueError("no successful trial reported "
                             f"metric {metric!r}")
        keyfn = lambda r: r.metrics[metric]  # noqa: E731
        return (max if mode == "max" else min)(scored, key=keyfn)

    def get_dataframe(self):
        import pandas as pd
        rows = []
        for r in self._results:
            row = {f"config/{k}": v for k, v in r.config.items()}
            row.update(r.metrics)
            row["status"] = r.status
            rows.append(row)
        return pd.DataFrame(rows)


@dataclass
class _Trial:
    trial_id: str
    config: dict
    actor: Any = None
    run_ref: Any = None
    cursor: int = 0
    reports: List[dict] = field(default_factory=list)
    stop_requested: bool = False
    exploit: Any = None       # pending PBT Exploit decision


def _trainer_trainable(trainer) -> Callable[[dict], Any]:
    def run_trial(config: dict):
        import copy
        import threading
        import uuid as _uuid

        import ray_tpu_torch
        from ray_tpu_torch.train.trainer import get_controller

        t = copy.copy(trainer)
        t.train_loop_config = {**(trainer.train_loop_config or {}),
                               **(config or {})}
        # Unique-but-correlated run name: sweep name + trial suffix, so
        # get_controller-based monitoring still works per trial.
        t.run_config = copy.copy(trainer.run_config)
        base = trainer.run_config.name or "tune"
        t.run_config.name = f"{base}-{_uuid.uuid4().hex[:6]}"

        box: dict = {}

        def _fit():
            try:
                box["res"] = t.fit()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                box["err"] = e

        th = threading.Thread(target=_fit, daemon=True)
        th.start()
        # Stream the run's reports to the scheduler LIVE (via the
        # controller actor's history) so ASHA-style early stopping can
        # actually interrupt training instead of post-hoc replay.
        reported = 0
        stopped = False
        while th.is_alive() and not stopped:
            th.join(timeout=0.3)
            try:
                h = get_controller(t.run_config.name)
                hist = ray_tpu_torch.get(
                    h.history.remote(reported), timeout=10)
            except Exception:
                continue
            for m in hist:
                reported += 1
                try:
                    report(m)
                except TrialStopped:
                    stopped = True
                    try:
                        ray_tpu_torch.get(h.stop.remote(), timeout=60)
                    except Exception:
                        pass
                    break
        th.join(timeout=300)
        if stopped:
            raise TrialStopped()
        if "err" in box:
            raise box["err"]
        res = box.get("res")
        if res is None:
            raise RuntimeError("trainer.fit() did not complete")
        if res.error is not None:
            raise res.error
        for m in res.metrics_history[reported:]:
            report(m)
        if res.checkpoint is not None:
            # forward the run's best checkpoint into tune's plane so
            # grid.get_best_result().checkpoint is recoverable
            report(dict(res.metrics), checkpoint=res.checkpoint)
        return res.metrics

    run_trial._nested_trainer = trainer  # Tuner derives resources from it
    return run_trial


class Tuner:
    """Reference: tune/tuner.py:43. ``Tuner(fn, param_space=...,
    tune_config=TuneConfig(...)).fit()`` -> ResultGrid.

    With ``storage_path`` set, sweep state (sampled configs + per-trial
    outcomes) persists after every trial completion, and
    ``Tuner.restore(storage_path, trainable, name=...)`` resumes an
    interrupted sweep: finished trials keep their results, unfinished
    ones re-run, and a model-based searcher is re-fed the finished
    observations (reference: tune/tuner.py Tuner.restore +
    result_grid restoration)."""

    def __init__(self, trainable, *,
                 param_space: Optional[Dict[str, Any]] = None,
                 tune_config: Optional[TuneConfig] = None,
                 storage_path: Optional[str] = None,
                 name: str = "tune",
                 _restored: Optional[dict] = None):
        from ray_tpu_torch.train.trainer import BaseTrainer
        if isinstance(trainable, BaseTrainer):
            # Tuner(trainer) parity (reference: tuner.py accepts a
            # Trainer): each trial re-runs the trainer with the sampled
            # config merged into train_loop_config. Reports flow through
            # the normal train.report plane; the trial's result is the
            # run's final metrics.
            trainable = _trainer_trainable(trainable)
        if not callable(trainable):
            raise TypeError(
                "trainable must be a callable(config) or a Trainer")
        self._fn = trainable
        self._space = dict(param_space or {})
        self._cfg = tune_config or TuneConfig()
        self._storage_path = storage_path
        self._name = name
        self._restored = _restored

    # -- persistence / restore ------------------------------------------

    def _state_key(self) -> str:
        return f"{self._name}/tuner_state.pkl"

    def _persist(self, trials: List["_Trial"],
                 results: Dict[str, "Result"]) -> None:
        if not self._storage_path:
            return
        import cloudpickle

        from ray_tpu_torch.util import storage as _st
        recs = []
        for t in trials:
            r = results.get(t.trial_id)
            recs.append({
                "id": t.trial_id, "config": t.config,
                "status": r.status if r else "PENDING",
                "metrics": r.metrics if r else None,
                "error": r.error if r else None,
                "reports": r.all_reports if r else [],
                "checkpoint": r.checkpoint if r else None,
            })
        try:
            blob = cloudpickle.dumps(
                {"space": self._space, "cfg": self._cfg, "trials": recs},
                protocol=5)
        except Exception:
            return  # unpicklable user objects: persistence is optional
        st, root = _st.get_storage(self._storage_path)
        st.put_bytes(f"{root}/{self._state_key()}", blob)

    @classmethod
    def restore(cls, storage_path: str, trainable, *,
                name: str = "tune",
                restart_errored: bool = True) -> "Tuner":
        """Resume an interrupted sweep persisted under
        ``storage_path``/``name``. Completed trials are restored as
        results; pending (and, with ``restart_errored``, errored)
        trials re-run with their original sampled configs."""
        import pickle

        from ray_tpu_torch.util import storage as _st
        st, root = _st.get_storage(storage_path)
        blob = st.get_bytes(f"{root}/{name}/tuner_state.pkl")
        if blob is None:
            raise FileNotFoundError(
                f"no tuner state at {storage_path}/{name}")
        state = pickle.loads(blob)
        return cls(trainable, param_space=state["space"],
                   tune_config=state["cfg"], storage_path=storage_path,
                   name=name,
                   _restored={"trials": state["trials"],
                              "restart_errored": restart_errored})

    def fit(self) -> ResultGrid:
        import ray_tpu_torch
        cfg = self._cfg
        scheduler = cfg.scheduler or FIFOScheduler()
        if getattr(scheduler, "metric", None) is None and cfg.metric:
            scheduler.metric = cfg.metric
            scheduler.mode = cfg.mode
        searcher = cfg.search_alg
        restored_recs = (self._restored or {}).get("trials") or []
        restart_errored = (self._restored or {}).get(
            "restart_errored", True)
        if searcher is not None:
            searcher.set_search_properties(cfg.metric, cfg.mode,
                                           self._space)
            trials = []          # suggested lazily as slots free up
        elif restored_recs:
            trials = []          # rebuilt from the persisted sweep below
        else:
            configs = generate_variants(self._space, cfg.num_samples,
                                        cfg.seed)
            trials = [_Trial(uuid.uuid4().hex[:8], c) for c in configs]
        nested = getattr(self._fn, "_nested_trainer", None)
        if nested is not None:
            # Trainer trials: the trial actor only coordinates (the
            # nested worker gang holds the real resources), so it costs
            # nothing — and concurrency defaults to how many gangs the
            # cluster can actually place, not the CPU count.
            resources = cfg.resources_per_trial or {"CPU": 0.0}
            if cfg.max_concurrent_trials:
                limit = cfg.max_concurrent_trials
            else:
                res_w = nested.scaling_config.worker_resources()
                nw = nested.scaling_config.num_workers
                if isinstance(nw, tuple):
                    nw = nw[0]
                key = next((k for k in ("TPU", "GPU") if k in res_w),
                           "CPU")
                per_gang = max(1e-9, res_w.get(key, 1.0) * max(1, nw))
                total = ray_tpu_torch.cluster_resources().get(key, 1.0)
                limit = max(1, int(total // per_gang))
        else:
            limit = cfg.max_concurrent_trials or max(
                1, int(ray_tpu_torch.cluster_resources().get("CPU", 4)))
            resources = cfg.resources_per_trial or {"CPU": 1.0}

        actor_cls = ray_tpu_torch.remote(_TrialActor).options(
            max_concurrency=4, resources=resources)
        pending = list(trials)
        running: Dict[str, _Trial] = {}
        results: Dict[str, Result] = {}

        # Restore: finished trials become Results; unfinished ones
        # re-run their original sampled configs. A restored searcher
        # was pickled WITH its observations (persist runs after
        # on_trial_complete), so replay only into a searcher that has
        # none — re-observing would double-weight pre-crash points in
        # the TPE good/bad split.
        replay = searcher is not None and restored_recs and \
            not getattr(searcher, "_obs", None)
        for rec in restored_recs:
            t = _Trial(rec["id"], rec["config"])
            trials.append(t)
            done = rec["status"] in ("TERMINATED", "STOPPED") or (
                rec["status"] == "ERROR" and not restart_errored)
            if done:
                results[t.trial_id] = Result(
                    config=rec["config"], metrics=rec["metrics"] or {},
                    error=rec["error"],
                    checkpoint=rec.get("checkpoint"),
                    all_reports=list(rec.get("reports") or []),
                    status=rec["status"])
                if replay and rec["status"] == "TERMINATED":
                    searcher.observe(rec["config"], rec["metrics"] or {})
            else:
                pending.append(t)

        def finalize(t: _Trial, status: str, error: Optional[str] = None):
            checkpoint = None
            final_metrics = t.reports[-1] if t.reports else {}
            try:
                fin = ray_tpu_torch.get(t.actor.get_final.remote(), timeout=30)
                checkpoint = fin["checkpoint"]
                if isinstance(fin.get("final_return"), dict):
                    final_metrics = {**final_metrics,
                                     **fin["final_return"]}
            except Exception:
                pass
            results[t.trial_id] = Result(
                config=t.config, metrics=final_metrics, error=error,
                checkpoint=checkpoint, all_reports=list(t.reports),
                status=status)
            scheduler.on_trial_complete(t.trial_id, final_metrics)
            if searcher is not None:
                searcher.on_trial_complete(t.trial_id, final_metrics)
            try:
                ray_tpu_torch.kill(t.actor)
            except Exception:
                pass
            self._persist(trials, results)

        def donor_checkpoint(donor_id: str):
            d = running.get(donor_id)
            if d is not None:
                try:
                    fin = ray_tpu_torch.get(d.actor.get_final.remote(),
                                            timeout=30)
                    return fin["checkpoint"]
                except Exception:
                    return None
            r = results.get(donor_id)
            return r.checkpoint if r is not None else None

        suggested = len(restored_recs)

        def _refill_from_searcher():
            """Ask the searcher for new trials as slots free (sequential
            model-based search: each suggest() may condition on every
            result observed so far)."""
            nonlocal suggested
            while suggested < cfg.num_samples and \
                    len(pending) + len(running) < limit:
                tid = uuid.uuid4().hex[:8]
                c = searcher.suggest(tid)
                if c is None:
                    suggested = cfg.num_samples   # searcher exhausted
                    break
                suggested += 1
                t = _Trial(tid, c)
                trials.append(t)    # ResultGrid orders by `trials`
                pending.append(t)

        while True:
            if searcher is not None:
                _refill_from_searcher()
            if not pending and not running and (
                    searcher is None or suggested >= cfg.num_samples):
                break
            started = False
            while pending and len(running) < limit:
                t = pending.pop(0)
                t.actor = actor_cls.remote()
                if hasattr(scheduler, "on_trial_start"):
                    scheduler.on_trial_start(t.trial_id, t.config)
                t.run_ref = t.actor.run.remote(self._fn, t.config)
                running[t.trial_id] = t
                started = True
            if started:
                # in-flight configs reach storage BEFORE their outcomes
                # exist, so a crash mid-trial leaves them restorable
                self._persist(trials, results)
            for t in list(running.values()):
                try:
                    r = ray_tpu_torch.get(t.actor.poll.remote(t.cursor),
                                          timeout=60)
                except ray_tpu_torch.RayTpuError as e:
                    finalize(t, "ERROR", f"trial actor lost: {e}")
                    running.pop(t.trial_id)
                    continue
                t.cursor = r["cursor"]
                t.reports.extend(r["reports"])
                for m in r["reports"]:
                    if t.stop_requested:
                        continue
                    d = scheduler.on_result(t.trial_id, m)
                    if d == STOP:
                        t.stop_requested = True
                        t.actor.request_stop.remote()
                    elif isinstance(d, Exploit):
                        t.stop_requested = True
                        t.exploit = d
                        t.actor.request_stop.remote()
                if r["status"] != "RUNNING":
                    if t.exploit is not None and r["status"] == "STOPPED":
                        # PBT: clone the donor's checkpoint, continue on
                        # the same actor with the mutated config
                        ck = donor_checkpoint(t.exploit.donor_id)
                        t.config = dict(t.exploit.config)
                        t.exploit = None
                        t.stop_requested = False
                        if hasattr(scheduler, "on_exploit_applied"):
                            scheduler.on_exploit_applied(
                                t.trial_id, t.config)
                        t.run_ref = t.actor.restart.remote(
                            self._fn, t.config, ck)
                        continue
                    status = ("TERMINATED" if r["status"] == "TERMINATED"
                              else r["status"])
                    finalize(t, status, r["error"])
                    running.pop(t.trial_id)
            if running:
                time.sleep(0.05)
        ordered = [results[t.trial_id] for t in trials
                   if t.trial_id in results]
        return ResultGrid(ordered, cfg.metric, cfg.mode)
