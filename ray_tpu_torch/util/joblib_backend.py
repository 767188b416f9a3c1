"""joblib parallel backend over the cluster.

Reference: python/ray/util/joblib/ (register_ray -> a joblib
ParallelBackendBase running scikit-learn's Parallel loops on Ray
actors). Here each joblib batch runs as one runtime task; n_jobs=-1
means the cluster's CPU count, so an sklearn grid search or
cross-validation fans out across nodes with the one-line backend swap
joblib users expect:

    from ray_tpu_torch.util.joblib_backend import register_ray_tpu
    register_ray_tpu()
    with joblib.parallel_backend("ray_tpu_torch"):
        GridSearchCV(...).fit(X, y)

The port's copy of ``ray_tpu/util/joblib_backend.py`` over the port's
runtime; its backend registers as "ray_tpu_torch", so the two packages'
backends can live in one process.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional


class _TaskResult:
    """future-like joblib expects from apply_async: .get(timeout) plus
    an optional completion callback fired off a waiter thread."""

    def __init__(self, ref, callback: Optional[Callable]):
        self._ref = ref
        self._result = None
        self._error: Optional[BaseException] = None
        self._done = threading.Event()
        self._cb = callback
        t = threading.Thread(target=self._wait, daemon=True)
        t.start()

    def _wait(self):
        import ray_tpu_torch
        try:
            self._result = ray_tpu_torch.get(self._ref, timeout=None)
        except BaseException as e:  # noqa: BLE001 — delivered via get()
            self._error = e
        self._done.set()
        if self._cb is not None and self._error is None:
            self._cb(self._result)

    def get(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError("joblib task timed out")
        if self._error is not None:
            raise self._error
        return self._result


def _run_batch(payload_fn):
    return payload_fn()


def _make_backend_cls():
    from joblib.parallel import ParallelBackendBase

    class RayTpuBackend(ParallelBackendBase):
        """Each apply_async ships one joblib BatchedCalls (a picklable
        callable of many items) as a single runtime task."""

        uses_threads = False
        supports_sharedmem = False
        supports_timeout = True     # _TaskResult.get honors it

        def __init__(self, *a, num_cpus_per_batch: float = 1.0, **kw):
            super().__init__(*a, **kw)
            self.num_cpus_per_batch = num_cpus_per_batch
            self._remote_fn = None
            self._inflight: list = []

        def configure(self, n_jobs: int = 1, parallel=None,
                      **backend_args):
            import ray_tpu_torch
            if not ray_tpu_torch.is_initialized():
                ray_tpu_torch.init()
            self.parallel = parallel
            return self.effective_n_jobs(n_jobs)

        def effective_n_jobs(self, n_jobs: int) -> int:
            import ray_tpu_torch
            if n_jobs == 0:
                raise ValueError("n_jobs == 0 has no meaning")
            if n_jobs is None:
                return 1
            if n_jobs < 0:
                return max(1, int(ray_tpu_torch.cluster_resources()
                                  .get("CPU", 1)))
            return n_jobs

        def submit(self, func, callback=None) -> _TaskResult:
            # joblib >= 1.5 calls submit; older versions apply_async
            return self.apply_async(func, callback)

        def apply_async(self, func, callback=None) -> _TaskResult:
            import ray_tpu_torch
            if self._remote_fn is None:
                # ONE RemoteFunction for the backend's lifetime — a
                # fresh wrapper per batch would redo runtime-env
                # validation/caching per submission
                self._remote_fn = ray_tpu_torch.remote(_run_batch).options(
                    num_cpus=self.num_cpus_per_batch)
            ref = self._remote_fn.remote(func)
            self._inflight = [r for r in self._inflight
                              if not r._done.is_set()]
            res = _TaskResult(ref, callback)
            self._inflight.append(res)
            return res

        def abort_everything(self, ensure_ready: bool = True):
            """A failed fit aborts its siblings: cancel every in-flight
            batch instead of letting up to pre_dispatch of them burn
            cluster CPUs to completion."""
            import ray_tpu_torch
            for res in self._inflight:
                if not res._done.is_set():
                    try:
                        ray_tpu_torch.cancel(res._ref)
                    except Exception:
                        pass
            self._inflight.clear()
            if ensure_ready:
                self.configure(n_jobs=self.parallel.n_jobs
                               if self.parallel else 1,
                               parallel=self.parallel)

    return RayTpuBackend


_registered = False


def register_ray_tpu() -> None:
    """Idempotently register the 'ray_tpu_torch' joblib backend."""
    global _registered
    if _registered:
        return
    from joblib import register_parallel_backend
    register_parallel_backend("ray_tpu_torch", _make_backend_cls())
    _registered = True
