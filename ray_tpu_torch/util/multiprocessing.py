"""multiprocessing.Pool API over cluster tasks.

Drop-in analog of the reference integration (reference:
python/ray/util/multiprocessing/pool.py): the standard-library Pool
surface, with work units running as runtime tasks so a pool spans the
cluster instead of one machine.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List, Optional


class AsyncResult:
    def __init__(self, refs, single: bool):
        self._refs = refs
        self._single = single

    def get(self, timeout: Optional[float] = None):
        import ray_tpu_torch
        vals = ray_tpu_torch.get(self._refs, timeout=timeout)
        return vals[0] if self._single else vals

    def wait(self, timeout: Optional[float] = None):
        import ray_tpu_torch
        ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                     timeout=timeout)

    def ready(self) -> bool:
        import ray_tpu_torch
        done, _ = ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                               timeout=0)
        return len(done) == len(self._refs)

    def successful(self) -> bool:
        try:
            self.get(timeout=0)
            return True
        except Exception:
            return False


class Pool:
    """Pool(processes=N) bounds concurrency to N in-flight tasks."""

    def __init__(self, processes: Optional[int] = None,
                 initializer: Optional[Callable] = None,
                 initargs: tuple = ()):
        import ray_tpu_torch
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        if processes is None:
            processes = int(ray_tpu_torch.cluster_resources().get("CPU", 1))
        self._processes = max(1, processes)
        self._initializer = initializer
        self._initargs = initargs
        self._closed = False

    def _remote_fn(self, func):
        import ray_tpu_torch
        init, init_args = self._initializer, self._initargs

        @ray_tpu_torch.remote
        def _call(*a, **kw):
            if init is not None and not getattr(_call, "_did", False):
                init(*init_args)
            return func(*a, **kw)

        return _call

    def _check(self):
        if self._closed:
            raise ValueError("Pool not running")

    # -- sync API --------------------------------------------------------

    def apply(self, func, args: tuple = (), kwds: dict = None):
        return self.apply_async(func, args, kwds).get()

    def apply_async(self, func, args: tuple = (), kwds: dict = None):
        self._check()
        rf = self._remote_fn(func)
        return AsyncResult([rf.remote(*args, **(kwds or {}))], True)

    def map(self, func, iterable: Iterable[Any],
            chunksize: Optional[int] = None) -> List[Any]:
        return self.map_async(func, iterable, chunksize).get()

    def map_async(self, func, iterable: Iterable[Any],
                  chunksize: Optional[int] = None) -> AsyncResult:
        self._check()
        items = list(iterable)
        rf = self._remote_fn(func)
        refs = self._bounded_submit(rf, [(it,) for it in items])
        return AsyncResult(refs, False)

    def starmap(self, func, iterable: Iterable[tuple],
                chunksize: Optional[int] = None) -> List[Any]:
        self._check()
        rf = self._remote_fn(func)
        refs = self._bounded_submit(rf, list(iterable))
        return AsyncResult(refs, False).get()

    def imap(self, func, iterable: Iterable[Any],
             chunksize: Optional[int] = None):
        import ray_tpu_torch
        self._check()
        rf = self._remote_fn(func)
        refs = self._bounded_submit(rf, [(it,) for it in iterable])
        for r in refs:
            yield ray_tpu_torch.get(r)

    def imap_unordered(self, func, iterable: Iterable[Any],
                       chunksize: Optional[int] = None):
        import ray_tpu_torch
        self._check()
        rf = self._remote_fn(func)
        pending = list(self._bounded_submit(
            rf, [(it,) for it in iterable]))
        while pending:
            done, pending = ray_tpu_torch.wait(pending, num_returns=1)
            for r in done:  # wait may return more than num_returns
                yield ray_tpu_torch.get(r)

    def _bounded_submit(self, rf, arg_tuples: List[tuple]):
        """Submit everything; the scheduler's queues bound execution, and
        `processes` bounds how many are IN FLIGHT at once to cap cluster
        resource use (parity with Pool's process count)."""
        import ray_tpu_torch
        refs = []
        inflight: List = []
        for a in arg_tuples:
            if len(inflight) >= self._processes:
                _, inflight = ray_tpu_torch.wait(
                    inflight, num_returns=1)
            r = rf.remote(*a)
            refs.append(r)
            inflight.append(r)
        return refs

    # -- lifecycle -------------------------------------------------------

    def close(self):
        self._closed = True

    def terminate(self):
        self._closed = True

    def join(self):
        if not self._closed:
            raise ValueError("Pool is still running")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.terminate()
        return False
