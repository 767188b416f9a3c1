"""Job submission SDK: run driver scripts on the cluster head.

Analog of the reference's job submission client (reference:
python/ray/dashboard/modules/job/sdk.py JobSubmissionClient,
job_manager.py:62) over the RPC plane instead of REST: submit a shell
entrypoint, poll status, fetch logs, stop.

    client = JobSubmissionClient("127.0.0.1:6379")
    sid = client.submit_job(entrypoint="python train.py",
                            runtime_env={"env_vars": {"MODE": "prod"}})
    client.wait_until_finish(sid)
    print(client.get_job_logs(sid))

The port's copy of ``ray_tpu/job_submission.py``, unchanged but for
import paths.
"""

from __future__ import annotations

import time
from typing import Optional

from ray_tpu_torch.runtime import rpc


class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"
    TERMINAL = (SUCCEEDED, FAILED, STOPPED)


class JobSubmissionClient:
    def __init__(self, address: str):
        host, port = address.rsplit(":", 1)
        self._addr = (host, int(port))
        self._elt = rpc.EventLoopThread("ray_tpu_jobclient")
        self._pool = None

    def _call(self, method: str, **kw):
        async def go():
            global_pool = self._pool
            if global_pool is None:
                self._pool = global_pool = rpc.ConnectionPool()
            return await global_pool.call(self._addr, method,
                                          timeout=30.0, **kw)
        return self._elt.run(go())

    def submit_job(self, *, entrypoint: str,
                   runtime_env: Optional[dict] = None,
                   submission_id: Optional[str] = None) -> str:
        rt = None
        if runtime_env:
            from ray_tpu_torch.runtime.runtime_env import validate
            rt = validate(runtime_env)
        r = self._call("submit_job", entrypoint=entrypoint,
                       submission_id=submission_id, runtime_env=rt)
        if not r.get("ok"):
            raise RuntimeError(r.get("error", "job submission failed"))
        return r["submission_id"]

    def get_job_status(self, submission_id: str) -> str:
        info = self._call("get_submitted_job", submission_id=submission_id)
        if info is None:
            raise ValueError(f"no job {submission_id!r}")
        return info["status"]

    def get_job_info(self, submission_id: str) -> dict:
        info = self._call("get_submitted_job", submission_id=submission_id)
        if info is None:
            raise ValueError(f"no job {submission_id!r}")
        return info

    def list_jobs(self) -> list:
        return self._call("list_submitted_jobs")

    def get_job_logs(self, submission_id: str) -> str:
        logs = self._call("submitted_job_logs",
                          submission_id=submission_id)
        if logs is None:
            raise ValueError(f"no job {submission_id!r}")
        return logs

    def stop_job(self, submission_id: str) -> bool:
        r = self._call("stop_submitted_job", submission_id=submission_id)
        return bool(r.get("ok"))

    def wait_until_finish(self, submission_id: str,
                          timeout: float = 300.0,
                          poll_s: float = 0.5) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            st = self.get_job_status(submission_id)
            if st in JobStatus.TERMINAL:
                return st
            time.sleep(poll_s)
        raise TimeoutError(
            f"job {submission_id!r} not finished after {timeout}s")

    def close(self):
        if self._pool is not None:
            pool = self._pool
            self._pool = None
            self._elt.run(pool.close())
        self._elt.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
