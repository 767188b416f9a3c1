"""``ray_tpu_torch.shutdown()`` returns only once the node's worker
processes have exited: the agent terminates every worker and waits for
it (one shared bound, then SIGKILL), so a worker's device memory is free
when shutdown returns and the next phase's processes can take it."""

import os

import ray_tpu_torch as rt


def _gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def test_shutdown_returns_after_workers_exit(tmp_path):
    """An actor's and a task's worker pids, recorded while they run, no
    longer exist the moment ``shutdown()`` returns (no sleep between).
    The actor leaves a thread that keeps its process alive for 6 s after
    SIGTERM (the interpreter joins it at exit; with the checkpoint plane
    imported the worker's own backstop is ``preempt_grace_s`` + 3 s =
    8 s), as a worker releasing a large device allocation takes a while
    to exit: longer than the servers' bounded closes (2 s each) that
    shutdown waits for anyway. Its exit handlers ran: it left through
    its own drain, not a kill."""
    mark = tmp_path / "exited"
    rt.init(num_cpus=2)
    try:
        @rt.remote
        def task_pid():
            import os
            return os.getpid()

        @rt.remote
        class Probe:
            def pid(self, mark):
                import atexit
                import os
                import threading
                import time

                import ray_tpu_torch.train.ckptio  # noqa: F401
                atexit.register(lambda: open(mark, "w").close())
                threading.Thread(target=time.sleep, args=(6.0,)).start()
                return os.getpid()

        probe = Probe.remote()
        pids = {rt.get(probe.pid.remote(str(mark)), timeout=60),
                rt.get(task_pid.remote(), timeout=60)}
        assert len(pids) == 2 and os.getpid() not in pids
        assert not any(_gone(p) for p in pids)
    finally:
        rt.shutdown()
    assert all(_gone(p) for p in pids), \
        [p for p in pids if not _gone(p)]
    assert mark.exists()
