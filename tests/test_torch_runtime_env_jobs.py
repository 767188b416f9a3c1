"""The port's runtime environments (``runtime/runtime_env.py``: env
vars, working dirs, py_modules) held to the JAX package's own tests.

``tests/test_runtime_env_jobs.py`` runs here unedited
(``_torch_ported.py``, ``ray_tpu`` rewritten to ``ray_tpu_torch``, no
other rename). Left out, for the ROADMAP.md Queue 1 item it waits for:

- test_job_submission_end_to_end: item 17 (``job_submission.py``).
"""

from _torch_ported import adopt, ported

SKIP = {
    "test_job_submission_end_to_end": "Queue 1 item 17: job_submission.py",
}

adopt(ported("test_runtime_env_jobs"), globals(), skip=SKIP)
