"""The port's runtime environments (``runtime/runtime_env.py``: env
vars, working dirs, py_modules) and job submission
(``job_submission.py``) held to the JAX package's own tests.

``tests/test_runtime_env_jobs.py`` runs here unedited
(``_torch_ported.py``, ``ray_tpu`` rewritten to ``ray_tpu_torch``, no
other rename). Nothing is left out.
"""

from _torch_ported import adopt, ported

adopt(ported("test_runtime_env_jobs"), globals())
