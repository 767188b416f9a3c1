"""The port's library surfaces over the runtime (``util/actor_pool.py``,
``util/queue.py``, ``util/multiprocessing.py``, the joblib backend) held
to the JAX package's own tests.

``tests/test_util_integrations.py`` runs here unedited
(``_torch_ported.py``, ``ray_tpu`` rewritten to ``ray_tpu_torch``, no
other rename). The reference module imports the actor pool, the queue
and the multiprocessing pool at its top, so the port carries copies of
all three (ROADMAP.md Queue 1 item 17, partly done) and runs every test.
"""

from _torch_ported import adopt, ported

adopt(ported("test_util_integrations"), globals())
