"""The port's always-on task events (``util/tracing.record_exec`` and the
``RAY_TPU_TRACE_TASKS``/``RAY_TPU_TASK_EVENTS`` switches, read through
``util/state.list_tasks``) held to the JAX package's own
``tests/test_task_events.py``, run here unedited with every ``ray_tpu``
name rewritten to ``ray_tpu_torch`` (``_torch_ported.py``)."""

from _torch_ported import adopt, ported

adopt(ported("test_task_events"), globals())
