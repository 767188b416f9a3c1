"""The port's utilities: the event buffer, the metrics registry, request
tracing, the device monitor, the forensics state providers, the actor
pool, the queue and the TPU helpers, each a copy (or, for the device
monitor, a ``torch.cuda`` counterpart) of the ``ray_tpu/util`` module of
the same name."""


def __getattr__(name):
    # Submodules import lazily so `import ray_tpu_torch.util` stays cheap.
    if name in ("events", "metrics", "tpu", "queue", "actor_pool",
                "multiprocessing", "state", "collective", "tracing",
                "dashboard", "accelerators", "joblib_backend"):
        import importlib
        return importlib.import_module(f"ray_tpu_torch.util.{name}")
    if name == "ActorPool":
        from ray_tpu_torch.util.actor_pool import ActorPool
        return ActorPool
    raise AttributeError(
        f"module 'ray_tpu_torch.util' has no attribute {name!r}")
